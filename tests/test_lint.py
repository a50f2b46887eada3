"""Self-tests for the static-analysis gate (scripts/analysis/,
docs/ANALYSIS.md).

Every rule is demonstrated twice on inline source fixtures: a
minimal bad example it must FIRE on, and the good twin it must stay
silent on — plus the pragma/waiver engine, and the full-tree gate
itself (which exercises the real legacy-path waivers: the loops=1
single-loop ingress fast paths, the Metrics single-writer mode).
"""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import analysis  # noqa: E402
from analysis import Context  # noqa: E402


def lint(src, path="emqx_tpu/example.py", ctx=None, rule=None):
    kept, suppressed = analysis.analyze_source(
        textwrap.dedent(src), path=path, ctx=ctx, rule=rule)
    return kept, suppressed


def rules_of(findings):
    return [f.rule for f in findings]


def has(findings, rule):
    return any(f.rule == rule for f in findings)


# -- core rules (the original linter, carried over) ------------------------

def test_core_rules_fire_on_bad_examples():
    kept, _ = lint("""\
        import os
        def f(x=[]):
            try:
                pass
            except:
                pass
            if x == None:
                assert (x, "oops")
        def f():
            pass
        """)
    for rule in ("F401", "B006", "E722", "E711", "F631", "F811"):
        assert has(kept, rule), (rule, kept)


def test_core_rules_silent_on_good_twin():
    kept, _ = lint("""\
        import os
        def f(x=None):
            try:
                pass
            except ValueError:
                pass
            if x is None:
                assert x, "oops"
            return os.sep
        """)
    assert kept == []


def test_f401_string_annotation_counts_as_use():
    # the old linter flagged imports used only in quoted annotations
    kept, _ = lint("""\
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            from emqx_tpu.router import Router
        def f(r: "Router") -> "Router":
            return r
        """)
    assert kept == []


def test_f401_type_checking_block_is_checked():
    # ...and never looked inside TYPE_CHECKING blocks at all: a dead
    # typing import could rot there forever
    kept, _ = lint("""\
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            from emqx_tpu.router import Router
        def f(x):
            return x
        """)
    assert has(kept, "F401")


def test_e999_syntax_error():
    kept, _ = lint("def f(:\n")
    assert rules_of(kept) == ["E999"]


# -- CD101: cross-domain call into a loop-only function --------------------

_CD101_BAD = """\
    from emqx_tpu.concurrency import bg_thread, owner_loop

    class C:
        @owner_loop
        def deliver(self):
            pass

        @bg_thread
        def worker(self):
            self.deliver()
    """

def test_cd101_fires_on_cross_domain_call():
    kept, _ = lint(_CD101_BAD)
    assert rules_of(kept) == ["CD101"]


def test_cd101_silent_when_marshaled_or_same_domain():
    kept, _ = lint("""\
        from emqx_tpu.concurrency import bg_thread, owner_loop

        class C:
            @owner_loop
            def deliver(self):
                pass

            @owner_loop
            def tail(self):
                self.deliver()     # loop -> loop: fine

            @bg_thread
            def worker(self, loop):
                # a reference handed to the bridge is NOT a call
                loop.call_soon_threadsafe(self.deliver)
        """)
    assert kept == []


def test_cd101_pragma_waives_with_reason():
    src = _CD101_BAD.replace(
        "self.deliver()",
        "self.deliver()  # lint: ok-CD101 shutdown fallback: loop gone")
    kept, suppressed = lint(src)
    assert kept == []
    assert rules_of(suppressed) == ["CD101"]


def test_cd101_ignores_unannotated_paths():
    # only annotated callers/callees are judged — scripts/tests and
    # unannotated emqx_tpu code never produce findings
    kept, _ = lint("""\
        class C:
            def deliver(self):
                pass
            def worker(self):
                self.deliver()
        """)
    assert kept == []


# -- CD102: shared-attribute writes outside the lock -----------------------

_CD102_BAD = """\
    import threading
    from emqx_tpu.concurrency import shared_state

    @shared_state(lock="_lock", attrs=("_buf",))
    class W:
        def __init__(self):
            self._lock = threading.Lock()
            self._buf = []

        def append(self, x):
            self._buf.append(x)
    """

def test_cd102_fires_on_unlocked_mutation():
    kept, _ = lint(_CD102_BAD)
    assert rules_of(kept) == ["CD102"]


def test_cd102_silent_under_lock_and_alias():
    kept, _ = lint("""\
        import threading
        from emqx_tpu.concurrency import shared_state

        @shared_state(lock="_lock", attrs=("_buf",))
        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._buf = []

            def append(self, x):
                with self._lock:
                    self._buf.append(x)

            def swap(self):
                lk = self._lock
                with lk:                    # the Metrics alias idiom
                    batch, self._buf = self._buf, []
                return batch

            def _drain_locked(self):
                # the _locked suffix: caller holds the lock
                self._buf.clear()
        """)
    assert kept == []


def test_cd102_init_exempt_and_pragma():
    src = _CD102_BAD.replace(
        "self._buf.append(x)",
        "self._buf.append(x)  # lint: ok-CD102 single-writer mode")
    kept, suppressed = lint(src)
    assert kept == []
    assert rules_of(suppressed) == ["CD102"]


# -- CD103/CD104: async misuse ---------------------------------------------

def test_cd103_unawaited_coroutine():
    kept, _ = lint("""\
        class C:
            async def flush(self):
                pass

            async def run(self):
                self.flush()
        """)
    assert rules_of(kept) == ["CD103"]


def test_cd103_silent_when_awaited():
    kept, _ = lint("""\
        class C:
            async def flush(self):
                pass

            async def run(self):
                await self.flush()
        """)
    assert kept == []


def test_cd104_dropped_create_task():
    kept, _ = lint("""\
        def go(loop, coro):
            loop.create_task(coro)
        """)
    assert rules_of(kept) == ["CD104"]


def test_cd104_silent_when_retained():
    kept, _ = lint("""\
        TASKS = set()

        def go(loop, coro):
            t = loop.create_task(coro)
            TASKS.add(t)
            t.add_done_callback(TASKS.discard)
        """)
    assert kept == []


# -- RD201..RD204: metrics / gauge registries ------------------------------

def _metrics_ctx():
    ctx = Context()
    ctx.metric_names = {"messages.received", "retained.count"}
    ctx.gauge_metrics = {"retained.count"}
    ctx.stats_keys = {"connections.count"}
    ctx.docs_observability = (
        "counters: `messages.*` and `retained.count` here")
    return ctx


def test_rd201_undeclared_metric_name():
    kept, _ = lint("""\
        def f(self):
            self.metrics.inc("messages.typo_counter")
        """, ctx=_metrics_ctx())
    assert "RD201" in rules_of(kept)


def test_rd202_undocumented_metric_and_glob_coverage():
    ctx = _metrics_ctx()
    ctx.metric_names.add("wal.appends")
    kept, _ = lint("""\
        def f(self):
            self.metrics.inc("wal.appends")      # not in docs
            self.metrics.inc("messages.received")  # glob-covered
        """, ctx=ctx)
    assert rules_of(kept) == ["RD202"]
    assert kept[0].line == 2


def test_rd203_dec_outside_gauge_metrics():
    kept, _ = lint("""\
        def f(self):
            self.metrics.dec("messages.received")
            self.metrics.dec("retained.count")    # audited gauge: ok
        """, ctx=_metrics_ctx())
    assert rules_of(kept) == ["RD203"]


def test_rd204_unregistered_stats_gauge():
    kept, _ = lint("""\
        def f(stats):
            stats.setstat("connections.count", 1)
            stats.setstat("mystery.gauge", 2)
        """, ctx=_metrics_ctx())
    assert rules_of(kept) == ["RD204"]


def test_metrics_rules_skip_dynamic_names_and_foreign_receivers():
    kept, _ = lint("""\
        def f(self, key):
            self.metrics.inc(f"cluster.{key}")   # dynamic: skipped
            self._gc.inc(1, 2)                   # not a Metrics
        """, ctx=_metrics_ctx())
    assert kept == []


# -- RD211..RD214: fault-point catalog -------------------------------------

def _faults_ctx():
    ctx = Context()
    ctx.fault_points = {"device.walk": 10, "net.delay": 20}
    ctx.docs_robustness = "| `device.walk` | site | raise | sim |"
    ctx.tests_text = 'faults.arm("device.walk")'
    return ctx


def test_rd211_fire_site_outside_catalog():
    kept, _ = lint("""\
        from emqx_tpu import faults

        def f():
            if faults.enabled:
                faults.fire("device.typo")
        """, ctx=_faults_ctx())
    assert "RD211" in rules_of(kept)


def test_rd212_213_214_catalog_cross_checks():
    ctx = _faults_ctx()
    # device.walk: fired, documented, tested. net.delay: fired but
    # neither documented nor tested -> RD212 + RD213
    kept, _ = lint("""\
        from emqx_tpu import faults as _faults

        def f():
            _faults.fire("device.walk")
            _faults.fire("net.delay")
        """, ctx=ctx)
    assert sorted(rules_of(kept)) == ["RD212", "RD213"]
    # an unfired catalog point -> RD214 (plus its doc/test gaps)
    ctx2 = _faults_ctx()
    kept2, _ = lint("""\
        from emqx_tpu import faults

        def f():
            faults.fire("device.walk")
        """, ctx=ctx2)
    assert "RD214" in rules_of(kept2)
    assert all(f.rule in ("RD212", "RD213", "RD214")
               for f in kept2)


# -- RD221/RD222: closed-schema config vs example toml ---------------------

def _config_ctx():
    ctx = Context()
    ctx.schema = {"durability": {
        "enabled": ("emqx_tpu/durability.py", 5),
        "fsync": ("emqx_tpu/durability.py", 6),
    }}
    ctx.toml_keys = {"durability": {"enabled": 171, "wal_shardz": 191}}
    return ctx


def test_rd221_schema_key_missing_from_toml():
    kept, _ = lint("x = 1\n", ctx=_config_ctx())
    assert "RD221" in rules_of(kept)
    f = next(f for f in kept if f.rule == "RD221")
    assert "fsync" in f.msg


def test_rd222_toml_key_unknown_to_schema():
    kept, _ = lint("x = 1\n", ctx=_config_ctx())
    assert "RD222" in rules_of(kept)
    f = next(f for f in kept if f.rule == "RD222")
    assert "wal_shardz" in f.msg


def test_config_clean_when_in_lockstep():
    ctx = _config_ctx()
    ctx.toml_keys = {"durability": {"enabled": 1, "fsync": 2}}
    kept, _ = lint("x = 1\n", ctx=ctx)
    assert kept == []


def test_toml_loader_reads_commented_defaults_and_skips_prose():
    ctx = Context()
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "ex.toml"
        p.write_text(textwrap.dedent("""\
            [durability]
            enabled = false
            # fsync = true
            # `false` restores the legacy path byte-for-byte.
            # false = legacy per-delivery walk prose
            """))
        ctx.root = Path(d)
        ctx.toml_path = "ex.toml"
        from analysis import config_drift
        config_drift.load_toml(ctx)
    assert set(ctx.toml_keys["durability"]) == {"enabled", "fsync"}


# -- RD231/RD232: telemetry stages -----------------------------------------

def _stages_ctx():
    ctx = Context()
    ctx.stages = ("match", "fetch")
    ctx.stages_loc = ("emqx_tpu/telemetry.py", 104)
    return ctx


def test_rd231_unknown_stage_observed():
    kept, _ = lint("""\
        def f(pb, t0):
            pb.span.add("fetchh", t0)
        """, ctx=_stages_ctx())
    assert "RD231" in rules_of(kept)


def test_rd232_stage_with_no_observe_site():
    kept, _ = lint("""\
        def f(pb, t0):
            pb.span.add("match", t0)
        """, ctx=_stages_ctx())
    assert "RD232" in rules_of(kept)
    assert "fetch" in [f.msg for f in kept
                       if f.rule == "RD232"][0]


def test_stage_rules_ignore_set_add_and_cover_all_sites():
    ctx = _stages_ctx()
    kept, _ = lint("""\
        def f(pb, tel, seen, t0, ms):
            seen.add("not-a-stage")        # a set, not a span
            pb.span.add("match", t0)
            tel.observe_stage("fetch", ms)
        """, ctx=ctx)
    assert kept == []


def _port_ctx():
    ctx = _stages_ctx()
    ctx.port_stages = ("match", "queue")
    ctx.port_stages_loc = ("emqx_tpu_torch/telemetry.py", 120)
    return ctx


def test_rd231_unknown_stage_observed_on_the_port():
    # each package's sites answer to its own registry: "fetch" is the
    # JAX package's stage, not the port's
    kept, _ = lint("""\
        def f(pb, sp, tel, t0, ms):
            pb.span.add("match", t0)
            sp.add_ms("queue", ms)
            sp.add("fetch", t0)
        """, path="emqx_tpu_torch/example.py", ctx=_port_ctx())
    assert rules_of(kept) == ["RD231"]
    assert "emqx_tpu_torch/telemetry.STAGES" in kept[0].msg


def test_rd232_port_stage_with_no_observe_site():
    kept, _ = lint("""\
        def f(pb, t0):
            pb.span.add("match", t0)
        """, path="emqx_tpu_torch/example.py", ctx=_port_ctx())
    assert rules_of(kept) == ["RD232"]
    assert "'queue'" in kept[0].msg
    assert kept[0].path == "emqx_tpu_torch/telemetry.py"


def test_stage_rules_run_over_the_port_and_pass():
    """RD231/RD232 over every file of ``emqx_tpu_torch/`` against its
    own ``STAGES``: each stage has its observe site, and no site
    observes a stage the registry lacks."""
    from pathlib import Path

    from emqx_tpu_torch.telemetry import STAGES

    root = Path(ROOT)
    ctx = analysis.build_context(root)
    assert ctx.port_stages == STAGES
    files = []
    for p in sorted((root / "emqx_tpu_torch").rglob("*.py")):
        fi, _errs = analysis.parse_file(p, str(p.relative_to(root)))
        files.append(fi)
    for rule in ("RD231", "RD232"):
        kept, _sup, _counts = analysis.run(files, ctx, rule=rule)
        assert kept == [], [f.render() for f in kept]
    sites = {s for path, _l, s in ctx.stage_sites
             if path.startswith("emqx_tpu_torch/")}
    assert set(STAGES) <= sites


# -- DP301: device purity in ops/ ------------------------------------------

def test_dp301_fires_on_host_sync_constructs():
    kept, _ = lint("""\
        import jax
        import jax.numpy as jnp

        def walk(x):
            a = x.sum().item()
            b = jax.device_get(x)
            c = float(jnp.max(x))
            x.block_until_ready()
            return a, b, c
        """, path="emqx_tpu/ops/kernel.py")
    assert rules_of(kept) == ["DP301"] * 4


def test_dp301_scoped_to_ops_and_whitelisted_seams():
    src = """\
        import jax

        def fetch_seam(x):
            return jax.device_get(x)
        """
    # outside ops/: not judged
    kept, _ = lint(src, path="emqx_tpu/broker.py")
    assert kept == []
    # inside ops/ but whitelisted as a fetch seam
    ctx = Context()
    ctx.device_whitelist = {"fetch_seam"}
    kept, _ = lint(src, path="emqx_tpu/ops/kernel.py", ctx=ctx)
    assert kept == []


def test_dp301_silent_on_numpy_host_math():
    kept, _ = lint("""\
        import numpy as np

        def plan(counts):
            return int(counts.sum()) + int(np.max(counts))
        """, path="emqx_tpu/ops/plan.py")
    assert kept == []


# -- pragma engine ---------------------------------------------------------

def test_lnt001_pragma_without_reason():
    kept, _ = lint("""\
        def f(x=[]):  # lint: ok-B006
            return x
        """)
    assert "LNT001" in rules_of(kept)
    # the unwaived finding still reports
    assert "B006" in rules_of(kept)


def test_lnt002_stale_pragma():
    kept, _ = lint("""\
        def f(x=None):  # lint: ok-B006 not mutable anymore
            return x
        """)
    assert rules_of(kept) == ["LNT002"]


def test_pragma_on_preceding_comment_line():
    kept, suppressed = lint("""\
        def f(
            # lint: ok-B006 fixture default, never mutated
            x=[],
        ):
            return x
        """)
    assert kept == []
    assert rules_of(suppressed) == ["B006"]


def test_pragma_multi_rule_and_docstring_immunity():
    kept, suppressed = lint('''\
        """Docs may quote `# lint: ok-CD102 reason` without waiving."""

        def f(x=[]):  # lint: ok-B006,F811 fixture default
            return x
        ''')
    assert kept == []
    assert rules_of(suppressed) == ["B006"]


def test_single_rule_mode_disables_stale_check():
    kept, _ = lint("""\
        def f(x=None):  # lint: ok-B006 would be stale in full runs
            return x
        """, rule="E711")
    assert kept == []


# -- the real tree ---------------------------------------------------------

@pytest.mark.slow
def test_full_tree_gate_is_clean():
    """The whole repo passes its own gate — including the legacy-path
    waivers (single-loop ingress fast paths, Metrics single-writer
    mode) staying live, reasoned, and non-stale."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "lint.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_rule_catalog_is_complete_and_documented():
    rules = analysis.all_rules()
    for rid in ("F401", "CD101", "CD102", "CD103", "CD104", "RD201",
                "RD211", "RD221", "RD231", "DP301", "LNT001",
                "LNT002"):
        assert rid in rules
    doc = open(os.path.join(ROOT, "docs", "ANALYSIS.md")).read()
    for rid in rules:
        assert rid in doc, f"rule {rid} missing from docs/ANALYSIS.md"
