"""Whole runs at a small size on the CPU: the harness without its look
for a chip, the output check, its control and the faults it catches."""

import subprocess
import sys
import time

import pytest

from benchmark import control, harness
from benchmark.tests import _tiny

SEED = 2**31 + 11


def _run(cfg, tr, tamper=None, traced=False):
    out = harness.run_cell(cfg, tr, SEED, 1.0, traced,
                           time.perf_counter(), device="cpu",
                           tamper=tamper)
    return out["checks"], out


@pytest.mark.parametrize("cell,cfg,law", [
    ("plus_1m.zipf", _tiny.plus_cfg, "zipf"),
    ("hash_1m_deep.uniform", _tiny.hash_cfg, "uniform")])
def test_sound_run_is_correct(cell, cfg, law):
    checks, out = _run(cfg(), _tiny.traffic(law))
    assert all(v == 0 for v in checks.values()), checks
    assert out["attempted"] > 0 and out["failed"] == 0
    rd = out["rd"]
    assert rd.acked_in_window > 0 and rd.setup_s > 0


def test_traced_run_reads_the_span_metrics():
    from benchmark import manifest

    checks, out = _run(_tiny.plus_cfg(), _tiny.traffic("zipf"),
                       traced=True)
    assert all(v == 0 for v in checks.values()), checks
    rd = out["rd"]
    man = manifest.load_manifest()
    got = {m["name"]: manifest.reader(m["name"])(rd)
           for m in manifest.metrics_for(man, "plus_1m.zipf", True)}
    for name in ("batch_msgs", "cache_hit_pct", "match_ms",
                 "fetch_plan_ms", "dispatch_ms", "host_fallback_pct",
                 "puback_p99_ms", "subscribe_s"):
        assert got[name] is not None and got[name] >= 0, name
    # no device: the device's readers find nothing, and say so
    assert got["walk_roofline_pct"] is None
    assert manifest.reader("bitmap_or_roofline_pct")(rd) is None


def _half_batch(node):
    """Half of every batch left out: its messages acknowledged with no
    delivery."""
    b = node.broker
    begin = b.publish_begin

    def half(msgs, *a, **kw):
        n = len(msgs)
        pb = begin(list(msgs)[: (n + 1) // 2], *a, **kw)
        pb.results += [0] * (n - len(pb.results))
        return pb

    b.publish_begin = half


def _altered_answer(node):
    """Each acknowledgement's delivery count altered where it is made."""
    ing = node.ingress
    resolve = ing._resolve
    ing._resolve = lambda pending, results: resolve(
        pending, [n + 1 for n in results])


def _altered_topic(node):
    """One message of each batch routed under an altered topic."""
    b = node.broker
    begin = b.publish_begin

    def alter(msgs, *a, **kw):
        if msgs:
            msgs[0].topic = msgs[0].topic + "/x"
        return begin(msgs, *a, **kw)

    b.publish_begin = alter


def _unchanged_state(node):
    """The delivery step returns with its state unchanged."""
    node.broker._deliver_plan_group = lambda pb, ps, g: ()


@pytest.mark.parametrize("fault,checks", [
    (_half_batch, ("lost", "ack_wrong")),
    (_altered_answer, ("ack_wrong",)),
    (_altered_topic, ("lost",)),
    (_unchanged_state, ("lost",)),
])
def test_fault_makes_the_run_not_correct(fault, checks):
    got, _ = _run(_tiny.mixed_cfg(), _tiny.traffic("zipf"), tamper=fault)
    assert any(got[k] > 0 for k in checks), got


def test_sound_run_of_every_filter_kind_is_correct():
    """Literal, '#', $share and wide filters (the bitmap path) beside
    the '+' filters: the same check holds them all."""
    checks, out = _run(_tiny.mixed_cfg(), _tiny.traffic("zipf"))
    assert all(v == 0 for v in checks.values()), checks
    assert out["attempted"] > 0


def test_a_missing_seam_refuses_the_run():
    """Without the match cache the benchmark reads, the run stops
    rather than read the walk another way."""
    def no_cache(node):
        node.router.config.match_cache = False

    with pytest.raises(harness.SeamMissing):
        _run(_tiny.plus_cfg(), _tiny.traffic("zipf"), tamper=no_cache)


@pytest.mark.parametrize("cell,cfg,law", [
    ("plus_1m.zipf", _tiny.plus_cfg, "zipf"),
    ("hash_1m_deep.uniform", _tiny.hash_cfg, "uniform")])
def test_control_is_not_correct(cell, cfg, law):
    correct, checks, _ = control.run(cell, SEED, 1.0, cfg(),
                                     _tiny.traffic(law))
    assert not correct and checks["early_ack"] > 0, checks


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "plus_1m.zipf", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.__file__.rsplit("/benchmark/", 1)[0],
        capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names():
    from benchmark import run

    assert run.forbidden_modules(["emqx_tpu_torch", "emqx_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["emqx_tpu.ops.walk", "jax.numpy",
                                  "flax", "jaxlib.xla"]) == [
        "emqx_tpu", "flax", "jax", "jaxlib"]


@pytest.mark.gpu
def test_sound_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = harness.run_cell(_tiny.plus_cfg(),
                           _tiny.traffic("zipf"), SEED, 1.0, True,
                           time.perf_counter(), device="cuda")
    assert all(v == 0 for v in out["checks"].values()), out["checks"]
    assert out["rd"].trace["busy_s"] > 0

