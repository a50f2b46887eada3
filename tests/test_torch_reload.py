"""The port's live config reload (``emqx_tpu_torch.reload``, ``ctl
reload``) against the JAX package's.

tests/test_reload.py's nine cases run on port nodes booted with
``build_node(cfg, device="cpu")``: a reloadable change applies while a
client stays connected and reaches the live objects (the monitor, the
breaker, the ingress bound, telemetry, dispatch, the drain); a boot-only
edit rejects the whole reload; an inactive section is boot-only; an
absent section stays untouched; the zones-only output keeps its shape;
``matcher.delta`` flips the router; the classification covers every
knob and matches docs/OPERATIONS.md; a node built without a file diffs
against its live objects. Then the two packages side by side: every
``RELOADABLE`` set of the port equals the JAX package's, section by
section, and ``ctl reload`` prints the same text on the same file for
an applied, a rejected, a zones-only and a broken reload. Exact
equality everywhere; every wait is bounded.
"""

import asyncio
import dataclasses
from pathlib import Path

import pytest

from emqx_tpu import config as jconfig
from emqx_tpu import reload as jreload
from emqx_tpu_torch import config as pconfig
from emqx_tpu_torch import reload as preload
from emqx_tpu_torch import zone as pzone
from emqx_tpu_torch.node import Node as PNode

from mqtt_client import TestClient

REPO = Path(__file__).resolve().parents[1]
LIMIT = 60.0


@pytest.fixture(autouse=True)
def _port_zone_isolation():
    saved = dict(pzone._zones)
    yield
    pzone._zones.clear()
    pzone._zones.update(saved)


def _write(cfg_path, body: str) -> str:
    cfg_path.write_text(body)
    return str(cfg_path)


BASE = (
    '[zones.hot]\nmax_packet_size = 1024\n\n'
    '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "hot"\n\n'
    '[overload]\nlag_warn_ms = 200.0\n\n'
    '[telemetry]\nslow_threshold_ms = 100.0\n'
)


class booted:
    """``async with booted(path) as node``: a port node built from the
    file on the CPU, started, stopped on the way out."""

    def __init__(self, path):
        self.node = pconfig.build_node(pconfig.load_config(path),
                                       device="cpu")

    async def __aenter__(self):
        await self.node.start()
        return self.node

    async def __aexit__(self, *exc):
        await self.node.stop()


def within(fn):
    import functools

    @functools.wraps(fn)
    async def run(*a, **kw):
        await asyncio.wait_for(fn(*a, **kw), LIMIT)
    return run


@within
async def test_reload_applies_reloadable_without_drop(tmp_path):
    p = _write(tmp_path / "n.toml", BASE)
    async with booted(p) as node:
        c = TestClient("rl-live")
        await c.connect(port=node.listeners[0].port)
        _write(tmp_path / "n.toml", (
            '[zones.hot]\nmax_packet_size = 2048\n\n'
            '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "hot"\n\n'
            '[overload]\nlag_warn_ms = 500.0\n'
            'breaker_failures = 7\nbreaker_cooldown_s = 9.0\n'
            'ingress_wait_timeout_s = 11.0\n\n'
            '[telemetry]\nslow_threshold_ms = 250.0\n\n'
            '[dispatch]\npreserialize = false\n\n'
            '[drain]\nwave_size = 5\n'
        ))
        out = node.ctl.run(["reload", p])
        assert "zones reloaded: hot" in out
        assert "rebound" in out
        assert "applied: overload.lag_warn_ms 200.0 -> 500.0" in out
        # the values landed in the RUNNING objects
        assert node.overload.cfg.lag_warn_ms == 500.0
        assert node.broker.breaker.threshold == 7
        assert node.broker.breaker.cooldown_s == 9.0
        assert node.ingress.submit_wait_timeout == 11.0
        assert node.telemetry.config.slow_threshold_ms == 250.0
        assert node.broker.dispatch_config.preserialize is False
        assert node.drain.cfg.wave_size == 5
        assert node.metrics.val("config.reload.applied") >= 5
        # the client never dropped: round trips still work
        await c.ping()
        await c.publish("rl/t", b"x", qos=1)
        await c.close()


@within
async def test_reload_rejects_boot_only_atomic(tmp_path):
    p = _write(tmp_path / "n.toml", BASE)
    async with booted(p) as node:
        _write(tmp_path / "n.toml", (
            '[zones.hot]\nmax_packet_size = 4096\n\n'
            '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "hot"\n\n'
            '[node]\nloops = 4\n\n'
            '[overload]\nlag_warn_ms = 900.0\n\n'
            '[matcher]\nmax_levels = 8\n'
        ))
        out = node.ctl.run(["reload", p])
        assert "reload rejected" in out
        assert "node.loops" in out and "matcher.max_levels" in out
        assert pzone.get_zone("hot").max_packet_size == 1024
        assert node.overload.cfg.lag_warn_ms == 200.0
        assert node.router.config.max_levels == 16
        assert node.loop_group is None
        assert node.metrics.val("config.reload.rejected") >= 2
        assert node.metrics.val("config.reload.applied") == 0


@within
async def test_reload_inactive_sections_are_boot_only(tmp_path):
    p = _write(tmp_path / "n.toml", BASE)
    async with booted(p) as node:
        _write(tmp_path / "n.toml", (
            '[zones.hot]\nmax_packet_size = 1024\n\n'
            '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "hot"\n\n'
            '[[listeners]]\ntype = "tcp"\nport = 1884\nzone = "hot"\n\n'
            '[overload]\nlag_warn_ms = 200.0\n\n'
            '[telemetry]\nslow_threshold_ms = 100.0\n\n'
            '[durability]\nenabled = true\n'
        ))
        out = node.ctl.run(["reload", p])
        assert "reload rejected" in out
        assert "durability.enabled" in out
        assert "listeners.*" in out
        assert node.durability is None


@within
async def test_reload_absent_sections_untouched(tmp_path):
    p = _write(tmp_path / "n.toml", BASE)
    async with booted(p) as node:
        _write(tmp_path / "n.toml", (
            '[zones.hot]\nmax_packet_size = 1024\n\n'
            '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "hot"\n'
        ))
        out = node.ctl.run(["reload", p])
        assert "rejected" not in out
        assert node.overload.cfg.lag_warn_ms == 200.0


@within
async def test_reload_zone_only_output_shape(tmp_path):
    p = _write(tmp_path / "n.toml", BASE)
    async with booted(p) as node:
        _write(tmp_path / "n.toml", BASE.replace("1024", "2048"))
        out = node.ctl.run(["reload", p])
        assert out.startswith("zones reloaded: hot")
        assert "listeners rebound: tcp:0" in out
        _write(tmp_path / "n.toml", (
            '[zones.other]\nmax_inflight = 5\n\n'
            '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "other"\n'
        ))
        out = node.ctl.run(["reload", p])
        assert "stale" in out and "hot" in out
        _write(tmp_path / "n.toml", '[zones.hot]\nno_such = 1\n')
        out = node.ctl.run(["reload", p])
        assert "error" in out.lower()
        assert "diff" in node.ctl.usage()


@within
async def test_reload_matcher_delta_flip_applies(tmp_path):
    p = _write(tmp_path / "n.toml", BASE)
    async with booted(p) as node:
        assert node.router.config.delta
        _write(tmp_path / "n.toml", BASE + '\n[matcher]\ndelta = false\n')
        out = node.ctl.run(["reload", p])
        assert "applied: matcher.delta" in out
        assert not node.router.config.delta
        assert not node.router.delta_info().get("enabled")


def test_classification_covers_every_knob():
    table = preload.classification()
    for section, cls in preload._sections().items():
        fields = {f.name for f in dataclasses.fields(cls)} - {"mesh"}
        assert set(table[section]) == fields, section
        reloadable = getattr(cls, "RELOADABLE", frozenset())
        assert reloadable <= fields, section
    assert set(table["node"]) == {
        "name", "sys_interval", "cookie", "cluster_port",
        "load_default_modules", "loops", "frame"}


def test_classification_matches_operations_doc():
    """docs/OPERATIONS.md's knob table holds a row for every section of
    the port's classification, as it does for the JAX package's."""
    doc = (REPO / "docs" / "OPERATIONS.md").read_text()
    for section, knobs in preload.classification().items():
        r = ", ".join(f"`{k}`" for k, v in sorted(knobs.items())
                      if v == "reloadable") or "—"
        b = ", ".join(f"`{k}`" for k, v in sorted(knobs.items())
                      if v == "boot_only") or "—"
        assert f"| `[{section}]` | {r} | {b} |" in doc, section


def test_diff_config_programmatic_node():
    node = PNode(device="cpu", boot_listeners=False)
    cfg = pconfig.parse_config({
        "overload": {"lag_warn_ms": 777.0},
        "listeners": [{"type": "tcp", "port": 1883}]})
    knobs = {c.knob: c.kind for c in preload.diff_config(node, cfg)}
    assert knobs.get("overload.lag_warn_ms") == "reloadable"
    assert "listeners.*" not in knobs
    report = preload.apply_reload(node, cfg)
    assert [a["knob"] for a in report["applied"]] == [
        "overload.lag_warn_ms"]
    assert node.overload_config.lag_warn_ms == 777.0


# -- the two packages side by side ------------------------------------------


@pytest.mark.parametrize("section", sorted(jreload._sections()))
def test_reloadable_sets_equal_jax(section):
    jcls = jreload._sections()[section]
    pcls = preload._sections()[section]
    assert pcls.RELOADABLE == jcls.RELOADABLE
    assert preload.classification()[section] == \
        jreload.classification()[section]


def test_node_pseudo_section_equal_jax():
    assert preload.NODE_RELOADABLE == jreload.NODE_RELOADABLE
    assert preload.NODE_KEYS == jreload.NODE_KEYS
    assert preload.classification()["node"] == \
        jreload.classification()["node"]


#: edits after BASE, each reloaded on both packages' nodes: applied,
#: rejected (boot-only), zones-only with a stale zone, broken
EDITS = {
    "applied": (
        '[zones.hot]\nmax_packet_size = 2048\n\n'
        '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "hot"\n\n'
        '[overload]\nlag_warn_ms = 500.0\nbreaker_failures = 7\n\n'
        '[telemetry]\nslow_threshold_ms = 250.0\n\n'
        '[dispatch]\npreserialize = false\n\n'
        '[matcher]\ndelta_max_filters = 100\n\n'
        '[drain]\nwave_size = 5\n\n[node]\nsys_interval = 30.0\n'),
    "rejected": (
        '[zones.hot]\nmax_packet_size = 4096\n\n'
        '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "hot"\n\n'
        '[node]\nloops = 4\nframe = "native"\n\n'
        '[overload]\nlag_warn_ms = 900.0\n\n'
        '[matcher]\nmax_levels = 8\n\n[durability]\nenabled = true\n'),
    "zones": (
        '[zones.other]\nmax_inflight = 5\n\n'
        '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "other"\n'),
    "broken": '[zones.hot]\nno_such = 1\n',
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_ctl_reload_text_equals_jax(tmp_path, edit):
    """``ctl reload`` on the same two files: the same text, the same
    counters, the same live values afterwards."""
    async def scenario(config, node_of, name):
        d = tmp_path / name
        d.mkdir()
        p = _write(d / "n.toml", BASE)
        node = node_of(config.load_config(p))
        await node.start()
        try:
            _write(d / "n.toml", EDITS[edit])
            out = node.ctl.run(["reload", p])
            return (out.replace(str(d), "<dir>"),
                    node.metrics.val("config.reload.applied"),
                    node.metrics.val("config.reload.rejected"),
                    node.overload.cfg.lag_warn_ms, node.sys.interval,
                    node.router.config.delta_max_filters,
                    [lst.zone.name for lst in node.listeners])
        finally:
            await node.stop()

    async def both():
        want = await scenario(jconfig, jconfig.build_node, "jax")
        got = await scenario(
            pconfig, lambda c: pconfig.build_node(c, device="cpu"), "port")
        return want, got

    want, got = asyncio.run(asyncio.wait_for(both(), LIMIT))
    assert got == want
