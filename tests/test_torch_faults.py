"""The port's fault-injection registry against the JAX package's.

Each package keeps its own process-wide registry and ``enabled`` flag.
Every test arms both with the same specs and seeds and compares what
they do: validation errors, ``times`` accounting, seeded probabilistic
triggers, ``parse_arm``, ``configure`` and ``info``. A fixture clears
both registries before and after each test, so a leaked arm cannot
reach a later test on the same worker. The last test pins the
zero-cost disabled mode: with nothing armed, no site of the port's
publish path calls ``fire``.
"""

import dataclasses

import pytest

from emqx_tpu import faults as jf
from emqx_tpu_torch import faults as pf
from emqx_tpu_torch.router import MatcherConfig
from emqx_tpu_torch.types import Message

BOTH = (jf, pf)


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in BOTH:
        f.clear()
        f.set_master(True)
        f.drain_injected()
    try:
        yield
    finally:
        for f in BOTH:
            f.clear()
            f.set_master(True)


def _outcome(fn):
    """A call's result, or the type of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the type is the outcome
        return ("raise", type(e).__name__)


def test_catalog_equals_the_jax_package():
    assert list(pf.POINTS) == list(jf.POINTS)
    assert {p: a for p, (a, _d) in pf.POINTS.items()} == \
        {p: a for p, (a, _d) in jf.POINTS.items()}
    assert pf._ACTIONS == jf._ACTIONS


@pytest.mark.parametrize("kw", [
    dict(point="no.such.point"),
    dict(point="device.walk", action="explode"),
    dict(point="device.walk", action="stall"),          # needs delay_ms
    dict(point="device.walk", action="stall", delay_ms=-1.0),
    dict(point="device.walk", prob=0.0),
    dict(point="device.walk", prob=1.5),
    dict(point="device.walk", action="drop", times=0),
    dict(point="ingress.saturate", times=3, prob=0.25),
])
def test_arm_validation_equals_the_jax_package(kw):
    got = [_outcome(lambda f=f: f.arm(**kw)) for f in BOTH]
    assert got[0] == got[1]
    assert jf.enabled == pf.enabled
    assert {p: (a["action"], a["times"], a["prob"])
            for p, a in pf.info()["armed"].items()} == \
        {p: (a["action"], a["times"], a["prob"])
         for p, a in jf.info()["armed"].items()}


def test_times_accounting_and_gate_in_lockstep():
    for f in BOTH:
        assert not f.enabled
        f.arm("ingress.saturate", times=2)
    seq = [[f.fire("ingress.saturate") for _ in range(3)] for f in BOTH]
    assert seq[0] == seq[1] == [True, True, False]
    assert not pf.enabled and not jf.enabled
    assert pf.drain_injected() == jf.drain_injected() == 2
    assert pf.drain_injected() == 0
    # a raise arm raises the package's own FaultInjected, once
    for f in BOTH:
        f.arm("device.fetch", times=1)
        with pytest.raises(f.FaultInjected) as ei:
            f.fire("device.fetch")
        assert ei.value.point == "device.fetch"
        assert f.fire("device.fetch") is False
    # device.lost armed times=0 is persistent until disarmed
    for f in BOTH:
        f.arm("device.lost", times=0)
        for _ in range(4):
            with pytest.raises(f.FaultInjected):
                f.fire("device.lost")
        assert f.disarm("device.lost") and not f.disarm("device.lost")
        assert f.fire("device.lost") is False


@pytest.mark.parametrize("seed,prob", [(7, 0.5), (0, 0.1), (123, 0.9),
                                       (99, 0.33)])
def test_seeded_probability_is_the_jax_sequence(seed, prob):
    seqs = []
    for f in BOTH:
        f.seed(seed)
        f.arm("ingress.saturate", times=0, prob=prob)
        seqs.append([f.fire("ingress.saturate") for _ in range(64)])
        # the same seed replays the same schedule
        f.clear()
        f.seed(seed)
        f.arm("ingress.saturate", times=0, prob=prob)
        assert [f.fire("ingress.saturate") for _ in range(64)] == seqs[-1]
    assert seqs[0] == seqs[1]
    assert True in seqs[1] and False in seqs[1]


def test_master_switch_stall_and_context_manager():
    for f in BOTH:
        f.arm("ingress.saturate", times=0)
        f.set_master(False)
        assert not f.enabled            # arms kept, inert
        f.set_master(True)
        assert f.enabled
        f.clear()
        with f.injected("device.walk", times=0):
            assert f.enabled
        assert not f.enabled
        # stall sleeps, then proceeds: fire returns False
        f.arm("device.fetch", action="stall", delay_ms=1.0)
        assert f.fire("device.fetch") is False
        assert not f.enabled
    assert pf.info()["points"].keys() == jf.info()["points"].keys()


@pytest.mark.parametrize("spec", [
    "device.fetch:raise:3", "device.fetch", "device.walk::0",
    "socket.reset:drop:2:5", "device.fetch:stall:1:250.5",
    "ingress.saturate::", "device.fetch:bogus", "no.such:raise",
    "", ":raise", "device.lost:raise:x",
])
def test_parse_arm_equals_the_jax_package(spec):
    assert _outcome(lambda: pf.parse_arm(spec)) == \
        _outcome(lambda: jf.parse_arm(spec))


def test_faults_config_schema_and_configure():
    assert [f.name for f in dataclasses.fields(pf.FaultsConfig)] == \
        [f.name for f in dataclasses.fields(jf.FaultsConfig)]
    assert dataclasses.asdict(pf.FaultsConfig()) == \
        dataclasses.asdict(jf.FaultsConfig())
    assert pf.FaultsConfig.RELOADABLE == jf.FaultsConfig.RELOADABLE
    # a disabled section stores its arms inert
    spec = dict(enabled=False, seed=3, arm=["device.fetch:raise:2",
                                            "ingress.saturate:drop:0"])
    pf.configure(pf.FaultsConfig(**spec))
    jf.configure(jf.FaultsConfig(**spec))
    assert not pf.enabled and not jf.enabled
    assert pf.info()["armed"] == jf.info()["armed"]
    pf.set_master(True)
    jf.set_master(True)
    assert [pf.fire("ingress.saturate") for _ in range(3)] == \
        [jf.fire("ingress.saturate") for _ in range(3)]
    # an unknown point in the arm list raises in both
    for f in BOTH:
        with pytest.raises(ValueError):
            f.configure(f.FaultsConfig(arm=["no.such.point"]))


def test_a_node_with_a_faults_section_arms_the_port_registry():
    from emqx_tpu_torch.node import Node

    node = Node(device="cpu", faults_config=pf.FaultsConfig(
        enabled=True, seed=1, arm=["ingress.saturate:drop:2"]))
    assert pf.enabled and not jf.enabled
    assert node.ingress.backlogged() and node.ingress.backlogged()
    assert not node.ingress.backlogged()
    node.tick()
    assert node.metrics.val("faults.injected") == 2


def test_disabled_sites_never_call_fire(monkeypatch):
    """The zero-cost pin: with nothing armed every site's guard is a
    dead branch — the port's ``fire`` is never reached on the device
    path's begin and fetch, the ingress and the router."""
    def boom(point):
        raise AssertionError(f"fire({point!r}) called while disabled")

    monkeypatch.setattr(pf, "fire", boom)
    assert not pf.enabled
    from emqx_tpu_torch.node import Node

    node = Node(device="cpu",
                matcher=MatcherConfig(device_min_filters=0,
                                      delta_max_filters=2))

    class Sink:
        got = []

        def deliver(self, flt, msg):
            self.got.append((flt, msg.topic))

    s = Sink()
    for i in range(4):   # crosses delta_max_filters: a compaction
        node.subscribe(s, f"p/{i}")
    assert node.broker.publish_batch(
        [Message(topic="p/1", payload=b"x")]) == [1]
    assert not node.ingress.backlogged()
    assert Sink.got == [("p/1", "p/1")]
