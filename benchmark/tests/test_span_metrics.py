"""The readers of the port's own publish stages (``ingress_wait_ms``
to ``dispatch_cpu_pct``): a number on a tiny traced run on the CPU,
nothing on a run that read nothing, and nothing from a program that
lacks the stages."""

import time

import pytest

from benchmark import harness, manifest
from benchmark.metrics._port_stages import per_batch_ms
from benchmark.tests import _tiny

SEED = 2**31 + 23
NEW = ("ingress_wait_ms", "fetch_wait_ms", "order_wait_ms",
       "tail_yield_ms", "ack_ms", "gc_pause_pct", "fetch_cpu_pct",
       "dispatch_cpu_pct")
#: the submit wait and the stages that tile a device batch's life
LIFE = ("queue", "begin_host", "match", "cache_gather", "pack",
        "fetch_wait", "fetch", "dispatch_plan", "serialize", "order_wait",
        "dispatch", "tail_yield", "ack")


@pytest.fixture(scope="module")
def traced():
    out = harness.run_cell(_tiny.plus_cfg(), _tiny.traffic("zipf"), SEED,
                           1.0, True, time.perf_counter(), device="cpu")
    assert all(v == 0 for v in out["checks"].values()), out["checks"]
    return out["rd"]


def test_the_metrics_are_listed_for_the_cell():
    man = manifest.load_manifest()
    got = {m["name"]: m for m in manifest.metrics_for(man, "plus_1m.zipf",
                                                      True)}
    for name in NEW:
        m = got[name]
        assert m["source"] == "program_span" and m["moves"] == "msgs_per_s"
        assert m["workloads"] == ["plus_1m.zipf"]


@pytest.mark.parametrize("name", NEW)
def test_each_reads_a_number_on_a_traced_run(traced, name):
    v = manifest.reader(name)(traced)
    assert v is not None and v >= 0.0, (name, v)
    if name.endswith("_cpu_pct"):
        assert v <= 100.0


def test_the_waits_are_a_share_of_the_batches_life(traced):
    """A batch's waits fit inside its life, the submit wait and the
    stages that tile it from ``publish_begin`` to the last
    acknowledgement, as the same counters give them a batch (not
    inside the window: a batch folded in a short window may have begun
    long before it on a loaded host), and the acknowledgement stage is
    positive (every batch sets its futures)."""
    life = sum(per_batch_ms(traced, s) for s in LIFE)
    for name in ("ingress_wait_ms", "fetch_wait_ms", "order_wait_ms",
                 "tail_yield_ms", "ack_ms"):
        assert 0.0 <= manifest.reader(name)(traced) <= life, name
    assert manifest.reader("ack_ms")(traced) > 0.0


@pytest.mark.parametrize("name", NEW)
def test_each_reads_nothing_on_an_empty_run(name):
    assert manifest.reader(name)(harness.RunData()) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reads_nothing_without_the_programs_stages(traced, name):
    """A program without the port's stages (the counters hold only the
    JAX package's) gives no number, and the reader does not raise."""
    from emqx_tpu_torch.telemetry import PORT_STAGES

    old = harness.RunData()
    old.window_s = traced.window_s
    for side in ("before", "after"):
        setattr(old, side, {
            k: v for k, v in getattr(traced, side).items()
            if k.split(".")[1] not in PORT_STAGES})
    assert manifest.reader(name)(old) is None
