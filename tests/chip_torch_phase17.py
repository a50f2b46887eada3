"""Phase 17 of ``chip_smoke.py`` alone: the multi-loop front door, the
worker pool and the config-file boot. Run from the root of a checkout.

On a machine with the card, at the script's full size (phase 5's set-up
and oracle, its node freed, then phase 17)::

    python3 tests/chip_torch_phase17.py

On the CPU, a rehearsal at a small size (20,000 '+' filters): the
kernel wrappers swapped for counted plain twins, the kernel timers
stubbed, 17b's workers and 17c's process on ``device="cpu"``::

    python3 tests/chip_torch_phase17.py --rehearse
"""
import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def counted_plain_kernels() -> None:
    """On CPU tensors the wrappers run their plain twins uncounted:
    swap each entry point on phase 17's path for its plain twin plus
    one count, as a launch would count, and stub the kernel timers."""
    import torch

    import emqx_tpu_torch.broker as broker
    import emqx_tpu_torch.modules.retainer as retainer
    import emqx_tpu_torch.ops.delta as delta
    import emqx_tpu_torch.router as router
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops.bitmap import or_union_rows_ref
    from emqx_tpu_torch.ops.match import match_batch
    from emqx_tpu_torch.ops.retained_match import match_names_many

    def walk(*a, **kw):
        _build.count_launch("walk")
        return match_batch(*a, **kw)

    def union(*a, **kw):
        _build.count_launch("bitmap_or")
        return or_union_rows_ref(*a, **kw)

    def names(*a):
        _build.count_launch("retained_match")
        return match_names_many(*a)

    router.match_batch_auto = delta.match_batch_auto = walk
    broker.or_union_rows_auto = union
    retainer.match_names_auto = names
    torch.cuda.synchronize = lambda *a, **kw: None
    cs.p14_kernels = lambda *a, **kw: {"walk_ms": 0.0, "or_ms": 0.0,
                                       "b3_ms": 0.0, "max_abs_err": 0}
    # small tables: the big filters' 64 members must pass the fan-out
    # threshold, and the delta must fold before it outgrows the patcher
    from emqx_tpu_torch.router import MatcherConfig

    orig = MatcherConfig.__init__

    def init(self, *a, **kw):
        kw.setdefault("fanout_threshold", 32)
        kw.setdefault("delta_max_filters", 1000)
        orig(self, *a, **kw)

    MatcherConfig.__init__ = init


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="a small run on the CPU with the plain twins")
    args = ap.parse_args()
    from emqx_tpu_torch.node import Node

    if args.rehearse:
        device, card = "cpu", "CPU rehearsal (no device number)"
        opts = argparse.Namespace(subs=20_000, others=800, batches=3,
                                  batch=256, seed=0)
        counted_plain_kernels()
        big_members = 64
    else:
        device = "cuda"
        card = cs.phase_env()
        cs.phase_build(card)
        opts = argparse.Namespace(subs=1_000_000, others=10_000, batches=20,
                                  batch=4096, seed=0)
        big_members = 4096
    t0 = time.perf_counter()
    rng = np.random.default_rng(opts.seed)
    wl = cs.make_workload(rng, opts.subs, opts.others, 8, big_members)
    node = Node(device=device, batch_size=opts.batch, boot_listeners=False)
    _sinks, draw, pairs = cs.subscribe_all(node.broker, wl, rng)
    oracle = cs.route_oracle(node.broker.router)
    topics = cs.zipf_topics(rng, draw, opts.batch * (opts.batches + 1))
    batches = [topics[(i + 1) * opts.batch:(i + 2) * opts.batch]
               for i in range(opts.batches)]
    del node, _sinks
    gc.collect()
    cs.log(f"[drv] set-up {time.perf_counter() - t0:.1f} s")
    p17 = cs.timed("17", cs.run_loops, pairs, wl, draw, oracle, batches,
                   device, card)
    cs.log(json.dumps({"p17_launches": p17["launches"],
                       "17b": p17["17b"], "17c": p17["17c"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
