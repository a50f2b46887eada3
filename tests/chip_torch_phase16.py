"""Phases 5 (its set-up and 4 of its batches), 15 and 16 of
``chip_smoke.py`` alone, on one card, at the script's full size: the
quick way to rerun the operations surface and the secure front door.
Run from the root of a checkout on a machine with the card::

    python3 tests/chip_torch_phase16.py
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.types import Message

    card = cs.phase_env()
    cs.phase_build(card)
    opts = argparse.Namespace(subs=1_000_000, others=10_000, batches=20,
                              batch=4096, seed=0)
    t0 = time.perf_counter()
    rng = np.random.default_rng(opts.seed)
    wl = cs.make_workload(rng, opts.subs, opts.others, 8, 4096)
    node = Node(device="cuda", batch_size=opts.batch)
    _sinks, draw, pairs = cs.subscribe_all(node.broker, wl, rng)
    node.broker.router.automaton()
    oracle = cs.route_oracle(node.broker.router)
    topics = cs.zipf_topics(rng, draw, opts.batch * (opts.batches + 1))
    node.broker.publish_batch([Message(topic=t)
                               for t in topics[:opts.batch]])
    batches = [topics[(i + 1) * opts.batch:(i + 2) * opts.batch]
               for i in range(opts.batches)]
    cs.log(f"[drv] set-up {time.perf_counter() - t0:.1f} s")
    sl = cs.phase_slice(node.broker, batches[:4], card, oracle)
    cs.timed("15", cs.run_modules, node, batches, draw, card, oracle, sl)
    p16 = cs.timed("16", cs.run_ops, node, pairs, batches, wl, draw,
                   oracle, opts, card)
    cs.log(json.dumps({"p16_launches": p16["launches"],
                       "checkpoint": p16["checkpoint"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
