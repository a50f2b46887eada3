"""Phase 14c of ``chip_smoke.py`` (the drain, with live QoS 1 clients
resuming on the target) rehearsed on the CPU at a small size.

The kernels' entry points are swapped for their counted plain twins
(``tests/chip_torch_phase17.py``'s ``counted_plain_kernels``), the nodes
run on ``device="cpu"`` and the phase's checks hold as on the card:
the live clients lose nothing and get no repeat without DUP. Prints
the phase's own lines and a line a run with its time-to-empty, the
messages published and the repeats without DUP, and the hand-off's
cluster calls by op. ``--root`` runs the phase of another checkout of
the repository (its ``chip_smoke.py`` and its package). Run from the
repository's root::

    JAX_PLATFORMS=cpu python3 scripts/rehearse_14c.py [--runs 1] \\
        [--sessions 300] [--root DIR]
"""

import argparse
import asyncio
import collections
import os
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--sessions", type=int, default=300,
                    help="detached sessions on bd0 (the card runs 1,000)")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    opts = ap.parse_args()
    sys.path[:0] = [opts.root, os.path.join(opts.root, "tests")]

    import chip_smoke as cs
    from chip_torch_phase17 import counted_plain_kernels
    from emqx_tpu_torch import cluster_net

    counted_plain_kernels()
    calls = collections.Counter()
    call = cluster_net.SocketTransport.call

    def counted_call(self, node, op, *a, **k):
        calls[op] += 1
        return call(self, node, op, *a, **k)

    cluster_net.SocketTransport.call = counted_call
    failed = 0
    for i in range(opts.runs):
        calls.clear()
        args = argparse.Namespace(batch=256, seed=0, p14_sessions=300,
                                  p14_drain_sessions=opts.sessions)
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="reh14c-") as tmp:
            try:
                out = asyncio.run(cs.repl_14c(args, "cpu",
                                              "CPU rehearsal", tmp))
                res = {k: out.get(k) for k in (
                    "time_to_empty_s", "live_msgs",
                    "live_repeats_without_dup")}
            except AssertionError as e:
                failed += 1
                res = f"FAILED {e}"
        print(f"run {i}: {time.perf_counter() - t:.1f} s {res} calls "
              f"{dict(calls)}", flush=True)
    print(f"{opts.runs - failed} of {opts.runs} held every check")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
