"""Kernel B4 (the dense bitmap OR, ``csrc/bitmap_or_dense.cu``) against
the packed kernel B2 (``csrc/bitmap_or.cu``) run over every topic, on
the same inputs in one process.

Each case goes through ``chip_smoke.dense_ab``: both kernels held equal
to the plain ``or_bitmaps_ref``, then each kernel's device time from
torch.profiler's trace in turns (B2, B4, B4, B2), the function's bound
(bytes over 3.35 TB/s) and B4's share of it. The cases: B4's shape in
``chip_smoke.py`` (W = 32,768, B = 4,096, row ids drawn from 8 live
bitmap rows of a 16-row table and -1) at mb = 1, 4 and 16; the same at
64 distinct rows; and a 2x2 mesh cell's shape (B = 2,048, W = 16,384)
with a live row in one topic of 500. Prints one JSON line a case
(``b4_ms`` and ``b2_ms`` the lower of each kernel's two times), then
the card's name and power limit. Needs one CUDA card; run from the
repository's root::

    python3 scripts/dense_or_ab.py [--build-verbose]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-verbose", action="store_true",
                    help="print the compiler's output (ptxas registers)")
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from emqx_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("dense_or_ab: needs a CUDA card", file=sys.stderr)
        return 2
    cs.log(f"[build] {_build.build(verbose=opts.build_verbose):.1f} s")
    card = cs.phase_env()
    rng = np.random.default_rng(opts.seed)
    # (case, R, W, B, mb, live rows, share of live slots): B4's phase
    # draws ids from [-1, 8), so 8/9 of its slots are live
    cases = [(f"b4 mb={mb}", 16, 32768, 4096, mb, 8, 8 / 9)
             for mb in (1, 4, 16)]
    cases += [("64 distinct rows mb=16", 64, 32768, 4096, 16, 64, 8 / 9),
              ("mesh cell 2x2", 16, 16384, 2048, 16, 2, 1 / 8000)]
    for name, R, W, B, mb, live_rows, p_live in cases:
        bm = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(R, W))
                              .astype(np.int32)).cuda()
        rows = rng.integers(0, live_rows, size=(B, mb)).astype(np.int32)
        rows[rng.random((B, mb)) >= p_live] = -1
        rows = torch.from_numpy(rows).cuda()
        out = cs.dense_ab(bm, rows, f"{name} B={B} W={W} R={R}", card)
        cs.log(json.dumps({"case": name, "R": R, "W": W, "B": B, "mb": mb,
                           "live_slots": int((rows >= 0).sum()), **out,
                           "card": card}))
        del bm, rows
        torch.cuda.empty_cache()
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
