"""How many kernel launches torch.profiler's CUDA trace keeps as the
process ages, with and without the padded window that ``chip_smoke.py``
profiles in.

Every ``--every`` seconds, for ``--rounds`` rounds, 20 back-to-back
launches of kernel B3 (the retained match, F = 32 filters against
65,536 names) are traced in: an unpadded window (CUDA activity; CPU
and CUDA), a window opened ``chip_smoke.TRACE_PAD_S`` before the first
launch (``chip_smoke.traced``), and ``chip_smoke.kernel_ms``'s recipe
(which prints a line of its own when its fullest window holds fewer
than 20). Prints one line per round with the launches each window
kept, then the card's name and power limit.
Needs one CUDA card; run from the repository's root::

    python3 scripts/torch_trace_window.py [--rounds 10] [--every 25]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NAME = "retained_match_kernel"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--every", type=float, default=25.0)
    opts = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("torch_trace_window: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops.retained_match import match_names_cuda

    t0 = time.monotonic()
    _build.library()
    g = torch.Generator().manual_seed(0)
    F, cap = 32, 65536
    args = [torch.randint(-1, 4, (F, 16), generator=g, dtype=torch.int32),
            torch.randint(1, 5, (F,), generator=g, dtype=torch.int32),
            torch.rand(F, generator=g) < 0.3,
            torch.randint(-1, 4, (cap, 16), generator=g, dtype=torch.int32),
            torch.randint(1, 5, (cap,), generator=g, dtype=torch.int32),
            torch.rand(cap, generator=g) < 0.1]
    args = [a.cuda() for a in args]

    def fn():
        return match_names_cuda(*args)

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def kept(prof):
        return sum(e.count for e in prof.key_averages() if NAME in e.key)

    def unpadded(acts):
        from torch.profiler import profile

        with profile(activities=acts) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        return kept(prof)

    cuda, both = [ProfilerActivity.CUDA], [ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]
    for rnd in range(opts.rounds):
        if rnd:
            time.sleep(opts.every)
        row = {"unpadded": unpadded(cuda),
               "unpadded_cpu_cuda": unpadded(both),
               "padded": kept(cs.traced(fn, 20, cuda))}
        ms = cs.kernel_ms(fn, NAME)
        print(f"[trace] age {time.monotonic() - t0:7.1f} s: of 20 launches "
              f"kept {row}; kernel_ms {ms:.5f} ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
