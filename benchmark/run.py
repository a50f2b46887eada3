"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run needs as many CUDA devices as the
cell asks for and the ``emqx_tpu_torch`` package beside this folder;
without either it exits with code 2 and prints no result. With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled window. The
numbers the output check compares, each beside its limit, are the last
lines on standard error and the last key of the result line.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import manifest, reference, trace, workload  # noqa: E402

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "emqx_tpu")
#: the limit of every compared number: the checks are exact
LIMITS = dict.fromkeys(reference.CHECKS, 0)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (by default the
    modules this process holds), compared whole."""
    if names is None:
        names = list(sys.modules)
    tops = {name.partition(".")[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def breakdown(red: dict) -> dict:
    ops = sorted(red["ops"].items(), key=lambda kv: -kv[1])[:trace.TOP]
    # a kernel's name up to its argument list: templated names run to
    # kilobytes
    ops = [(k if len(k) <= 160 else k[:157] + "...", v) for k, v in ops]
    gaps = [[f"{lab} ({n} gaps)", sec]
            for lab, sec, n in red["gaps"][:trace.TOP]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def main(argv=None) -> int:
    args = parse(argv)
    man = manifest.load_manifest()
    spec = manifest.cell(man, args.workload)
    try:
        import torch
    except ImportError as e:
        log(f"refused: PyTorch is not importable ({e})")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(spec["chips"]):
        log(f"refused: the cell needs {spec['chips']} CUDA device(s); "
            f"this host has {torch.cuda.device_count()}")
        return 2
    try:
        import emqx_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"refused: the program emqx_tpu_torch is not importable ({e})")
        return 2
    cfg = workload.load(manifest.config_path(spec["config"]))
    traffic = workload.load(manifest.traffic_path(spec["traffic"]))
    metrics = manifest.metrics_for(man, spec["name"], bool(args.trace))
    readers = manifest.readers(metrics)
    from benchmark import harness

    try:
        out = harness.run_cell(cfg, traffic, args.seed,
                               args.seconds, bool(args.trace), T_PROCESS)
    except harness.SeamMissing as e:
        log(f"refused: {e}")
        return 2
    bad = forbidden_modules()
    if bad:
        log(f"refused: the run loaded {', '.join(bad)}")
        return 3
    log(f"[card] {card_line()}")
    rd = out["rd"]
    values = {}
    for m in metrics:
        v = readers[m["name"]](rd)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = out["checks"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(spec["chips"]),
              "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": values, "device": device}
    if args.trace:
        device["busy_s"] = rd.trace["busy_s"]
        device["window_s"] = rd.trace["window_s"]
        result["breakdown"] = breakdown(rd.trace)
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]}
                        for k in LIMITS}
    log(f"[metrics] {json.dumps(values)}")
    for k in LIMITS:
        log(f"check {k} {checks[k]} limit {LIMITS[k]}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
