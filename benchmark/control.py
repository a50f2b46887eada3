"""The output check's control: the reference in the program's place,
one guarantee broken.

    python3 -m benchmark.control --workload <cell> --seed <n> --seconds <s>

The control broker matches and fans out with the plain reference
(``reference.py``) and delivers exactly what the reference says, but it
acknowledges each PUBLISH on receipt, before its deliveries: the QoS 0
step below the QoS 1 the configurations state ("acknowledged only after
every delivery"). The harness drives it at the cell's own size and
load, exactly as it drives the program, and the same check must come
out not correct (``early_ack`` above its limit 0). The benchmark's own
runs never run it. It imports nothing of the program.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import sys
import time
from typing import Dict, List

from benchmark import manifest, reference, workload

_guid = 0


def _next_id() -> int:
    global _guid
    _guid += 1
    return _guid


@dataclasses.dataclass
class Message:
    """The control's own message: what a PUBLISH carries."""

    topic: str
    payload: bytes = b""
    qos: int = 0
    from_: str = ""
    flags: dict = dataclasses.field(default_factory=dict)
    id: int = dataclasses.field(default_factory=_next_id)


class _Counters:
    device_batches = 0
    device_msgs = 0


class _Telemetry:
    spans_total = 0
    hists: Dict[str, object] = {}


class _NoCache:
    """The control matches every topic afresh: its cache counts
    nothing."""

    def stats(self) -> Dict[str, int]:
        return {"hit": 0, "miss": 0}


class ControlBroker:
    """Subscriptions and deliveries by the reference; acknowledgements
    on receipt."""

    def __init__(self) -> None:
        self.pairs: List[tuple] = []
        self.objs: Dict[int, object] = {}
        self.ref = None
        self.rr: Dict[tuple, int] = {}
        self._match_cache_obj = _NoCache()

    def subscribe(self, sub, topic_filter: str) -> None:
        self.objs[sub.sid] = sub
        self.pairs.append((sub.sid, topic_filter))

    def automaton(self) -> None:
        self.ref = reference.Reference(self.pairs)

    def submit(self, msg):
        loop = asyncio.get_running_loop()
        need, groups, matched = self.ref.expect(msg.topic)
        fut = loop.create_future()
        fut.set_result(sum(need.values()) + len(groups))
        # two turns of the loop: the acknowledgement's callback, which
        # the caller adds now, runs first
        loop.call_soon(loop.call_soon, self._deliver, msg, need, groups,
                       matched)
        return fut

    def _deliver(self, msg, need, groups, matched) -> None:
        objs = self.objs
        for sid, n in need.items():
            for _ in range(n):
                objs[sid].deliver(None, msg)
        for members in groups:
            key = (id(members), msg.topic)
            k = self.rr.get(key, 0)
            self.rr[key] = k + 1
            objs[members[k % len(members)]].deliver(None, msg)


class ControlNode:
    """The surface of a node the harness drives."""

    def __init__(self) -> None:
        self.broker = ControlBroker()
        self.router = self.broker
        self.ingress = _Counters()
        self.ingress.submit = self.broker.submit
        self.telemetry = _Telemetry()

    async def start(self) -> None:
        return None

    async def stop(self) -> None:
        return None


def build_control(cfg: dict, device: str) -> ControlNode:
    return ControlNode()


def run(cell: str, seed: int, seconds: float, cfg=None, traffic=None):
    """One control run; returns ``(correct, checks)``. The cell names
    the configuration and traffic that ``cfg`` and ``traffic`` leave
    out."""
    from benchmark import harness

    t = time.perf_counter()
    if cfg is None or traffic is None:
        spec = manifest.cell(manifest.load_manifest(), cell)
        cfg = cfg or workload.load(manifest.config_path(spec["config"]))
        traffic = traffic or workload.load(
            manifest.traffic_path(spec["traffic"]))
    out = harness.run_cell(cfg, traffic, seed, seconds, False, t,
                           device="host", build=build_control,
                           message_type=Message)
    checks = out["checks"]
    return all(v == 0 for v in checks.values()), checks, out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    correct, checks, out = run(args.workload, args.seed, args.seconds)
    print(json.dumps({"control": args.workload, "seed": args.seed,
                      "correct": correct, "attempted": out["attempted"],
                      "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
