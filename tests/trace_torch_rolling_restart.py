"""The port's side of ``tests/test_torch_drain.py::test_rolling_restart_3node``
run again and again in one process on the CPU, with a packet and custody
trace of every run.

Each run calls the test's scenario (``_rolling`` on the port's nodes,
``ROLLING_MSGS`` publishes at least) in a fresh directory. The trace
wraps the test's MQTT client and the port's classes; each event is
``[seconds since the run began, thread, kind, ...]``:

- the clients: ``connack`` (client, node, reason code, session present),
  ``pub_out`` and ``pub_in`` (client, node, packet id, seq, DUP),
  ``ack_in``, ``disconnect_in``, ``eof``;
- the subscriber's session: ``from_wire``, ``to_wire`` and ``replay``
  (the outbox, inflight and queued seqs at that moment), ``write``
  (each packet its node wrote: packet id, seq, DUP), ``deliver``
  (node, seq, connected, a bounced forward);
- custody: ``failback_in`` (a hand-off chunk applied), ``drop_local``,
  ``handoff_start``/``handoff_end``, ``locate`` and ``remote_takeover``
  (a CONNECT's registry chase), ``node_up`` (the sessions it
  recovered), ``node_stop``.

A run that fails, or whose subscriber got a seq twice with the repeat
without DUP, writes its trace to ``<trace-dir>/<tag>_<run>.json``. Prints
a line a run and the passes. It drives a test's scenario, so it imports
both packages, as the tests do. Run from the repository's root::

    JAX_PLATFORMS=cpu python3 tests/trace_torch_rolling_restart.py --runs 25 \\
        [--msgs 200] [--trace-dir DIR] [--no-trace] [--tag NAME]
"""

import argparse
import asyncio
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

CIDS = ("roll-sub", "roll-pub")
EVENTS: list = []
T0 = [0.0]


def ev(*args) -> None:
    EVENTS.append([round(time.time() - T0[0], 4),
                   threading.current_thread().name[-12:], *args])


def _seq(msg):
    try:
        return int(msg.payload)
    except (TypeError, ValueError, AttributeError):
        return None


def _packets(items):
    from emqx_tpu_torch.session import PUBREL_MARKER
    return [("rel", m) if pid == PUBREL_MARKER
            else (pid, _seq(m), bool(m.flags.get("dup")))
            for pid, m in items]


def _state(sess):
    inflight = sorted((pid, _seq(v[0])) for pid, v in
                      sess.inflight.to_list() if hasattr(v[0], "payload"))
    queued = [_seq(m) for _p, msgs in sess.mqueue.snapshot() for m in msgs]
    return {"outbox": _packets(sess.outbox), "inflight": inflight,
            "mq": queued}


def _wrap(cls, name, before=None, after=None):
    orig = getattr(cls, name)

    def wrapped(self, *a, **k):
        if before is not None:
            before(self, *a, **k)
        out = orig(self, *a, **k)
        if after is not None:
            after(self, out, *a, **k)
        return out
    setattr(cls, name, wrapped)


def install_trace(td) -> None:
    """Wrap the test's client and the port's classes to record the
    events above."""
    from emqx_tpu.mqtt import constants as C
    from emqx_tpu.mqtt.packet import PubAck, Publish
    from emqx_tpu_torch import cm, drain, node, replication, session

    ports = {}
    orig_mk = td._mk_node

    async def mk_node(P, name, *a, **k):
        n = await orig_mk(P, name, *a, **k)
        ports[n.listeners[0].port] = name
        ev("node_up", name, sorted(n.cm._detached))
        return n
    td._mk_node = mk_node

    class Client(td.TestClient):
        __test__ = False

        async def connect(self, host="127.0.0.1", port=1883, timeout=5.0,
                          ssl=None):
            self.node = ports.get(port, port)
            r = await super().connect(host, port, timeout, ssl)
            ev("connack", self.client_id, self.node, r.reason_code,
               r.session_present)
            return r

        async def send(self, pkt):
            if isinstance(pkt, Publish):
                ev("pub_out", self.client_id, self.node, pkt.packet_id,
                   _seq(pkt), bool(pkt.dup))
            await super().send(pkt)

        async def _read_loop(self):
            client = self

            class Tap:
                def __init__(self, q):
                    self.q = q

                async def put(self, pkt):
                    if isinstance(pkt, Publish):
                        ev("pub_in", client.client_id, client.node,
                           pkt.packet_id, _seq(pkt), bool(pkt.dup))
                    elif getattr(pkt, "type", None) == C.DISCONNECT:
                        ev("disconnect_in", client.client_id, client.node,
                           pkt.reason_code)
                    elif isinstance(pkt, PubAck):
                        ev("ack_in", client.client_id, client.node,
                           pkt.type, pkt.packet_id)
                    await self.q.put(pkt)

                def __getattr__(self, k):
                    return getattr(self.q, k)

            inbox, acks = self.inbox, self.acks
            self.inbox, self.acks = Tap(inbox), Tap(acks)
            try:
                await super()._read_loop()
            finally:
                ev("eof", self.client_id, self.node)
                self.inbox, self.acks = inbox, acks

    td.TestClient = Client

    S = session.Session
    orig_from_wire = S.from_wire.__func__

    def from_wire(cls, d):
        s = orig_from_wire(cls, d)
        if s.client_id in CIDS:
            ev("from_wire", s.client_id, _state(s))
        return s
    S.from_wire = classmethod(from_wire)
    mine = lambda s: s.client_id == "roll-sub"  # noqa: E731
    _wrap(S, "to_wire", before=lambda s: mine(s) and ev(
        "to_wire", getattr(s.broker, "node", None), _state(s)))
    _wrap(S, "replay", before=lambda s: mine(s) and ev(
        "replay", getattr(s.broker, "node", None), _state(s)))
    _wrap(S, "drain_outbox", after=lambda s, out: mine(s) and out and ev(
        "write", getattr(s.broker, "node", None), _packets(out)))
    _wrap(S, "deliver", before=lambda s, flt, m: mine(s) and ev(
        "deliver", getattr(s.broker, "node", None), _seq(m), s.connected,
        bool(m.headers.get("fwd_bounce"))))

    R = replication.ReplicationManager
    _wrap(R, "handle_failback", before=lambda r, src, payload: ev(
        "failback_in", r.node.name, src,
        [c for c, _d, _s in payload.get("sessions", [])],
        bool(payload.get("final"))))
    _wrap(R, "_drop_local_session",
          before=lambda r, cid, s, registry=True: cid in CIDS and ev(
              "drop_local", r.node.name, cid, _state(s)))
    D = drain.DrainManager
    _wrap(D, "_handoff",
          before=lambda d: ev("handoff_start", d.node.name,
                              sorted(d.node.cm._detached)),
          after=lambda d, _o: ev("handoff_end", d.node.name,
                                 d.handed_off, d.handoff_ok))
    M = cm.ConnectionManager
    _wrap(M, "_remote_takeover",
          before=lambda m, cid: ev(
              "locate", getattr(m.broker, "node", None), cid,
              m.cluster.locate_client(cid)),
          after=lambda m, out, cid: ev(
              "remote_takeover", getattr(m.broker, "node", None), cid,
              out is not None))
    orig_stop = node.Node.stop

    async def stop(self, *a, **k):
        ev("node_stop", self.name, sorted(self.cm._detached))
        return await orig_stop(self, *a, **k)
    node.Node.stop = stop


def repeats_without_dup():
    """Seqs the subscriber got again, the repeat without DUP."""
    seen, bad = set(), []
    for e in EVENTS:
        if e[2] == "pub_in" and e[3] == "roll-sub":
            seq, dup = e[6], e[7]
            if seq in seen and not dup:
                bad.append(seq)
            seen.add(seq)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--msgs", type=int, default=60,
                    help="ROLLING_MSGS: publishes at least")
    ap.add_argument("--trace-dir", default=None,
                    help="where failing runs' traces go (default: a "
                         "temporary directory, printed)")
    ap.add_argument("--no-trace", action="store_true",
                    help="run the scenario as the test does, unwrapped")
    ap.add_argument("--tag", default="roll")
    opts = ap.parse_args()
    os.environ["ROLLING_MSGS"] = str(opts.msgs)

    import test_torch_drain as td
    from test_torch_repl_pkgs import PORT, clear_faults

    if not opts.no_trace:
        install_trace(td)
    trace_dir = Path(opts.trace_dir or tempfile.mkdtemp(prefix="rolltrace-"))
    trace_dir.mkdir(parents=True, exist_ok=True)
    passed = 0
    for i in range(opts.runs):
        EVENTS.clear()
        T0[0] = time.time()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="rollrun-") as d:
            clear_faults()
            try:
                asyncio.run(td._rolling(PORT, Path(d)))
                err = ""
            except AssertionError as e:
                err = f"{type(e).__name__}: {e}"[:300]
            finally:
                clear_faults()
        bad = repeats_without_dup()
        ok = not err and not bad
        passed += ok
        if not ok and not opts.no_trace:
            path = trace_dir / f"{opts.tag}_{i}.json"
            path.write_text(json.dumps(EVENTS, default=str))
            err += f" (trace {path})"
        print(f"{time.strftime('%H:%M:%S')} [{opts.tag}] run {i}: "
              f"{'ok' if ok else 'FAILED'} {time.perf_counter() - t:.1f} s "
              f"repeats without DUP {bad} {err}", flush=True)
    print(f"[{opts.tag}] passed {passed} of {opts.runs}", flush=True)
    return 0 if passed == opts.runs else 1


if __name__ == "__main__":
    sys.exit(main())
