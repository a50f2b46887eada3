"""Per-clientid / per-topic tracing via logging handlers (the port of
the JAX package's ``tracer.py``; reference: src/emqx_tracer.erl:102-151
— OTP logger handlers with metadata/topic filters; here:
logging.Handler instances filtered on record attributes, plus an
in-memory tap for tests and the command line).

Each Tracer owns a private, non-propagating logger so traces on one
broker node never capture another node's traffic in multi-node
processes."""

from __future__ import annotations

import itertools
import json
import logging
from typing import Dict, List, Tuple

from emqx_tpu_torch import topic as T

_ids = itertools.count()


class _TraceHandler(logging.Handler):
    def __init__(self, kind: str, value: str, sink) -> None:
        super().__init__(level=logging.DEBUG)
        self.kind = kind      # "clientid" | "topic"
        self.value = value
        self.sink = sink      # list or file-like
        self.dead = False     # sink failed — emit is a no-op
        # set by the owning Tracer: detaches this handler on a sink
        # failure so a closed file doesn't stay subscribed forever
        self.on_error = None

    def match(self, record: logging.LogRecord) -> bool:
        if self.kind == "clientid":
            return getattr(record, "clientid", None) == self.value
        topic = getattr(record, "topic", None)
        return topic is not None and T.match(topic, self.value)

    def emit(self, record: logging.LogRecord) -> None:
        if self.dead or not self.match(record):
            return
        line = self.format(record)
        try:
            if hasattr(self.sink, "write"):
                self.sink.write(line + "\n")
            else:
                self.sink.append(line)
        except Exception:
            # a closed/broken sink must not bubble out of the
            # logging call on the PUBLISH path (trace_publish runs
            # inside publish_begin): go dead immediately, then let
            # the tracer unhook us cleanly
            self.dead = True
            if self.on_error is not None:
                self.on_error(self)


class Tracer:
    def __init__(self) -> None:
        self._log = logging.getLogger(
            f"emqx_tpu_torch.trace.{next(_ids)}")
        self._log.setLevel(logging.DEBUG)
        self._log.propagate = False
        self._traces: Dict[Tuple[str, str], _TraceHandler] = {}

    def start_trace(self, kind: str, value: str, sink=None):
        """sink: a list (in-memory) or open file; returns the sink."""
        assert kind in ("clientid", "topic")
        key = (kind, value)
        if key in self._traces:
            raise ValueError("already_traced")
        sink = [] if sink is None else sink
        h = _TraceHandler(kind, value, sink)
        h.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(message)s"))
        h.on_error = self._detach
        self._log.addHandler(h)
        self._traces[key] = h
        return sink

    def _detach(self, h: _TraceHandler) -> None:
        """A handler's sink failed mid-emit: unhook it from the
        logger and the registry. REBIND the handler list rather than
        mutating it — this runs from inside the logger's own
        callHandlers iteration, and an in-place removal would shift
        the list under the loop and skip the NEXT handler for the
        current record."""
        self._traces.pop((h.kind, h.value), None)
        self._log.handlers = [x for x in self._log.handlers
                              if x is not h]

    def stop_trace(self, kind: str, value: str) -> bool:
        h = self._traces.pop((kind, value), None)
        if h is None:
            return False
        self._log.removeHandler(h)
        flush = getattr(h.sink, "flush", None)
        if callable(flush):
            # a file sink's buffered tail must land when the operator
            # stops the trace — they read the file next
            try:
                flush()
            except Exception:
                pass
        return True

    def lookup_traces(self) -> List[Tuple[str, str]]:
        return list(self._traces)

    def trace_publish(self, msg) -> None:
        """Tee a publish into the trace log (emqx_broker.erl:202)."""
        if self._traces:
            self._log.debug("PUBLISH to %s: %r", msg.topic,
                            msg.payload[:64],
                            extra={"topic": msg.topic,
                                   "clientid": msg.from_})

    def trace_packet(self, direction: str, clientid: str, pkt) -> None:
        if self._traces:
            # outbound PUBLISH/inbound packets that carry a topic must
            # stamp it, or topic-filter traces miss them entirely (the
            # filter matches on the record's `topic` extra)
            topic = getattr(pkt, "topic", None)
            extra = {"clientid": clientid}
            if topic:
                extra["topic"] = topic
            self._log.debug("%s %s", direction, pkt, extra=extra)

    def trace_slow_publish(self, record: dict) -> None:
        """Tee a slow-publish telemetry record (telemetry.Telemetry)
        into the trace log: a topic trace whose filter matches the
        batch's sample topic captures the per-stage breakdown inline
        with that topic's publishes."""
        if self._traces:
            self._log.warning("SLOW PUBLISH %s", json.dumps(record),
                              extra={"topic": record.get("topic")})
