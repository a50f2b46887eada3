"""Prometheus exposition endpoint for the node's counters and gauges
(the port of the JAX package's ``modules/prometheus.py``).

The reference ecosystem ships this as the `emqx_prometheus` plugin
(outside the core app); here it is a built-in module because the
metric registries it reads (`emqx_tpu_torch/metrics.py` ↔
src/emqx_metrics.erl, `emqx_tpu_torch/stats.py` ↔ src/emqx_stats.erl)
are core surfaces and an ops stack without a scrape endpoint is
incomplete. Stdlib-only: a minimal asyncio HTTP listener serving
`GET /metrics` in the Prometheus text exposition format (0.0.4).

Naming: metric/stat keys are dotted (`messages.received`,
`subscriptions.count`); Prometheus names must match
``[a-zA-Z_:][a-zA-Z0-9_:]*``, so dots and slashes become underscores
under an ``emqx_`` prefix: ``emqx_messages_received``. Counters from
the metrics registry are TYPE counter — EXCEPT the audited
non-monotonic names (`metrics.GAUGE_METRICS`, e.g. the retainer's
live-entry count, which `Metrics.dec` moves down): those are TYPE
gauge, because a scraper computes `rate()` over counters and reads
any decrease as a process restart. Stats are point-in-time TYPE
gauge (their ``.max`` companions included). Publish-path latency
histograms (`emqx_tpu_torch/telemetry.py`) render as proper histogram
families: cumulative ``_bucket{le=...}`` lines (buckets in
milliseconds, matching the ``_ms`` family suffix), ``_sum``,
``_count``.

Env keys (``[modules.prometheus]``): ``host`` (default 127.0.0.1),
``port`` (default 9505; 0 = ephemeral, the bound port is in
``self.port`` after load).
"""

from __future__ import annotations

import asyncio
import logging
import re
from typing import Optional

from emqx_tpu_torch.modules import Module

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(key: str) -> str:
    return "emqx_" + _NAME_RE.sub("_", key)


def render(metrics: dict, stats: dict,
           histograms: Optional[dict] = None) -> str:
    """The registries as one exposition document. Counters and
    gauges carry no labels (single-node registry; per-topic metrics
    stay in the topic_metrics module, deliberately unexported — an
    unbounded topic set is a label-cardinality trap); histogram
    buckets carry only the standard ``le`` label.

    ``histograms`` maps a ready-made family name to a
    ``Histogram.snapshot()`` dict (cumulative ``(le, count)`` bucket
    pairs + sum/count) — the shape ``Telemetry.histograms()``
    produces."""
    from emqx_tpu_torch.metrics import GAUGE_METRICS

    out = []
    for key in sorted(metrics):
        name = prom_name(key)
        kind = "gauge" if key in GAUGE_METRICS else "counter"
        out.append(f"# TYPE {name} {kind}")
        out.append(f"{name} {int(metrics[key])}")
    for key in sorted(stats):
        name = prom_name(key)
        out.append(f"# TYPE {name} gauge")
        val = stats[key]
        if isinstance(val, float) and not val.is_integer():
            # sub-unit gauges (cluster.hb.rtt_ms) must not floor to 0
            out.append(f"{name} {val}")
        else:
            out.append(f"{name} {int(val)}")
    for name in sorted(histograms or ()):
        snap = histograms[name]
        out.append(f"# TYPE {name} histogram")
        for le, cum in snap["buckets"]:
            out.append(f'{name}_bucket{{le="{format(le, "g")}"}} {cum}')
        out.append(f'{name}_bucket{{le="+Inf"}} {snap["count"]}')
        out.append(f"{name}_sum {snap['sum']:.6f}")
        out.append(f"{name}_count {snap['count']}")
    return "\n".join(out) + "\n"


class PrometheusModule(Module):
    name = "prometheus"

    def __init__(self, node) -> None:
        super().__init__(node)
        self._server: Optional[asyncio.base_events.Server] = None
        self._task: Optional[asyncio.Task] = None
        self._closing = False
        self.port: Optional[int] = None

    def load(self, env: dict) -> None:
        self._host = env.get("host", "127.0.0.1")
        self._port = int(env.get("port", 9505))
        self._kick_on_loop()

    def on_loop_start(self) -> None:
        self._closing = False
        if self._task is None or (self._task.done()
                                  and self._server is None):
            loop = asyncio.get_running_loop()
            self._task = loop.create_task(self._serve())

    def on_loop_stop(self) -> None:
        # flag-based shutdown, NOT a mid-bind cancel: cancelling the
        # serve task exactly as start_server completes internally
        # would drop an already-bound Server with no reference left
        # to close — the flag lets _serve finish and self-close
        self._closing = True
        if self._server is not None:
            self._server.close()
            self._server = None
            self.port = None

    def unload(self) -> None:
        self.on_loop_stop()
        self._task = None

    async def _serve(self) -> None:
        try:
            server = await asyncio.start_server(
                self._handle, self._host, self._port)
        except OSError as e:
            # a silent scrape endpoint is an ops trap: say WHY at
            # boot (EADDRINUSE etc), don't leave an unretrieved task
            # exception for loop teardown
            logging.getLogger(__name__).error(
                "prometheus endpoint failed to bind %s:%s: %s",
                self._host, self._port, e)
            return
        if self._closing:  # unload/stop raced the bind
            server.close()
            return
        self._server = server
        self.port = server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req = await asyncio.wait_for(reader.readline(), timeout=5.0)
            # drain headers to be a polite HTTP/1.1 peer
            while True:
                line = await asyncio.wait_for(reader.readline(),
                                              timeout=5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = req.decode("latin-1").split()
            if len(parts) >= 2 and parts[0] == "GET" \
                    and parts[1].split("?")[0] == "/metrics":
                # refresh registered gauge update-funs before reading,
                # like the $SYS heartbeat does
                self.node.stats.tick()
                tel = getattr(self.node, "telemetry", None)
                hists = (tel.histograms()
                         if tel is not None and tel.enabled else None)
                body = render(self.node.metrics.all(),
                              self.node.stats.all(), hists).encode()
                head = (b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: text/plain; version=0.0.4; "
                        b"charset=utf-8\r\n"
                        b"Content-Length: %d\r\n"
                        b"Connection: close\r\n\r\n" % len(body))
                writer.write(head + body)
            else:
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Content-Length: 0\r\n"
                             b"Connection: close\r\n\r\n")
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, ValueError):
            # ValueError = StreamReader's LimitOverrunError on a
            # >64KiB line (scanner garbage) — drop, don't crash the
            # connection task
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass
