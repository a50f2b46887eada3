"""Logging facade: per-connection metadata + the broker line format.

Mirrors ``src/emqx_logger.erl`` (set_metadata_clientid/peername —
stamped once per connection at src/emqx_connection.erl:232 and
src/emqx_channel.erl:1161-1162 so every later log line carries the
client context) and ``src/emqx_logger_formatter.erl`` (the
``date time level clientid@peername msg`` line format). asyncio tasks
share one process-wide logging module, so the metadata lives in a
:class:`contextvars.ContextVar` — each connection task sees its own
values, the way each BEAM process owns its logger metadata.
"""

from __future__ import annotations

import contextvars
import logging
from typing import Optional, Tuple

_metadata: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "emqx_log_metadata", default={})


def set_metadata_clientid(clientid: str) -> None:
    md = dict(_metadata.get())
    md["clientid"] = clientid
    _metadata.set(md)


def set_metadata_peername(peername: Tuple[str, int]) -> None:
    md = dict(_metadata.get())
    md["peername"] = f"{peername[0]}:{peername[1]}"
    _metadata.set(md)


def get_metadata() -> dict:
    return _metadata.get()


def clear_metadata() -> None:
    _metadata.set({})


class MetadataFilter(logging.Filter):
    """Injects the context metadata onto every record passing through
    a handler (the role of OTP logger process metadata)."""

    def filter(self, record: logging.LogRecord) -> bool:
        md = _metadata.get()
        if "clientid" in md and not hasattr(record, "clientid"):
            record.clientid = md["clientid"]
        if "peername" in md and not hasattr(record, "peername"):
            record.peername = md["peername"]
        return True


class BrokerFormatter(logging.Formatter):
    """``date time [level] clientid@peername msg`` — the reference
    formatter's single-line template (emqx_logger_formatter default
    template, src/emqx_logger_formatter.erl)."""

    default_fmt = "%(asctime)s [%(levelname)s] %(client_tag)s%(message)s"

    def __init__(self) -> None:
        super().__init__(self.default_fmt)

    def format(self, record: logging.LogRecord) -> str:
        clientid = getattr(record, "clientid", None)
        peername = getattr(record, "peername", None)
        if clientid and peername:
            record.client_tag = f"{clientid}@{peername} "
        elif clientid:
            record.client_tag = f"{clientid} "
        else:
            record.client_tag = ""
        return super().format(record)


def setup(level: int = logging.INFO,
          handler: Optional[logging.Handler] = None) -> logging.Handler:
    """Attach the broker formatter + metadata filter to the package
    logger (primary_log_level in the reference's logger config)."""
    root = logging.getLogger("emqx_tpu_torch")
    root.setLevel(level)
    if handler is None:
        # idempotent: a second setup() reuses the existing default
        # handler instead of stacking one (duplicate log lines)
        for h in root.handlers:
            if isinstance(h.formatter, BrokerFormatter):
                h.setLevel(level)
                return h
        handler = logging.StreamHandler()
    else:
        # an explicit handler REPLACES prior broker handlers — a
        # second setup(handler=...) must not double every log line
        for h in list(root.handlers):
            if isinstance(h.formatter, BrokerFormatter):
                root.removeHandler(h)
    handler.addFilter(MetadataFilter())
    handler.setFormatter(BrokerFormatter())
    root.addHandler(handler)
    return handler
