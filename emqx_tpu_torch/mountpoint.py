"""Per-client topic namespace prefixing
(reference: src/emqx_mountpoint.erl)."""

from __future__ import annotations

from typing import Optional


def replvar(mountpoint: Optional[str], client_id: str = "",
            username: Optional[str] = None) -> Optional[str]:
    """Substitute %c (clientid) and %u (username) variables."""
    if not mountpoint:
        return mountpoint
    out = mountpoint.replace("%c", client_id)
    if username is not None:
        out = out.replace("%u", username)
    return out


def mount(mountpoint: Optional[str], topic: str) -> str:
    if not mountpoint:
        return topic
    return mountpoint + topic


def unmount(mountpoint: Optional[str], topic: str) -> str:
    if not mountpoint:
        return topic
    if topic.startswith(mountpoint):
        return topic[len(mountpoint):]
    return topic
