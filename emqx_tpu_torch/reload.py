"""Live config reload — diff the running config against a TOML file
and apply the reloadable knobs atomically.

The port of the JAX package's ``reload.py``: the same classification
(the port's ``RELOADABLE`` sets equal the JAX package's, set by set),
the same per-knob report.

Every closed-schema config dataclass classifies its knobs with a
``RELOADABLE`` frozenset (a plain class attribute — not a dataclass
field): a knob is *reloadable* only when the running code reads it at
use time (per call, per tick, per wave), so assigning the live config
object's attribute takes effect without a restart; everything else is
*boot_only* — it was copied into a built structure (a thread, a
device table, a WAL layout) and only a restart re-reads it.

``ctl reload <toml>`` re-parses the file, diffs every section against
the RUNNING config objects, and:

  - rejects the WHOLE reload (nothing applied, zones included) when
    any boot_only knob changed — with a per-knob report, so the
    operator knows exactly which edit needs the restart;
  - otherwise applies every changed reloadable knob plus the zone
    re-publish/listener-rebind the legacy zones-only reload did, in
    one pass — an MQTT client connected across the reload never
    notices.

Sections ABSENT from the file are untouched (absence means "not
configured here", not "reset to defaults"); a section present in the
file on a node that never built that subsystem (e.g. ``[durability]
enabled = true`` on a volatile node) is a boot_only change by
definition. Listener topology is diffable only on nodes booted from
a file (``build_node`` stashes ``node.boot_config``); any change
there is boot_only.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("emqx_tpu_torch.reload")


def _sections() -> Dict[str, type]:
    """section name -> config dataclass (the closed-schema set)."""
    from emqx_tpu_torch.broker import DispatchConfig
    from emqx_tpu_torch.cluster import ClusterConfig
    from emqx_tpu_torch.drain import DrainConfig
    from emqx_tpu_torch.durability import DurabilityConfig
    from emqx_tpu_torch.faults import FaultsConfig
    from emqx_tpu_torch.overload import OverloadConfig
    from emqx_tpu_torch.router import MatcherConfig
    from emqx_tpu_torch.telemetry import TelemetryConfig
    from emqx_tpu_torch.tracing import TracingConfig

    return {
        "matcher": MatcherConfig,
        "telemetry": TelemetryConfig,
        "tracing": TracingConfig,
        "dispatch": DispatchConfig,
        "overload": OverloadConfig,
        "faults": FaultsConfig,
        "durability": DurabilityConfig,
        "cluster": ClusterConfig,
        "drain": DrainConfig,
    }


#: the [node] table's reloadable keys (the section is a literal key
#: tuple in config.parse_config, not a dataclass)
NODE_RELOADABLE = frozenset({"sys_interval"})
NODE_KEYS = ("name", "sys_interval", "cookie", "cluster_port",
             "load_default_modules", "loops", "frame")


def classification() -> Dict[str, Dict[str, str]]:
    """section -> {knob -> "reloadable" | "boot_only"} for every
    closed-schema knob (the table ``docs/OPERATIONS.md`` gives)."""
    out: Dict[str, Dict[str, str]] = {
        "node": {k: ("reloadable" if k in NODE_RELOADABLE
                     else "boot_only") for k in NODE_KEYS}}
    for name, cls in _sections().items():
        reloadable = getattr(cls, "RELOADABLE", frozenset())
        fields = [f.name for f in dataclasses.fields(cls)
                  if f.name != "mesh"]  # runtime-only, never in TOML
        unknown = reloadable - set(fields)
        if unknown:  # a typo'd RELOADABLE entry must never pass silently
            raise ValueError(f"[{name}] RELOADABLE names unknown "
                             f"knobs: {sorted(unknown)}")
        out[name] = {f: ("reloadable" if f in reloadable
                         else "boot_only") for f in fields}
    return out


@dataclasses.dataclass
class Change:
    section: str
    key: str
    old: object
    new: object
    kind: str                       # "reloadable" | "boot_only"
    reason: str = ""
    apply: Optional[Callable] = None

    @property
    def knob(self) -> str:
        return f"{self.section}.{self.key}"


def _running_sections(node) -> Dict[str, object]:
    """The live config objects the diff runs against. ``None`` =
    the subsystem was never built — any change there is boot_only."""
    from emqx_tpu_torch.durability import DurabilityConfig
    from emqx_tpu_torch.faults import FaultsConfig

    dur = node.durability
    cl = getattr(node, "cluster", None)
    return {
        "matcher": node.router.config,
        "telemetry": node.telemetry.config,
        "tracing": node.tracing.config,
        "dispatch": node.broker.dispatch_config,
        "overload": node.overload_config,
        # a durability-off node diffs against the disabled defaults:
        # the only way to change anything is enabled=true (boot_only)
        "durability": dur.cfg if dur is not None
        else DurabilityConfig(),
        "cluster": cl.config if cl is not None else None,
        "faults": getattr(node, "faults_config", None)
        or FaultsConfig(),
        "drain": node.drain.cfg,
    }


def _appliers(node) -> Dict[Tuple[str, str], Callable]:
    """Knobs whose live value was copied into a built object at boot
    — reloading them must push the new value there too (the config
    object is also updated, so ctl/info stays truthful)."""
    def _breaker(attr):
        def _apply(val):
            br = node.broker.breaker
            if br is not None:
                setattr(br, attr, val)
        return _apply

    def _recovery(attr):
        def _apply(val):
            br = node.broker.breaker
            if br is not None and br.recovery is not None:
                setattr(br.recovery, attr, float(val))
        return _apply

    def _ingress_wait(val):
        if node.ingress is not None:
            node.ingress.submit_wait_timeout = val

    def _sys_interval(val):
        node.sys.interval = float(val)

    return {
        ("node", "sys_interval"): _sys_interval,
        ("matcher", "delta"): node.router.set_delta,
        ("overload", "ingress_wait_timeout_s"): _ingress_wait,
        ("overload", "breaker_failures"):
            _breaker("threshold"),
        ("overload", "breaker_cooldown_s"):
            _breaker("cooldown_s"),
        ("overload", "breaker_slow_ms"): _breaker("slow_ms"),
        ("overload", "rebuild_backoff_s"):
            _recovery("backoff_s"),
        ("overload", "sentinel_timeout_s"):
            _recovery("sentinel_timeout_s"),
    }


def diff_config(node, cfg) -> List[Change]:
    """Every knob that differs between the running node and a parsed
    :class:`~emqx_tpu_torch.config.NodeConfig`, classified. Sections absent
    from the file produce no changes."""
    table = classification()
    running = _running_sections(node)
    changes: List[Change] = []
    # the [node] pseudo-section
    live_node = {
        "name": node.name,
        "sys_interval": node.sys.interval,
        "loops": node.loop_group.n if node.loop_group is not None
        else 1,
        # the configured parser ("py" or "native")
        "frame": node.frame,
        "load_default_modules": node._load_default_modules,
    }
    ccfg = node._cluster_cfg
    if ccfg is not None:
        live_node["cluster_port"] = None  # rebinds are topology
        live_node["cookie"] = ccfg[2]
    file_node = {"name": cfg.name, "sys_interval": cfg.sys_interval,
                 "loops": cfg.loops, "frame": cfg.frame,
                 "load_default_modules": cfg.load_default_modules}
    if cfg.cookie is not None and "cookie" in live_node:
        file_node["cookie"] = cfg.cookie
    if cfg.cluster_port is not None and ccfg is None:
        file_node["cluster_port"] = cfg.cluster_port
        live_node["cluster_port"] = None
    for key, new in file_node.items():
        old = live_node.get(key)
        if key == "cluster_port" and ccfg is not None:
            continue  # running port is post-bind; not diffable
        if old != new:
            changes.append(Change("node", key, old, new,
                                  table["node"][key]))
    # the closed-schema dataclass sections
    file_sections = {
        "matcher": cfg.matcher, "telemetry": cfg.telemetry,
        "tracing": getattr(cfg, "tracing", None),
        "dispatch": cfg.dispatch, "overload": cfg.overload,
        "faults": cfg.faults, "durability": cfg.durability,
        "cluster": cfg.cluster, "drain": getattr(cfg, "drain", None),
    }
    if file_sections["durability"] is not None and cfg.base_dir \
            and not os.path.isabs(file_sections["durability"].dir):
        # the same base_dir anchoring build_node applies — without
        # it every reload would flag durability.dir as changed
        file_sections["durability"].dir = os.path.join(
            cfg.base_dir, file_sections["durability"].dir)
    for section, new_cfg in file_sections.items():
        if new_cfg is None:
            continue
        run_cfg = running[section]
        for key, kind in table[section].items():
            new = getattr(new_cfg, key)
            if run_cfg is None:
                # subsystem never built: a non-default value is a
                # boot_only change by definition
                old = getattr(type(new_cfg)(), key, None)
                kind = "boot_only"
                reason = "section not active on this node"
            else:
                old = getattr(run_cfg, key)
                reason = ""
            if old != new:
                changes.append(Change(section, key, old, new, kind,
                                      reason=reason))
    # listener topology: diffable only against the boot config. The
    # zone BINDING is excluded — zones re-publish and listeners
    # rebind by name on every reload (the legacy semantics), so a
    # zone rename in the file is not a topology change
    boot = getattr(node, "boot_config", None)
    if cfg.listeners and boot is not None:
        def _topo(lcs):
            return [dataclasses.replace(lc, zone="") for lc in lcs]
        if _topo(cfg.listeners) != _topo(boot.listeners):
            changes.append(Change(
                "listeners", "*", f"{len(boot.listeners)} listeners",
                f"{len(cfg.listeners)} listeners", "boot_only",
                reason="listener topology changes need a restart"))
    return changes


def apply_reload(node, cfg) -> dict:
    """The diff-based reload: all-or-nothing. Returns a report dict
    (``zones``/``listeners``/``stale`` keep the legacy zones-reload
    shape; ``applied``/``rejected`` carry the knob verdicts)."""
    from emqx_tpu_torch.zone import _zones, set_zone

    changes = diff_config(node, cfg)
    rejected = [c for c in changes if c.kind == "boot_only"]
    applied = [c for c in changes if c.kind == "reloadable"]
    report = {
        "zones": sorted(cfg.zones),
        "listeners": [],
        "stale": sorted(n for n in _zones
                        if n != "default" and n not in cfg.zones),
        "applied": [], "rejected": [],
    }
    if rejected:
        report["rejected"] = [
            {"knob": c.knob, "old": c.old, "new": c.new,
             "reason": c.reason or "boot_only — requires restart"}
            for c in rejected]
        node.metrics.inc("config.reload.rejected", len(rejected))
        return report
    # zones re-publish + listener rebind (the legacy reload, folded
    # in — existing connections keep their snapshot, the reference's
    # emqx_zone:force_reload semantics)
    for zone in cfg.zones.values():
        set_zone(zone)
    for lst in node.listeners:
        nz = cfg.zones.get(lst.zone.name)
        if nz is not None and lst.zone is not nz:
            lst.zone = nz
            report["listeners"].append(lst.name)
    hooks = _appliers(node)
    running = _running_sections(node)
    for c in applied:
        run_cfg = running.get(c.section)
        if run_cfg is not None and c.section != "node":
            setattr(run_cfg, c.key, c.new)
        hook = hooks.get((c.section, c.key))
        if hook is not None:
            hook(c.new)
        report["applied"].append(
            {"knob": c.knob, "old": c.old, "new": c.new})
        log.info("config reload: %s %r -> %r", c.knob, c.old, c.new)
    if applied:
        node.metrics.inc("config.reload.applied", len(applied))
    return report
