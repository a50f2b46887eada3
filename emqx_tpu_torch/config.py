"""Config-file layer: TOML → zones, listeners, node settings.

The port of the JAX package's ``config.py``: the same closed schema,
the same error messages, so one file parses into equal configs in both
packages. The device is not a config key: :func:`build_node` and
:func:`boot_from_file` take ``device=`` (``"cuda"`` unless the caller
asks for the CPU), like every entry point of the port.

The reference boots from a 2,257-line ``etc/emqx.conf`` rendered by
cuttlefish into app env, then snapshotted into zones for lock-free
per-connection reads (src/emqx_zone.erl:89-95; zone sections at
etc/emqx.conf:698-907; listeners carry their zone,
src/emqx_listeners.erl:43-76). This module is that pipeline with
TOML (stdlib ``tomllib``) as the schema language:

    [node]
    name = "emqx_tpu@127.0.0.1"
    sys_interval = 60.0
    cookie = "secret"          # cluster transport cookie
    cluster_port = 4370        # 0 = ephemeral, omit = no transport

    [zones.default]
    max_packet_size = 1048576
    allow_anonymous = true

    [zones.external]
    idle_timeout = 10.0
    ratelimit_bytes_in = [102400, 204800]   # (rate/sec, burst)

    [[listeners]]
    type = "tcp"               # tcp | ws | ssl | wss
    port = 1883
    zone = "external"

    [[listeners]]
    type = "ssl"
    port = 8883
    certfile = "etc/certs/cert.pem"
    keyfile = "etc/certs/key.pem"
    cacertfile = "etc/certs/cacert.pem"
    verify = "verify_peer"
    fail_if_no_peer_cert = true

Unknown zone keys are rejected (a typo must not silently fall back
to a default — the cuttlefish schema gives the reference the same
property).
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any, Dict, List, Optional

from emqx_tpu_torch.zone import Zone, set_zone

#: Zone fields that arrive from TOML as 2-lists but are tuples in the
#: dataclass ((rate, burst) pairs; force_gc_policy is (count, bytes))
_TUPLE_FIELDS = {"ratelimit_msg_in", "ratelimit_bytes_in",
                 "quota_conn_messages", "force_gc_policy"}

_LISTENER_TYPES = {"tcp", "ws", "ssl", "wss"}
_TLS_KEYS = {"certfile", "keyfile", "cacertfile", "verify",
             "fail_if_no_peer_cert", "ciphers", "tls_version"}


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class ListenerConfig:
    type: str
    port: int
    host: str = "127.0.0.1"
    zone: str = "default"
    name: Optional[str] = None
    path: str = "/mqtt"          # ws/wss
    max_connections: int = 1024000
    tls: Optional[dict] = None   # ssl/wss: TlsOptions kwargs
    # PROXY protocol v1/v2 (fronting LB carries the real client
    # address; reference listener.tcp.*.proxy_protocol)
    proxy_protocol: bool = False
    proxy_protocol_timeout: float = 3.0
    # esockd-style accept controls (reference listener.*.access.N,
    # listener.*.max_conn_rate) — tcp/ssl listeners
    access: Optional[List[str]] = None
    max_conn_rate: float = 0.0
    # ssl listeners: CONNECT username from the client cert (cn | dn)
    peer_cert_as_username: Optional[str] = None


@dataclasses.dataclass
class NodeConfig:
    name: str = "emqx_tpu@127.0.0.1"
    sys_interval: float = 60.0
    cookie: Optional[str] = None
    cluster_port: Optional[int] = None
    # multi-loop front door: shard accepted connections over this many
    # event loops inside the node. 1 = the single-loop node, exactly.
    loops: int = 1
    # MQTT frame parser engine: "py" (pure-Python Parser) or "native"
    # (the C framing; a library that cannot be built raises at boot).
    # Boot-only.
    frame: str = "py"
    zones: Dict[str, Zone] = dataclasses.field(default_factory=dict)
    listeners: List[ListenerConfig] = dataclasses.field(
        default_factory=list)
    load_default_modules: bool = False
    # [modules.<name>] sections: module env dicts by name (the
    # reference's data/loaded_modules + per-module cuttlefish config)
    modules: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    # directory of the config file: relative paths inside it (module
    # files, certs) resolve against this, not the process cwd
    base_dir: Optional[str] = None
    # [matcher] section: device matcher / publish-path knobs
    # (emqx_tpu_torch.router.MatcherConfig — match-cache sizing and off
    # switch, kernel bounds, host/device threshold). None = defaults.
    matcher: Optional[Any] = None
    # [telemetry] section: publish-path stage histograms + slow-
    # publish log (emqx_tpu_torch.telemetry.TelemetryConfig). None =
    # defaults (enabled).
    telemetry: Optional[Any] = None
    # [tracing] section: sampled end-to-end message spans, slow-
    # subscriber ranking, per-loop profiler
    # (emqx_tpu_torch.tracing.TracingConfig). None = defaults
    # (sampling off).
    tracing: Optional[Any] = None
    # [dispatch] section: publish delivery-tail knobs
    # (emqx_tpu_torch.broker.DispatchConfig — batch dispatch planner and
    # egress pre-serialization on/off). None =
    # defaults (planner + preserialize on).
    dispatch: Optional[Any] = None
    # [overload] section: overload monitor levels/shedding + the
    # device-path circuit breaker
    # (emqx_tpu_torch.overload.OverloadConfig). None = defaults
    # (enabled).
    overload: Optional[Any] = None
    # [faults] section: deterministic fault injection
    # (emqx_tpu_torch.faults.FaultsConfig). None = the
    # registry untouched (disabled).
    faults: Optional[Any] = None
    # [durability] section: write-ahead journal + atomic checkpoints
    # + crash recovery (emqx_tpu_torch.durability.DurabilityConfig).
    # None = disabled (in-memory only, byte-for-byte).
    durability: Optional[Any] = None
    # [cluster] section: heartbeat failure detector + auto-heal /
    # anti-entropy knobs (emqx_tpu_torch.cluster.ClusterConfig).
    # None = the EOF-only failure story,
    # byte-for-byte. Only takes effect on a node with a cluster
    # transport ([node] cluster_port).
    cluster: Optional[Any] = None
    # [drain] section: graceful-drain wave pacing, default target,
    # SIGTERM drain mode (emqx_tpu_torch.drain.DrainConfig). None =
    # defaults (drain available via ctl, passive until started).
    drain: Optional[Any] = None


#: zone fields with a closed value set — a typo must be a startup
#: ConfigError, not a silently-permissive default (a misspelled
#: acl_deny_action would disable a security knob without a trace)
_ENUM_FIELDS = {
    "acl_nomatch": ("allow", "deny"),
    "acl_deny_action": ("ignore", "disconnect"),
}


def _build_zone(name: str, raw: Dict[str, Any]) -> Zone:
    known = {f.name for f in dataclasses.fields(Zone)}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown zone setting: zones.{name}.{key}")
        if key in _TUPLE_FIELDS and isinstance(val, list):
            val = tuple(val)
        if key in _ENUM_FIELDS and val not in _ENUM_FIELDS[key]:
            raise ConfigError(
                f"zones.{name}.{key} must be one of "
                f"{_ENUM_FIELDS[key]}, got {val!r}")
        kwargs[key] = val
    return Zone(name=name, **kwargs)


def _build_matcher(raw: Dict[str, Any]):
    """``[matcher]`` table → :class:`~emqx_tpu_torch.router.MatcherConfig`.
    Unknown keys are startup errors (same closed-schema rule as
    zones: a typo'd ``match_cache = false`` must not silently leave
    the cache on); ``mesh`` is runtime-only and not configurable
    from a file."""
    import dataclasses as _dc

    from emqx_tpu_torch.router import MatcherConfig

    known = {f.name for f in _dc.fields(MatcherConfig)} - {"mesh"}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown matcher setting: matcher.{key}")
        want = MatcherConfig.__dataclass_fields__[key].type
        if want == "bool" and not isinstance(val, bool):
            raise ConfigError(f"matcher.{key} must be a boolean")
        if want == "int" and (isinstance(val, bool)
                              or not isinstance(val, int)):
            raise ConfigError(f"matcher.{key} must be an integer")
        kwargs[key] = val
    p = kwargs.get("cache_partitions")
    if p is not None and (p < 1 or (p & (p - 1))):
        # Router would reject this too (ValueError at node build);
        # catching it here makes it a startup ConfigError with the
        # file location semantics of every other [matcher] typo
        raise ConfigError(
            f"matcher.cache_partitions must be a power of two >= 1, "
            f"got {p}")
    return MatcherConfig(**kwargs)


def _build_telemetry(raw: Dict[str, Any]):
    """``[telemetry]`` table → :class:`~emqx_tpu_torch.telemetry
    .TelemetryConfig`. Closed schema like zones/matcher: a typo'd
    ``enabled = false`` silently leaving span recording on (or off)
    is exactly the drift this rule exists to catch."""
    import dataclasses as _dc

    from emqx_tpu_torch.telemetry import TelemetryConfig

    known = {f.name for f in _dc.fields(TelemetryConfig)}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown telemetry setting: "
                              f"telemetry.{key}")
        want = TelemetryConfig.__dataclass_fields__[key].type
        if want == "bool" and not isinstance(val, bool):
            raise ConfigError(f"telemetry.{key} must be a boolean")
        if want == "int" and (isinstance(val, bool)
                              or not isinstance(val, int)):
            raise ConfigError(f"telemetry.{key} must be an integer")
        if want == "float":
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise ConfigError(f"telemetry.{key} must be a number")
            val = float(val)
        kwargs[key] = val
    if kwargs.get("slow_threshold_ms", 1.0) < 0:
        raise ConfigError("telemetry.slow_threshold_ms must be >= 0")
    if kwargs.get("ring_size", 1) <= 0:
        raise ConfigError("telemetry.ring_size must be > 0")
    return TelemetryConfig(**kwargs)


def _build_tracing(raw: Dict[str, Any]):
    """``[tracing]`` table → :class:`~emqx_tpu_torch.tracing
    .TracingConfig`. Closed schema like zones/matcher/telemetry: a
    typo'd ``sample_rate`` silently tracing nothing (or everything)
    is the drift this rule catches."""
    import dataclasses as _dc

    from emqx_tpu_torch.tracing import TracingConfig

    known = {f.name for f in _dc.fields(TracingConfig)}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown tracing setting: "
                              f"tracing.{key}")
        want = TracingConfig.__dataclass_fields__[key].type
        if want == "bool" and not isinstance(val, bool):
            raise ConfigError(f"tracing.{key} must be a boolean")
        if want == "int" and (isinstance(val, bool)
                              or not isinstance(val, int)):
            raise ConfigError(f"tracing.{key} must be an integer")
        if want == "float":
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise ConfigError(f"tracing.{key} must be a number")
            val = float(val)
        kwargs[key] = val
    rate = kwargs.get("sample_rate", 0.0)
    if not 0.0 <= rate <= 1.0:
        raise ConfigError("tracing.sample_rate must be in [0, 1]")
    if kwargs.get("ring_size", 1) <= 0:
        raise ConfigError("tracing.ring_size must be > 0")
    if kwargs.get("export_keep", 1) <= 0:
        raise ConfigError("tracing.export_keep must be > 0")
    if kwargs.get("slow_subs_top", 1) <= 0:
        raise ConfigError("tracing.slow_subs_top must be > 0")
    if kwargs.get("slow_subs_threshold_ms", 0.0) < 0:
        raise ConfigError(
            "tracing.slow_subs_threshold_ms must be >= 0")
    if kwargs.get("slow_subs_expiry_s", 1.0) <= 0:
        raise ConfigError("tracing.slow_subs_expiry_s must be > 0")
    if kwargs.get("slow_subs_alarm_ticks", 1) < 1:
        raise ConfigError(
            "tracing.slow_subs_alarm_ticks must be >= 1")
    if kwargs.get("profile_interval_ms", 1.0) <= 0:
        raise ConfigError("tracing.profile_interval_ms must be > 0")
    return TracingConfig(**kwargs)


def _build_dispatch(raw: Dict[str, Any]):
    """``[dispatch]`` table → :class:`~emqx_tpu_torch.broker
    .DispatchConfig`. Closed schema like zones/matcher/telemetry: a
    typo'd ``planner = false`` silently leaving the planner on is the
    drift this rule catches."""
    import dataclasses as _dc

    from emqx_tpu_torch.broker import DispatchConfig

    known = {f.name for f in _dc.fields(DispatchConfig)}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown dispatch setting: "
                              f"dispatch.{key}")
        want = DispatchConfig.__dataclass_fields__[key].type
        if want == "bool" and not isinstance(val, bool):
            raise ConfigError(f"dispatch.{key} must be a boolean")
        kwargs[key] = val
    return DispatchConfig(**kwargs)


def _build_overload(raw: Dict[str, Any]):
    """``[overload]`` table → :class:`~emqx_tpu_torch.overload
    .OverloadConfig`. Closed schema like zones/matcher: a typo'd
    ``enabled = false`` silently leaving shedding armed (or off) is
    the drift this rule catches."""
    import dataclasses as _dc

    from emqx_tpu_torch.overload import OverloadConfig

    known = {f.name for f in _dc.fields(OverloadConfig)}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown overload setting: "
                              f"overload.{key}")
        want = OverloadConfig.__dataclass_fields__[key].type
        if want == "bool" and not isinstance(val, bool):
            raise ConfigError(f"overload.{key} must be a boolean")
        if want == "int" and (isinstance(val, bool)
                              or not isinstance(val, int)):
            raise ConfigError(f"overload.{key} must be an integer")
        if want == "float":
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise ConfigError(f"overload.{key} must be a number")
            val = float(val)
        kwargs[key] = val
    try:
        return OverloadConfig(**kwargs)
    except ValueError as e:
        # threshold-ordering violations become startup errors with
        # file-location semantics, like every other section typo
        raise ConfigError(str(e)) from e


def _build_faults(raw: Dict[str, Any]):
    """``[faults]`` table → :class:`~emqx_tpu_torch.faults.FaultsConfig`.
    Arm specs are validated against the point catalog here — a typo'd
    chaos config must fail the boot, not silently test nothing."""
    from emqx_tpu_torch.faults import FaultsConfig, parse_arm

    known = {"enabled", "seed", "arm"}
    for key in raw:
        if key not in known:
            raise ConfigError(f"unknown faults setting: faults.{key}")
    if not isinstance(raw.get("enabled", False), bool):
        raise ConfigError("faults.enabled must be a boolean")
    seed = raw.get("seed", 0)
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise ConfigError("faults.seed must be an integer")
    arm = raw.get("arm", [])
    if not isinstance(arm, list) \
            or not all(isinstance(a, str) for a in arm):
        raise ConfigError("faults.arm must be a list of spec strings")
    for spec in arm:
        try:
            parse_arm(spec)
        except ValueError as e:
            raise ConfigError(f"faults.arm: {e}") from e
    return FaultsConfig(enabled=raw.get("enabled", False), seed=seed,
                        arm=list(arm))


def _build_durability(raw: Dict[str, Any]):
    """``[durability]`` table → :class:`~emqx_tpu_torch.durability
    .DurabilityConfig`. Closed schema like zones/matcher: a typo'd
    ``enabled = true`` silently leaving the broker volatile is the
    exact drift this rule exists to catch."""
    import dataclasses as _dc

    from emqx_tpu_torch.durability import DurabilityConfig

    known = {f.name for f in _dc.fields(DurabilityConfig)}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown durability setting: "
                              f"durability.{key}")
        want = DurabilityConfig.__dataclass_fields__[key].type
        if want == "bool" and not isinstance(val, bool):
            raise ConfigError(f"durability.{key} must be a boolean")
        if want == "int" and (isinstance(val, bool)
                              or not isinstance(val, int)):
            raise ConfigError(f"durability.{key} must be an integer")
        if want == "float":
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise ConfigError(f"durability.{key} must be a number")
            val = float(val)
        if want == "str" and not isinstance(val, str):
            raise ConfigError(f"durability.{key} must be a string")
        kwargs[key] = val
    try:
        return DurabilityConfig(**kwargs)
    except ValueError as e:
        raise ConfigError(str(e)) from e


def _build_cluster(raw: Dict[str, Any]):
    """``[cluster]`` table → :class:`~emqx_tpu_torch.cluster
    .ClusterConfig`. Closed schema like zones/matcher: a typo'd
    ``detector = false`` silently leaving the failure detector armed
    (or off) is the drift this rule catches; knob-ordering violations
    (down_after < suspect_after) become startup errors."""
    import dataclasses as _dc

    from emqx_tpu_torch.cluster import ClusterConfig

    known = {f.name for f in _dc.fields(ClusterConfig)}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown cluster setting: "
                              f"cluster.{key}")
        want = ClusterConfig.__dataclass_fields__[key].type
        if want == "bool" and not isinstance(val, bool):
            raise ConfigError(f"cluster.{key} must be a boolean")
        if want == "int" and (isinstance(val, bool)
                              or not isinstance(val, int)):
            raise ConfigError(f"cluster.{key} must be an integer")
        if want == "float":
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise ConfigError(f"cluster.{key} must be a number")
            val = float(val)
        kwargs[key] = val
    try:
        return ClusterConfig(**kwargs)
    except ValueError as e:
        raise ConfigError(str(e)) from e


def _build_drain(raw: Dict[str, Any]):
    """``[drain]`` table → :class:`~emqx_tpu_torch.drain.DrainConfig`.
    Closed schema like zones/matcher: a typo'd ``on_sigterm = true``
    silently leaving SIGTERM a hard stop is the drift this rule
    catches."""
    import dataclasses as _dc

    from emqx_tpu_torch.drain import DrainConfig

    known = {f.name for f in _dc.fields(DrainConfig)}
    kwargs: Dict[str, Any] = {}
    for key, val in raw.items():
        if key not in known:
            raise ConfigError(f"unknown drain setting: drain.{key}")
        want = DrainConfig.__dataclass_fields__[key].type
        if want == "bool" and not isinstance(val, bool):
            raise ConfigError(f"drain.{key} must be a boolean")
        if want == "int" and (isinstance(val, bool)
                              or not isinstance(val, int)):
            raise ConfigError(f"drain.{key} must be an integer")
        if want == "float":
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise ConfigError(f"drain.{key} must be a number")
            val = float(val)
        if want == "str" and not isinstance(val, str):
            raise ConfigError(f"drain.{key} must be a string")
        kwargs[key] = val
    try:
        return DrainConfig(**kwargs)
    except ValueError as e:
        raise ConfigError(str(e)) from e


def _build_listener(i: int, raw: Dict[str, Any]) -> ListenerConfig:
    raw = dict(raw)
    ltype = raw.pop("type", None)
    if ltype not in _LISTENER_TYPES:
        raise ConfigError(
            f"listeners[{i}].type must be one of {sorted(_LISTENER_TYPES)},"
            f" got {ltype!r}")
    if "port" not in raw:
        raise ConfigError(f"listeners[{i}] needs a port")
    tls = {k: raw.pop(k) for k in list(raw) if k in _TLS_KEYS}
    if ltype in ("ssl", "wss") and "certfile" not in tls:
        raise ConfigError(f"listeners[{i}] ({ltype}) needs a certfile")
    if ltype in ("tcp", "ws") and tls:
        # an operator who sets certfile on a tcp listener meant ssl;
        # serving plaintext on a port believed TLS-terminated is the
        # worst possible silent fallback
        raise ConfigError(
            f"listeners[{i}] ({ltype}) does not take TLS settings "
            f"({sorted(tls)}); did you mean type = \"ssl\"/\"wss\"?")
    known = {f.name for f in dataclasses.fields(ListenerConfig)}
    for key in raw:
        if key not in known:
            raise ConfigError(f"unknown listener setting: "
                              f"listeners[{i}].{key}")
    if float(raw.get("proxy_protocol_timeout", 3.0)) <= 0:
        # wait_for(..., 0) times out every accept instantly with only
        # a debug log — make the foot-gun a startup error instead
        raise ConfigError(
            f"listeners[{i}].proxy_protocol_timeout must be > 0")
    if raw.get("access") is not None:
        if ltype not in ("tcp", "ssl"):
            raise ConfigError(
                f"listeners[{i}]: access rules only apply to "
                f"tcp/ssl listeners")
        from emqx_tpu_torch.connection import parse_access_rules
        try:
            parse_access_rules(raw["access"])
        except ValueError as e:
            raise ConfigError(f"listeners[{i}].access: {e}") from e
    rate = float(raw.get("max_conn_rate", 0) or 0)
    if rate < 0:
        raise ConfigError(f"listeners[{i}].max_conn_rate must be >= 0")
    if rate > 0 and ltype not in ("tcp", "ssl"):
        # ws/wss listeners don't carry the accept bucket yet — a
        # config-accepted-but-unenforced rate limit is a silent noop
        raise ConfigError(
            f"listeners[{i}]: max_conn_rate only applies to "
            f"tcp/ssl listeners")
    pcu = raw.get("peer_cert_as_username")
    if pcu is not None:
        if ltype != "ssl":
            raise ConfigError(
                f"listeners[{i}]: peer_cert_as_username needs a "
                f"client-cert-bearing ssl listener")
        if pcu not in ("cn", "dn"):
            raise ConfigError(
                f"listeners[{i}].peer_cert_as_username must be "
                f"\"cn\" or \"dn\", got {pcu!r}")
        if tls.get("verify") != "verify_peer":
            # without peer verification no client ever presents a
            # cert: every username would stay self-asserted while the
            # operator believes it is cert-backed
            raise ConfigError(
                f"listeners[{i}]: peer_cert_as_username requires "
                f"verify = \"verify_peer\"")
    if raw.get("proxy_protocol") and ltype != "tcp":
        # silently ignoring it would leave the LB's real-client
        # addresses unseen — the worst kind of security-adjacent noop
        raise ConfigError(
            f"listeners[{i}]: proxy_protocol is only supported on "
            f"type = \"tcp\" listeners")
    return ListenerConfig(type=ltype, tls=tls or None, **raw)


def load_config(path: str) -> NodeConfig:
    """Parse + validate a TOML config file into a NodeConfig."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    cfg = parse_config(raw)
    cfg.base_dir = os.path.dirname(os.path.abspath(path))
    return cfg


def parse_config(raw: Dict[str, Any]) -> NodeConfig:
    cfg = NodeConfig()
    node = raw.get("node", {})
    for key in node:
        if key not in ("name", "sys_interval", "cookie", "cluster_port",
                       "load_default_modules", "loops", "frame"):
            raise ConfigError(f"unknown node setting: node.{key}")
    cfg.name = node.get("name", cfg.name)
    cfg.sys_interval = float(node.get("sys_interval", cfg.sys_interval))
    cfg.cookie = node.get("cookie")
    cfg.cluster_port = node.get("cluster_port")
    cfg.load_default_modules = bool(
        node.get("load_default_modules", False))
    loops = node.get("loops", 1)
    if isinstance(loops, bool) or not isinstance(loops, int) \
            or loops < 1:
        raise ConfigError(
            f"node.loops must be an integer >= 1, got {loops!r}")
    cfg.loops = loops
    frame = node.get("frame", "py")
    if frame not in ("py", "native"):
        raise ConfigError(
            f'node.frame must be "py" or "native", got {frame!r}')
    cfg.frame = frame
    mraw = raw.get("matcher")
    if mraw is not None:
        if not isinstance(mraw, dict):
            raise ConfigError("matcher must be a table")
        cfg.matcher = _build_matcher(mraw)
    traw = raw.get("telemetry")
    if traw is not None:
        if not isinstance(traw, dict):
            raise ConfigError("telemetry must be a table")
        cfg.telemetry = _build_telemetry(traw)
    trcraw = raw.get("tracing")
    if trcraw is not None:
        if not isinstance(trcraw, dict):
            raise ConfigError("tracing must be a table")
        cfg.tracing = _build_tracing(trcraw)
    draw = raw.get("dispatch")
    if draw is not None:
        if not isinstance(draw, dict):
            raise ConfigError("dispatch must be a table")
        cfg.dispatch = _build_dispatch(draw)
    oraw = raw.get("overload")
    if oraw is not None:
        if not isinstance(oraw, dict):
            raise ConfigError("overload must be a table")
        cfg.overload = _build_overload(oraw)
    fraw = raw.get("faults")
    if fraw is not None:
        if not isinstance(fraw, dict):
            raise ConfigError("faults must be a table")
        cfg.faults = _build_faults(fraw)
    duraw = raw.get("durability")
    if duraw is not None:
        if not isinstance(duraw, dict):
            raise ConfigError("durability must be a table")
        cfg.durability = _build_durability(duraw)
    craw = raw.get("cluster")
    if craw is not None:
        if not isinstance(craw, dict):
            raise ConfigError("cluster must be a table")
        cfg.cluster = _build_cluster(craw)
    drraw = raw.get("drain")
    if drraw is not None:
        if not isinstance(drraw, dict):
            raise ConfigError("drain must be a table")
        cfg.drain = _build_drain(drraw)
    for name, zraw in raw.get("zones", {}).items():
        cfg.zones[name] = _build_zone(name, zraw)
    for i, lraw in enumerate(raw.get("listeners", [])):
        lc = _build_listener(i, lraw)
        if lc.zone != "default" and lc.zone not in cfg.zones:
            # same invariant as unknown keys: a zone typo must not
            # silently run the listener with default limits
            raise ConfigError(
                f"listeners[{i}].zone {lc.zone!r} is not defined "
                f"(zones: {sorted(cfg.zones) or ['default']})")
        cfg.listeners.append(lc)
    for name, env in raw.get("modules", {}).items():
        if name not in _module_classes():
            raise ConfigError(
                f"unknown module: modules.{name} "
                f"(available: {sorted(_module_classes())})")
        if not isinstance(env, dict):
            raise ConfigError(f"modules.{name} must be a table")
        cfg.modules[name] = env
    return cfg


def _module_classes() -> Dict[str, type]:
    from emqx_tpu_torch.modules.acl_file import AclFileModule
    from emqx_tpu_torch.modules.delayed import DelayedModule
    from emqx_tpu_torch.modules.presence import PresenceModule
    from emqx_tpu_torch.modules.prometheus import PrometheusModule
    from emqx_tpu_torch.modules.retainer import RetainerModule
    from emqx_tpu_torch.modules.rewrite import RewriteModule
    from emqx_tpu_torch.modules.subscription import SubscriptionModule
    from emqx_tpu_torch.modules.topic_metrics import TopicMetricsModule

    return {cls.name: cls for cls in (
        AclFileModule, DelayedModule, PresenceModule, PrometheusModule,
        RetainerModule, RewriteModule, SubscriptionModule,
        TopicMetricsModule)}


def build_node(cfg: NodeConfig, device=None):
    """Instantiate a Node (listeners attached, not yet started) from
    a parsed config on ``device`` (``"cuda"`` unless the caller asks
    for the CPU; raises without CUDA); registers the zones globally so
    ``get_zone`` resolves them (the reference's ETS zone snapshot)."""
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.tls import TlsOptions

    for zone in cfg.zones.values():
        set_zone(zone)
    if cfg.durability is not None and cfg.base_dir \
            and not os.path.isabs(cfg.durability.dir):
        # like module files: a relative data dir anchors at the
        # config file, not the process cwd
        cfg.durability.dir = os.path.join(cfg.base_dir,
                                           cfg.durability.dir)
    default = cfg.zones.get("default")
    node = Node(name=cfg.name, zone=default,
                matcher=cfg.matcher,
                telemetry=cfg.telemetry,
                tracing=cfg.tracing,
                dispatch_config=cfg.dispatch,
                sys_interval=cfg.sys_interval,
                load_default_modules=cfg.load_default_modules,
                loops=cfg.loops,
                frame=cfg.frame,
                overload=cfg.overload,
                faults_config=cfg.faults,
                durability=cfg.durability,
                drain=cfg.drain,
                boot_listeners=False,
                device=device)
    # the live-reload diff's baseline (reload.py): listener
    # topology is only comparable against what the node booted from
    node.boot_config = cfg
    for i, lc in enumerate(cfg.listeners):
        zone = cfg.zones.get(lc.zone)
        name = lc.name or f"{lc.type}:{i}"
        kw = dict(host=lc.host, port=lc.port, zone=zone, name=name,
                  max_connections=lc.max_connections)
        if lc.type == "tcp":
            node.add_listener(
                proxy_protocol=lc.proxy_protocol,
                proxy_protocol_timeout=lc.proxy_protocol_timeout,
                access_rules=lc.access,
                max_conn_rate=lc.max_conn_rate,
                **kw)
        elif lc.type == "ws":
            node.add_ws_listener(path=lc.path, **kw)
        elif lc.type == "ssl":
            node.add_tls_listener(
                tls_options=TlsOptions(**lc.tls),
                access_rules=lc.access,
                max_conn_rate=lc.max_conn_rate,
                peer_cert_as_username=lc.peer_cert_as_username,
                **kw)
        else:  # wss
            node.add_wss_listener(path=lc.path,
                                  tls_options=TlsOptions(**lc.tls), **kw)
    classes = _module_classes()
    for name, env in cfg.modules.items():
        env = dict(env)
        f = env.get("file")
        if isinstance(f, str) and not os.path.isabs(f) and cfg.base_dir:
            env["file"] = os.path.join(cfg.base_dir, f)
        if isinstance(env.get("file"), str) and \
                not os.path.exists(env["file"]):
            raise ConfigError(
                f"modules.{name}.file not found: {env['file']}")
        node.modules.load(classes[name], env=env)
    if cfg.cluster_port is not None:
        # socket transport + cluster agent come up inside
        # node.start() (the transport needs the serving loop)
        node.enable_cluster(port=cfg.cluster_port,
                            cookie=cfg.cookie or "emqxtpu",
                            config=cfg.cluster)
    return node


def reload_zones(path: str, node=None) -> dict:
    """Runtime zone reload (the reference's emqx_zone:force_reload:
    re-copy config into the lock-free snapshot registry). Re-parses
    the file, validates it in full, republishes every zone, and —
    given a node — REBINDS running listeners to the new Zone objects
    by name, so connections accepted from now on get the new limits.
    Existing connections keep the snapshot they were built with (the
    reference's semantics). Listener/cluster/module topology changes
    require a restart and are ignored here.

    Returns ``{"zones": [...], "listeners": [rebound...],
    "stale": [...]}`` — ``stale`` lists previously published zones
    the new file no longer defines (kept: a listener may still hold
    them; the report makes the drift visible)."""
    from emqx_tpu_torch.zone import _zones

    cfg = load_config(path)
    for zone in cfg.zones.values():
        set_zone(zone)
    rebound = []
    if node is not None:
        for lst in node.listeners:
            nz = cfg.zones.get(lst.zone.name)
            if nz is not None and lst.zone is not nz:
                lst.zone = nz
                rebound.append(lst.name)
    stale = sorted(n for n in _zones
                   if n != "default" and n not in cfg.zones)
    return {"zones": sorted(cfg.zones), "listeners": rebound,
            "stale": stale}


def boot_from_file(path: str, device=None):
    """Build a Node from a config file on ``device`` (listeners
    attached, not yet started): ``node = boot_from_file(path);
    await node.start()``."""
    return build_node(load_config(path), device=device)
