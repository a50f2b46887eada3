"""CLI command registry + the built-in management commands
(reference: src/emqx_ctl.erl + the ctl hooks in broker/cm/plugins) —
the port of the JAX package's ``ctl.py``.

Commands operate on a live :class:`~emqx_tpu_torch.node.Node` and read
the port's own subsystems; the registry is extensible the same way the
reference's `emqx_ctl:register_command` is. Every built-in of the JAX
``Ctl`` is here, ``reload`` (the live config reload, ``reload.py``)
included.
Where the port runs on other hardware the text says so: ``vm`` lists
the CUDA cards, and ``cache``'s and ``retained``'s walk variant is
``cuda`` (kernel B1) or ``torch`` (its plain twin) where the JAX
package says ``pallas`` or ``lax``."""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List

#: ``ctl retained``'s index keys (the JAX package's
#: ``RetainIndex.device_info`` keys, in its order; ``walk`` follows)
_INDEX_KEYS = ("rows", "deep", "cap", "epoch", "cached", "dirty_rows",
               "device_broken", "suspended", "last_batch")


class Ctl:
    def __init__(self, node) -> None:
        self.node = node
        self._commands: Dict[str, Callable] = {}
        self._usage: Dict[str, str] = {}
        self._register_builtins()

    def register_command(self, name: str, fn: Callable,
                         usage: str = "") -> None:
        self._commands[name] = fn
        self._usage[name] = usage

    def unregister_command(self, name: str) -> None:
        self._commands.pop(name, None)
        self._usage.pop(name, None)

    def run(self, argv: List[str]) -> str:
        if not argv or argv[0] in ("help", "--help"):
            return self.usage()
        cmd = self._commands.get(argv[0])
        if cmd is None:
            return f"unknown command: {argv[0]}\n" + self.usage()
        try:
            return cmd(argv[1:])
        except Exception as e:  # operator input errors become text
            usage = self._usage.get(argv[0], "")
            return f"error: {e}\nusage: {argv[0]} {usage}"

    def usage(self) -> str:
        lines = ["commands:"]
        for name in sorted(self._commands):
            lines.append(f"  {name:<14} {self._usage.get(name, '')}")
        return "\n".join(lines)

    # -- built-ins --------------------------------------------------------

    def _register_builtins(self) -> None:
        self.register_command("status", self._status, "broker status")
        self.register_command("broker", self._broker, "broker info")
        self.register_command("clients", self._clients,
                              "list | show <clientid> | kick <clientid>")
        self.register_command("sessions", self._sessions, "session count")
        self.register_command("topics", self._topics, "list routed topics")
        self.register_command("subscriptions", self._subs,
                              "show <clientid>")
        self.register_command("metrics", self._metrics, "all counters")
        self.register_command("stats", self._stats, "all gauges")
        self.register_command("routes", self._routes, "list routes")
        self.register_command("plugins", self._plugins,
                              "list | load <name> | unload <name>")
        self.register_command("banned", self._banned,
                              "list | add <kind> <value> [secs] | del <kind> <value>")
        self.register_command("checkpoint", self._checkpoint,
                              "save|load <path>")
        self.register_command(
            "reload", self._reload,
            "<config.toml> — diff the running config and apply "
            "reloadable knobs + zones atomically; boot-only edits "
            "are rejected with a per-knob report "
            "(docs/OPERATIONS.md)")
        self.register_command(
            "drain", self._drain,
            "start [--target <peer>] [--ref <host:port>] | status | "
            "stop — graceful node drain: redirect clients in paced "
            "waves, hand session custody to the target "
            "(docs/OPERATIONS.md)")
        self.register_command("trace", self._trace,
                              "list | start client|topic <v> | "
                              "stop client|topic <v> | export <path>")
        self.register_command(
            "slow_subs", self._slow_subs,
            "top-N slowest subscribers by moving delivery latency "
            "(docs/OBSERVABILITY.md) | reset")
        self.register_command("vm", self._vm,
                              "host/runtime introspection (emqx_vm)")
        self.register_command(
            "cluster", self._cluster,
            "status | join <host:port> | leave  (emqx_ctl cluster)")
        self.register_command("listeners", self._listeners,
                              "list listeners + connection counts")
        self.register_command("log", self._log,
                              "set-level <debug|info|warning|error> | show")
        self.register_command(
            "telemetry", self._telemetry,
            "stages | slow | reset — publish-path stage latency")
        self.register_command(
            "cache", self._cache,
            "publish match-cache: hit/miss/stale, epoch-bump split, "
            "partitions, fid quarantine")
        self.register_command(
            "overload", self._overload,
            "overload level, samples, shed counters, breaker state "
            "incl. device-loss recovery (rebuilds, last_rebuild_s)")
        self.register_command(
            "faults", self._faults,
            "list | arm <point[:action[:times[:delay_ms]]]> | "
            "disarm <point> | clear | on | off")
        self.register_command(
            "durability", self._durability,
            "journal/checkpoint/recovery state | checkpoint — "
            "commit a generation now")
        self.register_command(
            "retained", self._retained,
            "retained store/index state: store/deep/tombstone "
            "counts, device epoch + dirty rows, fallback/breaker "
            "state, replay batch counters (docs/OBSERVABILITY.md)")
        from emqx_tpu_torch.profiling import register_ctl
        register_ctl(self)

    def _overload(self, args) -> str:
        """One-stop overload diagnosis (docs/ROBUSTNESS.md): current
        level + last sample set, the cumulative shed/heal counters,
        and the device-path breaker state — with the device-loss
        recovery fields (state incl. ``rebuilding``, classification,
        rebuilds, rebuild_failures, last_rebuild_s) when the
        recovery manager is attached."""
        from emqx_tpu_torch.metrics import BREAKER_METRICS, OVERLOAD_METRICS
        ov = self.node.overload
        out = {"enabled": ov is not None}
        if ov is not None:
            out.update(ov.info())
        m = self.node.metrics
        out["counters"] = {
            k: m.val(k) for k in OVERLOAD_METRICS + BREAKER_METRICS
            if m.val(k)}
        out["orphaned_xloop"] = m.val("delivery.xloop.orphaned")
        br = self.node.broker.breaker
        out["breaker"] = br.info() if br is not None else "disabled"
        return json.dumps(out, indent=2)

    def _durability(self, args) -> str:
        """One-stop durability diagnosis (docs/DURABILITY.md):
        generation, journal shards/bytes/records/degraded state, last
        fsync latency, checkpoint chain + age, the last recovery
        summary, and the replication block (role, the replication-
        group topology with per-standby link state + shipped/acked
        offsets, aggregate lag, ack-quorum status, last promotion/
        failback; warm replicas this node holds for its peers)."""
        dur = self.node.durability
        repl = getattr(self.node, "replication", None)
        if dur is None:
            if repl is not None and repl.replicas:
                # a pure standby: durability off locally, but warm
                # replicas for peers are operator-relevant state
                return json.dumps({"enabled": False,
                                   "replication": repl.info()},
                                  indent=2, default=str)
            return ("durability not enabled "
                    "([durability] enabled = true in the config)")
        if args and args[0] == "checkpoint":
            return json.dumps(dur.checkpoint_now(), indent=2)
        out = dur.info()
        if repl is not None and "replication" not in out:
            out["replication"] = repl.info()
        return json.dumps(out, indent=2, default=str)

    def _faults(self, args) -> str:
        from emqx_tpu_torch import faults
        if not args or args[0] == "list":
            return json.dumps(faults.info(), indent=2)
        if args[0] == "arm" and len(args) > 1:
            faults.arm_spec(args[1])
            return "ok"
        if args[0] == "disarm" and len(args) > 1:
            return "ok" if faults.disarm(args[1]) else "not armed"
        if args[0] == "clear":
            faults.clear()
            return "ok"
        if args[0] in ("on", "off"):
            faults.set_master(args[0] == "on")
            return "ok"
        raise ValueError(f"bad subcommand: {args[0]}")

    def _cache(self, args) -> str:
        """Everything needed to diagnose a hit-rate collapse from one
        command (docs/MATCH_CACHE.md "Partitioned epochs"): per-cache
        cumulative counters + hit rate, the bump.global/bump.partition
        split, the live partition count, and the fid-quarantine
        depth."""
        r = self.node.router
        out = {
            "partitions": r.cache_partitions_live(),
            "bumps": r.cache_bump_totals(),
            "entries": r.cache_entries(),
            "quarantined_ids": r.quarantined_ids(),
            # online delta automaton (docs/DELTA.md): pending side-
            # automaton size, tombstones, merge count, and the
            # cumulative lock-stall the off-lock compaction design
            # keeps near zero
            "delta": r.delta_info(),
            # walk variant (cuda: kernel B1 | torch: its plain twin)
            # + the live tables' level-compression snapshot
            "walk": r.walk_info(),
        }
        for name, c in (("single", r._match_cache_obj),
                        ("sharded", r._sharded_cache_obj)):
            if c is not None:
                st = c.stats()
                st["hit_rate"] = round(st["hit_rate"], 4)
                out[name] = st
        if r._match_cache_obj is None and r._sharded_cache_obj is None:
            out["state"] = ("disabled" if not r.config.match_cache
                            or r.config.match_cache_slots <= 0
                            else "cold (no device match yet)")
        return json.dumps(out, indent=2)

    def _retained(self, args) -> str:
        """One-stop retained-path diagnosis (docs/OBSERVABILITY.md
        "Retained replay"): the store/replay counters (entries,
        tombstones, dropped/expired, replay batches + last batch
        size) and the reverse index's device state (live/deep rows,
        capacity, epoch, dirty-row backlog, breaker/suspension
        fallback, walk variant)."""
        mod = self.node.modules._loaded.get("retainer") \
            if hasattr(self.node, "modules") else None
        if mod is None:
            return "retainer module not loaded"
        out = mod.replay_info()
        idx = mod._index
        info = idx.device_info()
        # the JAX package's keys, in its order; the walk variant is the
        # device's (cuda | torch)
        out["index"] = {k: info[k] for k in _INDEX_KEYS}
        out["index"]["walk"] = ("cuda" if idx.device.type == "cuda"
                                else "torch")
        return json.dumps(out, indent=2)

    def _telemetry(self, args) -> str:
        tel = getattr(self.node, "telemetry", None)
        if tel is None:
            return "telemetry not available on this node"
        if not args or args[0] == "stages":
            if not tel.enabled:
                return "telemetry: disabled ([telemetry] enabled = false)"
            from emqx_tpu_torch.telemetry import STAGES
            stats = tel.stage_stats()
            lines = [f"{'stage':<14}{'count':>8}{'p50_ms':>10}"
                     f"{'p95_ms':>10}{'p99_ms':>10}"]
            for s in STAGES:
                st = stats[s]
                lines.append(f"{s:<14}{st['count']:>8}"
                             f"{st['p50_ms']:>10.3f}"
                             f"{st['p95_ms']:>10.3f}"
                             f"{st['p99_ms']:>10.3f}")
            lines.append(f"spans: {tel.spans_total}  slow: "
                         f"{tel.slow_total} (threshold "
                         f"{tel.config.slow_threshold_ms}ms)")
            return "\n".join(lines)
        if args[0] == "slow":
            recs = tel.slow_records()
            return json.dumps(recs, indent=2) if recs else "(none)"
        if args[0] == "reset":
            tel.reset()
            return "ok"
        raise ValueError(f"bad subcommand: {args[0]}")

    def _log(self, args) -> str:
        import logging
        root = logging.getLogger("emqx_tpu_torch")
        if not args or args[0] == "show":
            return f"level: {logging.getLevelName(root.level)}"
        if args[0] == "set-level":
            if len(args) < 2:
                raise ValueError("set-level needs a level")
            level = getattr(logging, args[1].upper(), None)
            if not isinstance(level, int):
                raise ValueError(f"bad level: {args[1]}")
            from emqx_tpu_torch.logger import set_level
            set_level(level)
            return f"level: {logging.getLevelName(root.level)}"
        raise ValueError(f"bad subcommand: {args[0]}")

    def _listeners(self, args) -> str:
        out = []
        for lst in self.node.listeners:
            out.append({
                "name": lst.name,
                "bind": f"{lst.host}:{lst.port}",
                "tls": lst.ssl_context is not None,
                "zone": lst.zone.name,
                "current_connections": lst.current_connections(),
                "max_connections": lst.max_connections,
            })
        return json.dumps(out, indent=2)

    def _cluster(self, args) -> str:
        cl = getattr(self.node, "cluster", None)
        if cl is None:
            return ("clustering not enabled "
                    "(set [node] cluster_port in the config, or "
                    "attach a Cluster)")
        if not args or args[0] == "status":
            peers = {}
            book = getattr(cl.transport, "addr_book", None)
            if book is not None:
                peers = {k: f"{v[0]}:{v[1]}" for k, v in book().items()}
            # per-member failure-detector health (docs/CLUSTER.md):
            # state (ok/suspect/down), last heartbeat RTT, detector
            # transitions since state entry; plus the anti-entropy
            # sweep/repair summary
            health = {}
            for name, h in cl.transport.health_info().items():
                rtt = h.get("rtt_ms")
                health[name] = {
                    "state": h["state"],
                    "rtt_ms": round(rtt, 3) if rtt else None,
                    "misses": h.get("misses", 0),
                    "since": h.get("since"),
                    "departed": h.get("departed", False),
                }
            ae = cl.ae_info()
            return json.dumps({"node": cl.name,
                               "members": sorted(cl.members),
                               "addresses": peers,
                               "health": health,
                               "anti_entropy": ae}, indent=2)
        if args[0] == "join":
            import asyncio
            import threading

            host, _, port = args[1].rpartition(":")
            host = host or "127.0.0.1"
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                cl.join_remote(host, int(port))  # management shell
                return f"joined; members: {sorted(cl.members)}"
            # called ON the serving loop: join_remote blocks on
            # network calls (up to the transport timeout per member)
            # — run it on a worker so MQTT serving never stalls
            threading.Thread(
                target=lambda: cl.join_remote(host, int(port)),
                daemon=True, name="ctl-cluster-join").start()
            return ("join started in background; "
                    "run 'cluster status' to confirm")
        if args[0] == "leave":
            cl.leave()
            return "left the cluster"
        raise ValueError(f"bad subcommand: {args[0]}")

    def _vm(self, args) -> str:
        from emqx_tpu_torch import vm
        return json.dumps(vm.get_system_info(self.node.device), indent=2,
                          default=str)

    def _status(self, args) -> str:
        n = self.node
        return (f"node: {n.name}\n"
                f"connections: {n.cm.connection_count()}\n"
                f"sessions: {n.cm.session_count()}\n"
                f"topics: {len(n.router.topics())}")

    def _broker(self, args) -> str:
        from emqx_tpu_torch import __version__
        from emqx_tpu_torch.sys_topics import SYSDESCR
        return f"{self.node.name} {__version__} — {SYSDESCR}"

    def _clients(self, args) -> str:
        cm = self.node.cm
        if not args or args[0] == "list":
            return "\n".join(cm._channels) or "(none)"
        if args[0] == "show" and len(args) > 1:
            chan = cm.lookup_channel(args[1])
            if chan is None:
                return "not found"
            return json.dumps(dict(chan.clientinfo), default=str)
        if args[0] == "kick" and len(args) > 1:
            return "ok" if cm.kick_session(args[1]) else "not found"
        return "usage: clients list | show <id> | kick <id>"

    def _sessions(self, args) -> str:
        return str(self.node.cm.session_count())

    def _topics(self, args) -> str:
        return "\n".join(sorted(self.node.router.topics())) or "(none)"

    def _subs(self, args) -> str:
        if args and args[0] == "show" and len(args) > 1:
            chan = self.node.cm.lookup_channel(args[1])
            if chan is None or chan.session is None:
                return "not found"
            return json.dumps({f: o.to_dict()
                               for f, o in chan.session.subscriptions.items()})
        out = []
        for cid, chan in self.node.cm._channels.items():
            if getattr(chan, "session", None):
                for f in chan.session.subscriptions:
                    out.append(f"{cid} -> {f}")
        return "\n".join(out) or "(none)"

    def _metrics(self, args) -> str:
        return "\n".join(f"{k:<40} {v}"
                         for k, v in self.node.metrics.all().items() if v)

    def _stats(self, args) -> str:
        return "\n".join(f"{k:<30} {v}"
                         for k, v in self.node.stats.all().items())

    def _routes(self, args) -> str:
        out = []
        for t in self.node.router.topics():
            for r in self.node.router.lookup_routes(t):
                out.append(f"{r.topic} -> {r.dest}")
        return "\n".join(out) or "(none)"

    def _plugins(self, args) -> str:
        p = self.node.plugins
        if not args or args[0] == "list":
            return "\n".join(f"{d['name']} ({'active' if d['active'] else 'inactive'})"
                             for d in p.list()) or "(none)"
        if args[0] == "load" and len(args) > 1:
            return "ok" if p.load(args[1]) else "already loaded"
        if args[0] == "unload" and len(args) > 1:
            return "ok" if p.unload(args[1]) else "not loaded"
        return "usage: plugins list | load <name> | unload <name>"

    def _banned(self, args) -> str:
        b = self.node.broker.banned
        if not args or args[0] == "list":
            return "\n".join(f"{r.who[0]}:{r.who[1]} until={r.until}"
                             for r in b.info()) or "(none)"
        if args[0] == "add" and len(args) >= 3:
            dur = float(args[3]) if len(args) > 3 else None
            b.create(args[1], args[2], duration=dur)
            return "ok"
        if args[0] == "del" and len(args) >= 3:
            b.delete(args[1], args[2])
            return "ok"
        return "usage: banned list | add <kind> <value> [secs] | del <kind> <value>"

    def _reload(self, args) -> str:
        """The diff-based live reload (``reload.py``): re-parse and
        validate the file in full, then all-or-nothing — a boot-only
        edit rejects the whole reload with a per-knob report; otherwise
        the zones re-publish and every changed reloadable knob applies."""
        from emqx_tpu_torch.config import load_config
        from emqx_tpu_torch.reload import apply_reload

        if len(args) != 1:
            return "usage: reload <config.toml>"
        info = apply_reload(self.node, load_config(args[0]))
        if info["rejected"]:
            lines = ["reload rejected (boot-only changes; nothing "
                     "applied):"]
            for r in info["rejected"]:
                lines.append(f"  {r['knob']}: {r['old']!r} -> "
                             f"{r['new']!r} ({r['reason']})")
            return "\n".join(lines)
        out = f"zones reloaded: {', '.join(info['zones']) or '(none)'}"
        if info["listeners"]:
            out += f"; listeners rebound: {', '.join(info['listeners'])}"
        if info["stale"]:
            out += (f"; stale (no longer in config, kept): "
                    f"{', '.join(info['stale'])}")
        for a in info["applied"]:
            out += f"\napplied: {a['knob']} {a['old']!r} -> {a['new']!r}"
        return out

    def _drain(self, args) -> str:
        """Graceful drain control (drain.py, docs/OPERATIONS.md)."""
        dr = self.node.drain
        if not args or args[0] == "status":
            return json.dumps(dr.info(), indent=2)
        if args[0] == "start":
            target = ref = None
            rest = list(args[1:])
            while rest:
                flag = rest.pop(0)
                if flag == "--target" and rest:
                    target = rest.pop(0)
                elif flag == "--ref" and rest:
                    ref = rest.pop(0)
                else:
                    raise ValueError(f"bad drain option: {flag}")
            dr.start(target=target, ref=ref)
            return json.dumps(dr.info(), indent=2)
        if args[0] == "stop":
            dr.stop()
            return json.dumps(dr.info(), indent=2)
        raise ValueError(f"bad subcommand: {args[0]}")

    def _checkpoint(self, args) -> str:
        from emqx_tpu_torch import checkpoint
        if len(args) != 2 or args[0] not in ("save", "load"):
            return "usage: checkpoint save|load <path>"
        if args[0] == "save":
            info = checkpoint.save(self.node.router, args[1])
            return (f"saved {info['routes']} routes"
                    f"{' + tables' if info['tables'] else ''}")
        info = checkpoint.load(self.node.router, args[1])
        return (f"restored {info['routes']} routes"
                f"{' + tables' if info['tables_restored'] else ''}")

    def _trace(self, args) -> str:
        tr = self.node.tracer
        if not args or args[0] == "list":
            return "\n".join(f"{k}:{v}" for k, v in tr.lookup_traces()) \
                or "(none)"
        if args[0] == "start" and len(args) >= 3:
            kind = "clientid" if args[1] == "client" else "topic"
            tr.start_trace(kind, args[2])
            return "ok"
        if args[0] == "stop" and len(args) >= 3:
            kind = "clientid" if args[1] == "client" else "topic"
            return "ok" if tr.stop_trace(kind, args[2]) else "not found"
        if args[0] == "export" and len(args) >= 2:
            # drain any spans still sitting in the per-thread rings
            # first, so a just-published message's chain is complete
            trc = self.node.tracing
            trc.drain_tick(self.node.stats)
            n = trc.export(args[1])
            return (f"exported {n} trace events to {args[1]} "
                    f"(Chrome trace-event JSON — chrome://tracing, "
                    f"Perfetto)")
        return ("usage: trace list | start client|topic <v> | "
                "stop client|topic <v> | export <path>")

    def _slow_subs(self, args) -> str:
        trc = self.node.tracing
        if args and args[0] == "reset":
            trc.slow.reset()
            return "ok"
        # fold anything pending so the ranking reflects now
        trc.drain_tick(self.node.stats)
        rows = trc.slow.top()
        if not rows:
            return ("(none traced — slow_subs ranks sampled "
                    "deliveries; set [tracing] sample_rate > 0)")
        cfg = trc.config
        lines = [f"{'clientid':<24}{'avg_ms':>10}{'max_ms':>10}"
                 f"{'flushes':>9}{'age_s':>7}"]
        now = time.time()
        for cid, avg, mx, n, last in rows:
            lines.append(f"{cid:<24}{avg:>10.2f}{mx:>10.2f}"
                         f"{n:>9}{now - last:>7.0f}")
        lines.append(f"threshold {cfg.slow_subs_threshold_ms:g}ms, "
                     f"expiry {cfg.slow_subs_expiry_s:g}s, "
                     f"tracked {len(trc.slow.clients)}")
        return "\n".join(lines)
