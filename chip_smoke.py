#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``emqx_tpu_torch``) on one GPU.

Drives the port's single-GPU paths — publish → match → dispatch, the
retained store with subscribe-time replay, and both again through the
MQTT front door over loopback sockets — and holds its hand-written
kernels against their plain PyTorch versions:

  1. environment: torch / CUDA versions and the card's name and power
     limit (``nvidia-smi``);
  2. build: compiles ``emqx_tpu_torch/csrc/*.cu`` (one ``nvcc`` per
     source, in parallel) and prints the build seconds and the
     compiler's register report; then the host library
     (``csrc/host_native.cpp``, ``g++``: the router's trie, flatten
     and encoder, and the frame scanner) and its seconds;
  3. B1 (the NFA walk) against the plain walk, byte for byte: the
     1M-filter narrow automaton of phase 5 (built by the native
     engine) at the main path's batch,
     a wide (chain-compressed) automaton, k ∈ {15, 16, 17, 32, 64}
     (both compaction orders and their edge) with ``pack_ids`` on and
     off, batches of 1 and 4,093 topics, tiny-k overflow, ``$SYS`` and
     too-deep topics; kernel, per-hop, whole-call device and plain
     times. Past the register instantiation's limits (the scratch-row
     one): k ∈ {65, 128, 200} on the main automaton, and L ∈ {65, 100}
     on the main automaton and a narrow deep one, with the k = 128 and
     L = 65 kernel times; and ``Broker(device="cuda")`` with
     ``active_k = 128``, and with ``max_levels = 80`` and 70-level
     topics, delivering what the TrieOracle gives;
  4. B2 (the bitmap OR of the packed union rows) against
     ``or_union_rows_ref``, bit for bit, on the slice batch with the
     most live row slots at the learned packed-row budget and at one
     below its live count (overflow), and packed from a dense shape
     (W = 32,768, B = 4,096, mb = 16) with an overflowing budget; the
     old route (B4's dense OR, then ``pack_union_rows``) against the
     packed launch on the main path's batch: equal, times and peak
     device memory; then B4 (the dense union, ``or_bitmaps_cuda``,
     ``csrc/bitmap_or_dense.cu``) and B2 run over every topic (B4's
     design before its own kernel) against ``or_bitmaps_ref``, bit for
     bit, on small edge shapes and, timed in turns with their bounds,
     at W = 32,768, B = 4,096 and mb = 1, 4 and 16 on the main path's
     bitmap table and on 64 distinct rows; B4's entry point
     ``or_bitmaps`` at mb = 16; kernel times and bounds;
  5. the slice: ``Node(device="cuda")``'s broker at BASELINE config 2's
     shape
     (1M ``+`` subscriptions over a 5-level tree of 40 words per level,
     10K literal, 10K ``#``, 10K ``$share`` subscriptions, 8 filters of
     4,096 subscribers on the bitmap path), batches of Zipf(1.1) topics
     through ``publish_begin`` / ``publish_fetch`` / ``publish_finish``
     (what ``publish_batch`` runs); asserts every batch took the device
     path and launched both kernels, checks every batch's per-message
     (subscriber, filter) sets against a host ``TrieOracle`` of the
     same filters, built apart from the router's engine, and prints
     msgs/s, p50/p99 batch latency, the overflow-row share, the
     phase's peak device memory and the subscribe / build seconds —
     twice on the same batches: on a node at the defaults (the native
     engine, match cache, delta automaton and pre-serialization on;
     with the cache hit rate), and, after phases 8 and 7a, on a second
     node with the same subscriptions in the plain configuration, the
     path before the host engines (``match_cache=False, delta=False,
     use_native=False, preserialize=False``: the Python trie and
     flatten, timed), which then runs 8b once more on its Python
     engine with 8b's draws;
  6. the retained slice: ``Node(device="cuda")`` with ``RetainerModule``
     at its defaults stores 1,000,000 retained messages
     (``s{i % 499}/g{(i // 499) % 97}/d{i}/state``) through
     ``broker.publish_batch``, then replays 8 bursts of 64
     subscriptions inside one asyncio loop, each subscription a
     SUBSCRIBE handed to its own sans-IO ``Channel`` (taking wire bytes,
     as a socket's does), then each channel's ``handle_deliver``;
     asserts per burst one replay batch, one B3 launch and every
     session's deliveries equal to the stored names its filter matches
     (8 filters of the first burst also against the host ``T.match``
     scan); the same bursts with ``preserialize`` on, then off
     (:data:`REPLAY_ORDER`), every subscriber's wire bytes equal in
     every run; prints store and
     upload seconds, p50/p99 replay latency (to the last wire byte),
     with and without the collector's pauses, subscriptions/s, the
     on-loop serialize count (``delivery.serialize.onloop``) and the
     bytes fetched per burst, per setting over its two runs;
     Then B3 (the retained match) against the plain
     ``match_names_many``, bit for bit, on the 1M-name index at F = 32
     and F = 64 and on small indexes with ``$`` names, 20-level names,
     dead rows, UNKNOWN filter words and ragged F, at caps of 4·k + 1,
     4·k + 2 and 4·k + 3 with F = 1, 5 and 130, and on random rows;
     kernel and plain times and the bound from the run's filters;
  7. the front door on the card, on the nodes phases 5 and 6 built:
     (7a) a listener on phase 5's node and 2,000 TCP connections over
     loopback in this process (1,000 subscribers, half MQTT v4 and half
     v5, each at QoS 1 on one config-2 ``+`` filter and one big
     literal filter; 1,000 publishers sending QoS 1 PUBLISHes, 5 each
     in the timed window, cut from the fleet's 20 to hold the run's
     time, topics Zipf(1.1) with seed 0, the send time in the payload);
     before the fleet, an open-loop burst into the ingress batcher in
     one loop step (every pipeline slot busy, the largest batch
     reached), its acks' order and every delivery checked;
     every socket delivery checked against the TrieOracle; CONNACKs/s,
     delivered msgs/s, publish→delivery and PUBACK latencies, the
     deliveries serialized on the loop (pre-serialization on), the
     ingress batcher's device batches, the B1 and B2 launches of the
     socket path and the device idle share over a profiled window;
     then 200 of the fleet's connections through a second listener
     with the native frame parser (``frame="native"``), every
     delivery against the TrieOracle and every packet the clients
     sent framed by the C parser (``frame.native.frames``);
     (7b) a listener on phase 6's node and 8 bursts of 64 live clients,
     each a CONNECT then a SUBSCRIBE, with ``preserialize`` in
     :data:`REPLAY_ORDER`; every replayed message checked against the
     name family and every client's received bytes equal in every run;
     SUBACK-to-last-retained and per-burst p50/p99, subscriptions/s,
     the on-loop serialize count and the B3 launches;
  8. route churn at full width, on phase 5's node: (8c) patch in
     place (``delta=False``): 1,000 adds and deletes of matching
     filters, the drains' times and the bytes each clones, one drain
     on the card against the same drain on CPU copies, parity, then
     ``set_delta(True)``; the delta walk on B1 against the plain walk
     (k = ``snap.k`` and 1), 2 B1 launches on a batch with pending
     delta adds, the cache's insert and merge, the tombstone mask and
     the packed union on the card against the CPU, with their device
     times and the host probe's; (8a) the reference's churn bench
     (``bench.py:1701-1960``): batches of 256 Zipf(1.1) topics through
     ``Router.match_ids`` without churn and under a churner at 10,000
     route ops/s (strict add→delete pairs) for ``churn/{i}/leaf``,
     ``+/churnrw/{i}`` and ``$share/churngrp/churnsh{i}/leaf``: p50/p99
     both ways, the achieved rate, the cache hit rate and the route-op
     p99, every result against the TrieOracle of the static set;
     (8b) 4,096 matching filters cross ``delta_max_filters``: match
     batches and route ops (deletes of frozen filters, new adds)
     during the off-lock flatten, parity during and after the swap,
     the flatten seconds, lock stall and peak device memory — on the
     native engine here, and again on the plain node's Python engine
     with the same draws (phase 5's second run), the two printed side
     by side; (8d) :data:`P8D_BATCHES`
     publish batches of 4,096 through the broker with 64 subscribers
     in and 64 out between batches, every delivery against the
     oracle, no re-flatten, the fan-out rebuild
     (``FanoutManager.state``) timed apart;
  9. the device-path breaker and device-loss recovery (every node runs
     the default ``OverloadConfig``; phases 5-8 and 6-7b each assert
     and print 0 breaker trips, 0 fallback batches, 0 injected faults,
     and the retained node 0 failed retained matches; the phase 7
     clients retry a CONNECT refused with ServerBusy and each socket
     phase prints the monitor's transitions, what it shed and the
     refusals), with the breaker's cooldown and first rebuild backoff
     cut to :data:`P9_COOLDOWN_S` and :data:`P9_BACKOFF_S` (printed):
     (9a) on phase 5's node, 20 fresh batches: ``device.fetch`` armed
     for 3 batches, served exactly from the host trie, the breaker
     opens with its alarm; 2 batches while open launch neither B1 nor
     B2; after the cooldown the probe launches both and closes it;
     host-served against device batch latency; (9b) ``device.lost``
     armed: 3 failed begins trip it, the sentinel classifies the card
     lost, rebuild attempts fail; disarmed, the 1.02M-filter rebuild
     and the re-warm run while a churner issues route ops and
     1,024-message batches are host-matched; the probe closes it;
     rebuild seconds, re-warm ms and launches, route-op p99, the first
     live batch after recovery; every message of every batch against
     the TrieOracle; (9c) on phase 6's node: a burst while the router
     is suspended is served by the host scan, then the rebuild, then a
     burst launches B3, both exact; (9d) ``sentinel_alive`` on the
     card, timed;
 10. crash-consistent durability at full width
     (``DurabilityConfig(enabled=True, fsync=True)``, every other field
     at the JAX default, the directory on the checkout's disk; its
     filesystem must not be a tmpfs): (10a) a durable
     ``Node(device="cuda")`` with ``RetainerModule``; phase 5's filters
     (cut to :data:`P10_ROUTES`, the '+' class cut, every other class
     whole; printed) held by 4,096 persistent sessions
     (``clean_start=False``, expiry 3,600 s, QoS 1, each with the 8 big
     filters), its 10,000 ``#`` filters on clean subscribers, then
     :data:`P10_NAMES` retained messages (cut from 1M; printed), all
     journaled; (10b) the first :data:`P10_BATCHES` of phase 5's 20
     batches as QoS 1 (cut to hold the run's time; printed), every
     session acking but 64 on the last batch, a full checkpoint after
     half of them, then 256 subscribe/unsubscribe ops and a delta
     checkpoint;
     (10c) the kill -9 analogue, half a frame appended to the newest
     journal, the node dropped; (10d) a fresh node recovers the
     directory: routes equal the pre-crash table less the clean refs,
     4,096 sessions, the retained store exact, the 64 sessions resumed
     through a sans-IO CONNECT get session-present and every unacked
     message with DUP, the first :data:`P10_REPEAT` of those batches
     again against a TrieOracle of the recovered subscriptions (B1 and
     B2 on the recovered node); (10e) :data:`P10_BURSTS` replay bursts
     through B3 on the recovered store; (10f)
     ``set_delta(False)``, ``checkpoint.save``, and ``checkpoint.load``
     into a fresh ``delta=False`` router: the tables placed on the card
     with no flatten, B1 walking them equal to the oracle;
 11. observability at the JAX package's defaults (every node above runs
     with telemetry spans on, tracing built at rate 0, the ``$SYS``
     heartbeat every 60 s, the host monitors and the forced-GC policy):
     phase 5 checks every batch's span (closed once, its tags the
     broker's own counts) and prints each stage's count, p50 and p99,
     then runs its batches with a disabled ``Telemetry`` and with the
     node's, in the order of :data:`AB_RUNS`: equal deliveries, msgs/s and p99 both
     ways; phase 3 times B1's whole call with ``profiling.KernelTimer``;
     on phase 5's node after 7a, with its listener up: (11a) one
     heartbeat with a ``$SYS/brokers/#`` subscriber (the topic set, the
     heartbeat's ms and B1 launches, the stats flush's ms at 1.06M
     subscriptions), (11b) one Prometheus scrape over loopback (the
     stage histograms, ``emqx_subscriptions_count`` equal to the
     broker's), (11c) 200 connections of 5 QoS 1 PUBLISHes each at
     sample rate 0.05 (every delivery against the TrieOracle, every
     sampled chain complete, the slow-subscriber rows, the export
     loaded); every phase with a node prints the collections the
     connections' ``GcPolicy`` forced and the node's ``sysmon.long_gc``.

 12. the device mesh on the card (``parallel/``), on phase 5's
     subscriptions cut to :data:`P12_ROUTES` filters (the '+' class
     cut, every other class whole; printed) and its batches, one node
     at a time, after the plain node: (12a) ``MatcherConfig(mesh=default_mesh())``, 1×1
     on the one card, B1 and B4 (the dense union) once a batch and B2
     never, every message's deliveries equal phase 5's node's and the
     TrieOracle's, msgs/s and p50/p99 beside phase 5's; (12b) a 2×2
     mesh naming the card four times (:data:`MESH_GRID`): B1 and B4
     four times a batch (one a cell), deliveries equal 12a's; per cell,
     B1 on the cell's data shard and trie shard against the plain walk
     and B4's dense union against the plain OR, with their device times
     and B2 run over every topic on the same rows beside B4; one subscribe
     patches its shard alone, then 256 route ops with no full rebuild
     and a batch against the TrieOracle; on a small 2×2 broker, a
     fan-only overflow grows d and not k; 12a and 12b print the idle
     share of three batches under the profiler. Its time against
     :data:`P12_BUDGET_S` is printed; 12a drives :data:`P12A_BATCHES`
     and 12b :data:`P12B_BATCHES` of phase 5's batches (printed).
 13. the cluster on the card (``cluster.py``, ``cluster_net.py``,
     ``cm_locker.py``), after phase 12, its time against
     :data:`P13_BUDGET_S` printed: (13a) two port nodes on the card in
     this process over ``SocketTransport`` on loopback (the JAX
     package's ``ClusterConfig`` defaults), phase 5's
     subscriptions cut to :data:`P13_ROUTES` filters (the '+' class cut,
     every other class whole; printed) and split by subscriber over the
     nodes, so each router holds every filter and each node about half
     of every big filter's members; route replication seconds (to every
     route on both routers and equal plane digests) and routes/s, with
     the detector's and anti-entropy's counters meanwhile; phase 5's batches published on the two nodes in turn:
     each batch launches B1 and B2 once on its publishing thread and
     nothing runs off it (a forwarded message is dispatched by its
     matched filter on the host), every message's deliveries on both
     nodes against a TrieOracle of 13a's filters (one member a shared
     group cluster-wide) and against phase 5's, ``messages.forward``
     against the oracle's (message, remote node, filter) count, equal
     plane digests, 0 forwards dropped; msgs/s and p50/p99 beside phase
     5's, forwarded publish→delivery p50/p99, the cast buffers' peak,
     peak device memory, each node's B1 and B2 against their plain twins
     with device times; (13b) :data:`P13_RETAINED` retained messages
     stored on node 0 reach node 1's store and index through
     ``retain_set``; a burst of :data:`P13_BURST` SUBSCRIBEs on node 1
     replays through one B3 launch on its own index, equal to node 0's
     replay of the same filters; (13c) a persistent QoS 1 session with
     :data:`P13_TAKEOVER_FILTERS` subscriptions taken over from node 0 to
     node 1 between rounds of QoS 1 traffic on both nodes: no message
     lost, none twice without DUP, its routes on node 1 on both nodes,
     the next batch on either node delivering to it through B1; (13d)
     the JAX partition bench's plan on three nodes at its config and
     3,000 routes: ``net.partition`` splits {n0, n1} from {n2} with
     churn on both sides, then heals: the detection and the heal to
     equal digests, in seconds, and the forwards dropped.
 14. replicated durability and the drain on the card
     (``replication.py``, ``drain.py``), after phase 10, its time against
     :data:`P14_BUDGET_S` printed, each driven path's launches counted
     from 0: (14a) the JAX failover bench's plan (bench.py:2495-2609) on
     two port nodes on the card over ``SocketTransport`` on loopback
     (:data:`FAILOVER_BENCH`: the bench's ``ClusterConfig`` with a
     steadier detector, printed): fb0 durable (``standby="fb1"``,
     ``wal_shards=4``), both with the retainer; :data:`P14_SESSIONS`
     persistent QoS 1 sessions, each with
     ``fb/<i>/+`` and the wide :data:`P14_WIDE` (a filter of 5,000
     subscribers: B2's path), :data:`P14_RETAINED` retained messages
     (13b's store, not the bench's 100); flush and ship, kill fb0;
     failover and promotion seconds, ``rpo_records`` 0 and
     ``durable_digest`` equal to fb0's pre-kill digest; on fb1 a batch
     of ``--batch`` publishes to the adopted filters launches B1 and B2
     once, every delivery against a TrieOracle of the adopted
     sessions, and a burst of :data:`P14_BURST` SUBSCRIBEs replays the
     adopted store through one B3 launch, equal to the host scan; B1,
     B2 and B3 on the adopted tables against their plain twins; (14b)
     failback (bench.py:2610-2660): a post-promotion retained message,
     fb0 restarted from its directory, demotion and resync,
     ``failback_s`` and the hand-off seconds, ``durable_digest`` equal
     to fb1's pre-failback digest, none of the handed routes left on
     fb1, a batch on fb0 through B1 and B2 delivering to the handed-back
     sessions; (14c) the JAX drain bench (emqx_tpu/bench_live.py:953-1063):
     two durable nodes, each the other's standby (``ack_quorum=1``),
     :data:`P14_DRAIN_SESSIONS` detached sessions on ``bench/<i % 97>/+``
     (cut from the bench's 5,000; printed) and :data:`P14_DRAIN_LIVE`
     live v5 clients on bd0 with persistent sessions on
     :data:`P14_DRAIN_LIVE_TOPIC` at QoS 1, waves of
     :data:`P14_DRAIN_WAVE`; a CONNECT meanwhile gets 0x9C with the
     Server-Reference; publishes on bd1 during the live sessions'
     finalize; time-to-empty, sessions/s, the wave p99, 50
     redirected, every session handed off, the digest equal with one
     holder; the live clients resume on bd1 with their sessions, none
     lost, and the repeats without DUP printed on their own line, 0
     (fault C.9); a batch on bd1 through B1 (:data:`P14_DRAIN_DEVICE_MIN`)
     delivering to the handed sessions; bd0's stop with its target set
     sends 0x9C and the reference.
 15. the access plane and the built-in modules (``banned.py``,
     ``flapping.py``, ``modules/``), its time against
     :data:`P15_BUDGET_S` printed: (15a) on phase 5's node after 9b,
     ``load_default_modules()`` (delayed, the file ACL, the retainer),
     then rewrite (:data:`P15_REWRITE`), topic_metrics on
     :data:`P15_METERED` topics of batch 0 and presence;
     :data:`P15_BATCHES` of phase 5's batches with every topic under
     :data:`P15_PREFIX` (a cold match cache first): B1 and B2 on every
     batch, every delivery against the TrieOracle of the rewritten
     topics, topic_metrics' in/out against the oracle's counts, msgs/s
     and p50/p99 beside phase 5's; then :data:`P15_DELAYED` messages
     ``$delayed/1/<topic>``: held (``messages.delayed``), nothing
     delivered, ``tick(now + 2)`` republishes each alone, one B1 launch
     a message, the deliveries against the oracle, ms a message;
     (15b) a listener on the same node with ``enable_flapping_detect``
     and :data:`P15_RETAINED` retained names: a banned clientid gets
     CONNACK 0x8A, a client closing ``max_count`` times is auto-banned
     and refused, a drained one is not counted; then the subscription
     module (its auto-subscription checked), and a non-local client
     (:data:`P15_NONLOCAL`) under the default ACL rules is denied
     ``$SYS/#`` in its SUBACK while its wildcard filters replay through
     B3, equal to the host match, a presence event arrives; B1, B2 and
     B3 on the node's tables against their plain twins; (15c) inside
     13d's cluster after the heal: a ban on one node held on every node
     with equal non-empty ``bans`` digests, a CONNECT of that clientid
     on another node refused, a delete on a third clearing it
     everywhere.
 16. the operations surface and the secure front door (``ctl.py``,
     ``plugins.py``, ``vm.py``, the module-level API, ``tls.py``,
     ``psk_tls.py``, ``ws_connection.py``), on phase 5's node right after
     phase 15, its time against :data:`P16_BUDGET_S` printed: (16a)
     ``profile start <dir>``, one of phase 5's batches (a cold match
     cache), ``profile stop``: the Chrome trace holds the batch's B1 and
     B2 launches; every ``ctl`` command (all of the JAX ``Ctl``'s;
     ``reload`` without a file prints its usage, 17a reloads files), ``status``'s topic count, ``routes``' line count,
     ``listeners``, ``cache``'s hit rate, ``retained``'s device epoch
     and ``vm``'s card and ``bytes_limit`` checked against the node;
     ``Router.match_routes`` on :data:`P16_MATCH_ROUTES` of phase 5's
     topics against the oracle, B1 a call; ``emqx_tpu_torch.subscribe``
     of :data:`P16_API_FILTERS` filters on the default broker (built on
     the card) and :data:`P16_API_PUBLISHES` ``emqx_tpu_torch.publish``
     calls, each count the oracle's, B1 on each; a plugin discovered
     from ``chip_smoke:OpsPlugin`` with its ``<config_dir>/<name>.toml``
     env through ``ctl plugins``; (16b) TLS (the committed test
     certificates, ``peer_cert_as_username="cn"``), WSS, WS and PSK-TLS
     (the native engine) listeners, :data:`P16_CONNS` connections each
     (7a's shape: half subscribers at QoS 1 on a config-2 '+' filter
     and a big literal filter, half publishers of :data:`P16_PUBS` QoS 1
     PUBLISHes of Zipf(1.1) topics, seed 0): every delivery against the
     oracle, connects/s with the handshake, publish→delivery and PUBACK
     p50/p99 and B1/B2 launches per listener; a retained SUBSCRIBE on
     each secure listener replayed through B3 (:data:`P16_REPLAY`); a
     client certificate's CN as the username; a listener with
     ``max_connections = 2`` refusing the third connect; ``ctl
     listeners`` with the TLS flags; B1, B2 and B3 on the node's tables
     against their plain twins; then (16a) ``set_delta(False)``, ``ctl
     checkpoint save`` of the node's router with its tables and ``ctl
     checkpoint load`` into a fresh ``delta=False`` node, both timed,
     and one of phase 5's batches on the loaded tables against the
     oracle, B1 and B2 counted. Each kernel row carries
     ``ops_launches`` (16a, 16b).
 17. the multi-loop front door, the worker pool and the config-file
     boot (``loops.py``, ``workers.py``, ``config.py``, ``reload.py``,
     ``__main__.py``), after phase 13 with one 1.02M-filter node alive at
     a time, its time against :data:`P17_BUDGET_S` printed: (17a) a TOML
     file (``[node] loops = 4``, one tcp listener on port 0,
     ``[modules.retainer]``) booted with ``boot_from_file(path,
     device="cuda")``; phase 5's subscriptions (1.02M filters) and
     :data:`P17_RETAINED` retained names; :data:`P17_CONNS` connections,
     100 a loop (7a's shape: half subscribers at QoS 1 on a config-2 '+'
     filter and a big literal filter, half publishers of
     :data:`P17_PUBS` QoS 1 PUBLISHes of Zipf(1.1) topics, seed 0): every
     delivery against the TrieOracle, msgs/s, publish→delivery and
     PUBACK p50/p99, the delivery ring's handoffs and deliveries with 0
     orphaned, B1 and B2 launched; a retained SUBSCRIBE on each peer
     loop (:data:`P17_REPLAY`) replayed through B3 launched on that
     loop's thread (``ThreadLaunches``); a persistent session with
     :data:`P17_BACKLOG` unacked QoS 1 messages taken over onto another
     loop, its backlog redelivered; the ``loop.<i>.lag_ms`` and
     ``loop.<i>.connections`` rows; ``ctl reload`` of an edited copy
     (``[telemetry] slow_threshold_ms``) applied with every client held,
     and of a copy with ``loops = 2`` rejected whole; no error on a peer
     loop; B1, B2 and B3 on the node's tables against their plain twins,
     0 trips; (17b) ``WorkerPool(2, port=0, device="cuda")``: 6
     subscribers × 3 publishes across the workers, one client id twice,
     a worker killed under traffic, then ``restart_worker`` rejoining the
     cluster, every delivery checked, each worker's seconds to READY;
     (17c) ``python -m emqx_tpu_torch --config`` as a process on the card
     (``loops = 2``, ``[durability] enabled``): a persistent session's
     queued QoS 1 messages survive a SIGTERM (exit 0 within
     :data:`P17C_TERM_S`) through the 2-shard journal, and a second boot
     from the same file and directory delivers them. Each kernel row
     carries ``loops_launches`` (17a).

The last two lines are one JSON object per kernel row
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``. Every
phase raises on failure; the script then exits non-zero. Without CUDA,
or without the ``emqx_tpu_torch`` package beside it, it exits non-zero
at once and prints no result.

    python3 chip_smoke.py                 # full size, one card
    python3 chip_smoke.py --subs 100000   # a smaller tree
    python3 chip_smoke.py --names 100000  # a smaller retained store
    python3 chip_smoke.py --conns 200 --pubs-per-conn 5   # a smaller fleet
    python3 chip_smoke.py --churn-iters 20   # shorter 8a passes
    python3 chip_smoke.py --sessions 1024    # fewer persistent sessions
    python3 chip_smoke.py --p14-sessions 1000 --p14-drain-sessions 1000
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import random
import signal
import subprocess
import sys
import time

from typing import Optional

import numpy as np

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet),
#: operations/s; the data sheet lists no int32 vector rate, and Hopper
#: has half as many int32 lanes as float32 ones, so integer work over
#: this rate is a loose lower bound
VECTOR_OPS_PER_S = 67e12
LEVELS = 5
VOCAB = 40
#: the kernels the publish path launches on every device batch
PUBLISH_KERNELS = ("walk", "bitmap_or")
#: the kernels a mesh node's publish path launches on every device
#: batch: B1 and B4, the dense union, in every cell
MESH_KERNELS = ("walk", "bitmap_or_dense")
#: QoS 1 PUBLISHes a publisher of the 2,000-connection fleet sends
FLEET_PUBS = 20
#: phase 7a's connections through the native frame parser
NATIVE_CONNS = 200
#: ``preserialize`` of the replay runs of phases 6 and 7b, in order;
#: cut from on, off, off, on to hold the run under 1,100 s on a slow
#: host (printed)
REPLAY_ORDER = (True, False)
#: CONNECTs the broker refused with ServerBusy (0x89; 3, server
#: unavailable, on MQTT 3.1.1) at critical overload, each retried
#: after a short back-off as a client library does: the socket
#: clients' and the sans-IO channels' of the replay bursts
REFUSED = {"connects": 0}
#: retries of one refused CONNECT before the phase fails
CONNECT_RETRIES = 100


async def refused_backoff(attempt: int) -> None:
    """Counts one refused CONNECT and waits before the retry."""
    REFUSED["connects"] += 1
    await asyncio.sleep(min(0.5, 0.05 * (attempt + 1)))


def log(*a) -> None:
    print(*a, flush=True)


class Sink:
    """A subscriber; while ``Sink.log`` is a list, it records
    ``(message id, sink id, filter)`` per delivery, and while
    ``Sink.stamps`` is one, ``(message id, sink id, host clock)``."""

    __slots__ = ("sid",)
    log = None
    stamps = None

    def __init__(self, sid: int) -> None:
        self.sid = sid

    def deliver(self, topic_filter, msg) -> None:
        if Sink.log is not None:
            Sink.log.append((msg.id, self.sid, topic_filter))
        if Sink.stamps is not None:
            Sink.stamps.append((msg.id, self.sid, time.perf_counter()))


# -- workload: BASELINE config 2's shape -----------------------------------

def _word(level: int, i: int) -> str:
    return f"w{level}_{i}"


def _unique_rows(rng, n, make):
    """``n`` distinct rows from ``make(count)`` (generation order)."""
    rows = make(3 * n + 64)
    key = np.zeros(len(rows), np.int64)
    for col in range(rows.shape[1]):
        key = key * (VOCAB + 2) + rows[:, col]
    _, first = np.unique(key, return_index=True)
    if len(first) < n:
        raise RuntimeError("workload generator: too few distinct filters")
    return rows[np.sort(first)[:n]]


def _join(row) -> str:
    out = []
    for level, i in enumerate(row):
        if i < 0:
            break
        out.append("+" if i == VOCAB else "#" if i == VOCAB + 1
                   else _word(level, int(i)))
    return "/".join(out)


def make_workload(rng, n_plus: int, n_other: int, n_big: int,
                  big_members: int):
    """Filter strings of every class (subscription order)."""
    def plus_rows(c):
        r = rng.integers(0, VOCAB, size=(c, LEVELS))
        r[np.arange(c), rng.integers(0, LEVELS, size=c)] = VOCAB
        return r

    def hash_rows(c):
        r = rng.integers(0, VOCAB, size=(c, LEVELS))
        d = rng.integers(1, LEVELS, size=c)       # '#' after 1..4 words
        r[np.arange(c), d] = VOCAB + 1
        r[np.arange(LEVELS)[None, :] > d[:, None]] = -1
        return r

    plus = [_join(r) for r in _unique_rows(rng, n_plus, plus_rows)]
    lit = [_join(r) for r in _unique_rows(
        rng, n_other, lambda c: rng.integers(0, VOCAB, size=(c, LEVELS)))]
    hsh = [_join(r) for r in _unique_rows(rng, n_other, hash_rows)]
    shared = [_join(r) for r in _unique_rows(rng, n_other // 4, plus_rows)]
    big = ["/".join([_word(i, 0) for i in range(LEVELS - 1)] + [f"big{j}"])
           for j in range(n_big)]
    return {"plus": plus, "literal": lit, "hash": hsh, "shared": shared,
            "big": big, "big_members": big_members}


def subscribe_all(broker, wl, rng):
    """Subscribe every class; returns the sinks, the drawable filters
    (inner filter strings, big filters at Zipf ranks 1000-1007 so a
    batch hits a few of them) and the ``(sink, filter)`` pairs in
    subscription order (:func:`subscribe_pairs` replays them)."""
    sinks, pairs = [], []

    def new_sink():
        s = Sink(len(sinks))
        sinks.append(s)
        return s

    for f in wl["plus"]:
        pairs.append((new_sink(), f))
    for f in wl["literal"] + wl["hash"]:
        pairs.append((new_sink(), f))
    for f in wl["shared"]:
        for _ in range(4):
            pairs.append((new_sink(), f"$share/g/{f}"))
    n_plus = len(wl["plus"])
    for f in wl["big"]:
        for i in rng.choice(n_plus, size=wl["big_members"], replace=False):
            pairs.append((sinks[int(i)], f))
    subscribe_pairs(broker, pairs)
    draw = wl["plus"] + wl["literal"] + wl["hash"] + wl["shared"]
    draw = [draw[i] for i in rng.permutation(len(draw))]
    at = min(1000, len(draw))
    draw[at:at] = wl["big"]
    return sinks, draw, pairs


def subscribe_pairs(broker, pairs) -> float:
    """``broker.subscribe`` every ``(sink, filter)`` pair in order;
    returns the seconds it took."""
    t0 = time.perf_counter()
    for sink, f in pairs:
        broker.subscribe(sink, f)
    return time.perf_counter() - t0


def route_oracle(router):
    """An independent host ``TrieOracle`` of ``router``'s live filter
    set (the router's own trie may be the native engine's, the thing
    under test)."""
    from emqx_tpu_torch.oracle import TrieOracle

    oracle = TrieOracle()
    with router._lock:
        filters = list(router._filter_ids)
    for f in filters:
        oracle.insert(f)
    return oracle


class OracleUnion:
    """Matches of several tries (a static set plus the filters a phase
    added)."""

    def __init__(self, *tries) -> None:
        self.tries = tries

    def match(self, topic: str):
        return [f for t in self.tries for f in t.match(topic)]


def encode_for(router, topics, L):
    """``(ids, n, sysm)`` of ``topics`` in the router's word-id space,
    from whichever engine it runs."""
    from emqx_tpu_torch.ops.tokenize import encode_batch

    with router._wt_lock:
        if router._native is not None:
            return router._native.encode_batch(topics, L)
        return encode_batch(router._table, topics, L)


def zipf_topics(rng, draw, n: int, a: float = 1.1):
    """``n`` topics: filters drawn Zipf(a) by rank, wildcards filled."""
    w = 1.0 / np.arange(1, len(draw) + 1, dtype=np.float64) ** a
    ranks = rng.choice(len(draw), size=n, p=w / w.sum())
    fill = rng.integers(0, VOCAB, size=(n, LEVELS))
    out = []
    for t, r in enumerate(ranks):
        ws = draw[int(r)].split("/")
        if ws[-1] == "#":
            # '#' matches the prefix plus 0 .. LEVELS-d more words
            d = len(ws) - 1
            extra = int(fill[t, 0]) % (LEVELS - d + 1)
            ws = ws[:-1] + [_word(d + j, int(fill[t, d + j]))
                            for j in range(extra)]
        out.append("/".join(_word(lv, int(fill[t, lv])) if w == "+" else w
                            for lv, w in enumerate(ws)))
    return out


# -- timing and bounds ------------------------------------------------------

def time_cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_events(prof):
    """The trace's device activities (kernels, copies), each once: an
    operator that launched a kernel reports the kernel's time as its
    own device time too, so operators are left out, and so are the
    profiler schedule's ``ProfilerStep`` annotation, a device-side span
    around each step's kernels, and :func:`flush_trace`'s kernel."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep") and _dev_us(e) > 0
            and FLUSH_KERNEL not in e.key]


#: torch.profiler (2.11, NVIDIA H100 80GB HBM3, 700 W) drops the first
#: kernel records of each trace window, none in a young process and more
#: the older it is (``scripts/torch_trace_window.py`` prints the count
#: against the age): their launches are in the trace, their kernels are
#: not, and a window that waits before its first launch drops as many.
#: So every window opens with this many launches of a tiny kernel of its
#: own (:func:`flush_trace`), which the readers of the trace leave out
TRACE_FLUSH = 1000
#: the kernel :func:`flush_trace` launches (``torch.cuda._sleep``'s)
FLUSH_KERNEL = "spin_kernel"
#: windows :func:`kernel_ms` traces at most before it keeps the fullest
TRACE_WINDOWS = 5


def flush_trace() -> None:
    """:data:`TRACE_FLUSH` launches of :data:`FLUSH_KERNEL` (a one-cycle
    spin), then a device sync: the records a new trace window drops are
    theirs."""
    import torch

    for _ in range(TRACE_FLUSH):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def traced(fn, iters, activities):
    """``iters`` calls of ``fn`` under torch.profiler, in a window that
    opens with :func:`flush_trace`."""
    import torch
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        flush_trace()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def kernel_ms(fn, name: str, iters: int = 20):
    """Device time of one launch of the kernel whose name contains
    ``name``, from torch.profiler's CUDA trace (the wrapper's host
    work and the torch ops around it excluded): the mean over the
    traced launches. Up to :data:`TRACE_WINDOWS` windows, CUDA and
    then CPU and CUDA activity in turn, are traced until one holds all
    ``iters`` launches; the fullest is kept, and the line says so when
    it holds fewer. Raises when none holds a launch."""
    import torch
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = (0, 0.0)
    for k in range(TRACE_WINDOWS):
        acts = ([ProfilerActivity.CUDA] if k % 2 == 0 else
                [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        hits = [e for e in traced(fn, iters, acts).key_averages()
                if name in e.key and _dev_us(e) > 0]
        n = sum(e.count for e in hits)
        if n > best[0]:
            best = (n, sum(_dev_us(e) for e in hits))
        if n >= iters:
            break
    n, us = best
    if not n:
        raise RuntimeError(f"torch.profiler traced no device time for "
                           f"{name} in {TRACE_WINDOWS} windows")
    if n < iters:
        log(f"[profile] {name}: the fullest of {TRACE_WINDOWS} traces "
            f"holds {n} of {iters} launches; the time is their mean")
    return us / n / 1e3


def kernel_timer_ms(fn, iters: int = 20) -> float:
    """p50 ms of ``fn()`` timed whole by ``profiling.KernelTimer``: the
    host clock from the call to the card's sync on its output (the
    JAX package's ``KernelTimer`` blocks on the output there)."""
    import torch

    from emqx_tpu_torch.profiling import KernelTimer

    kt = KernelTimer()
    torch.cuda.synchronize()
    for _ in range(iters):
        with kt.span("call") as done:
            done(fn())
    return kt.stats()["call"]["p50_ms"]


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: every kernel and copy it
    runs, from torch.profiler's CUDA trace (host time between launches
    excluded), in windows that open with :func:`flush_trace`. Up to
    :data:`TRACE_WINDOWS` windows, CUDA and then CPU and CUDA activity
    in turn, are traced until a second one holds as many device
    activities as the fullest so far (the trace loses launches, never
    adds them); the fullest is kept. Raises when none holds device
    time."""
    import torch
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = (0, 0.0)
    for k in range(TRACE_WINDOWS):
        acts = ([ProfilerActivity.CUDA] if k % 2 == 0 else
                [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        events = device_events(traced(fn, iters, acts))
        n = sum(e.count for e in events)
        if n > best[0]:
            best = (n, sum(_dev_us(e) for e in events))
        elif n and n == best[0]:
            break
    if not best[0]:
        raise RuntimeError(f"torch.profiler traced no device time in "
                           f"{TRACE_WINDOWS} windows")
    return best[1] / iters / 1e3


def walk_lanes(router, trie, topics, k: int, steps: int):
    """``(live, probing)`` lane-hops of a narrow walk of ``topics``
    (the padded batch), replayed on ``trie`` (a host TrieOracle of the
    router's filters): per hop, every live lane reads its state's
    node2 row and every lane that walks a word the router knows
    probes two bucket rows. A frontier past k keeps k lanes, so an
    overflow row's count is approximate."""
    lookup = (router._native.lookup if router._native is not None
              else router._table.lookup)
    max_levels = router.config.max_levels
    live = probing = 0
    for t in topics:
        ws = t.split("/")
        n = len(ws) if len(ws) <= max_levels else -1
        root_sys = ws[0].startswith("$")
        front = [trie.root]
        for s in range(steps):
            live += len(front)
            if s >= n:
                break  # ending (or too deep): no edge is walked
            known = lookup(ws[s]) >= 0
            nxt = []
            for node in front:
                if known:
                    probing += 1
                    child = node.children.get(ws[s])
                    if child is not None:
                        nxt.append(child)
                plus = node.children.get("+")
                if plus is not None and not (s == 0 and root_sys):
                    nxt.append(plus)
            front = nxt[:k]
            if not front:
                break
    return live, probing


def walk_bound_ms(B, L, steps, k, live, probing, row_bytes) -> float:
    """Least time for the walk's bytes: the batch words, lengths and
    flags read once, one node2 row per live lane per hop and two bucket
    rows per probing lane (what this batch needs, :func:`walk_lanes`),
    the emit slots and the overflow flags written once."""
    nbytes = (B * L * 4 + 2 * B * 4 + 4 + live * 16 + probing * 2 * row_bytes
              + B * steps * 2 * k * 4 + B * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def or_bound_ms(R, W, B, mb, rows_live) -> float:
    """Least time for the dense OR's bytes: the rows read once, each
    live bitmap row tile read once (at most the whole table), the
    [B, W] union written once."""
    read = min(rows_live, R) * W * 4
    return (read + B * mb * 4 + B * W * 4) / HBM_BYTES_PER_S * 1e3


def union_bound_ms(pr, mb, W, rows_live) -> float:
    """Least time for the packed union's bytes: the slot map and the
    packed topics' row slots read once (pr + pr * mb ids), each
    distinct live bitmap row read once, the [pr, W] rows written
    once."""
    nbytes = pr * mb * 4 + pr * 4 + rows_live * W * 4 + pr * W * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- phases -----------------------------------------------------------------

def phase_env():
    import torch

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    log(smi)
    return smi


def phase_build(card):
    from emqx_tpu_torch.ops import _build

    secs = _build.build(verbose=True)
    log(f"[build] {len(_build.KERNELS)} kernel sources built in {secs:.1f} s "
        f"({card})")
    secs = _build.build_host()
    log(f"[build] the host library ({_build.HOST_SRC.name}, "
        f"{' '.join(_build.HOST_CXX)}) built in {secs:.1f} s ({card})")


def check_walk(auto, args, kw, label):
    """Kernel vs plain on the same inputs; raises on any difference."""
    import torch

    from emqx_tpu_torch.ops.match import match_batch
    from emqx_tpu_torch.ops.walk_cuda import match_batch_cuda

    want = match_batch(auto, *args, **kw)
    got = match_batch_cuda(auto, *args, **kw)
    torch.cuda.synchronize()
    err = 0
    for name, x, y in zip(("ids", "count", "overflow"), got, want):
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"walk kernel != plain walk ({label}: {name})")
        err = max(err, int((x.long() - y.long()).abs().max()) if x.numel() else 0)
    log(f"[B1] {label}: equal; {int(got.overflow.sum())} overflow rows")
    return err


def phase_walk(broker, batch_topics, rng, card, oracle):
    """B1 against the plain walk: the main automaton (built by the
    router's engine, native at the defaults) at the main path's
    inputs, k/pack variants, tiny k, $SYS, too-deep topics, and a wide
    automaton. Returns the kernel row's numbers."""
    import torch

    from emqx_tpu_torch.ops import convert
    from emqx_tpu_torch.ops.csr import (attach_walk_tables,
                                        build_automaton, compress_automaton)
    from emqx_tpu_torch.ops.match import match_batch, walk_params
    from emqx_tpu_torch.ops.tokenize import WordTable, encode_batch
    from emqx_tpu_torch.ops.walk_cuda import match_batch_cuda
    from emqx_tpu_torch.oracle import TrieOracle

    router = broker.router
    auto, _map, _epoch = router.automaton()
    uniq = list(dict.fromkeys(batch_topics))
    args, kw = router.walk_inputs(uniq)
    B, L = args[0].shape
    main = (f"main automaton ({'wide' if kw['take'] > 1 else 'narrow'}, "
            f"{'native' if router._native is not None else 'Python'} "
            f"flatten)")
    err = check_walk(auto, args, kw,
                     f"{main}, main path inputs B={B} L={L} "
                     f"k={kw['k']} steps={kw['steps']}")
    # k = 15 .. 17 and 32: the edge of the two compaction orders
    # (2k = 30, 32, 34 and 64)
    for k in (15, 16, 17, 32, 64):
        for pack in (True, False):
            err = max(err, check_walk(
                auto, args, dict(kw, k=k, pack_ids=pack),
                f"{main} k={k} pack_ids={pack}"))
    # a batch that is not a multiple of a block's 4 topics, and one topic
    for cut in (4093, 1):
        err = max(err, check_walk(auto, [a[:cut] for a in args], kw,
                                  f"{main} B={cut}"))
    odd = uniq[:2000] + ["$SYS/brokers/up", "$SYS/w1_0/w2_0",
                         "/".join(["w0_1"] * 20), "w0_1/w1_1/w2_1/w3_1/w4_1/x"]
    a2, kw2 = router.walk_inputs(odd)
    for pack in (True, False):
        err = max(err, check_walk(auto, a2, dict(kw2, k=2, m=8, pack_ids=pack),
                                  f"{main} tiny k=2 m=8 pack_ids={pack} "
                                  f"($SYS, too deep)"))
    # a wide automaton: deep literal chains the compressor fuses
    trie, table, fids = TrieOracle(), WordTable(), {}
    while len(fids) < 20000:
        depth = int(rng.integers(6, 17))
        ws = [f"d{int(x)}" for x in rng.integers(0, 3, size=depth)]
        r = rng.random()
        if r < 0.2:
            ws[-1] = "#"
        elif r < 0.35:
            ws[int(rng.integers(0, depth))] = "+"
        f = "/".join(ws)
        if f not in fids:
            fids[f] = len(fids)
            trie.insert(f)
            for w in ws:
                if w not in ("+", "#"):
                    table.intern(w)
    raw = build_automaton(trie, fids, table, skip_hash=True)
    wide, edges = compress_automaton(raw, force_mode="wide")
    wide = attach_walk_tables(wide, edges)
    wauto = convert.automaton(wide, router.device)
    topics = ["/".join(w if w not in ("+", "#") else "d1"
                       for w in f.split("/")) for f in list(fids)[:3000]]
    topics += ["$SYS/d0/d1", "/".join(["d0"] * 20), "d0", "d2/d2/d2"]
    ids, n, sysm = encode_batch(table, (topics * 2)[:4093], 16)
    wargs = [torch.from_numpy(a).to(router.device) for a in (ids, n, sysm)]
    wlabel = f"wide ({wide.v2_states} states, take {wide.wt_take})"
    for k in (2, 15, 16, 17, 32, 64):
        for pack in (True, False):
            err = max(err, check_walk(
                wauto, wargs, dict(k=k, m=64, pack_ids=pack,
                                   **walk_params(wide, ids.shape[1])),
                f"{wlabel} B=4093 k={k} pack_ids={pack}"))
    err = max(err, check_walk(
        wauto, [a[-1:] for a in wargs],
        dict(k=16, m=64, **walk_params(wide, ids.shape[1])),
        f"{wlabel} B=1 k=16"))
    # past the register instantiation's limits (the scratch-row one):
    # frontiers of 65 to 200 lanes, and topics of 65 and 100 levels on
    # the main automaton and on a narrow deep one
    for k in (65, 128, 200):
        for pack in (True, False):
            err = max(err, check_walk(
                auto, args, dict(kw, k=k, pack_ids=pack),
                f"{main} main path inputs k={k} pack_ids={pack}"))
    deep_auto, deep_table, deep_topics = deep_automaton(rng, 100)
    deep_dev = convert.automaton(deep_auto, router.device)
    deep_in = {}
    for depth in (65, 100):
        # the main automaton: half of the topics run on past level 5
        # (named apart from L, the main path's level count, which the
        # bound below reads)
        topics = [t if i % 2
                  else t + "/" + "/".join(["w0_1"] * (depth - LEVELS))
                  for i, t in enumerate(uniq[:2000])]
        ids, n, sysm = encode_for(router, topics, depth)
        a_main = [torch.from_numpy(a).to(router.device)
                  for a in (ids, n, sysm)]
        ids, n, sysm = encode_batch(
            deep_table, [t for t in deep_topics if t.count("/") < depth],
            depth)
        a_deep = [torch.from_numpy(a).to(router.device)
                  for a in (ids, n, sysm)]
        deep_in[depth] = (a_deep, dict(m=64, pack_ids=False,
                                       **walk_params(deep_auto, depth)))
        for k in (16, 128):
            err = max(err, check_walk(
                auto, a_main, dict(kw, k=k, steps=router._steps_for(depth)),
                f"{main} L={depth} B={len(topics)} k={k}"))
            err = max(err, check_walk(
                deep_dev, a_deep, dict(deep_in[depth][1], k=k),
                f"narrow deep automaton ({deep_auto.v2_states} states) "
                f"L={depth} B={a_deep[0].shape[0]} k={k}"))
    # times and bound at the main path's inputs: the kernel alone
    # (profiler device time) and the wrapper with its torch tail
    run = lambda: match_batch_cuda(auto, *args, **kw)  # noqa: E731
    wrapper_ms = time_cuda_ms(run)
    ms = kernel_ms(run, "walk_kernel")
    call_ms = device_ms(run)
    timer_ms = kernel_timer_ms(run)
    plain_ms = time_cuda_ms(lambda: match_batch(auto, *args, **kw),
                            iters=3, warmup=1)
    if kw["take"] > 1:
        raise RuntimeError("walk_lanes replays the narrow layout only")
    padded = uniq + ["\x00/pad"] * (B - len(uniq))
    live, probing = walk_lanes(router, oracle, padded, kw["k"],
                               kw["steps"])
    bound = walk_bound_ms(B, L, kw["steps"], kw["k"], live, probing,
                          auto.wt.shape[1] * 4)
    log(f"[B1] main path inputs B={B}: kernel {ms:.5f} ms, "
        f"{ms / kw['steps'] * 1e3:.4f} us per hop over {kw['steps']} steps; "
        f"whole match_batch_cuda call {call_ms:.5f} ms of device time "
        f"(kernel and its torch tail; {wrapper_ms:.5f} ms on CUDA events, "
        f"host enqueue included; {timer_ms:.5f} ms p50 a call on "
        f"profiling.KernelTimer, launch to the card's sync), plain "
        f"{plain_ms:.4f} ms, bound "
        f"{bound:.5f} ms (bytes) — {card}")
    # the scratch-row instantiation: k = 128 at the main path's inputs,
    # and the deep automaton at L = 65 (k = 16)
    k128_ms = kernel_ms(lambda: match_batch_cuda(auto, *args,
                                                 **dict(kw, k=128)),
                        "walk_kernel_gmem")
    a_deep, kw_deep = deep_in[65]
    l65_ms = kernel_ms(lambda: match_batch_cuda(deep_dev, *a_deep,
                                                **dict(kw_deep, k=16)),
                       "walk_kernel_gmem")
    log(f"[B1] past the registers: k=128 at the main path inputs B={B} "
        f"{k128_ms:.5f} ms ({k128_ms / kw['steps'] * 1e3:.4f} us per hop); "
        f"L=65 on the narrow deep automaton B={a_deep[0].shape[0]} k=16 "
        f"{l65_ms:.5f} ms over {kw_deep['steps']} steps — {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "k128_ms": k128_ms, "l65_ms": l65_ms,
            "kernel_timer_ms": timer_ms}


def deep_automaton(rng, L):
    """A narrow automaton over 2,000 spines of 60 to ``L`` levels with
    wildcards sprinkled in; the topics made from each filter, and
    random topics up to ``L`` levels."""
    from emqx_tpu_torch.ops.csr import (attach_walk_tables,
                                        build_automaton, compress_automaton)
    from emqx_tpu_torch.ops.tokenize import WordTable
    from emqx_tpu_torch.oracle import TrieOracle

    trie, table, fids = TrieOracle(), WordTable(), {}
    while len(fids) < 2000:
        depth = int(rng.integers(60, L + 1))
        ws = [f"s{int(x)}" for x in rng.integers(0, 3, size=depth)]
        for _ in range(int(rng.integers(0, 4))):
            ws[int(rng.integers(0, depth))] = "+"
        if rng.random() < 0.3:
            ws[-1] = "#"
        f = "/".join(ws)
        if f not in fids:
            fids[f] = len(fids)
            trie.insert(f)
            for w in ws:
                if w not in ("+", "#"):
                    table.intern(w)
    raw = build_automaton(trie, fids, table, skip_hash=True)
    deep, edges = compress_automaton(raw, force_mode="narrow")
    topics = [f.replace("+", "s1").replace("#", "s2") for f in fids]
    topics += ["/".join(f"s{int(x)}" for x in
                        rng.integers(0, 3, size=int(rng.integers(1, L + 1))))
               for _ in range(500)]
    return attach_walk_tables(deep, edges), table, topics


def phase_c1(device, card):
    """Fault C.1 closed, through the entry point a user calls:
    ``Broker(device="cuda")`` with ``active_k = 128`` (frontiers past
    64 lanes), and with ``max_levels = 80`` and topics of 70 levels,
    delivers what the TrieOracle gives; the walk ran on the card."""
    from emqx_tpu_torch.broker import Broker
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.router import MatcherConfig
    from emqx_tpu_torch.types import Message

    rng = random.Random(61)
    wide = set()
    while len(wide) < 1500:
        ws = [rng.choice("aaab++++") for _ in range(rng.randint(1, 10))]
        if rng.random() < 0.15:
            ws[-1] = "#"
        wide.add("/".join(ws))
    deep = set()
    while len(deep) < 1100:
        ws = ["s%d" % rng.randint(0, 2) for _ in range(rng.randint(60, 80))]
        ws[rng.randrange(len(ws))] = "+"
        if rng.random() < 0.3:
            ws[-1] = "#"
        deep.add("/".join(ws))
    cases = [
        ("active_k=128", MatcherConfig(active_k=128), sorted(wide),
         ["/".join("a" * rng.randint(1, 11)) for _ in range(50)]
         + [f.replace("+", "a").replace("#", "b") for f in sorted(wide)]),
        ("max_levels=80", MatcherConfig(max_levels=80), sorted(deep),
         [f.replace("+", "s1").replace("#", "s2/s0") for f in sorted(deep)]
         + ["/".join(["s0"] * 70), "/".join(["s1"] * 70)]),
    ]
    for label, cfg, filters, topics in cases:
        broker = Broker(config=cfg, device=device)
        for i, f in enumerate(filters):
            broker.subscribe(Sink(i), f)
        msgs = [Message(topic=t) for t in topics]
        Sink.log = []
        _build.reset_launches()
        pb = broker.publish_begin(msgs)
        if pb.done:
            raise AssertionError(f"C.1 {label}: not the device path")
        broker.publish_fetch(pb)
        res = broker.publish_finish(pb)
        deliveries, Sink.log = Sink.log, None
        if _build.LAUNCHES["walk"] < 1:
            raise AssertionError(f"C.1 {label}: the walk kernel did not "
                                 f"launch")
        check_batches(broker, [(msgs, res)], deliveries)
        n_ovf = int(pb.ovf[:pb.n_uniq].sum())
        log(f"[C.1] Broker(device='cuda') {label}: {len(filters)} filters, "
            f"{len(msgs)} messages, {len(deliveries)} deliveries equal the "
            f"TrieOracle; {pb.n_uniq - n_ovf} of {pb.n_uniq} topics "
            f"finished on the card (the rest re-matched on the host) — "
            f"{card}")


def check_or(bitmaps, rows, label):
    """Kernel B4 (the dense OR) and B2 run over every topic (the design
    B4 ran on before its own kernel) against the plain OR; ids at or
    past R are skipped like -1."""
    import torch

    from emqx_tpu_torch.ops.bitmap import (or_bitmaps_cuda, or_bitmaps_ref,
                                           or_union_rows_cuda)

    want = or_bitmaps_ref(bitmaps, torch.where(rows < bitmaps.shape[0],
                                               rows, -1))
    got = or_bitmaps_cuda(bitmaps, rows)
    every = torch.arange(rows.shape[0], dtype=torch.int32,
                         device=rows.device)
    b2 = or_union_rows_cuda(bitmaps, rows, every)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dense bitmap OR kernel != plain OR ({label})")
    if not torch.equal(b2, want):
        raise AssertionError(f"bitmap OR kernel over every topic != plain "
                             f"OR ({label})")
    log(f"[B4] {label}: B4 and B2 over every topic equal to the plain OR")
    return int((got.long() - want.long()).abs().max())


def check_union(bitmaps, rows, has_big, pr, label):
    """The packed union at budget ``pr`` against its plain twin."""
    import torch

    from emqx_tpu_torch.ops.bitmap import (or_union_rows_cuda,
                                           or_union_rows_ref)
    from emqx_tpu_torch.ops.pack import union_slots

    _sel, src, total = union_slots(has_big, pr)
    want = or_union_rows_ref(bitmaps, rows, src)
    got = or_union_rows_cuda(bitmaps, rows, src)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"packed bitmap OR kernel != plain twin "
                             f"({label}, pr={pr})")
    log(f"[B2] {label}, pr={pr} ({int(total)} live topics): equal")
    return int((got.long() - want.long()).abs().max())


def peak_mib(fn) -> float:
    """Peak device memory one call of ``fn`` allocates above what was
    resident before it, MiB."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def route_ab(bm, rows, has_big, pr, card):
    """The publish path's old route (the dense [B, W] OR, kernel B4,
    then ``pack_union_rows``' gather) against the packed launch, on the
    same inputs in one call: equal outputs, the device time of each route
    with its torch glue (profiler; old, new, new, old), its OR kernel
    alone, and the peak device memory it allocates."""
    import torch

    from emqx_tpu_torch.ops.bitmap import or_bitmaps_cuda, or_union_rows_cuda
    from emqx_tpu_torch.ops.pack import pack_union_rows, union_slots

    def old():
        return pack_union_rows(or_bitmaps_cuda(bm, rows), has_big, pr=pr)

    def new():
        sel, src, total = union_slots(has_big, pr)
        return sel, or_union_rows_cuda(bm, rows, src), total

    a, b = old(), new()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("packed OR route != dense OR + pack_union_rows")
    t = [device_ms(fn) for fn in (old, new, new, old)]
    old_kernel = kernel_ms(lambda: or_bitmaps_cuda(bm, rows),
                           "bitmap_or_dense_kernel")
    mem = {"old": peak_mib(old), "new": peak_mib(new)}
    log(f"[B2] route A/B at the main path's batch, pr={pr}: equal; device "
        f"time old (dense OR + gather) {t[0]:.5f} / {t[3]:.5f} ms (its OR "
        f"kernel {old_kernel:.5f} ms), peak {mem['old']:.1f} MiB; new (slots "
        f"+ packed OR) {t[1]:.5f} / {t[2]:.5f} ms, peak {mem['new']:.1f} MiB "
        f"— {card}")


def phase_bitmap(broker, batches, rng, card):
    """B2 against its plain twin at the main path's rows (of the slice
    batch with the most live row slots) at the learned budget and an
    overflowing one, packed from a dense shape (W = 32,768 x B = 4,096
    x mb = 16) with an overflowing budget, and the old route against
    the new; then B4 (:func:`phase_dense`) on the same bitmap table."""
    import torch

    from emqx_tpu_torch.ops.bitmap import (or_union_rows_cuda,
                                           or_union_rows_ref, rows_for_matches)
    from emqx_tpu_torch.ops.pack import mask_pad_rows, union_slots
    from emqx_tpu_torch.ops.walk_cuda import match_batch_auto

    router = broker.router
    auto, id_map, epoch = router.automaton()
    st = broker.helper.state(epoch, id_map)
    rows, live, pick = None, -1, -1
    for bi, batch in enumerate(batches):
        uniq = list(dict.fromkeys(batch))
        args, kw = router.walk_inputs(uniq)
        ids = mask_pad_rows(match_batch_auto(auto, *args, **kw).ids,
                            len(uniq))
        r, _ovf = rows_for_matches(st.bm, ids, mb=router.config.fanout_mb)
        n = int((r >= 0).sum())
        if n > live:
            rows, live, pick = r, n, bi
    if live <= 0:
        raise AssertionError("no slice batch matched a bitmap-path filter")
    bm = st.bm.bitmaps
    R, W = bm.shape
    B, mb = rows.shape
    has_big = (rows >= 0).any(dim=1)
    total = int(has_big.sum())
    # the budget the broker holds for this bucket (grown by any batch
    # that overflowed it), else the one it would start from
    pr = broker._pack_budgets.get(B, [0, 0, max(1, router.config.pack_rows)])[2]
    label = (f"main path rows (slice batch {pick}) B={B} mb={mb} R={R} "
             f"W={W}, {live} live slots")
    err = check_union(bm, rows, has_big, pr, label + ", learned budget")
    if total >= 2:
        err = max(err, check_union(bm, rows, has_big, total - 1,
                                   label + ", overflow"))
    dense = torch.from_numpy(rng.integers(-1, st.bm.n_rows, size=(4096, 16))
                             .astype(np.int32)).to(bm.device)
    err = max(err, check_union(bm, dense, (dense >= 0).any(dim=1), 64,
                               f"dense B=4096 mb=16 W={W} "
                               f"({int((dense >= 0).sum())} live slots), "
                               f"overflow"))
    route_ab(bm, rows, has_big, pr, card)
    src = union_slots(has_big, pr)[1]
    ms = kernel_ms(lambda: or_union_rows_cuda(bm, rows, src), "bitmap_or_kernel")
    plain_ms = time_cuda_ms(lambda: or_union_rows_ref(bm, rows, src),
                            iters=3, warmup=1)
    packed = rows[src[src >= 0].long()]
    live_rows = len(set(packed[packed >= 0].tolist()))
    bound = union_bound_ms(pr, mb, W, live_rows)
    log(f"[B2] main path packed union B={B} pr={pr}, {total} live topics, "
        f"{live_rows} live bitmap rows: kernel {ms:.5f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.6f} ms (bytes of the packed "
        f"function) — {card}")
    b4 = phase_dense(bm, st.bm.n_rows, rng, card)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "pr": pr, "live_rows": live_rows}, b4


#: B4's timed dense shape (phase 4): topics and row slots a topic
DENSE_B, DENSE_MB = 4096, 16


def dense_ab(bm, rows, label, card):
    """Kernel B4 against B2 run over every topic (the design B4 had
    before its own kernel), on the same inputs: both equal to the plain
    OR, then each kernel's device time in turns (B2, B4, B4, B2), the
    bound (bytes) and B4's share of it. Returns B4's time, B2's and the
    bound."""
    import torch

    from emqx_tpu_torch.ops.bitmap import or_bitmaps_cuda, or_union_rows_cuda

    check_or(bm, rows, label)
    every = torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)

    def b2():
        return or_union_rows_cuda(bm, rows, every)

    def b4():
        return or_bitmaps_cuda(bm, rows)

    t = [kernel_ms(fn, name) for fn, name in (
        (b2, "bitmap_or_kernel"), (b4, "bitmap_or_dense_kernel"),
        (b4, "bitmap_or_dense_kernel"), (b2, "bitmap_or_kernel"))]
    distinct = int(torch.unique(rows[rows >= 0]).numel())
    bound = or_bound_ms(*bm.shape, *rows.shape, distinct)
    ms, b2_ms = min(t[1], t[2]), min(t[0], t[3])
    log(f"[B4] {label}, {distinct} distinct rows: B4 {t[1]:.5f} / "
        f"{t[2]:.5f} ms, B2 over every topic {t[0]:.5f} / {t[3]:.5f} ms, "
        f"bound {bound:.5f} ms (bytes): B4 at {bound / ms:.1%} of its "
        f"bound, {b2_ms / ms:.2f}x B2's speed — {card}")
    return {"ms": ms, "b2_ms": b2_ms, "bound_ms": bound}


def phase_dense(bm, n_rows, rng, card):
    """B4, the dense union (``or_bitmaps_cuda``, ``csrc/bitmap_or_dense.cu``),
    against the plain OR and against B2 over every topic on the same
    inputs: on the main path's bitmap table at W = 32,768, B = 4,096 and
    mb = 1, 4 and 16 (ids drawn from the live rows and -1), on a table
    of 64 distinct rows, and on small edges (B not a multiple of the
    kernel's 8-topic chunk, a ragged strip, more distinct rows than it
    stages, a topic's spill list overflowing, no slots, ids at or past
    R, dead topics). Then B4's entry point ``or_bitmaps`` at mb = 16,
    equal and timed, with the plain OR's time. Returns the kernel row's
    numbers."""
    import torch

    from emqx_tpu_torch.ops.bitmap import or_bitmaps, or_bitmaps_ref

    dev = bm.device
    R, W = bm.shape

    def ids(hi, shape):
        return torch.from_numpy(rng.integers(-1, hi, size=shape)
                                .astype(np.int32)).to(dev)

    def table(r, w):
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(r, w))
                                .astype(np.int32)).to(dev)

    err = 0
    for rr, b, m, w in ((8, 300, 16, 2048), (8, 64, 4, 1028),
                        (80, 130, 16, 1024), (300, 40, 24, 1024),
                        (4, 70, 0, 1024), (3, 1, 1, 1024)):
        t, r = table(rr, w), ids(rr, (b, m))
        err = max(err, check_or(t, r, f"R={rr} B={b} mb={m} W={w}"))
    t, r = table(8, 1024), ids(8, (200, 16))
    r[::5] = -1
    r[1::3, ::2] = 8 + 2 * torch.arange(8, dtype=torch.int32, device=dev)
    err = max(err, check_or(t, r, "R=8 B=200 mb=16 W=1024, every fifth "
                                  "topic dead, ids at or past R"))
    by_mb = {}
    for m in (1, 4, DENSE_MB):
        dense = ids(n_rows, (DENSE_B, m))
        by_mb[m] = dense_ab(bm, dense, f"B={DENSE_B} mb={m} W={W} R={R} "
                                       f"({n_rows} live rows)", card)
    wide = table(64, W)
    d64 = dense_ab(wide, ids(64, (DENSE_B, DENSE_MB)),
                   f"B={DENSE_B} mb={DENSE_MB} W={W} R=64", card)
    del wide
    # B4's entry point (its contract: W a multiple of 1,024 words) on
    # the last mb = 16 rows
    want = or_bitmaps_ref(bm, dense)
    got = or_bitmaps(bm, dense)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("or_bitmaps (B4's entry point) != plain OR")
    err = max(err, int((got.long() - want.long()).abs().max()))
    del got, want
    ms = kernel_ms(lambda: or_bitmaps(bm, dense), "bitmap_or_dense_kernel")
    plain = time_cuda_ms(lambda: or_bitmaps_ref(bm, dense), iters=3, warmup=1)
    bound = by_mb[DENSE_MB]["bound_ms"]
    log(f"[B4] or_bitmaps B={DENSE_B} mb={DENSE_MB} W={W}: equal; kernel "
        f"{ms:.5f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms (bytes), "
        f"{bound / ms:.1%} of it; B2 over every topic "
        f"{by_mb[DENSE_MB]['b2_ms']:.5f} ms — {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "b2_ms": by_mb[DENSE_MB]["b2_ms"],
            "by_mb": {str(m): v for m, v in by_mb.items()},
            "distinct_64": d64}


def check_batches(broker, batches, deliveries, oracle=None):
    """Every batch's per-message (subscriber, filter) multisets against
    ``oracle`` (a host TrieOracle of the broker's filters; built here
    when not given): every local subscriber of every matched filter
    exactly once, one member per shared group, nothing else.
    ``batches`` holds ``(messages, results)`` pairs. Returns the count
    of checked deliveries that took the bitmap (big-filter) path."""
    from collections import Counter

    if oracle is None:
        oracle = route_oracle(broker.router)
    by_msg = {}
    for mid, sid, flt in deliveries:
        by_msg.setdefault(mid, Counter())[(sid, flt)] += 1
    big = {}
    n_big = 0
    for msgs, results in batches:
        for i, msg in enumerate(msgs):
            filters = oracle.match(msg.topic)
            local = Counter()
            groups = []
            for f in filters:
                subs = broker.subscribers(f)
                for s in subs:
                    local[(s.sid, f)] += 1
                if big.setdefault(f, len(subs) > broker.helper.threshold):
                    n_big += len(subs)
                for route in broker.router.lookup_routes(f):
                    if isinstance(route.dest, tuple):
                        groups.append((route.dest[0], f))
            got = by_msg.get(msg.id, Counter())
            extra = got - local
            if local - got or len(extra) != len(groups) \
                    or sum(extra.values()) != len(groups):
                raise AssertionError(f"deliveries of {msg.topic!r} differ "
                                     f"from the oracle")
            for group, f in groups:
                members = {s.sid for s in broker.shared.subscribers(group, f)}
                if not any(sid in members for sid, ff in extra if ff == f):
                    raise AssertionError(f"shared group {group} of {f} missed")
            if results[i] != sum(local.values()) + len(groups):
                raise AssertionError(f"delivery count of {msg.topic!r}")
    return n_big


def phase_slice(broker, batches, card, oracle, label="slice",
                per_batch=None, kernels=PUBLISH_KERNELS):
    """The timed main-path run; every count starts at 0 here. Prints
    the match cache's hit rate over the run when the cache is on. With
    the node's telemetry on (the default), every batch's span is
    checked: closed once, with the broker's own per-batch counts as its
    tags (:class:`SpanLog`), and each stage's count, p50 and p99
    are printed. ``per_batch`` (kernel → launches) holds each batch's
    launches from its begin to the end of its fetch to exact counts
    (the mesh: one a cell). Returns the run's numbers and every
    message's local deliveries, ``(batch, message) → sorted (sink,
    filter) pairs`` (a mesh node's are held against phase 5's)."""
    import torch

    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.types import Message

    msgs = [[Message(topic=t, payload=b"x") for t in b] for b in batches]
    on_card = broker.router.device.type == "cuda"
    mesh = broker.router.config.mesh is not None
    if on_card:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    # the mesh's cache, when one exists (it stays off while big-filter
    # bitmaps are live, as in the JAX package)
    cache = (broker.router._sharded_cache_obj if mesh
             else broker.router._match_cache())
    c0 = (cache.hits, cache.misses) if cache is not None else (0, 0)
    spans = SpanLog(broker.telemetry)
    _build.reset_launches()
    lat, n_ovf, n_uniq = [], 0, 0
    split = np.zeros(3)  # begin (host + enqueue), fetch (+ wait), finish
    checks, big_rows = [], 0
    Sink.log = []
    for bi, batch in enumerate(msgs):
        before = dict(_build.LAUNCHES)
        cb = (cache.hits, cache.misses) if cache is not None else None
        t0 = time.perf_counter()
        pb = broker.publish_begin(batch)
        if pb.done:
            raise AssertionError(f"batch {bi} did not take the device path")
        t1 = time.perf_counter()
        sp = pb.span
        split_of = ((cache.hits - cb[0], cache.misses - cb[1])
                    if cb is not None else (-1, -1))
        broker.publish_fetch(pb)
        t2 = time.perf_counter()
        fetched = dict(_build.LAUNCHES)
        res = broker.publish_finish(pb)
        t3 = time.perf_counter()
        lat.append(t3 - t0)
        split += (t1 - t0, t2 - t1, t3 - t2)
        for name in kernels:
            if _build.LAUNCHES[name] <= before[name]:
                raise AssertionError(f"batch {bi} did not launch {name}")
        for name, n in (per_batch or {}).items():
            if fetched[name] - before[name] != n:
                raise AssertionError(f"batch {bi} launched {name} "
                                     f"{fetched[name] - before[name]} "
                                     f"times, not {n}")
        n_ovf += int(pb.ovf[:pb.n_uniq].sum())
        n_uniq += pb.n_uniq
        big_rows += int((pb.sel[:pb.n_uniq] >= 0).sum())
        checks.append((batch, res))
        spans.expect(sp, {"batch": len(batch), "n_uniq": pb.n_uniq,
                          "path": "mesh" if mesh else "device",
                          "bucket": pb.ids_dev.shape[0],
                          "fallbacks": int(pb.ovf[:pb.n_uniq].sum()),
                          "cache": split_of})
    launches = dict(_build.LAUNCHES)
    out_spans = spans.check(label, card)
    peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
    deliveries, Sink.log = Sink.log, None
    n_big = check_batches(broker, checks, deliveries, oracle)
    n_msgs = sum(len(b) for b in msgs)
    pos = {m.id: (bi, i) for bi, b in enumerate(msgs) for i, m in enumerate(b)}
    local_sids = {}
    local = {}
    for mid, sid, flt in deliveries:
        sids = local_sids.get(flt)
        if sids is None:
            sids = local_sids[flt] = {s.sid for s in broker.subscribers(flt)}
        if sid in sids:
            local.setdefault(pos[mid], []).append((sid, flt))
    for v in local.values():
        v.sort()
    lat_ms = np.sort(np.array(lat) * 1e3)
    hit_rate = None
    if cache is not None:
        hd, md = cache.hits - c0[0], cache.misses - c0[1]
        hit_rate = hd / max(1, hd + md)
    cfg = broker.router.config
    out = {
        "msgs_per_s": n_msgs / sum(lat),
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "overflow_row_share": n_ovf / max(1, n_uniq),
        "unique_per_batch": n_uniq / len(msgs),
        "launches": launches,
        "peak_mib": peak,
        "cache_hit_rate": hit_rate,
        "stages": out_spans,
        "local": local,
    }
    grid = "" if cfg.mesh is None else \
        f"mesh={cfg.mesh.shape['data']}x{cfg.mesh.shape['trie']} "
    log(f"[{label}] {grid}match_cache={cfg.match_cache} delta="
        f"{broker.router.delta_info()['active']} "
        f"use_native={cfg.use_native} preserialize="
        f"{broker.dispatch_config.preserialize}: "
        f"{len(msgs)} batches x {len(msgs[0])} msgs: "
        f"{out['msgs_per_s']:.1f} msgs/s, p50 {out['p50_ms']:.3f} ms, "
        f"p99 {out['p99_ms']:.3f} ms, cache hit rate "
        f"{'off' if hit_rate is None else f'{hit_rate:.4f}'}, B1 launches "
        f"{launches['walk']}, overflow rows "
        f"{out['overflow_row_share']:.6f}, unique topics/batch "
        f"{out['unique_per_batch']:.1f}, launches {launches} — {card}")
    split_ms = split / len(msgs) * 1e3
    log(f"[{label}] per batch: begin (encode, dedup, enqueue) "
        f"{split_ms[0]:.3f} ms, fetch (device wait, copy, plan) "
        f"{split_ms[1]:.3f} ms, finish (delivery tail) {split_ms[2]:.3f} ms"
        f" — {card}")
    out["split_ms"] = split_ms.tolist()
    if on_card:
        log(f"[{label}] peak device memory of the publish phase {peak:.1f} "
            f"MiB ({resident / 2**20:.1f} MiB resident at its start) — {card}")
    log(f"[{label}] all {n_msgs} messages: {len(deliveries)} deliveries "
        f"({n_big} through the bitmap path, {big_rows} union rows) match "
        f"the TrieOracle")
    return out


class SpanLog:
    """Phase 5's span check. Resets the node's telemetry (its counts
    start at 0 with the run), wraps ``Telemetry.finish`` to see every
    close the broker makes, and holds each batch's span against the
    broker's own counts for that batch (:meth:`expect`); :meth:`check`
    asserts every batch span closed exactly once with equal tags and
    prints each stage's count, p50 and p99. Publishes the telemetry
    makes itself (the ``slow_publish`` alarm's ``$SYS`` messages,
    published from inside a batch's close) have spans of their own;
    they are counted apart. A no-op when telemetry is off."""

    def __init__(self, tel) -> None:
        self.tel = tel if tel is not None and tel.enabled else None
        self.want = []
        self.closes = []
        if self.tel is None:
            return
        self.tel.reset()
        fold = self.tel.finish

        def finish(span):
            self.closes.append(span)
            fold(span)

        self.tel.finish = finish

    def expect(self, span, tags) -> None:
        if self.tel is not None:
            self.want.append((span, tags))

    def check(self, label, card):
        tel = self.tel
        if tel is None:
            return None
        del tel.finish  # the class's method again
        for bi, (sp, tags) in enumerate(self.want):
            if sp is None:
                raise AssertionError(f"[{label}] batch {bi}: no span")
            n = sum(1 for x in self.closes if x is sp)
            got = {"batch": sp.batch, "n_uniq": sp.n_uniq, "path": sp.path,
                   "bucket": sp.bucket, "fallbacks": sp.fallbacks,
                   "cache": (sp.cache_hit, sp.cache_miss)}
            if not sp.closed or n != 1 or got != tags:
                raise AssertionError(f"[{label}] batch {bi}: span closed "
                                     f"{n} times, tags {got}, the broker's "
                                     f"{tags}")
        own = tel.spans_total - len(self.want)
        stages = {s: st for s, st in tel.stage_stats().items()
                  if st["count"]}
        log(f"[{label}] spans: {len(self.want)} batch spans, each closed "
            f"once with the broker's counts as its tags (batch, unique "
            f"topics, path, bucket, host fallbacks, cache split); "
            f"{own} more from the slow_publish alarm's own $SYS "
            f"publishes; {tel.slow_total} slow (over "
            f"{tel.config.slow_threshold_ms:g} ms) — {card}")
        log(f"[{label}] stages (count, p50 ms, p99 ms): " + "; ".join(
            f"{s} {st['count']} {st['p50_ms']:.3f} {st['p99_ms']:.3f}"
            for s, st in stages.items()) + f" — {card}")
        return {s: (st["count"], st["p50_ms"], st["p99_ms"])
                for s, st in stages.items()}


#: phase 5's spans A/B, in order (cut from off, on, off, on to make
#: room for phase 13; printed)
AB_RUNS = ("off", "on")


def phase_spans_ab(broker, batches, card):
    """Phase 5's A/B: the same batches through ``publish_batch`` with a
    disabled ``Telemetry`` and with the node's (on), in the order of
    :data:`AB_RUNS`. Every run's deliveries (per message: the (subscriber,
    filter) multiset) and results must be equal; prints msgs/s and the
    p99 batch latency of each run and the mean of each setting."""
    from collections import Counter

    from emqx_tpu_torch.telemetry import Telemetry, TelemetryConfig
    from emqx_tpu_torch.types import Message

    on = broker.telemetry
    off = Telemetry(TelemetryConfig(enabled=False))
    shared = {}
    for (_group, flt), members in broker.shared._subs.items():
        local = {x.sid for x in broker.subscribers(flt)}
        shared.setdefault(flt, set()).update(
            x.sid for x in members if x.sid not in local)
    runs = {"off": [], "on": []}
    want = None
    try:
        for setting in AB_RUNS:
            broker.telemetry = broker.router.telemetry = \
                on if setting == "on" else off
            Sink.log = []
            pos, res, lat = {}, [], []
            for bi, b in enumerate(batches):
                msgs = [Message(topic=t, payload=b"x") for t in b]
                for i, m in enumerate(msgs):
                    pos[m.id] = (bi, i)
                t0 = time.perf_counter()
                res.append(broker.publish_batch(msgs))
                lat.append(time.perf_counter() - t0)
            # a shared group's pick rotates from run to run: its
            # deliveries count per group, not per member
            got = Counter((pos[mid], "group" if sid in shared.get(flt, ())
                           else sid, flt)
                          for mid, sid, flt in Sink.log if mid in pos)
            Sink.log = None
            if want is None:
                want = (got, res)
            elif (got, res) != want:
                raise AssertionError(f"[5 A/B] telemetry {setting}: the "
                                     f"deliveries differ")
            n = sum(len(b) for b in batches)
            runs[setting].append((n / sum(lat),
                                  float(np.percentile(np.array(lat) * 1e3,
                                                      99))))
    finally:
        broker.telemetry = broker.router.telemetry = on
    mean = {k: (float(np.mean([r[0] for r in v])),
                float(np.mean([r[1] for r in v]))) for k, v in runs.items()}
    log(f"[5 A/B] spans off / on, {len(batches)} batches a run, runs "
        f"{', '.join(AB_RUNS)} (cut from off, on, off, on): msgs/s "
        f"{[round(r[0], 1) for r in runs['off']]} / "
        f"{[round(r[0], 1) for r in runs['on']]}, p99 ms "
        f"{[round(r[1], 3) for r in runs['off']]} / "
        f"{[round(r[1], 3) for r in runs['on']]}; means {mean['off'][0]:.1f}"
        f" / {mean['on'][0]:.1f} msgs/s, p99 {mean['off'][1]:.3f} / "
        f"{mean['on'][1]:.3f} ms; {sum(want[0].values())} deliveries equal "
        f"in every run — {card}")
    return {"runs": runs, "mean": mean}


def gc_mark(node):
    """The collections every connection's ``GcPolicy`` forced (process
    wide) and the node's ``sysmon.long_gc``, now."""
    from emqx_tpu_torch.gc import GcPolicy

    return GcPolicy.forced, node.metrics.val("sysmon.long_gc")


def log_gc(node, label, mark):
    """The forced young collections and the long collections the
    node's ``SysMon`` counted (only while the node runs) since
    ``mark``."""
    forced, long_gc = gc_mark(node)
    log(f"[{label}] gc.policy collections {forced - mark[0]}, "
        f"sysmon.long_gc {long_gc - mark[1]} (node "
        f"{'running' if node._started else 'stopped'} at the end)")


def profile_steps(steps, kernels, card, label):
    """Runs ``steps`` under torch.profiler: the first as its warm-up
    (traced and discarded, so the trace's start-up misses no record of
    the window), the rest recorded, with a device sync after each.
    Logs the device busy time and idle share of the recorded steps'
    wall time (profiler overhead included) and the largest device
    items. The busy time counts only when the trace holds exactly the
    launches that ``kernels``' counters saw in the window; otherwise it
    is logged as not measured. Reports, never fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from emqx_tpu_torch.ops import _build

    marks = []
    last = len(steps) - 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=last,
                                   repeat=1)) as prof:
        for i, step in enumerate(steps):
            step()
            torch.cuda.synchronize()
            if i == 0:
                # the recorded window opens, flushed (see TRACE_FLUSH)
                prof.step()
                flush_trace()
            marks.append((time.perf_counter(), dict(_build.LAUNCHES)))
            if i:
                prof.step()
    wall_ms = (marks[-1][0] - marks[0][0]) * 1e3
    events = device_events(prof)
    counted = {k: marks[-1][1][k] - marks[0][1][k] for k in kernels}
    traced = {k: sum(e.count for e in events if f"{k}_kernel" in e.key)
              for k in kernels}
    window = f"{len(steps) - 1} {label} under the profiler"
    if not events or counted != traced:
        log(f"[profile] {window}: device busy not measured — the trace "
            f"holds {traced} launches, the counters saw {counted} — {card}")
    else:
        busy_ms = sum(_dev_us(e) for e in events) / 1e3
        log(f"[profile] {window}: wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; "
            f"launches in the trace equal the counters' {counted} — {card}")
    for e in sorted(events, key=_dev_us, reverse=True)[:10]:
        log(f"[profile]   {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def phase_profile(broker, batches, card, kernels=PUBLISH_KERNELS):
    """A warm-up batch and three more under torch.profiler; ``kernels``
    are the ones a batch launches."""
    from emqx_tpu_torch.types import Message

    msgs = [[Message(topic=t, payload=b"x") for t in b] for b in batches[:4]]
    profile_steps([lambda b=b: broker.publish_batch(b) for b in msgs],
                  kernels, card, "batches")


def timed(label, fn, *args):
    """``fn(*args)``, with its seconds logged under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def run(opts, device, card):
    """Phases 3-5, 8, 7a, 9a-9b, 15a-15b, 16, 12, 13 (with 15c) and 17
    on ``device``; returns phase 13's, 15's, 16's and 17's numbers and
    the kernel rows."""
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.types import Message

    rng = np.random.default_rng(opts.seed)
    wl = make_workload(rng, opts.subs, opts.others, 8, 4096)
    # one node holds the table at the defaults (the native engine,
    # pre-serialization): phase 5 drives its broker, phases 8 and 7a
    # its router and listener; the ingress batcher takes up to a
    # slice batch
    node = Node(device=device, batch_size=opts.batch)
    broker = node.broker
    gmark = gc_mark(node)
    t0 = time.perf_counter()
    sinks, draw, pairs = subscribe_all(broker, wl, rng)
    sub_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    broker.router.automaton()
    rebuild_s = time.perf_counter() - t0
    # the checks' oracle: a host TrieOracle of the same filters, apart
    # from the engine under test
    t0 = time.perf_counter()
    oracle = route_oracle(broker.router)
    oracle_s = time.perf_counter() - t0
    topics = zipf_topics(rng, draw, opts.batch * (opts.batches + 1))
    t0 = time.perf_counter()
    broker.publish_batch([Message(topic=t) for t in topics[:opts.batch]])
    first_s = time.perf_counter() - t0
    log(f"[setup] {len(sinks)} subscribers, "
        f"{len(broker.router._filter_ids)} filters: subscribe "
        f"{sub_s:.1f} s, build of the automaton on the native engine "
        f"{rebuild_s:.1f} s, first batch (fan-out tables) {first_s:.1f} "
        f"s; the checks' TrieOracle {oracle_s:.1f} s — {card}")
    batches = [topics[(i + 1) * opts.batch:(i + 2) * opts.batch]
               for i in range(opts.batches)]
    walk = timed("3 (B1)", phase_walk, broker, topics[:opts.batch], rng,
                 card, oracle)
    timed("3 (C.1)", phase_c1, device, card)
    bmp, b4 = timed("4 (B2, B4)", phase_bitmap, broker, batches, rng, card)
    sl = timed("5 (slice)", phase_slice, broker, batches, card, oracle)
    timed("5 (spans A/B)", phase_spans_ab, broker, batches, card)
    timed("5 (profile)", phase_profile, broker, batches, card)
    check_quiet(node, "5")
    log_gc(node, "5", gmark)
    gmark = gc_mark(node)
    p8 = run_phase8(broker, draw, batches, rng, opts, card, oracle)
    check_quiet(node, "8")
    log_gc(node, "8", gmark)
    gmark = gc_mark(node)
    mark = overload_mark(node)
    sock = timed("7a and 11 (socket publish, observability)", phase_socket,
                 node, wl, draw, opts, card, oracle)
    log_overload(node, "7a", mark)
    check_quiet(node, "7a")
    log_gc(node, "7a and 11", gmark)
    gmark = gc_mark(node)
    p9 = timed("9a and 9b (breaker, device loss)", phase_devloss, node,
               draw, opts.batch, card, oracle)
    log_gc(node, "9a and 9b", gmark)
    gmark = gc_mark(node)
    p15 = timed("15a and 15b (modules, access plane)", run_modules, node,
                batches, draw, card, oracle, sl)
    log_gc(node, "15a and 15b", gmark)
    gmark = gc_mark(node)
    p16 = timed("16 (operations surface, secure front door)", run_ops,
                node, pairs, batches, wl, draw, oracle, opts, card)
    log_gc(node, "16", gmark)
    # one 1M-filter node at a time, as before the A/B: the plain node
    # starts once the collector has freed this one
    del node, broker
    gc.collect()
    timed("5 and 8b (plain config)", run_plain, pairs, batches,
          topics[:opts.batch], draw, opts, device, card, oracle, p8)
    gc.collect()
    p12 = timed("12 (mesh)", run_mesh, pairs, batches, topics[:opts.batch],
                opts, device, card, sl, walk)
    gc.collect()
    p13 = timed("13 (cluster)", run_cluster, pairs, batches,
                topics[:opts.batch], opts, device, card,
                dict(sl, walk_ms=walk["ms"]))
    gc.collect()
    p17 = timed("17 (multi-loop node, worker pool, command line)",
                run_loops, pairs, wl, draw, oracle, batches, device, card)
    mesh_launches = {name: {g: p12["launches"][g][name]
                            for g in ("12a", "12b")}
                     for name in PUBLISH_KERNELS + MESH_KERNELS}
    cluster = p13["13a"]
    walk["max_abs_err"] = max([walk["max_abs_err"],
                               p8["kernels"]["max_abs_err"],
                               p12["cells"]["max_abs_err"],
                               p15["kernels"]["max_abs_err"],
                               p16["kernels"]["max_abs_err"],
                               p17["kernels"]["max_abs_err"]]
                              + [k["max_abs_err"] for k in cluster["kernels"]])
    names = PUBLISH_KERNELS + ("bitmap_or_dense",)
    mods = {name: {"15a": p15["15a"]["slice"]["launches"][name],
                   "15a_delayed": p15["15a"]["delayed_launches"].get(name, 0),
                   "15b": p15["15b"]["launches"].get(name, 0)}
            for name in names}
    ops = {name: {g: p16["launches"][g].get(name, 0) for g in ("16a", "16b")}
           for name in names}
    loops = {name: p17["launches"].get(name, 0) for name in names}
    return p13, p15, p16, p17, [
        {"name": "walk", "route": "cuda",
         "source": "emqx_tpu_torch/csrc/walk.cu",
         "replaces": "emqx_tpu/ops/walk_pallas.py:87",
         "launches": sl["launches"]["walk"],
         "plain_config_launches": p8["plain_launches"]["walk"],
         "churn_launches": p8["launches"]["walk"],
         "delta_ms": p8["kernels"]["delta_ms"],
         "delta_plain_ms": p8["kernels"]["delta_plain_ms"],
         "socket_launches": sock["launches"]["walk"],
         "devloss_launches": p9["launches"]["walk"],
         "mesh_launches": mesh_launches["walk"],
         "mesh_cell_ms": p12["cells"]["walk_ms"],
         "mesh_cell_plain_ms": p12["cells"]["walk_plain_ms"],
         "cluster_launches": cluster["launches"].get("walk", 0),
         "cluster_node_ms": [k["walk_ms"] for k in cluster["kernels"]],
         "modules_launches": mods["walk"],
         "modules_ms": p15["kernels"]["walk_ms"],
         "ops_launches": ops["walk"],
         "ops_ms": p16["kernels"]["walk_ms"],
         "loops_launches": loops["walk"],
         "loops_ms": p17["kernels"]["walk_ms"],
         "equal": True,
         "bound_by": "bytes", "library_ms": None, **walk},
        {"name": "bitmap_or", "route": "cuda",
         "source": "emqx_tpu_torch/csrc/bitmap_or.cu",
         "replaces": "emqx_tpu/ops/bitmap.py:199",
         "launches": sl["launches"]["bitmap_or"],
         "socket_launches": sock["launches"]["bitmap_or"],
         "devloss_launches": p9["launches"]["bitmap_or"],
         "mesh_launches": mesh_launches["bitmap_or"],
         "cluster_launches": cluster["launches"].get("bitmap_or", 0),
         "cluster_node_ms": [k["or_ms"] for k in cluster["kernels"]],
         "modules_launches": mods["bitmap_or"],
         "modules_ms": p15["kernels"]["or_ms"],
         "ops_launches": ops["bitmap_or"],
         "ops_ms": p16["kernels"]["or_ms"],
         "loops_launches": loops["bitmap_or"],
         "loops_ms": p17["kernels"]["or_ms"],
         "equal": True,
         "bound_by": "bytes", "library_ms": None, **bmp},
        # B4's path is the mesh's per-cell union: "launches" are 12a's
        # and 12b's, each counted from 0; the single-device paths launch
        # it no time, and its entry point or_bitmaps none
        {"name": "bitmap_or_dense", "route": "cuda",
         "source": "emqx_tpu_torch/csrc/bitmap_or_dense.cu",
         "replaces": "emqx_tpu/ops/bitmap.py:137",
         "launches": sum(mesh_launches["bitmap_or_dense"].values()),
         "path": "mesh (12a, 12b)",
         "mesh_launches": mesh_launches["bitmap_or_dense"],
         "mesh_cell_ms": p12["cells"]["or_ms"],
         "mesh_cell_b2_ms": p12["cells"]["or_b2_ms"],
         "mesh_cell_plain_ms": p12["cells"]["or_plain_ms"],
         "mesh_cell_bound_ms": p12["cells"]["or_bound_ms"],
         "main_launches": sl["launches"]["bitmap_or_dense"],
         "or_bitmaps_launches": sl["launches"]["or_bitmaps"],
         "socket_launches": sock["launches"].get("bitmap_or_dense", 0),
         "devloss_launches": p9["launches"].get("bitmap_or_dense", 0),
         "cluster_launches": cluster["launches"].get("bitmap_or_dense", 0),
         "modules_launches": mods["bitmap_or_dense"],
         "ops_launches": ops["bitmap_or_dense"],
         "loops_launches": loops["bitmap_or_dense"],
         "equal": True, "bound_by": "bytes", "library_ms": None, **b4},
    ]


# -- phase 8: route churn at full width -------------------------------------

#: churn filter shapes of the reference's churn bench (bench.py:1701-1960):
#: a literal root no config-2 topic has, a root '+', a $share prefix
CHURN_SHAPES = (("disjoint", lambda i: f"churn/{i}/leaf"),
                ("root_wildcard", lambda i: f"+/churnrw/{i}"),
                ("share", lambda i: f"$share/churngrp/churnsh{i}/leaf"))
#: phase 8's time budget, seconds (cut iterations, never the table)
PHASE8_BUDGET_S = 60.0
#: wall-clock cap of one 8a pass, seconds: a pass stops early (and
#: says so) when the churner starves the matcher of the router lock.
#: Cut from 2.5 s with the spans and the heartbeat on, to hold the run
#: under 1,100 s
CHURN_PASS_S = 1.5


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def result_filters(router, topics, ids_np, ovf_np, id_map):
    """The matched filter set of each topic from one ``match_ids``
    result: the id row through the snapshot's id map, or the exact
    host re-match of an overflowed row."""
    out = []
    for i, t in enumerate(topics):
        if ovf_np[i]:
            out.append(frozenset(router.host_match(t)))
        else:
            out.append(frozenset(f for f in (id_map[j] for j in ids_np[i]
                                             if j >= 0) if f is not None))
    return out


def matching_filters(rng, topics, n, taken, plus=2):
    """``n`` new filters that match config-2 topics: a topic of
    ``topics`` with ``plus`` of its 5 levels made '+' (the static set
    has one '+' a filter at most, so two '+' are always new)."""
    out = []
    seen = set(taken)
    i = 0
    while len(out) < n:
        ws = topics[i % len(topics)].split("/")
        i += 1
        if len(ws) != LEVELS:
            continue
        for lv in rng.choice(LEVELS, size=plus, replace=False):
            ws[int(lv)] = "+"
        f = "/".join(ws)
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


def churn_pass(router, batches, iters, mk=None, rate=10_000):
    """One timed pass of ``iters`` batches (at most
    :data:`CHURN_PASS_S` seconds) through ``Router.match_ids``;
    with ``mk``, a churner thread adds and deletes ``mk(i)`` filters at
    ``rate`` route ops/s in strict add→delete pairs (the reference's
    churn bench; it also yields the GIL after every op) and the
    trailing add is deleted after the join, so
    every pass leaves the filter set as it found it. Returns the
    latencies, the results (topics, ids, overflow, id map), the route
    ops' latencies, the achieved rate and the cache hit rate of the
    pass."""
    import threading

    cache = router._match_cache_obj
    h0, m0 = (cache.hits, cache.misses) if cache is not None else (0, 0)
    stop = threading.Event()
    op_lat, pending, churned = [], [None], [0]

    def churner():
        i = 0
        interval = 1.0 / rate
        next_t = time.perf_counter()
        while not stop.is_set():
            t_op = time.perf_counter()
            if pending[0] is None:
                pending[0] = mk(i)
                router.add_route(pending[0])
                i += 1
            else:
                router.delete_route(pending[0])
                pending[0] = None
            op_lat.append(time.perf_counter() - t_op)
            churned[0] += 1
            next_t += interval
            # behind schedule, still yield the GIL once an op, as an
            # event loop does between callbacks: a churner that never
            # sleeps re-takes the router lock before a waiting matcher
            # can, and starves it for seconds
            time.sleep(max(0.0, next_t - time.perf_counter()))

    th = threading.Thread(target=churner, daemon=True) if mk else None
    lat, results = [], []
    t1 = time.perf_counter()
    if th is not None:
        th.start()
    for it in range(iters):
        if time.perf_counter() - t1 > CHURN_PASS_S:
            break
        batch = batches[it % len(batches)]
        t0 = time.perf_counter()
        _, ids_np, ovf_np, id_map, _ = router.match_ids(batch)
        lat.append(time.perf_counter() - t0)
        results.append((batch, ids_np, ovf_np, id_map))
    if th is not None:
        stop.set()
        th.join(timeout=10)
        if th.is_alive():
            raise AssertionError("churner did not stop")
    wall = time.perf_counter() - t1
    if pending[0] is not None:
        router.delete_route(pending[0])
    hd = (cache.hits - h0) if cache is not None else 0
    md = (cache.misses - m0) if cache is not None else 0
    return {"lat": lat, "results": results, "op_lat": op_lat,
            "rate": churned[0] / max(wall, 1e-9),
            "hit_rate": hd / max(1, hd + md)}


def check_static(router, passes, want_cache, static):
    """Every result of ``passes`` against ``static``, the TrieOracle of
    the static filter set (every churn add was paired with its
    delete; memoized per topic)."""
    n = 0
    for p in passes:
        for topics, ids_np, ovf_np, id_map in p["results"]:
            got = result_filters(router, topics, ids_np, ovf_np, id_map)
            for t, g in zip(topics, got):
                w = want_cache.get(t)
                if w is None:
                    w = want_cache[t] = frozenset(static.match(t))
                if g != w:
                    raise AssertionError(f"churn: {t!r} matched {sorted(g)}, "
                                         f"the TrieOracle {sorted(w)}")
                n += 1
    return n


def phase_churn(router, draw, rng, iters, card, static):
    """8a: the reference's churn bench at full width — batches of 256
    Zipf(1.1) config-2 topics through ``Router.match_ids``, a pass
    without churn and a pass under 10,000 route ops/s for each filter
    shape; every result checked against the TrieOracle of the static
    set."""
    from emqx_tpu_torch.oracle import TrieOracle

    topics = zipf_topics(rng, draw, 256 * 8)
    batches = [topics[i * 256:(i + 1) * 256] for i in range(8)]
    probe = TrieOracle()
    for _, mk in CHURN_SHAPES:
        for i in range(3):
            probe.insert(mk(i))
    if any(probe.match(t) for t in topics):
        raise AssertionError("a churn filter matches a config-2 topic")
    log(f"[8a] cut: each pass capped at {CHURN_PASS_S} s (2.5 s before "
        f"the spans and the heartbeat), to hold the run under 1,100 s")
    want, out, n_checked = {}, {}, 0
    for name, mk in CHURN_SHAPES:
        base = churn_pass(router, batches, iters)
        churn = churn_pass(router, batches, iters, mk)
        n_checked += check_static(router, (base, churn), want, static)
        for kind, p in (("without churn", base), ("under churn", churn)):
            if len(p["lat"]) < iters:
                log(f"[8a] cut: the {name} pass {kind} ran {len(p['lat'])} "
                    f"of {iters} batches, at its {CHURN_PASS_S} s cap")
        row = {"p50_ms": _pct(base["lat"], 50),
               "p99_ms": _pct(base["lat"], 99),
               "churn_p50_ms": _pct(churn["lat"], 50),
               "churn_p99_ms": _pct(churn["lat"], 99),
               "rate": churn["rate"], "hit_rate": churn["hit_rate"],
               "base_hit_rate": base["hit_rate"],
               "route_op_p99_ms": _pct(churn["op_lat"], 99)}
        out[name] = row
        log(f"[8a] {name} ({mk(0)}): {len(churn['lat'])} batches of 256 "
            f"— match p50 "
            f"{row['p50_ms']:.3f} / p99 {row['p99_ms']:.3f} ms without "
            f"churn (hit rate {row['base_hit_rate']:.4f}), p50 "
            f"{row['churn_p50_ms']:.3f} / p99 {row['churn_p99_ms']:.3f} ms "
            f"under {row['rate']:.1f} route ops/s (target 10,000; hit "
            f"rate {row['hit_rate']:.4f}), route-op p99 "
            f"{row['route_op_p99_ms']:.3f} ms — {card}")
    info = router.delta_info()
    log(f"[8a] {n_checked} results equal the TrieOracle of the static set; "
        f"no churn filter matches a config-2 topic; delta {info}")
    return out


def phase_compaction(router, draw, rng, card, static):
    """8b: one off-lock compaction at full width. 4,096 new filters
    that match config-2 topics cross ``delta_max_filters``; while the
    background flatten runs, match batches and route ops (deletes of
    512 of them, 256 more adds) go on and every result is checked
    against the static set plus the live new filters. After the swap:
    parity again, one more merge, and the flatten seconds, the lock
    stall and the peak device memory across it."""
    import torch

    from emqx_tpu_torch.oracle import TrieOracle

    dev = router.device
    topics = zipf_topics(rng, draw, 256 * 8)
    batches = [topics[i * 256:(i + 1) * 256] for i in range(8)]
    n_new = router.config.delta_max_filters
    pending0 = router.delta_info()["pending"]
    new = matching_filters(rng, topics, n_new + 256, router._routes)
    first, later = new[:n_new - pending0], new[n_new - pending0:]
    live = TrieOracle()
    new_all = set()
    orig = router._flatten_main
    flat = {}

    def timed_flatten(cap, nb):
        t = time.perf_counter()
        out = orig(cap, nb)
        flat["s"] = time.perf_counter() - t
        return out

    router._flatten_main = timed_flatten

    def expected(batch):
        return [frozenset(static.match(t)) | frozenset(live.match(t))
                for t in batch]

    def check(batch, res, when):
        got = result_filters(router, batch, *res)
        for t, g, w in zip(batch, got, expected(batch)):
            if g != w:
                raise AssertionError(f"8b {when}: {t!r} matched {sorted(g)}, "
                                     f"want {sorted(w)}")
        return len(batch)

    try:
        info0 = router.delta_info()
        if dev.type == "cuda":
            _sync(dev)
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        add_lat = []
        for f in first:
            t0 = time.perf_counter()
            router.add_route(f)
            add_lat.append(time.perf_counter() - t0)
            live.insert(f)
            new_all.add(f)
        t_trig = time.perf_counter()
        if not router._compacting and router.delta_info()["merges"] == \
                info0["merges"]:
            raise AssertionError("8b: 4,096 pending adds started no "
                                 "compaction")
        ops = [("-", f) for f in first[:512]] + [("+", f) for f in later]
        rng.shuffle(ops)
        match_lat, op_lat, n_checked, i = [], [], 0, 0
        while router._compacting:
            batch = batches[i % len(batches)]
            i += 1
            t0 = time.perf_counter()
            _, ids_np, ovf_np, id_map, _ = router.match_ids(batch)
            match_lat.append(time.perf_counter() - t0)
            n_checked += check(batch, (ids_np, ovf_np, id_map), "during")
            for _ in range(4):
                if not ops:
                    break
                op, f = ops.pop()
                t0 = time.perf_counter()
                if op == "+":
                    router.add_route(f)
                else:
                    router.delete_route(f)
                op_lat.append(time.perf_counter() - t0)
                if op == "+":
                    live.insert(f)
                    new_all.add(f)
                else:
                    live.delete(f)
        t_swap = time.perf_counter()
        n_during = len(op_lat)
        for op, f in ops:  # what the flatten did not outlast
            (router.add_route if op == "+" else router.delete_route)(f)
            if op == "+":
                live.insert(f)
                new_all.add(f)
            else:
                live.delete(f)
        _sync(dev)
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**20 \
            if dev.type == "cuda" else None
        info = router.delta_info()
        if info["merges"] < info0["merges"] + 1:
            raise AssertionError(f"8b: no merge ({info})")
        for batch in batches:
            _, ids_np, ovf_np, id_map, _ = router.match_ids(batch)
            n_checked += check(batch, (ids_np, ovf_np, id_map), "after")
        stall = info["rebuild_stall_ms"] - info0["rebuild_stall_ms"]
        engine = "native" if router._native is not None else "Python"
        log(f"[8b] {engine} engine: {len(first)} adds crossed "
            f"delta_max_filters "
            f"{n_new}: add p99 {_pct(add_lat, 99):.3f} ms; off-lock "
            f"flatten {flat.get('s', float('nan')):.3f} s, trigger to swap "
            f"{t_swap - t_trig:.3f} s, lock stall {stall:.3f} ms, peak "
            f"device memory {peak if peak is None else f'{peak:.1f}'} MiB "
            f"over the {mem0 / 2**20 if dev.type == 'cuda' else 0:.1f} MiB "
            f"resident — {card}")
        log(f"[8b] during the flatten: {len(match_lat)} match batches of "
            f"256, p50 {_pct(match_lat, 50):.3f} / p99 "
            f"{_pct(match_lat, 99):.3f} ms; {n_during} route ops "
            f"(deletes of frozen filters, new adds), p99 "
            f"{_pct(op_lat, 99):.3f} ms — {card}")
        log(f"[8b] {n_checked} results (during and after the swap, the new "
            f"and deleted filters included) equal the oracle; delta {info}")
        out = {"flatten_s": flat.get("s"), "swap_s": t_swap - t_trig,
               "stall_ms": stall, "peak_mib": peak,
               "match_p50_ms": _pct(match_lat, 50),
               "match_p99_ms": _pct(match_lat, 99),
               "op_p99_ms": _pct(op_lat, 99),
               "add_p99_ms": _pct(add_lat, 99)}
    finally:
        del router._flatten_main
    # back to the static set: every new filter still routed goes
    for f in sorted(new_all):
        if router.has_route(f):
            router.delete_route(f)
    return out


def phase_patch(router, draw, rng, card, static):
    """8c: patch in place (``delta=False``, set by the caller): 1,000
    adds and deletes of matching filters; the drains' times and the
    bytes each clones; one drain re-applied on CPU copies of the
    tables and held equal; parity against the oracle. Ends with
    ``set_delta(True)`` and the cache back on."""
    import torch

    from emqx_tpu_torch.oracle import TrieOracle

    dev = router.device
    topics = zipf_topics(rng, draw, 256 * 4)
    batches = [topics[i * 256:(i + 1) * 256] for i in range(4)]
    new = matching_filters(rng, topics, 500, router._routes)
    drains = []
    orig = router._apply_patches_locked

    def timed_drain():
        old = router._auto
        _sync(dev)
        t0 = time.perf_counter()
        orig()
        _sync(dev)
        dt = time.perf_counter() - t0
        cloned = sum(t.numel() * t.element_size()
                     for t, o in ((router._auto.wt, old.wt),
                                  (router._auto.node2, old.node2))
                     if t is not o)
        drains.append((dt, cloned))

    router._apply_patches_locked = timed_drain
    try:
        rebuilds0 = router._rebuilds
        # 500 adds, then the deletes of every second one; the other 250
        # go after the parity check: 1,000 route ops
        ops = [("+", f) for f in new] + [("-", f) for f in new[::2]] + \
            [None] + [("-", f) for f in new[1::2]]
        op_lat, n_checked, checked_drain = [], 0, False
        live = TrieOracle()   # the new filters routed now
        p = router._patcher
        for i, step in enumerate(ops):
            if step is None:
                for batch in batches:
                    _, ids_np, ovf_np, id_map, _ = router.match_ids(batch)
                    got = result_filters(router, batch, ids_np, ovf_np,
                                         id_map)
                    want = [frozenset(static.match(t))
                            | frozenset(live.match(t)) for t in batch]
                    for t, g, w in zip(batch, got, want):
                        if g != w:
                            raise AssertionError(f"8c: {t!r} matched "
                                                 f"{sorted(g)}, want "
                                                 f"{sorted(w)}")
                    n_checked += len(batch)
                continue
            op, f = step
            t0 = time.perf_counter()
            (router.add_route if op == "+" else router.delete_route)(f)
            op_lat.append(time.perf_counter() - t0)
            (live.insert if op == "+" else live.delete)(f)
            p = router._patcher   # a capacity overflow re-flattens
            if i >= 400 and not checked_drain and not router._dirty \
                    and p.queued:
                # one drain held against the same queue on CPU copies
                with router._lock:
                    q_col, q_slot = list(p._col), list(p._slot)
                    before = router._auto
                    router._apply_patches_locked()
                    after = router._auto
                    p._col, p._slot = q_col, q_slot
                    cpu = p.apply_updates(before._replace(
                        wt=before.wt.cpu(), node2=before.node2.cpu()))
                if not (torch.equal(cpu.wt, after.wt.cpu())
                        and torch.equal(cpu.node2, after.node2.cpu())):
                    raise AssertionError("8c: a patch drain on the card "
                                         "differs from the same drain on "
                                         "the CPU")
                log(f"[8c] a drain of {len(q_col)} column and "
                    f"{len(q_slot)} slot updates on the card equals the "
                    f"same drain on CPU copies of the tables")
                checked_drain = True
        if not checked_drain:
            raise AssertionError("8c: no queued drain to check")
        if router._rebuilds != rebuilds0:
            raise AssertionError("8c: a route op re-flattened the table")
    finally:
        del router._apply_patches_locked
    times = [d[0] * 1e3 for d in drains]
    log(f"[8c] patch in place: {len(op_lat)} route ops (p99 "
        f"{_pct(op_lat, 99):.3f} ms), {len(drains)} drains "
        f"(patch_drain_batch={router.config.patch_drain_batch}): "
        f"{', '.join(f'{t:.3f}' for t in times)} ms, "
        f"{drains[0][1] if drains else 0} bytes cloned a drain; "
        f"{n_checked} results equal the oracle; no re-flatten — {card}")
    t0 = time.perf_counter()
    router.set_delta(True)
    router.config.match_cache = True
    log(f"[8c] set_delta(True): one rebuild, {time.perf_counter() - t0:.1f} s "
        f"— {card}")
    return {"drain_ms": times, "bytes": drains[0][1] if drains else 0,
            "op_p99_ms": _pct(op_lat, 99)}


def phase_delta_kernels(router, draw, rng, card):
    """Phase 8's kernel checks at the main path's shapes: the delta
    walk on B1 against the plain walk, bit for bit; 2 B1 launches on a
    batch with pending delta adds; the cache's insert and merge, the
    tombstone mask and the packed union on the card against the same
    calls on CPU copies; their device times."""
    import torch

    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops.delta import mask_ids, union_packed
    from emqx_tpu_torch.ops.match import match_batch
    from emqx_tpu_torch.ops.match_cache import (MatchCache, insert_rows,
                                                merge_rows)
    from emqx_tpu_torch.ops.walk_cuda import match_batch_cuda

    # launches made to compare or time a kernel do not count
    saved = dict(_build.LAUNCHES)
    topics = zipf_topics(rng, draw, 4096)
    uniq = list(dict.fromkeys(topics))
    new = matching_filters(rng, uniq, 300, router._routes)
    # 50 routed filters with one local route: their deletes are
    # tombstones against the main tables (re-added at the end)
    dropped = [f for f in draw[:2000]
               if router._routes.get(f) == {router.node: 1}][:50]
    for f in new:
        router.add_route(f)
    for f in dropped:
        router.delete_route(f)
    cfg = router.config
    main, snap = router._snapshot_pair()
    if snap is None or snap.auto is None or snap.mask is None:
        raise AssertionError("no pending adds or tombstones in the delta")
    args, kw = router.walk_inputs(uniq)
    B, L = args[0].shape
    dkw = dict(k=snap.k, m=kw["m"], steps=snap.steps_for(L), slots=2,
               take=1)
    err = 0
    for pack in (True, False):
        err = max(err, check_walk(snap.auto, args, dict(dkw, pack_ids=pack),
                                  f"delta automaton ({snap.n_pending} pending "
                                  f"adds, k={snap.k}) B={B} L={L} "
                                  f"pack_ids={pack}"))
    err = max(err, check_walk(snap.auto, args, dict(dkw, k=1),
                              f"delta automaton B={B} L={L} k=1"))
    d_ms = kernel_ms(lambda: match_batch_cuda(snap.auto, *args, **dkw),
                     "walk_kernel")
    d_plain = time_cuda_ms(lambda: match_batch(snap.auto, *args, **dkw),
                           iters=3, warmup=1)
    cache = router._match_cache()
    m0 = cache.misses
    before = _build.LAUNCHES["walk"]
    router.match_dispatch(uniq)
    _sync(router.device)
    n_walk = _build.LAUNCHES["walk"] - before
    if cache.misses == m0 or n_walk != 2:
        raise AssertionError(f"a batch with pending delta adds launched B1 "
                             f"{n_walk} times ({cache.misses - m0} misses)")
    log(f"[8] delta walk on B1: kernel {d_ms:.5f} ms, plain {d_plain:.4f} "
        f"ms at B={B}; one dispatch with {snap.n_pending} pending adds and "
        f"{len(snap.mask.nonzero())} tombstones launched B1 {n_walk} times "
        f"— {card}")
    # the glue ops: card against CPU copies, at the main path's shapes
    res = match_batch_cuda(main[0], *args, **dict(kw, pack_ids=True))
    dres = match_batch_cuda(snap.auto, *args, **dict(dkw, pack_ids=True))
    raw = match_batch_cuda(main[0], *args, **kw).ids
    m = cfg.max_matches
    rows, ovf = union_packed(res.ids, dres.ids, m=m)
    slots = [int(s) for s in rng.permutation(cache.slots)[:B]]
    table = cache._table_now()
    hits = [int(s) for s in rng.permutation(cache.slots)[:B // 2]]
    hpos = [int(x) for x in rng.permutation(B)]
    mpos, hpos = hpos[B // 2:], hpos[:B // 2]
    calls = {
        "union_packed": lambda t: union_packed(t[0], t[1], m=m),
        "mask_ids": lambda t: (mask_ids(t[2], t[3]),),
        "insert_rows": lambda t: (insert_rows(t[4], slots, t[5], t[6]),),
        "merge_rows": lambda t: merge_rows(t[4], hits, hpos, t[5], t[6],
                                           mpos, B),
    }
    on_card = (res.ids, dres.ids, raw, snap.mask, table, rows, ovf)
    on_cpu = tuple(x.cpu() for x in on_card)
    glue = {}
    for name, fn in calls.items():
        for x, y in zip(fn(on_card), fn(on_cpu)):
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"{name} on the card != on the CPU")
        glue[name] = device_ms(lambda fn=fn: fn(on_card))
    # the probe is host work: a hit probe and a stale probe of the
    # batch on a cache of the same size
    c = MatchCache(cfg.match_cache_slots, m, router.device)
    p = c.probe(uniq, 0)
    c.insert(p, rows, ovf)
    t0 = time.perf_counter()
    c.probe(uniq, 0)
    hit_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    c.probe(uniq, 1)
    stale_ms = (time.perf_counter() - t0) * 1e3
    log(f"[8] glue on the card equals the CPU: "
        + ", ".join(f"{k} {v:.5f} ms" for k, v in glue.items())
        + f" of device time at B={B}, m={m}, {cache.slots} slots; cache "
        f"probe (host) {hit_ms:.3f} ms all hits, {stale_ms:.3f} ms all "
        f"stale — {card}")
    for f in dropped:
        router.add_route(f)
    for f in new:
        router.delete_route(f)
    _build.LAUNCHES.update(saved)
    _build.LAUNCHES["walk"] += n_walk
    return {"delta_ms": d_ms, "delta_plain_ms": d_plain, "max_abs_err": err,
            "glue_ms": glue, "probe_hit_ms": hit_ms,
            "probe_stale_ms": stale_ms}


#: 8d's publish batches (cut from 5 to make room for phase 13; printed)
P8D_BATCHES = 3


def phase_broker_churn(broker, batches, rng, card, static):
    """8d: the broker with the defaults — :data:`P8D_BATCHES` publish
    batches of 4,096;
    between batches 64 real subscribers subscribe to new matching
    filters and the previous 64 unsubscribe. Every delivery checked
    against the oracle; no re-flatten; the fan-out rebuild
    (``FanoutManager.state``, on every membership change) timed apart
    from begin, fetch and finish."""
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.oracle import TrieOracle
    from emqx_tpu_torch.types import Message

    router = broker.router
    rebuilds0 = router._rebuilds
    orig = broker.helper.state
    fan = []

    def timed_state(epoch, id_map):
        t0 = time.perf_counter()
        st = orig(epoch, id_map)
        fan.append(time.perf_counter() - t0)
        return st

    broker.helper.state = timed_state
    prev = []
    split = np.zeros(4)  # begin less fan-out, fan-out, fetch, finish
    n_del, launches = 0, 0
    try:
        for bi, batch in enumerate(batches[:P8D_BATCHES]):
            for s, f in prev:
                broker.unsubscribe(s, f)
            uniq = list(dict.fromkeys(batch))
            prev = [(Sink(10_000_000 + bi * 64 + j), f) for j, f in
                    enumerate(matching_filters(rng, uniq, 64,
                                               router._routes))]
            fresh = TrieOracle()
            for s, f in prev:
                broker.subscribe(s, f)
                fresh.insert(f)
            msgs = [Message(topic=t, payload=b"x") for t in batch]
            Sink.log = []
            before = _build.LAUNCHES["walk"]
            n_fan = len(fan)
            t0 = time.perf_counter()
            pb = broker.publish_begin(msgs)
            t1 = time.perf_counter()
            broker.publish_fetch(pb)
            t2 = time.perf_counter()
            res = broker.publish_finish(pb)
            t3 = time.perf_counter()
            if pb.done is not True or pb.host_topics is not None:
                raise AssertionError(f"8d batch {bi}: not the device path")
            f_s = sum(fan[n_fan:])
            split += (t1 - t0 - f_s, f_s, t2 - t1, t3 - t2)
            launches += _build.LAUNCHES["walk"] - before
            deliveries, Sink.log = Sink.log, None
            check_batches(broker, [(msgs, res)], deliveries,
                          OracleUnion(static, fresh))
            n_del += len(deliveries)
            if not any(sid >= 10_000_000 for _, sid, _ in deliveries):
                raise AssertionError(f"8d batch {bi}: no new subscriber "
                                     f"got a delivery")
        for s, f in prev:
            broker.unsubscribe(s, f)
    finally:
        del broker.helper.state
        Sink.log = None
    if router._rebuilds != rebuilds0:
        raise AssertionError("8d: a subscription re-flattened the table")
    ms = split / P8D_BATCHES * 1e3
    log(f"[8d] {P8D_BATCHES} batches of 4,096 (cut from 5), 64 subscribers "
        f"in and 64 out between "
        f"batches: {n_del} deliveries equal the oracle, no re-flatten "
        f"(rebuilds {router._rebuilds}), B1 launches {launches}; per batch "
        f"begin {ms[0]:.3f} ms + fan-out rebuild {ms[1]:.3f} ms "
        f"(FanoutManager.state, on every membership change), fetch "
        f"{ms[2]:.3f} ms, finish {ms[3]:.3f} ms — {card}")
    return {"split_ms": ms.tolist(), "launches": launches}


def run_phase8(broker, draw, batches, rng, opts, card, oracle):
    """Phase 8 on phase 5's node (the native engine), switched to patch
    in place first: 8c (which ends with the defaults back on), the
    kernel checks, 8a, 8b and 8d (:func:`run_plain` repeats 8b on the
    Python engine with the same draws). The B1 launches are counted
    from 0 at the phase's start; 8a's passes stop at
    :data:`CHURN_PASS_S` each to hold the phase near
    :data:`PHASE8_BUDGET_S` (a cut is printed)."""
    from emqx_tpu_torch.ops import _build

    router = broker.router
    router.config.match_cache = False
    t0 = time.perf_counter()
    router.set_delta(False)
    log(f"[8] set_delta(False) on the native engine: one rebuild "
        f"{time.perf_counter() - t0:.1f} s — {card}")
    _build.reset_launches()
    t0 = time.perf_counter()
    out = {"8c": timed("8c (patch in place)", phase_patch, router, draw,
                       rng, card, oracle)}
    out["kernels"] = timed("8 (delta kernels)", phase_delta_kernels, router,
                           draw, rng, card)
    out["8a"] = timed("8a (route churn)", phase_churn, router, draw, rng,
                      opts.churn_iters, card, oracle)
    out["8b"] = timed("8b (off-lock compaction, native engine)",
                      phase_compaction, router, draw,
                      np.random.default_rng(opts.seed + 8), card, oracle)
    out["8d"] = timed("8d (broker under churn)", phase_broker_churn, broker,
                      batches, rng, card, oracle)
    out["launches"] = dict(_build.LAUNCHES)
    out["seconds"] = time.perf_counter() - t0
    log(f"[8] phase 8 took {out['seconds']:.1f} s (budget "
        f"{PHASE8_BUDGET_S:.0f} s); B1 launches {out['launches']['walk']} "
        f"— {card}")
    return out


def run_plain(pairs, batches, warm, draw, opts, device, card, oracle, p8):
    """The A/B's other side, the path before the host engines: phase 5
    on the same batches (:func:`phase_slice_plain`), then 8b on the
    same node's Python engine with the match cache and the delta
    automaton on, as the native run had them, and 8b's draws (the
    same new filters and topics). Adds ``plain_launches`` and
    ``8b_py`` to ``p8``."""
    from emqx_tpu_torch.gc import GcPolicy

    gmark = (GcPolicy.forced, 0)  # a node starts with its counters at 0
    node, sl = phase_slice_plain(pairs, batches, warm, opts, device, card,
                                 oracle)
    p8["plain_launches"] = sl["launches"]
    router = node.broker.router
    router.config.match_cache = True
    t0 = time.perf_counter()
    router.set_delta(True)
    log(f"[8] set_delta(True) on the Python engine: one rebuild "
        f"{time.perf_counter() - t0:.1f} s — {card}")
    py = p8["8b_py"] = timed(
        "8b (off-lock compaction, Python engine)", phase_compaction,
        router, draw, np.random.default_rng(opts.seed + 8), card, oracle)
    check_quiet(node, "5 and 8b, plain config")
    log_gc(node, "5 and 8b, plain config", gmark)
    nat = p8["8b"]
    log(f"[8b] native against Python engine at {len(router._filter_ids)} "
        f"filters, the same draws: flatten {nat['flatten_s']:.3f} / "
        f"{py['flatten_s']:.3f} s, lock stall {nat['stall_ms']:.3f} / "
        f"{py['stall_ms']:.3f} ms, match p50 {nat['match_p50_ms']:.3f} / "
        f"{py['match_p50_ms']:.3f} ms, p99 {nat['match_p99_ms']:.3f} / "
        f"{py['match_p99_ms']:.3f} ms, route-op p99 {nat['op_p99_ms']:.3f} "
        f"/ {py['op_p99_ms']:.3f} ms during the flatten — {card}")


def phase_slice_plain(pairs, batches, warm, opts, device, card, oracle):
    """Phase 5 again on the same batches in the plain configuration,
    the path before the host engines: a second node with
    ``match_cache=False, delta=False, use_native=False`` and
    ``preserialize=False`` takes the same subscriptions (the Python
    trie and flatten, both timed); a warm batch first builds its
    fan-out tables, as the setup's first batch did. Returns the node
    and the slice's numbers."""
    from emqx_tpu_torch.broker import DispatchConfig
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.router import MatcherConfig
    from emqx_tpu_torch.types import Message

    node = Node(device=device, batch_size=opts.batch,
                matcher=MatcherConfig(match_cache=False, delta=False,
                                      use_native=False),
                dispatch_config=DispatchConfig(preserialize=False))
    broker = node.broker
    sub_s = subscribe_pairs(broker, pairs)
    t0 = time.perf_counter()
    broker.router.automaton()
    rebuild_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    broker.publish_batch([Message(topic=t) for t in warm])
    log(f"[slice, plain config] the same {len(pairs)} subscriptions on a "
        f"Python-engine node: subscribe {sub_s:.1f} s, build of the "
        f"automaton on the Python engine {rebuild_s:.1f} s; warm batch "
        f"(fan-out tables) {time.perf_counter() - t0:.1f} s — {card}")
    return node, phase_slice(broker, batches, card, oracle,
                             label="slice, plain config")


# -- phase 12: the device mesh on one card -----------------------------------

#: 12b's grid: a 2×2 mesh that names the card four times, so every cell
#: runs its own B1 (and B2) and every collective runs, on one device
MESH_GRID = (2, 2)
#: phase 12's time budget, printed against what it took
P12_BUDGET_S = 150.0
#: of phase 5's 20 batches, the ones 12a and 12b drive (cut from all 20
#: to make room for phase 13; printed)
P12A_BATCHES = 10
P12B_BATCHES = 4
#: the filters 12a and 12b subscribe: phase 5's set cut to this many,
#: every class whole but the '+' one, as 13a's (each node's 1.06M
#: subscriptions took 28-29 s of host time on the card's host and the
#: whole script crossed the 1,200 s limit on a slower one; printed)
P12_ROUTES = 250_000
#: 12b's route ops (subscribes of new filters and unsubscribes of
#: config-2 ones): one patch-drain batch
P12_ROUTE_OPS = 256


def mesh_node(pairs, warm, mesh, opts, device, card, label):
    """A node whose router runs on ``mesh`` (everything else at the
    defaults) with ``pairs`` subscribed, its automaton built and a warm
    batch through (the per-shard fan-out tables)."""
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.router import MatcherConfig
    from emqx_tpu_torch.types import Message

    node = Node(device=device, batch_size=opts.batch,
                matcher=MatcherConfig(mesh=mesh))
    sub_s = subscribe_pairs(node.broker, pairs)
    t0 = time.perf_counter()
    node.router.automaton()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    node.broker.publish_batch([Message(topic=t) for t in warm])
    log(f"[{label}] {mesh!r}: {len(pairs)} subscriptions: "
        f"subscribe {sub_s:.1f} s, the sharded build on the native engine "
        f"{build_s:.1f} s, warm batch (the per-shard fan-out tables) "
        f"{time.perf_counter() - t0:.1f} s — {card}")
    return node


def local_on(local, keep):
    """A run's local ``(sid, filter)`` deliveries, message by message,
    restricted to the ``(sink, filter)`` pairs of ``keep`` (a '+'
    filter cut away may still be a kept $share group's filter)."""
    kept = {(sink.sid, f) for sink, f in keep if not f.startswith("$share/")}
    out = {}
    for k, v in local.items():
        v = [x for x in v if x in kept]
        if v:
            out[k] = v
    return out


def same_deliveries(want, got, label, what):
    """Every message's local (sink, filter) deliveries against another
    run's on the same batches."""
    if want.keys() != got.keys() or any(want[k] != got[k] for k in want):
        bad = sorted(k for k in want.keys() | got.keys()
                     if want.get(k) != got.get(k))
        raise AssertionError(f"[{label}] deliveries differ from {what} at "
                             f"{len(bad)} messages, first {bad[:3]}")
    log(f"[{label}] every message's deliveries ({sum(map(len, got.values()))}"
        f" local, {len(got)} messages) equal {what}")


def mesh_cells(node, topics, card):
    """12b, per cell: B1 on the cell's inputs (its data shard of one
    batch, its trie shard's tables) against the plain walk, and B4's
    dense union of the cell's big-filter rows, and B2 over every topic
    on the same rows (the design B4 had before its own kernel), against
    the plain OR; the kernels' device times per cell (B4 and B2 in
    turns). Launches made here do not count."""
    import torch

    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops.bitmap import (BitmapTable, or_bitmaps_cuda,
                                           or_bitmaps_ref, or_union_rows_cuda,
                                           rows_for_matches)
    from emqx_tpu_torch.ops.match import match_batch
    from emqx_tpu_torch.ops.walk_cuda import match_batch_cuda
    from emqx_tpu_torch.parallel.sharded import _cell_auto

    saved = dict(_build.LAUNCHES)
    router = node.router
    cfg = router.config
    mesh = cfg.mesh
    uniq = list(dict.fromkeys(topics))
    auto, id_map, epoch = router.automaton()
    st = node.broker.helper.sharded_state(epoch, id_map, mesh,
                                          router.effective_d())
    ids, n, sysm, _ = router.encode_place_sharded(uniq)
    kw = dict(k=router.effective_k(), m=cfg.max_matches,
              **router._walk_kw(ids.shape[-1]))
    err = 0
    out = {"walk_ms": [], "walk_plain_ms": [], "or_ms": [],
           "or_plain_ms": [], "or_bound_ms": [], "or_b2_ms": []}
    for i, t, _dev in mesh.cells():
        a = _cell_auto(auto, i, t)
        args = (ids.cell(i, t), n.cell(i, t), sysm.cell(i, t))
        b = args[0].shape[0]
        err = max(err, check_walk(a, args, kw, f"12b cell ({i}, {t}), its "
                                  f"data shard B={b} L={args[0].shape[1]}"))
        res = match_batch_cuda(a, *args, **kw)
        bt = BitmapTable(st.bm.bitmaps.cell(i, t), st.bm.big_row.cell(i, t),
                         0, 0)
        rows_b, _ovf = rows_for_matches(bt, res.ids, mb=cfg.fanout_mb)
        every = torch.arange(b, dtype=torch.int32, device=rows_b.device)
        got = or_bitmaps_cuda(bt.bitmaps, rows_b)
        want = or_bitmaps_ref(bt.bitmaps, rows_b)
        b2 = or_union_rows_cuda(bt.bitmaps, rows_b, every)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(b2, want):
            raise AssertionError(f"[12b] cell ({i}, {t}): B4 or B2 != "
                                 f"plain OR")
        del got, want, b2
        live = int((rows_b >= 0).sum())
        out["b"] = b
        out["walk_ms"].append(kernel_ms(
            lambda: match_batch_cuda(a, *args, **kw), "walk_kernel"))
        out["walk_plain_ms"].append(time_cuda_ms(
            lambda: match_batch(a, *args, **kw), iters=3, warmup=1))
        dense = [kernel_ms(fn, name) for fn, name in (
            (lambda: or_union_rows_cuda(bt.bitmaps, rows_b, every),
             "bitmap_or_kernel"),
            (lambda: or_bitmaps_cuda(bt.bitmaps, rows_b),
             "bitmap_or_dense_kernel"),
            (lambda: or_bitmaps_cuda(bt.bitmaps, rows_b),
             "bitmap_or_dense_kernel"),
            (lambda: or_union_rows_cuda(bt.bitmaps, rows_b, every),
             "bitmap_or_kernel"))]
        out["or_ms"].append(min(dense[1], dense[2]))
        out["or_b2_ms"].append(min(dense[0], dense[3]))
        out["or_plain_ms"].append(time_cuda_ms(
            lambda: or_bitmaps_ref(bt.bitmaps, rows_b), iters=3, warmup=1))
        distinct = int(torch.unique(rows_b[rows_b >= 0]).numel())
        out["or_bound_ms"].append(or_bound_ms(*bt.bitmaps.shape, b,
                                              cfg.fanout_mb, distinct))
        log(f"[12b] cell ({i}, {t}): B4 dense union [{b}, "
            f"{bt.bitmaps.shape[1]}] of {live} live row slots equal to the "
            f"plain OR, and B2 over every topic; B1 "
            f"{out['walk_ms'][-1]:.5f} ms (plain "
            f"{out['walk_plain_ms'][-1]:.4f}), B4 {dense[1]:.5f} / "
            f"{dense[2]:.5f} ms against B2's {dense[0]:.5f} / "
            f"{dense[3]:.5f} ms ({out['or_ms'][-1] / out['or_b2_ms'][-1]:.3f}"
            f"x; plain {out['or_plain_ms'][-1]:.4f}, bound "
            f"{out['or_bound_ms'][-1]:.5f}, bytes) — {card}")
    _build.LAUNCHES.update(saved)
    out["max_abs_err"] = err
    return out


def mesh_churn(node, pairs, batch, rng, card, oracle):
    """12b: route ops patch only their shards' tables. One subscribe of
    a new filter drains into its shard alone (the other shard keeps its
    tensors); then :data:`P12_ROUTE_OPS` subscribes and unsubscribes in
    all, with no full rebuild, and a batch checked against the
    TrieOracle (updated with the same ops)."""
    from emqx_tpu_torch.parallel.sharded import shard_of
    from emqx_tpu_torch.types import Message

    broker, router = node.broker, node.router
    n_trie = router.config.mesh.shape["trie"]
    uniq = list(dict.fromkeys(batch))
    half = P12_ROUTE_OPS // 2
    new = matching_filters(rng, uniq, half, router._routes)
    gone = [(s, f) for s, f in pairs[:20 * half]
            if router._routes.get(f) == {router.node: 1}][:half]
    router.automaton()
    rebuilds, patches = router.stats()["rebuilds"], router.stats()["patches"]
    before = dict(router._auto.wt.parts)
    sink0 = Sink(20_000_000)
    broker.subscribe(sink0, new[0])
    oracle.insert(new[0])
    router.automaton()
    t0 = shard_of(new[0], n_trie)
    after = router._auto.wt.parts
    kept = [key for key in before if after[key] is before[key]]
    if sorted(kept) != sorted(k for k in before if k[0] != t0):
        raise AssertionError(f"[12b] one subscribe into shard {t0} "
                             f"replaced the tables of {kept}")
    lat = []
    for j, f in enumerate(new[1:]):
        t1 = time.perf_counter()
        broker.subscribe(Sink(20_000_001 + j), f)
        lat.append(time.perf_counter() - t1)
        oracle.insert(f)
    for s, f in gone:
        t1 = time.perf_counter()
        broker.unsubscribe(s, f)
        lat.append(time.perf_counter() - t1)
        oracle.delete(f)
    n_ops = 1 + len(lat)
    msgs = [Message(topic=t, payload=b"x") for t in batch]
    Sink.log = []
    res = broker.publish_batch(msgs)
    deliveries, Sink.log = Sink.log, None
    check_batches(broker, [(msgs, res)], deliveries, oracle)
    st = router.stats()
    if st["rebuilds"] != rebuilds or st["patches"] - patches != n_ops:
        raise AssertionError(f"[12b] {n_ops} route ops: rebuilds "
                             f"{rebuilds} -> {st['rebuilds']}, patches "
                             f"+{st['patches'] - patches}")
    lat_ms = np.sort(np.array(lat) * 1e3)
    log(f"[12b] churn: one subscribe patched shard {t0} alone (shard "
        f"{1 - t0 if n_trie == 2 else 'others'} kept its tensors); "
        f"{n_ops} route ops ({len(new)} subscribes of new filters, "
        f"{len(gone)} unsubscribes), each shard patched in place: "
        f"{st['patches'] - patches} patches, rebuilds {rebuilds} -> "
        f"{st['rebuilds']}; route-op p50 {np.percentile(lat_ms, 50):.3f} ms, "
        f"p99 {np.percentile(lat_ms, 99):.3f} ms; the next batch of "
        f"{len(msgs)} ({len(deliveries)} deliveries) matches the "
        f"TrieOracle — {card}")
    return {"ops": n_ops, "rebuilds": st["rebuilds"] - rebuilds}


def mesh_boost_d(device, card):
    """12b: a fan-only overflow grows d and not k (the JAX package's
    ``test_mesh_fan_overflow_boosts_d_not_k`` on the 2×2 grid of the
    card): three filters of two subscribers each and ``fanout_d=2``, so
    a shard holding two of them gathers 4 > d deliveries while the
    match stays inside k; every publish delivers exactly."""
    from emqx_tpu_torch.broker import Broker
    from emqx_tpu_torch.parallel.mesh import make_mesh
    from emqx_tpu_torch.router import MatcherConfig, Router
    from emqx_tpu_torch.types import Message

    mesh = make_mesh(*MESH_GRID, [device] * 4)
    b = Broker(router=Router(MatcherConfig(mesh=mesh, fanout_d=2),
                             node="local", device=device))
    for j, f in enumerate(("m/+", "m/#", "m/a")):
        for k in range(2):
            b.subscribe(Sink(2 * j + k), f)
    r = b.router
    k0, ds = r.effective_k(), [r.effective_d()]
    fan_only = []
    for _ in range(4):
        pb = b.publish_begin([Message(topic="m/a")])
        b.publish_fetch(pb)
        fan_only.append(bool(pb.ovf[0]) and not bool(pb.movf[0]))
        if b.publish_finish(pb) != [6]:
            raise AssertionError("[12b] boost_d: a publish did not deliver 6")
        ds.append(r.effective_d())
    if not fan_only[0] or ds[1] <= ds[0] or r.effective_k() != k0 \
            or fan_only[-1]:
        raise AssertionError(f"[12b] boost_d: d {ds}, k {k0} -> "
                             f"{r.effective_k()}, fan-only {fan_only}")
    log(f"[12b] a fan-only overflow grew d and not k: d "
        f"{' -> '.join(map(str, ds))}, k {k0} unchanged, fan-only overflow "
        f"per publish {fan_only}, 6 deliveries each — {card}")
    return {"d": ds}


def run_mesh(pairs, batches, warm, opts, device, card, p5, walk):
    """Phase 12, the device mesh on the card, on phase 5's subscriptions
    cut to :data:`P12_ROUTES` filters and its batches, one node at a
    time: (12a) ``default_mesh()``
    (1×1 on the one card), every message's deliveries equal phase 5's
    and the TrieOracle's, msgs/s and p50/p99 beside phase 5's; (12b) a
    :data:`MESH_GRID` grid of the card: B1 and B4 (the dense union) four
    times a batch, B2 never, deliveries equal 12a's; both with the idle
    share of three batches under the profiler; each cell's B1 and B4
    equal to their plain twins with device times, B4 beside B2 run over
    every topic on the same rows, the churn of :func:`mesh_churn` and the
    ``boost_d`` of :func:`mesh_boost_d`. Returns the launches and
    times for the kernel line."""
    from emqx_tpu_torch.parallel.mesh import default_mesh, make_mesh

    t_start = time.perf_counter()
    keep, n_plus = cluster_pairs(pairs, opts.subs, P12_ROUTES)
    log(f"[12] cut: 12a drives {min(P12A_BATCHES, len(batches))} and 12b "
        f"{min(P12B_BATCHES, len(batches))} of phase 5's {len(batches)} "
        f"batches; both subscribe {n_plus} of its {opts.subs} '+' filters "
        f"(every other class whole), {len(keep)} of its {len(pairs)} "
        f"subscriptions, to hold the run's time")
    # the one-card deployment's default; a CPU rehearsal names its device
    mesh = default_mesh() if device == "cuda" else default_mesh(
        devices=[device])
    node = mesh_node(keep, warm, mesh, opts, device, card, "12a")
    t0 = time.perf_counter()
    oracle = route_oracle(node.router)
    log(f"[12] the checks' TrieOracle of the {len(node.router._filter_ids)} "
        f"filters {time.perf_counter() - t0:.1f} s")
    cells = {"walk": mesh.size, "bitmap_or_dense": mesh.size,
             "bitmap_or": 0}
    sa = phase_slice(node.broker, batches[:P12A_BATCHES], card, oracle,
                     label="12a", per_batch=cells, kernels=MESH_KERNELS)
    same_deliveries(local_on({k: v for k, v in p5["local"].items()
                              if k[0] < P12A_BATCHES}, keep), sa["local"],
                    "12a", "phase 5's node's (its deliveries on 12's "
                    "filters)")
    phase_profile(node.broker, batches, card, MESH_KERNELS)
    check_quiet(node, "12a")
    del node
    gc.collect()
    mesh = make_mesh(*MESH_GRID, [device] * 4)
    node = mesh_node(keep, warm, mesh, opts, device, card, "12b")
    cells = {"walk": mesh.size, "bitmap_or_dense": mesh.size,
             "bitmap_or": 0}
    sb = phase_slice(node.broker, batches[:P12B_BATCHES], card, oracle,
                     label="12b", per_batch=cells, kernels=MESH_KERNELS)
    same_deliveries({k: v for k, v in sa["local"].items()
                     if k[0] < P12B_BATCHES}, sb["local"], "12b", "12a's")
    phase_profile(node.broker, batches, card, MESH_KERNELS)
    per_cell = mesh_cells(node, batches[0], card)
    churn = mesh_churn(node, keep, batches[1], np.random.default_rng(
        opts.seed + 12), card, oracle)
    check_quiet(node, "12b")
    del node
    gc.collect()
    boost = mesh_boost_d(device, card)
    for label, x in (("phase 5", p5), ("12a", sa), ("12b", sb)):
        log(f"[12] {label}: {x['msgs_per_s']:.1f} msgs/s, p50 "
            f"{x['p50_ms']:.3f} ms, p99 {x['p99_ms']:.3f} ms — {card}")
    log(f"[12] B1 device ms per cell of 12b (its data shard of "
        f"{per_cell['b']} topics): "
        f"{', '.join(f'{x:.5f}' for x in per_cell['walk_ms'])}; phase 5's "
        f"one-device B1 at {len(batches[0])} topics {walk['ms']:.5f} — "
        f"{card}")
    took = time.perf_counter() - t_start
    log(f"[12] phase 12 took {took:.1f} s of its {P12_BUDGET_S:.0f} s "
        f"budget — {card}")
    return {"launches": {"12a": sa["launches"], "12b": sb["launches"]},
            "cells": per_cell, "churn": churn, "boost_d": boost,
            "seconds": took}


# -- phase 13: the cluster on the card ----------------------------------------

#: phase 13's time budget, printed against what it took
P13_BUDGET_S = 180.0
#: 13a's filters: phase 5's set cut to this many, every class whole but
#: the '+' one (route replication with both nodes in one process took
#: 122-207 µs of host time a route at 252,508 routes on the card's
#: hosts: the 1.02M routes of the uncut set would take 125-212 s, past
#: the phase's budget before a batch is published; 250,000 until phase
#: 17 needed the script's room, 55-80 s of replication at that size)
P13_ROUTES = 125_000
#: 13b: retained messages stored on node 0 and replicated, and the
#: SUBSCRIBE burst on node 1
P13_RETAINED = 10_000
P13_BURST = 64
#: 13c: the persistent session's filters, the rounds of live QoS 1
#: traffic (one message a filter, on node 0 and node 1 in turn) and the
#: round after which it reconnects on node 1 (an odd one: that round's
#: forwards to node 0 are still in flight)
P13_TAKEOVER_FILTERS = 8
P13_TAKEOVER_ROUNDS = 12
P13_TAKEOVER_AT = 5
#: 13d: the JAX partition bench's routes and churn window
#: (bench.py:2697-2699)
P13_PARTITION_ROUTES = 3000
P13_PARTITION_WINDOW_S = 3.0


#: the JAX partition bench's ClusterConfig fields (bench.py:2700-2704):
#: heartbeats every 0.1 s, down after 3 misses, anti-entropy every 0.5 s
PARTITION_BENCH = dict(
    heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
    suspect_after=1, down_after=3, ok_after=1,
    anti_entropy_interval_s=0.5, call_timeout_s=2.0,
    redial_backoff_s=0.1, redial_backoff_max_s=0.5)


def partition_bench_config():
    """The JAX partition bench's ClusterConfig, :data:`PARTITION_BENCH`."""
    from emqx_tpu_torch.cluster import ClusterConfig

    return ClusterConfig(**PARTITION_BENCH)


def track_cast_peak(tr, box) -> None:
    """Record in ``box[0]`` the most bytes ``tr``'s cast buffers held
    just after a cast (the transport's own IO thread drains them)."""
    orig = tr.cast

    def cast(node, op, *args):
        orig(node, op, *args)
        with tr._cast_lock:
            n = sum(map(len, tr._cast_buf.values()))
        if n > box[0]:
            box[0] = n

    tr.cast = cast


class ThreadLaunches(dict):
    """Stands in for ``_build.LAUNCHES`` over a window: every wrapper's
    count moves as before, and ``by_thread`` says which thread made each
    launch (the main thread publishes; a forwarded message is
    dispatched on its receiver's transport IO thread)."""

    def __init__(self, base) -> None:
        super().__init__(base)
        self.by_thread = {}

    def __setitem__(self, key, value) -> None:
        import threading

        d = self.by_thread.setdefault(threading.current_thread().name, {})
        d[key] = d.get(key, 0) + value - self.get(key, 0)
        super().__setitem__(key, value)

    def main(self) -> dict:
        return dict(self.by_thread.get("MainThread", {}))


def cluster_of(names, device, opts, cfg, cookie):
    """Port nodes named ``names`` on ``device``, each with a
    ``SocketTransport`` on loopback and a ``Cluster`` (``cfg``), the
    others joined to the first through its address."""
    from emqx_tpu_torch.cluster import Cluster
    from emqx_tpu_torch.cluster_net import SocketTransport
    from emqx_tpu_torch.node import Node

    nodes, trs, cls = [], [], []
    for name in names:
        node = Node(name=name, device=device, batch_size=opts.batch)
        tr = SocketTransport(name, cookie=cookie, config=cfg)
        tr.serve()
        cls.append(Cluster(node, transport=tr, config=cfg))
        nodes.append(node)
        trs.append(tr)
    for cl in cls[1:]:
        cl.join_remote("127.0.0.1", trs[0].port)
    if any(sorted(c.members) != sorted(names) for c in cls):
        raise AssertionError(f"[13] join: members {[c.members for c in cls]}")
    return nodes, trs, cls


def close_cluster(trs, cls) -> None:
    for cl in cls:
        cl.close()
    for tr in trs:
        tr.close()


def barrier(trs, timeout: float = 120.0) -> None:
    """Every cast sent before now between two of ``trs`` has been
    dispatched at its receiver: a call first writes its link's buffered
    casts, and the receiver handles one link's frames in order."""
    deadline = time.perf_counter() + timeout
    for a in trs:
        for b in trs:
            if a is b:
                continue
            while True:
                try:
                    a.call_addr((b.host, b.port), "ping")
                    break
                except ConnectionError:
                    if time.perf_counter() > deadline:
                        raise
                    time.sleep(0.05)


def wait_for(pred, timeout, what, poll=0.02):
    """The clock when ``pred()`` first holds; raises after ``timeout``."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return time.perf_counter()
        time.sleep(poll)
    raise AssertionError(f"[13] {what} not reached in {timeout} s")


def digests_equal(cls) -> bool:
    """Every member's five plane digests are equal (the JAX partition
    bench's convergence predicate)."""
    d = [c.plane_digests() for c in cls]
    return all(x == d[0] for x in d[1:])


def routes_held(node) -> int:
    return sum(len(d) for d in node.router.route_table().values())


def cluster_pairs(pairs, n_plus, n_routes):
    """Phase 5's ``(sink, filter)`` pairs cut to about ``n_routes``
    filters: the first '+' pairs (``pairs[:n_plus]`` holds that class),
    every other class whole (literal, '#', $share, the big filters and
    their 4,096 members each)."""
    rest = pairs[n_plus:]
    others = len({f for _s, f in rest})
    keep = max(0, min(n_plus, n_routes - others))
    return pairs[:keep] + rest, keep


def cluster_kernels(node, topics, card, label):
    """B1 on the node's automaton (the whole cluster's filters) at the
    main path's inputs and B2 over its own big filters' packed rows,
    each held against its plain twin; their device times. Launches made
    here do not count."""
    import torch

    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops.bitmap import or_union_rows_cuda, rows_for_matches
    from emqx_tpu_torch.ops.pack import mask_pad_rows, union_slots
    from emqx_tpu_torch.ops.walk_cuda import match_batch_cuda

    saved = dict(_build.LAUNCHES)
    router = node.router
    auto, id_map, epoch = router.automaton()
    uniq = list(dict.fromkeys(topics))
    args, kw = router.walk_inputs(uniq)
    err = check_walk(auto, args, kw, f"{label} B={args[0].shape[0]}")
    walk = kernel_ms(lambda: match_batch_cuda(auto, *args, **kw),
                     "walk_kernel")
    ids = mask_pad_rows(match_batch_cuda(auto, *args, **kw).ids, len(uniq))
    st = node.broker.helper.state(epoch, id_map)
    rows, _ovf = rows_for_matches(st.bm, ids, mb=router.config.fanout_mb)
    has_big = (rows >= 0).any(dim=1)
    pr = node.broker._pack_budgets.get(
        rows.shape[0], [0, 0, max(1, router.config.pack_rows)])[2]
    err = max(err, check_union(st.bm.bitmaps, rows, has_big, pr,
                               f"{label} packed union pr={pr}"))
    src = union_slots(has_big, pr)[1]
    orr = kernel_ms(lambda: or_union_rows_cuda(st.bm.bitmaps, rows, src),
                    "bitmap_or_kernel")
    torch.cuda.synchronize()
    _build.LAUNCHES.update(saved)
    return {"walk_ms": walk, "or_ms": orr, "max_abs_err": err,
            "big_rows": st.bm.n_rows}


def cluster_13a(pairs, batches, warm, opts, device, card, p5):
    """13a, the data path: two nodes on the card, phase 5's
    subscriptions (cut, :data:`P13_ROUTES`) split by subscriber over
    them, phase 5's batches published on node 0 and node 1 in turn.
    Returns the nodes with their transports and clusters (13b and 13c
    run on them) and the numbers."""
    from collections import Counter

    import torch

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.cluster import ClusterConfig
    from emqx_tpu_torch.oracle import TrieOracle
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.types import Message

    keep, n_plus = cluster_pairs(pairs, opts.subs, P13_ROUTES)
    names = ("cn0", "cn1")
    want = {}
    for sink, f in keep:
        flt, popts = T.parse(f)
        name = names[sink.sid % 2]
        share = popts.get("share")
        want.setdefault(flt, set()).add((share, name) if share else name)
    n_routes = sum(map(len, want.values()))
    n5 = len({T.parse(f)[0] for _s, f in pairs})
    log(f"[13a] cut: {len(want)} of phase 5's {n5} filters ({n_plus} of "
        f"its {opts.subs} '+' filters, every other "
        f"class whole), {len(keep)} subscriptions, {n_routes} routes, to "
        f"hold the phase's {P13_BUDGET_S:.0f} s budget")
    # the JAX package's defaults, detector and anti-entropy on (the
    # partition bench's 0.5 s sweep over 250K routes in one process
    # flaps the peers: PERF.md §6, tests/ab_torch_cluster_replication.py)
    cfg = ClusterConfig()
    nodes, trs, cls = cluster_of(names, device, opts, cfg, "p13-data")
    for c in cls:
        c.drain_counters()
    t0 = time.perf_counter()
    for sink, f in keep:
        nodes[sink.sid % 2].broker.subscribe(sink, f)
    sub_s = time.perf_counter() - t0
    barrier(trs, timeout=600.0)
    barrier_s = time.perf_counter() - t0
    at_barrier = [routes_held(n) for n in nodes]
    # converged: every route on both routers and the five digests equal,
    # whatever the detector did on the way (casts are at most once: a
    # reset link or a down peer loses some, and anti-entropy repairs
    # them). Each node syncs with its peer at once rather than at the
    # next 30 s sweep, which would time the sweep's period, not the
    # replication
    syncs = []

    def converged() -> bool:
        if [routes_held(n) for n in nodes] == [n_routes] * 2 \
                and digests_equal(cls):
            return True
        for c, peer in zip(cls, reversed(names)):
            try:
                syncs.append(c.anti_entropy_sync(peer))
            except ConnectionError:
                syncs.append(None)  # a suspect peer fast-fails: again
        return False

    try:
        repl_s = wait_for(converged, 300.0, "13a route replication",
                          poll=1.0) - t0
    except AssertionError as e:
        raise AssertionError(
            f"{e}: routes held {[routes_held(n) for n in nodes]} of "
            f"{n_routes}, counters {[c.drain_counters() for c in cls]}, "
            f"anti-entropy {[c.ae_info() for c in cls]}") from None
    repl_counters = {}
    for c in cls:
        for k, v in c.drain_counters().items():
            repl_counters[k] = repl_counters.get(k, 0) + v
    for node in nodes:
        got = {f: set(d) for f, d in node.router.route_table().items()}
        if got != want:
            raise AssertionError(f"[13a] {node.name}'s routes differ from "
                                 f"the subscriptions' ({len(got)} filters)")
    log(f"[13a] route replication at the JAX defaults: {len(keep)} "
        f"subscriptions on two nodes "
        f"({sum(1 for s, _ in keep if s.sid % 2 == 0)} / "
        f"{sum(1 for s, _ in keep if s.sid % 2)}); every cast dispatched "
        f"after {barrier_s:.1f} s (the subscribe loop {sub_s:.1f} s) with "
        f"{at_barrier} of {n_routes} routes held; after the syncs "
        f"{syncs} (repairs; None a fast-failed one) each router holds all "
        f"{len(want)} filters and {n_routes} routes, plane digests equal, "
        f"after {repl_s:.1f} s: {n_routes / repl_s:.0f} routes/s; the "
        f"detector and anti-entropy meanwhile "
        f"{dict(sorted(repl_counters.items()))} — {card}")
    t0 = time.perf_counter()
    oracle = TrieOracle()
    for f in want:
        oracle.insert(f)
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for node in nodes:
        node.router.automaton()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for node in nodes:
        node.broker.publish_batch([Message(topic=t) for t in warm])
    barrier(trs)
    log(f"[13a] builds of both automata {build_s:.1f} s, warm batches "
        f"(fan-out tables) {time.perf_counter() - t0:.1f} s; the checks' "
        f"TrieOracle of the {len(want)} filters {oracle_s:.1f} s; "
        f"big-filter members a node: "
        f"{[len(n.broker.subscribers(keep[-1][1])) for n in nodes]}, "
        f"fanout_threshold {nodes[0].router.config.fanout_threshold} — "
        f"{card}")

    msgs = [[Message(topic=t, payload=b"x") for t in b] for b in batches]
    fwd0 = sum(n.metrics.val("messages.forward") for n in nodes)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    saved = _build.LAUNCHES
    tl = _build.LAUNCHES = ThreadLaunches(saved)
    lat, checks, begin_at, peak_buf = [], [], [], [0]
    for tr in trs:
        track_cast_peak(tr, peak_buf)
    Sink.log, Sink.stamps = [], []
    try:
        for bi, batch in enumerate(msgs):
            p = bi % 2
            broker = nodes[p].broker
            before = tl.main()
            t1 = time.perf_counter()
            begin_at.append(t1)
            pb = broker.publish_begin(batch)
            if pb.done:
                raise AssertionError(f"[13a] batch {bi} did not take the "
                                     f"device path")
            broker.publish_fetch(pb)
            fetched = tl.main()
            res = broker.publish_finish(pb)
            lat.append(time.perf_counter() - t1)
            for name in PUBLISH_KERNELS:
                n = fetched.get(name, 0) - before.get(name, 0)
                if n != 1:
                    raise AssertionError(f"[13a] batch {bi} launched {name} "
                                         f"{n} times on {names[p]}, not 1")
            checks.append((p, batch, res))
        barrier(trs)
    finally:
        deliveries, Sink.log = Sink.log, None
        stamps, Sink.stamps = Sink.stamps, None
        _build.LAUNCHES = saved
        saved.update(tl)
        for tr in trs:
            del tr.cast
    peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
    launches = tl.main()
    io = {t: d for t, d in tl.by_thread.items()
          if t != "MainThread" and any(d.values())}
    if io:
        raise AssertionError(f"[13a] kernels launched off the publishing "
                             f"thread: {io}")
    # every message against the oracle: each node's local subscribers of
    # every matched filter once, one member a shared group cluster-wide,
    # the publishing node's count in its result, one forward a remote
    # (node, filter)
    by_msg = {}
    for mid, sid, flt in deliveries:
        by_msg.setdefault(mid, Counter())[(sid, flt)] += 1
    subs_of, groups_of, plain_of = {}, {}, {}

    def tables(f):
        if f not in subs_of:
            subs_of[f] = [{s.sid for s in n.broker.subscribers(f)}
                          for n in nodes]
            groups_of[f] = sorted({r.dest[0] for r in
                                   nodes[0].router.lookup_routes(f)
                                   if isinstance(r.dest, tuple)})
            plain_of[f] = [q for q in (0, 1) if subs_of[f][q]]
        return subs_of[f], groups_of[f], plain_of[f]

    pos = {}
    want_fwd = 0
    for bi, (p, batch, res) in enumerate(checks):
        for i, msg in enumerate(batch):
            pos[msg.id] = (bi, i, p)
            local, groups = Counter(), []
            for f in oracle.match(msg.topic):
                sids, grps, plain = tables(f)
                for q in (0, 1):
                    for sid in sids[q]:
                        local[(sid, f)] += 1
                groups += [(g, f) for g in grps]
                want_fwd += sum(1 for q in plain if q != p)
            got = by_msg.get(msg.id, Counter())
            extra = got - local
            if local - got or len(extra) != len(groups) \
                    or sum(extra.values()) != len(groups):
                raise AssertionError(f"[13a] deliveries of {msg.topic!r} "
                                     f"differ from the oracle")
            for g, f in groups:
                members = {s.sid for n in nodes
                           for s in n.broker.shared.subscribers(g, f)}
                if not any(sid in members for sid, ff in extra if ff == f):
                    raise AssertionError(f"[13a] shared group {g} of {f} "
                                         f"missed")
            if res[i] != sum(c for (sid, _f), c in got.items()
                             if sid % 2 == p):
                raise AssertionError(f"[13a] {msg.topic!r}: result "
                                     f"{res[i]} is not its deliveries on "
                                     f"{names[p]}")
    n_fwd = sum(n.metrics.val("messages.forward") for n in nodes) - fwd0
    if n_fwd != want_fwd:
        raise AssertionError(f"[13a] messages.forward {n_fwd}, the oracle's "
                             f"(message, remote node, filter) count "
                             f"{want_fwd}")
    # the same local deliveries as phase 5's node, message by message,
    # where phase 5's (subscriber, filter) pair is one of 13a's (a '+'
    # filter cut away may still be a kept $share group's filter)
    local = {}
    for mid, sid, flt in deliveries:
        bi, i, _p = pos[mid]
        sids = tables(flt)[0]
        if sid in sids[0] or sid in sids[1]:
            local.setdefault((bi, i), []).append((sid, flt))
    for v in local.values():
        v.sort()
    same_deliveries(local_on(p5["local"], keep), local, "13a",
                    "phase 5's node's (its deliveries on 13a's filters)")
    # publish → delivery of the forwarded messages
    fwd_ms = np.sort(np.array([
        (t - begin_at[pos[mid][0]]) * 1e3 for mid, sid, t in stamps
        if sid % 2 != pos[mid][2]]))
    digests = [c.plane_digests() for c in cls]
    counters = [c.drain_counters() for c in cls]
    if digests[0] != digests[1]:
        raise AssertionError(f"[13a] plane digests differ: {digests}; "
                             f"routes held {[routes_held(n) for n in nodes]}"
                             f"; the detector's and anti-entropy's counters "
                             f"{counters}")
    dropped = sum(c.get("forward.dropped", 0) for c in counters)
    if dropped:
        raise AssertionError(f"[13a] {dropped} forwards dropped")
    for n in nodes:
        check_quiet(n, f"13a {n.name}")
    lat_ms = np.sort(np.array(lat) * 1e3)
    n_msgs = sum(len(b) for b in msgs)
    out = {"msgs_per_s": n_msgs / sum(lat),
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "fwd_p50_ms": float(np.percentile(fwd_ms, 50)),
           "fwd_p99_ms": float(np.percentile(fwd_ms, 99)),
           "launches": launches, "repl_s": repl_s, "barrier_s": barrier_s,
           "repl_counters": repl_counters, "syncs": syncs,
           "routes_per_s": n_routes / repl_s, "peak_mib": peak,
           "forwards": n_fwd, "cast_buf_peak": peak_buf[0]}
    log(f"[13a] {len(msgs)} batches x {len(msgs[0])} msgs on cn0 and cn1 in "
        f"turn: {out['msgs_per_s']:.1f} msgs/s, p50 {out['p50_ms']:.3f} ms, "
        f"p99 {out['p99_ms']:.3f} ms (phase 5's node: "
        f"{p5['msgs_per_s']:.1f} msgs/s, p50 {p5['p50_ms']:.3f} ms, p99 "
        f"{p5['p99_ms']:.3f} ms); launches on the publishing thread "
        f"{launches}, one B1 and one B2 a batch; 0 off it — {card}")
    log(f"[13a] {len(deliveries)} deliveries match the TrieOracle of 13a's "
        f"filters, one member a shared group cluster-wide; "
        f"messages.forward {n_fwd} = the oracle's (message, remote node, "
        f"filter) count; {len(fwd_ms)} forwarded deliveries, publish → "
        f"delivery p50 {out['fwd_p50_ms']:.3f} ms, p99 "
        f"{out['fwd_p99_ms']:.3f} ms; the cast buffers' peak "
        f"{peak_buf[0]} bytes; forwards dropped 0; plane digests equal "
        f"on both nodes — {card}")
    if on_card:
        log(f"[13a] peak device memory of the two nodes' publishes "
            f"{peak:.1f} MiB — {card}")
    ks = [cluster_kernels(n, batches[0], card, f"13a {n.name}")
          for n in nodes]
    out["kernels"] = ks
    log(f"[13a] per node, at batch 0's {len(set(batches[0]))} unique "
        f"topics: B1 device ms {[round(k['walk_ms'], 5) for k in ks]} (the "
        f"whole cluster's filters on each; phase 5's node "
        f"{p5.get('walk_ms', float('nan')):.5f}), B2 device ms "
        f"{[round(k['or_ms'], 5) for k in ks]} over "
        f"{[k['big_rows'] for k in ks]} big-filter rows of its own — {card}")
    return nodes, trs, cls, out


def cluster_13b(nodes, trs, card):
    """13b: retained messages stored on node 0 replicate to node 1
    (``retain_set``) and enter its index; a SUBSCRIBE burst on node 1
    replays through B3 on its own index, once, and delivers what node
    0's replay of the same filters delivers."""
    from emqx_tpu_torch.modules.retainer import RetainerModule

    rets = [n.modules.load(RetainerModule) for n in nodes]
    t0 = time.perf_counter()
    store_s = store_retained(nodes[0], P13_RETAINED)
    barrier(trs)
    repl_s = time.perf_counter() - t0
    stores = [{t: (bytes(m.payload), m.timestamp) for t, m in r._store.items()}
              for r in rets]
    if len(stores[0]) != P13_RETAINED or stores[0] != stores[1] \
            or len(rets[1]._index) != P13_RETAINED:
        raise AssertionError(f"[13b] node 1 holds {len(stores[1])} retained "
                             f"messages, node 0 {len(stores[0])}")
    bursts = retained_bursts(P13_RETAINED, 1, P13_BURST, seed=13)
    family = NameFamily(P13_RETAINED)

    async def both():
        r1 = await replay_bursts(nodes[1], rets[1]._index, bursts, family,
                                 tag="c1r")
        r0 = await replay_bursts(nodes[0], rets[0]._index, bursts, family,
                                 tag="c0r")
        return r1, r0

    r1, r0 = asyncio.run(both())
    if r1[6] != r0[6]:
        raise AssertionError("[13b] node 1's replay differs from node 0's")
    log(f"[13b] {P13_RETAINED} retained messages stored on cn0 "
        f"{store_s:.2f} s, on cn1 through retain_set after {repl_s:.2f} s; "
        f"a burst of {P13_BURST} SUBSCRIBEs on cn1: one B3 launch on its "
        f"own index, {r1[3]} messages replayed, {r1[0][0] * 1e3:.3f} ms "
        f"(cn0's replay of the same filters {r0[0][0] * 1e3:.3f} ms, the "
        f"same wire bytes) — {card}")
    return {"launches": r1[5]["retained_match"], "replay_ms": r1[0][0] * 1e3}


async def _takeover(nodes, trs, card):
    from emqx_tpu_torch.channel import Channel
    from emqx_tpu_torch.mqtt import constants as MC
    from emqx_tpu_torch.mqtt.packet import Connect, PubAck, Subscribe
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.types import Message

    flts = [f"tko/{j}/+" for j in range(P13_TAKEOVER_FILTERS)]
    got = []

    def connect(node):
        ch = Channel(node.broker, node.cm)
        pk = ch.handle_in(Connect(proto_ver=MC.MQTT_V5, client_id="mover",
                                  clean_start=False, properties={
                                      "Session-Expiry-Interval": 3600}))
        if ch.session is None:
            raise AssertionError(f"[13c] CONNECT on {node.name} refused")
        return ch, pk

    def read(ch, ack: bool, first=()) -> int:
        pubs = [p for p in list(first) + ch.handle_deliver()
                if getattr(p, "type", None) == MC.PUBLISH]
        for p in pubs:
            got.append((bytes(p.payload), p.packet_id, bool(p.dup), p.qos))
            if ack:
                ch.handle_in(PubAck(packet_id=p.packet_id))
        return len(pubs)

    def publish(node, tag, leaf="x"):
        node.broker.publish_batch([
            Message(topic=f"tko/{j}/{leaf}", payload=b"%s:%d" % (tag, j),
                    qos=1)
            for j in range(len(flts))])

    ch, _pk = connect(nodes[0])
    ch.handle_in(Subscribe(packet_id=1, topic_filters=[(f, {"qos": 1})
                                                       for f in flts]))
    barrier(trs)
    takeover_ms = None
    for r in range(P13_TAKEOVER_ROUNDS):
        publish(nodes[r % 2], b"%d" % r)
        if r == P13_TAKEOVER_AT:
            read(ch, ack=False)  # delivered before the move, not acked
            t0 = time.perf_counter()
            ch, pk = connect(nodes[1])
            takeover_ms = (time.perf_counter() - t0) * 1e3
            if not pk[0].session_present:
                raise AssertionError("[13c] the takeover lost the session")
            # the CONNECT's answer carries the resumed inflight window
            read(ch, ack=True, first=pk[1:])
        await asyncio.sleep(0)
        read(ch, ack=r % 3 != 0)
    for _ in range(3):
        barrier(trs)
        read(ch, ack=True)
    seen = {}
    for payload, _pid, dup, qos in got:
        seen.setdefault(payload, []).append(dup)
    lost = [b"%d:%d" % (r, j) for r in range(P13_TAKEOVER_ROUNDS)
            for j in range(len(flts)) if b"%d:%d" % (r, j) not in seen]
    dups = {p: d for p, d in seen.items() if d.count(False) > 1}
    if lost or dups:
        raise AssertionError(f"[13c] QoS 1 lost {lost[:5]} or delivered "
                             f"twice without DUP {list(dups)[:5]}")
    for f in flts:
        for n in nodes:
            dests = [r.dest for r in n.router.lookup_routes(f)]
            if dests != ["cn1"]:
                raise AssertionError(f"[13c] {f} routes to {dests} on "
                                     f"{n.name}")
    launched = []
    for q in (0, 1):
        n0 = len(got)
        before = _build.LAUNCHES["walk"]
        # topics no batch published before: the match cache misses
        publish(nodes[q], b"next%d" % q, leaf=f"next{q}")
        launched.append(_build.LAUNCHES["walk"] - before)
        barrier(trs)
        if read(ch, ack=True) != len(flts) or any(
                not p.startswith(b"next%d" % q) for p, *_x in got[n0:]):
            raise AssertionError(f"[13c] the batch on cn{q} did not deliver "
                                 f"to the session on cn1")
    if min(launched) < 1:
        raise AssertionError(f"[13c] B1 launches {launched}")
    n_dup = sum(1 for *_x, dup, _q in got if dup)
    log(f"[13c] a persistent QoS 1 session with {len(flts)} subscriptions "
        f"taken over from cn0 to cn1 after round {P13_TAKEOVER_AT} of "
        f"{P13_TAKEOVER_ROUNDS} (forwards of that round in flight) in "
        f"{takeover_ms:.3f} ms: session present, "
        f"{P13_TAKEOVER_ROUNDS * len(flts)} messages, none lost, {n_dup} "
        f"redelivered with DUP, none twice without; its routes point at "
        f"cn1 on both nodes; the next batch on cn0 and on cn1 reached it on "
        f"cn1 with B1 launches {launched} — {card}")
    return {"takeover_ms": takeover_ms}


def cluster_13d(device, opts, card):
    """13d, the JAX partition bench's plan (bench.py:2727-2790) on three
    port nodes at its config: 3,000 routes, ``net.partition`` splits
    {cn0, cn1} from {cn2} with churn on both sides, then disarm; the
    membership merges again and all five plane digests agree."""
    from emqx_tpu_torch import faults

    nodes, trs, cls = cluster_of(("pn0", "pn1", "pn2"), device, opts,
                                 partition_bench_config(), "p13-part")

    try:
        for i in range(P13_PARTITION_ROUTES):
            nodes[i % 3].broker.subscribe(Sink(i), f"bench/p/{i}")
        wait_for(lambda: digests_equal(cls), 60, "13d pre-partition sync")
        for c in cls:
            c.drain_counters()
        trs[0].fault_peers = trs[1].fault_peers = {"pn2"}
        trs[2].fault_peers = {"pn0", "pn1"}
        t0 = time.perf_counter()
        faults.arm("net.partition", times=0)
        try:
            detect_s = wait_for(lambda: cls[0].members == ["pn0", "pn1"]
                                and cls[2].members == ["pn2"], 30,
                                "13d detection") - t0
            churn = 0
            t_end = time.perf_counter() + P13_PARTITION_WINDOW_S
            while time.perf_counter() < t_end:
                side = nodes[0] if churn % 2 else nodes[2]
                s = Sink(100_000 + churn)
                side.broker.subscribe(s, f"bench/c/{churn % 3000}")
                side.broker.unsubscribe(s, f"bench/c/{churn % 3000}")
                churn += 1
                time.sleep(0.002)
            split = [c.plane_digests() for c in cls]
        finally:
            t1 = time.perf_counter()
            faults.disarm("net.partition")
        wait_for(lambda: all(sorted(c.members) == ["pn0", "pn1", "pn2"]
                             for c in cls), 60, "13d membership re-merge")
        heal_s = wait_for(lambda: digests_equal(cls), 60,
                          "13d plane-digest convergence") - t1
        bans = timed("15c (the ban plane)", ban_plane_15c, nodes, trs, cls,
                     card)
        counters = {}
        for c in cls:
            for k, v in c.drain_counters().items():
                counters[k] = counters.get(k, 0) + v
    finally:
        faults.clear()
        close_cluster(trs, cls)
    routes = [len(n.router.route_table()) for n in nodes]
    log(f"[13d] 3 nodes, {P13_PARTITION_ROUTES} routes, partition "
        f"{{pn0, pn1}} | {{pn2}}: detected in {detect_s:.3f} s; "
        f"{churn} churn ops in the {P13_PARTITION_WINDOW_S:.0f} s window "
        f"(the sides' digests {'differ' if split[0] != split[2] else 'equal'}"
        f"); heal to the five digests' convergence {heal_s:.3f} s, routes "
        f"{routes}; forwards dropped {counters.get('forward.dropped', 0)}; "
        f"counters {dict(sorted(counters.items()))} — {card}")
    return {"detect_s": detect_s, "heal_s": heal_s, "churn": churn,
            "dropped": counters.get("forward.dropped", 0), "15c": bans}


def run_cluster(pairs, batches, warm, opts, device, card, p5):
    """Phase 13, the cluster on the card (see the module docstring);
    returns the launches and numbers for the kernel line."""
    from emqx_tpu_torch import faults

    t_start = time.perf_counter()
    log(f"[13] P13_BUDGET_S {P13_BUDGET_S:.0f} s; two port nodes on "
        f"{device} over SocketTransport on loopback (13a-13c), three for "
        f"13d — {card}")
    nodes, trs, cls, a = timed("13a (cluster data path)", cluster_13a,
                               pairs, batches, warm, opts, device, card, p5)
    try:
        b = timed("13b (retained across nodes)", cluster_13b, nodes, trs,
                  card)
        c = timed("13c (cross-node takeover)", asyncio.run,
                  _takeover(nodes, trs, card))
        for n in nodes:
            check_quiet(n, f"13b and 13c {n.name}")
    finally:
        close_cluster(trs, cls)
    del nodes, trs, cls
    gc.collect()
    d = timed("13d (partition and heal)", cluster_13d, device, opts, card)
    # 13d's injected partition: the phases after it are checked for no
    # fault beyond it
    P9_INJECTED["n"] = faults.info()["injected_total"]
    took = time.perf_counter() - t_start
    log(f"[13] phase 13 took {took:.1f} s of its {P13_BUDGET_S:.0f} s "
        f"budget — {card}")
    return {"13a": a, "13b": b, "13c": c, "13d": d, "seconds": took}


# -- the retained slice: the retained_1m shape -------------------------------

def retained_name(i: int) -> str:
    return f"s{i % 499}/g{(i // 499) % 97}/d{i}/state"


def retained_bursts(n_names: int, n_bursts: int, burst: int, seed: int = 19):
    """Subscribe bursts drawn from the stored names: 50 % literal, 30 %
    with one level made '+', 20 % cut to a '#' suffix."""
    rng = random.Random(seed)
    out = []
    for _ in range(n_bursts):
        flts = []
        for _ in range(burst):
            ws = retained_name(rng.randrange(n_names)).split("/")
            r = rng.random()
            if r < 0.5:
                pass
            elif r < 0.8:
                ws[rng.randrange(len(ws))] = "+"
            else:
                ws = ws[:rng.randint(1, len(ws) - 1)] + ["#"]
            flts.append("/".join(ws))
        out.append(flts)
    return out


class NameFamily:
    """The stored names as columns (s, g, d indices; the last level is
    always ``state``): which names a filter matches, under
    ``emqx_topic:match/2``'s rules, as sorted name indices. Held against
    the host ``T.match`` scan on a sample of filters."""

    def __init__(self, n: int) -> None:
        i = np.arange(n)
        self.n = n
        self.cols = (i % 499, (i // 499) % 97, i)

    def match(self, flt: str) -> np.ndarray:
        ws = flt.split("/")
        deeper = ws[-1] == "#"
        if deeper:
            ws = ws[:-1]
        none = np.zeros(0, np.int64)
        if len(ws) > 4 or (not deeper and len(ws) != 4):
            return none
        mask = np.ones(self.n, bool)
        for lvl, w in enumerate(ws):
            if w == "+":
                continue
            if lvl == 3:
                if w != "state":
                    return none
                continue
            num = w[1:]
            if w[:1] != "sgd"[lvl] or not num.isdigit() \
                    or str(int(num)) != num:
                return none
            mask &= self.cols[lvl] == int(num)
        return np.flatnonzero(mask)


def store_retained(node, n_names: int, batch: int = 4096) -> float:
    """Store ``n_names`` retained messages through the broker; returns
    the seconds it took."""
    from emqx_tpu_torch.types import Message

    t0 = time.perf_counter()
    for base in range(0, n_names, batch):
        node.broker.publish_batch([
            Message(topic=retained_name(i), payload=b"%d" % i,
                    flags={"retain": True})
            for i in range(base, min(base + batch, n_names))])
    return time.perf_counter() - t0


async def one_burst(node, flts, tag):
    """One subscribe burst: a sans-IO ``Channel`` per filter (taking
    wire bytes, as a socket transport's does), connected first (a
    CONNECT refused with ServerBusy is retried, see :data:`REFUSED`), then
    handed its SUBSCRIBE, all in one loop tick; then the loop runs the
    replay flush; then each channel's ``handle_deliver``, its packets
    serialized as the connection would (the on-loop wire work).
    Returns the outboxes as the flush left them, each channel's wire
    bytes, and the seconds of the SUBSCRIBEs' channel work, of the
    flush and of the wire work."""
    from emqx_tpu_torch.channel import Channel
    from emqx_tpu_torch.mqtt.frame import serialize
    from emqx_tpu_torch.mqtt.packet import Connect, Subscribe

    chans = []
    for j in range(len(flts)):
        for attempt in range(CONNECT_RETRIES + 1):
            ch = Channel(node.broker, node.cm)
            ch.wire_fast = True
            ch.handle_in(Connect(client_id=f"{tag}_{j}"))
            if ch.session is not None:
                break
            # refused with ServerBusy at critical overload: retry after
            # a back-off, as a client does
            await refused_backoff(attempt)
        else:
            raise AssertionError(f"{tag}_{j}: CONNECT refused "
                                 f"{CONNECT_RETRIES + 1} times")
        chans.append(ch)
    t0 = time.perf_counter()
    for ch, flt in zip(chans, flts):
        ch.handle_in(Subscribe(packet_id=1, topic_filters=[(flt,
                                                            {"qos": 0})]))
    t1 = time.perf_counter()
    await asyncio.sleep(0)  # the burst's replay flush runs here
    t2 = time.perf_counter()
    boxes = [list(ch.session.outbox) for ch in chans]
    t3 = time.perf_counter()
    wire = [b"".join(p if type(p) is bytes else serialize(p, ch.proto_ver)
                     for p in ch.handle_deliver()) for ch in chans]
    wire_s = time.perf_counter() - t3
    return boxes, wire, t1 - t0, t2 - t1, wire_s


async def replay_bursts(node, index, bursts, family, tag="r"):
    """The replay run, every count at 0 at its start: per burst exactly
    one replay batch and one B3 launch, and every session's outbox
    equal to the stored messages its filter matches (``family``), each
    with the retain flag and its payload. Returns per-burst latencies
    (first channel call to the last wire byte) and their split
    (channel calls, index match, plan and delivery, wire), the hit
    bytes fetched (8 per hit: the device match copies its hits as
    int64 flat indices), the deliveries, the launch counts, the wire
    bytes per burst and subscriber and the on-loop serialize count."""
    from emqx_tpu_torch.ops import _build

    metrics = node.metrics
    loop = asyncio.get_running_loop()
    failures = []
    loop.set_exception_handler(
        lambda _l, ctx: failures.append(ctx.get("exception") or ctx))
    match_s, hits = [], []
    inner = index.match_many

    def timed_match(*a, **k):  # times the index match inside the flush
        t = time.perf_counter()
        out = inner(*a, **k)
        match_s.append(time.perf_counter() - t)
        hits.append(sum(map(len, out)))
        return out

    index.match_many = timed_match
    lat, split, fetched, n_deliveries, gc_s, wires = [], [], [], 0, [], []
    onloop0 = metrics.val("delivery.serialize.onloop")
    _build.reset_launches()
    try:
        for bi, flts in enumerate(bursts):
            batches = metrics.val("retained.replay.batches")
            launches = _build.LAUNCHES["retained_match"]
            with GcPauses() as gcp:
                boxes, wire, calls_s, flush_s, wire_s = await one_burst(
                    node, flts, f"{tag}{bi}")
            gc_s.append(sum(gcp.secs))
            wires.append(wire)
            lat.append(calls_s + flush_s + wire_s)
            split.append((calls_s, match_s[-1], flush_s - match_s[-1],
                          wire_s))
            if failures:
                raise RuntimeError(f"burst {bi}: the loop caught "
                                   f"{failures!r}")
            if metrics.val("retained.replay.batches") != batches + 1:
                raise AssertionError(f"burst {bi}: not exactly one replay "
                                     f"batch")
            if _build.LAUNCHES["retained_match"] != launches + 1:
                raise AssertionError(f"burst {bi}: B3 did not launch "
                                     f"exactly once")
            fetched.append(8 * hits[-1])
            for box, flt in zip(boxes, flts):
                want = family.match(flt)
                topics = sorted(m.topic for _pid, m in box)
                if topics != sorted(retained_name(int(i)) for i in want):
                    raise AssertionError(f"burst {bi}: {flt!r} replayed "
                                         f"{len(box)} messages, expected "
                                         f"{len(want)}")
                for _pid, m in box:
                    if not m.flags.get("retain") or \
                            m.payload != m.topic.split("/")[2][1:].encode():
                        raise AssertionError(f"burst {bi}: {m.topic!r} "
                                             f"lost its retain flag or "
                                             f"payload")
                n_deliveries += len(box)
    finally:
        del index.match_many
        loop.set_exception_handler(None)
    onloop = metrics.val("delivery.serialize.onloop") - onloop0
    return (lat, split, fetched, n_deliveries, gc_s, dict(_build.LAUNCHES),
            wires, onloop)


def check_host_scan(index, bursts, family, k: int = 8):
    """``k`` filters of the first burst (a '+', a '#' and a literal
    among them) through the device match against the host ``T.match``
    scan over all stored names, and the name family oracle."""
    from emqx_tpu_torch import topic as T

    first = bursts[0]
    pick = []
    for kind in (lambda f: "+" in f, lambda f: f.endswith("#"),
                 lambda f: not T.wildcard(f)):
        pick += [f for f in first if kind(f)][:1]
    pick += [f for f in first if f not in pick][:k - len(pick)]
    wild = [f for f in pick if T.wildcard(f)]
    dev = dict(zip(wild, index.match_many(wild, device_threshold=0)))
    names = list(index._row_of)
    for f in pick:
        host = sorted(t for t in names if T.match(t, f))
        got = sorted(dev.get(f, [f] if f in index._row_of else []))
        fam = sorted(retained_name(int(i)) for i in family.match(f))
        if not host == got == fam:
            raise AssertionError(f"{f!r}: device {len(got)}, host scan "
                                 f"{len(host)}, family {len(fam)}")
    log(f"[retained] {len(pick)} filters of burst 0 ({sum('+' in f for f in pick)}"
        f" '+', {sum(f.endswith('#') for f in pick)} '#', "
        f"{sum(not T.wildcard(f) for f in pick)} literal): the device hits "
        f"equal the host T.match scan over {len(names)} names")


def phase_retained(opts, device, card):
    """The retained slice through the port's Node at the retained_1m
    shape; returns the node's retained index (it stays on the card for
    B3's check), the bursts and the replay run's launch counts."""
    import torch

    from emqx_tpu_torch.modules.retainer import RetainerModule
    from emqx_tpu_torch.node import Node

    node = Node(device=device, boot_listeners=False)
    mod = node.modules.load(RetainerModule)
    store_s = store_retained(node, opts.names)
    if node.metrics.val("retained.count") != opts.names:
        raise AssertionError("retained.count != stored names")
    t0 = time.perf_counter()
    mod._index._device_arrays()
    if device != "cpu":
        torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    bursts = retained_bursts(opts.names, opts.bursts, opts.burst)
    family = NameFamily(opts.names)

    cfg = node.broker.dispatch_config

    async def replay():
        await node.start()
        try:
            # the same bursts with pre-serialization on (the default)
            # and off, in REPLAY_ORDER
            log(f"[retained] cut: replay runs with preserialize "
                f"{list(REPLAY_ORDER)} (was on, off, off, on), to hold "
                f"the run's time")
            runs = []
            try:
                for i, pre in enumerate(REPLAY_ORDER):
                    cfg.preserialize = pre
                    runs.append(await replay_bursts(
                        node, mod._index, bursts, family, f"r{i}_"))
            finally:
                cfg.preserialize = True
            return runs
        finally:
            await node.stop()

    runs = asyncio.run(replay())
    log(f"[retained] store {opts.names} retained messages: {store_s:.1f} s; "
        f"first upload of the index ({mod._index._cap} rows): "
        f"{upload_s * 1e3:.3f} ms — {card}")
    n_subs = sum(len(b) for b in bursts)
    out = {}
    for pre in (True, False):
        mine = [r for r, p in zip(runs, REPLAY_ORDER) if p == pre]
        lat = [x for r in mine for x in r[0]]
        gc_s = [x for r in mine for x in r[4]]
        lat_ms = np.sort(np.array(lat) * 1e3)
        # the bursts less their garbage-collector pauses: a full
        # collection lands in whichever run reaches its threshold
        net_ms = (np.array(lat) - np.array(gc_s)) * 1e3
        split_ms = np.mean([x for r in mine for x in r[1]], axis=0) * 1e3
        onloop = [r[7] for r in mine]
        label = "on" if pre else "off"
        out[label] = {"p50_ms": float(np.percentile(lat_ms, 50)),
                      "p99_ms": float(np.percentile(lat_ms, 99)),
                      "net_p50_ms": float(np.percentile(net_ms, 50)),
                      "net_p99_ms": float(np.percentile(net_ms, 99)),
                      "subs_per_s": len(mine) * n_subs / sum(lat),
                      "onloop": onloop}
        log(f"[retained] preserialize={label}: {len(mine)} runs of "
            f"{len(bursts)} bursts x {opts.burst} subscriptions: p50 "
            f"{out[label]['p50_ms']:.3f} ms, p99 {out[label]['p99_ms']:.3f} "
            f"ms per burst (first channel call to the last wire byte), "
            f"less the garbage collector's pauses p50 "
            f"{out[label]['net_p50_ms']:.3f} ms, p99 "
            f"{out[label]['net_p99_ms']:.3f} ms; "
            f"{out[label]['subs_per_s']:.1f} subs/s, {mine[0][3]} "
            f"deliveries a run, {onloop} serialized on the event loop, "
            f"hit bytes fetched per burst {[int(b) for b in mine[0][2]]}, "
            f"launches {mine[0][5]} — {card}")
        log(f"[retained] preserialize={label}, per burst: channel calls "
            f"{split_ms[0]:.3f} ms, index match (encode, B3, hit fetch) "
            f"{split_ms[1]:.3f} ms, plan and delivery {split_ms[2]:.3f} ms, "
            f"wire (handle_deliver and serialize) {split_ms[3]:.3f} ms; "
            f"bursts in order {[round(x * 1e3, 3) for x in lat]} ms, of "
            f"which garbage-collector pauses "
            f"{[round(x * 1e3, 3) for x in gc_s]} ms — {card}")
    on, off = runs[0], runs[1]
    if any(r[6] != on[6] for r in runs):
        raise AssertionError("replay: the wire bytes differ with "
                             "preserialize on and off")
    if not max(out["on"]["onloop"]) < min(out["off"]["onloop"]):
        raise AssertionError(f"replay: pre-serialization left "
                             f"{out['on']['onloop']} of "
                             f"{out['off']['onloop']} serializes on the "
                             f"loop")
    log(f"[retained] every subscriber's replayed wire bytes equal in all "
        f"{len(runs)} runs, preserialize on and off "
        f"({sum(len(b) for w in on[6] for b in w)} bytes a run)")
    launches = on[5]
    check_host_scan(mod._index, bursts, family)
    phase_retained_profile(node, opts, card)
    return node, mod._index, bursts, launches, out


def phase_retained_profile(node, opts, card):
    """A warm-up burst and two more (other filters) under
    torch.profiler, each in its own loop run."""
    bursts = retained_bursts(opts.names, 3, opts.burst, seed=20)
    profile_steps([lambda bi=bi, f=f: asyncio.run(one_burst(node, f, f"p{bi}"))
                   for bi, f in enumerate(bursts)],
                  ("retained_match",), card, "replay bursts")


def check_retained(args, label):
    import torch

    from emqx_tpu_torch.ops.retained_match import (match_names_cuda,
                                                   match_names_many)

    want = match_names_many(*args)
    got = match_names_cuda(*args)
    torch.cuda.synchronize()
    if got.dtype != torch.bool or not torch.equal(got, want):
        raise AssertionError(f"retained kernel != plain match ({label})")
    log(f"[B3] {label}: equal; {int(got.sum())} hits")
    return int((got.long() - want.long()).abs().max())


def retained_bound(args, L=16):
    """The two terms of B3's least time on these inputs, ``(bytes_ms,
    ops_ms)``; the bound is the larger. Bytes: the filters once,
    each name's length and '$' flag once, of its word row only the
    32-byte sectors that hold the levels some filter compares (levels
    past every filter's count do not enter the function), and the
    [F, cap] bytes written once. Operations: per (filter, name) pair,
    4 integer operations per compared level (two compares, an or, an
    and) and 8 for the length, '#' and '$' gates."""
    fw, fn = args[0], args[1]
    F, cap = fw.shape[0], args[3].shape[0]
    lv = fn.clamp(0, L).long()
    sectors = (4 * int(lv.max()) + 31) // 32 if F else 0
    nbytes = (cap * (32 * sectors + 4 + 1) + F * (L * 4 + 4 + 1)
              + F * cap)
    ops = cap * int((4 * lv + 8).sum())
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / VECTOR_OPS_PER_S * 1e3


def edge_index(rs, n):
    """A small CPU index with '$' names, 20-level names (deep set),
    dead rows and slot reuse."""
    from emqx_tpu_torch.modules.retainer import RetainIndex

    words = ["a", "b", "c", "$SYS", "$p", "s0", ""]
    idx = RetainIndex("cpu")
    for _ in range(n):
        depth = int(rs.integers(1, 21))
        idx.add("/".join(words[int(i)] for i in
                         rs.integers(0, len(words), size=depth)))
    for t in list(idx._row_of)[::3]:
        idx.remove(t)
    for _ in range(n // 10):
        idx.add("/".join(words[int(i)] for i in
                         rs.integers(0, len(words), size=3)))
    return idx


def phase_retained_kernel(index, bursts, rng, card):
    """B3 against the plain match: the 1M-name index at the main path's
    F (the padded unique wildcard filters of burst 0) and at F = 64,
    then small indexes with the edge cases. Returns the kernel row's
    numbers at the main path's F."""
    import torch

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.ops.retained_match import (match_names_cuda,
                                                   match_names_many)

    dev = index._device_arrays()
    cap = dev[2].shape[0]
    main_f = list(dict.fromkeys(f for f in bursts[0] if T.wildcard(f)))
    shapes = {}
    for flts in (main_f, bursts[1]):
        fw, fn, hh = (torch.from_numpy(a).to(dev[2].device)
                      for a in index._encode(flts))
        shapes[fw.shape[0]] = [fw, fn, hh, *dev[2:]]
    err = 0
    for F, args in shapes.items():
        err = max(err, check_retained(
            args, f"{len(index._row_of)}-name index cap={cap} F={F}"))
    edge_f = ["#", "+/+", "$SYS/#", "$p/+/#", "a/+/#", "zz/+", "a/zz/#", "+",
              "a", "b/#", "/".join(["+"] * 16), "/".join(["a"] * 17) + "/#",
              "+/b/c/#", "", "/"]
    for n_names, F, cut in ((300, 13, 1000), (2500, 40, 4001)):
        idx = edge_index(rng, n_names)
        fw, fn, hh = idx._encode((edge_f * 3)[:F])
        args = [torch.from_numpy(a).to(dev[2].device) for a in
                (fw[:F], fn[:F], hh[:F], idx._ids[:cut], idx._n[:cut],
                 idx._sys[:cut])]
        err = max(err, check_retained(args, f"edge index F={F} "
                                            f"cap={args[3].shape[0]} "
                                            f"({len(idx._deep)} deep names)"))
    # caps of 4·k + 1..3: a filter's output row is not 4-byte aligned
    fw, fn, hh = idx._encode((edge_f * 9)[:130])
    for cut in (idx._cap - 3, idx._cap - 2, idx._cap - 1):
        for F in (1, 5, 130):
            args = [torch.from_numpy(a).to(dev[2].device) for a in
                    (fw[:F], fn[:F], hh[:F], idx._ids[:cut], idx._n[:cut],
                     idx._sys[:cut])]
            err = max(err, check_retained(
                args, f"edge index F={F} cap={cut} (4k + {cut % 4})"))
    # random words, lengths (up to 20) and filter counts (-1 up to 18,
    # 10 or 6: the kernel reads 4, 3 or 2 of a row's four 16-byte parts)
    F, cut = 77, 3333
    for top in (18, 10, 6):
        raw = [rng.integers(-3, 5, size=(F, 16)),
               rng.integers(-1, top + 1, size=F), rng.random(F) < 0.4,
               rng.integers(-2, 5, size=(cut, 16)),
               rng.integers(-1, 21, size=cut), rng.random(cut) < 0.3]
        args = [torch.from_numpy(a.astype(np.int32) if a.dtype != bool else a)
                .to(dev[2].device) for a in raw]
        err = max(err, check_retained(
            args, f"random F={F} cap={cut} filter counts up to {top}"))
    rows = {}
    for F, args in shapes.items():
        ms = kernel_ms(lambda: match_names_cuda(*args), "retained_match_kernel")
        plain_ms = time_cuda_ms(lambda: match_names_many(*args), iters=3,
                                warmup=1)
        bytes_ms, ops_ms = retained_bound(args)
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"[B3] {len(index._row_of)}-name index F={F} (at most "
            f"{int(args[1].clamp(0, 16).max())} levels): kernel {ms:.5f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}; bytes "
            f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms) — {card}")
        rows[F] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by}
    return {"max_abs_err": err, **rows[next(iter(shapes))]}


# -- phase 7: the front door over loopback sockets ---------------------------

def raise_fd_limit(want: int) -> int:
    """Raise RLIMIT_NOFILE to its hard limit; returns the soft limit."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    target = hard if hard != resource.RLIM_INFINITY else max(soft, want)
    if soft < target:
        resource.setrlimit(resource.RLIMIT_NOFILE, (target, hard))
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    log(f"[socket] RLIMIT_NOFILE soft {soft}, hard {hard}; {want} wanted")
    return soft


class WireClient:
    """An MQTT client in this process, over the port's codec: records
    each PUBLISH it receives with its arrival time, answers QoS 1 with
    a PUBACK, and resolves a future per CONNACK, SUBACK and PUBACK."""

    def __init__(self, cid: str, version: int,
                 local_host: Optional[str] = None,
                 clean_start: bool = True, expiry: int = 0,
                 auto_ack: bool = True) -> None:
        self.cid = cid
        self.version = version
        # the source address (a loopback one other than 127.0.0.1
        # reaches the broker as a non-local peer)
        self.local_host = local_host
        # a persistent session: clean_start False and, on v5, a
        # Session-Expiry-Interval; auto_ack False leaves every QoS 1
        # delivery unacked (inflight on the broker)
        self.clean_start = clean_start
        self.expiry = expiry
        self.auto_ack = auto_ack
        self.got = []          # (topic, payload, retain, arrival)
        self.dup = False       # the DUP flag of the last PUBLISH
        self.raw = bytearray()  # every byte received
        self.sent = 0          # packets sent
        self.waiting = {}      # ("connack"|"suback"|"puback", pid) -> future
        self.on_publish = None
        self.closed = None
        self.connack = None    # the last CONNACK connect() read
        # ``opener(port)`` -> ``(reader, writer)`` for another transport
        # than plain TCP (TLS, WebSocket, the native TLS-PSK engine)
        self.opener = None

    async def connect(self, port: int) -> None:
        """CONNECT; a CONNECT refused with ServerBusy (the overload
        monitor at critical) is counted in :data:`REFUSED` and retried
        after a short back-off, as a client library does."""
        for attempt in range(CONNECT_RETRIES + 1):
            pkt = self.connack = await self.connect_once(port)
            if pkt.reason_code == 0:
                return
            if (pkt.reason_code not in (0x89, 3)
                    or attempt == CONNECT_RETRIES):
                raise AssertionError(f"{self.cid}: CONNACK "
                                     f"{pkt.reason_code}")
            self.writer.close()
            await self.closed
            self.raw.clear()
            await refused_backoff(attempt)

    async def connect_once(self, port: int):
        """One CONNECT; returns the CONNACK, whatever its code."""
        from emqx_tpu_torch.mqtt.frame import Parser
        from emqx_tpu_torch.mqtt.packet import Connect

        loop = asyncio.get_running_loop()
        self.parser = Parser(version=self.version)
        if self.opener is not None:
            self.reader, self.writer = await self.opener(port)
        else:
            self.reader, self.writer = await asyncio.open_connection(
                "127.0.0.1", port, local_addr=(self.local_host, 0)
                if self.local_host else None)
        self.closed = loop.create_future()
        fut = self.expect("connack", 0)
        self.send(Connect(client_id=self.cid, proto_ver=self.version,
                          proto_name="MQTT", keepalive=0,
                          clean_start=self.clean_start,
                          properties={"Session-Expiry-Interval":
                                      self.expiry} if self.expiry else {}))
        self._task = loop.create_task(self._read())
        return await fut

    def expect(self, kind: str, pid: int):
        fut = asyncio.get_running_loop().create_future()
        self.waiting[(kind, pid)] = fut
        return fut

    def send(self, pkt) -> None:
        from emqx_tpu_torch.mqtt.frame import serialize

        self.writer.write(serialize(pkt, self.version))
        self.sent += 1

    async def _read(self) -> None:
        from emqx_tpu_torch.mqtt import constants as C
        from emqx_tpu_torch.mqtt.packet import (Connack, Disconnect, PubAck,
                                                Publish, Suback)

        try:
            while True:
                data = await self.reader.read(1 << 16)
                if not data:
                    break
                now = time.perf_counter()
                self.raw += data
                for pkt in self.parser.feed(data):
                    if isinstance(pkt, Publish):
                        self.got.append((pkt.topic, pkt.payload, pkt.retain,
                                         now))
                        self.dup = bool(pkt.dup)
                        if pkt.qos == 1 and self.auto_ack:
                            self.send(PubAck(type=C.PUBACK,
                                             packet_id=pkt.packet_id))
                        if self.on_publish is not None:
                            self.on_publish(self)
                        continue
                    key = (("connack", 0) if isinstance(pkt, Connack) else
                           ("disconnect", 0)
                           if isinstance(pkt, Disconnect) else
                           ("suback", pkt.packet_id)
                           if isinstance(pkt, Suback) else
                           ("puback", pkt.packet_id)
                           if isinstance(pkt, PubAck) else None)
                    fut = self.waiting.pop(key, None)
                    if fut is None:
                        raise AssertionError(f"{self.cid}: unexpected "
                                             f"{pkt!r}")
                    fut.set_result(pkt)
        finally:
            for fut in self.waiting.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"{self.cid} closed"))
            if not self.closed.done():
                self.closed.set_result(None)

    async def close(self) -> None:
        self.writer.close()
        if self.opener is not None:
            # a stream pair over another transport (the TLS-PSK engine's
            # plaintext reader) may see no EOF of its own
            self._task.cancel()
        await self.closed


class Countdown:
    """Set ``done`` when ``n`` expected PUBLISHes have arrived."""

    def __init__(self, want) -> None:
        self.left = dict(want)   # client -> PUBLISHes still expected
        self.n = sum(self.left.values())
        self.done = asyncio.get_running_loop().create_future()
        if not self.n:
            self.done.set_result(None)

    def __call__(self, client) -> None:
        self.left[client] -= 1
        self.n -= 1
        if self.left[client] < 0:
            raise AssertionError(f"{client.cid}: more PUBLISHes than the "
                                 f"oracle gives")
        if not self.n and not self.done.done():
            self.done.set_result(None)


async def connect_fleet(port, specs, wave: int = 100):
    """Connect ``(client id, version)`` clients, ``wave`` at a time (the
    listener's accept backlog); returns them and the seconds taken."""
    clients = [WireClient(cid, v) for cid, v in specs]
    t0 = time.perf_counter()
    for i in range(0, len(clients), wave):
        await asyncio.gather(*(c.connect(port)
                               for c in clients[i:i + wave]))
    return clients, time.perf_counter() - t0


#: host-time groups of the socket path, by source file (first match)
HOST_GROUPS = (
    ("emqx_tpu_torch/mqtt/", "codec (parse, serialize)"),
    ("emqx_tpu_torch/channel.py", "channel"),
    ("emqx_tpu_torch/connection.py", "connection"),
    ("emqx_tpu_torch/ingress.py", "ingress batcher"),
    ("emqx_tpu_torch/session.py", "session"),
    ("emqx_tpu_torch/inflight.py", "session"),
    ("emqx_tpu_torch/mqueue.py", "session"),
    ("emqx_tpu_torch/", "broker, router, fan-out and plan"),
    ("chip_smoke.py", "the test's clients"),
    ("torch/", "torch (host side)"),
    ("asyncio/", "asyncio and sockets"),
    ("selectors.py", "asyncio and sockets"),
    ("socket", "asyncio and sockets"),
)


def host_split(prof):
    """Self time of a cProfile run by :data:`HOST_GROUPS`, largest
    first: ``[(group, seconds)]``. A built-in's time goes to the
    groups of its callers, in the shares they called it for; socket
    and selector built-ins go to asyncio and sockets."""
    import pstats

    def group(where):
        return next((g for key, g in HOST_GROUPS if key in where), "other")

    groups = {}
    for (path, _line, func), row in pstats.Stats(prof).stats.items():
        if path != "~" or group(func) != "other":
            shares = [(group(path if path != "~" else func), row[2])]
        else:
            shares = [(group(cpath), crow[2])
                      for (cpath, _l, _f), crow in row[4].items()]
        for name, sec in shares:
            groups[name] = groups.get(name, 0.0) + sec
    return sorted(groups.items(), key=lambda kv: -kv[1])


class GcPauses:
    """Seconds the interpreter's garbage collector held the process
    while installed, per generation."""

    def __init__(self) -> None:
        self.secs = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t0 = 0.0

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            gen = info["generation"]
            self.secs[gen] += time.perf_counter() - self._t0
            self.count[gen] += 1

    def __enter__(self):
        import gc

        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        import gc

        gc.callbacks.remove(self)


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if len(xs) else 0.0


async def socket_publish(node, wl, draw, opts, card, oracle):
    """Phase 7a on a running node: the fleet, the timed publish run
    and a profiled window; returns the numbers and the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from emqx_tpu_torch.mqtt.packet import Publish, Subscribe
    from emqx_tpu_torch.ops import _build

    router, ing = node.broker.router, node.ingress
    lst = node.listeners[-1]
    n_conn = opts.conns
    limit = raise_fd_limit(2 * n_conn + 256)
    if limit < 2 * n_conn + 256:
        n_conn = max(2, (limit - 256) // 2 // 2 * 2)
        log(f"[socket] the descriptor limit {limit} holds {n_conn} "
            f"connections, not {opts.conns}: running {n_conn}")
    n_sub = n_conn // 2
    n_pub = n_conn - n_sub
    plus_set = set(wl["plus"])
    top_plus = [f for f in draw if f in plus_set][:n_sub]
    specs = ([(f"sub{i}", 4 + i % 2) for i in range(n_sub)]
             + [(f"pub{i}", 4 + i % 2) for i in range(n_pub)])
    clients, conn_s = await connect_fleet(lst.port, specs)
    subs, pubs = clients[:n_sub], clients[n_sub:]
    log(f"[socket] {n_conn} connections ({n_sub} subscribers, {n_pub} "
        f"publishers, half MQTT v4 and half v5): {n_conn / conn_s:.1f} "
        f"CONNACKs/s — {card}")
    sub_filters = {}
    acks = []
    for i, c in enumerate(subs):
        flts = (top_plus[i % len(top_plus)], wl["big"][i % len(wl["big"])])
        sub_filters[c] = flts
        acks.append(c.expect("suback", 1))
        c.send(Subscribe(packet_id=1,
                         topic_filters=[(f, {"qos": 1}) for f in flts]))
    for a in await asyncio.gather(*acks):
        if a.reason_codes != [1, 1]:
            raise AssertionError(f"SUBACK {a.reason_codes}")
    per_pub = opts.pubs_per_conn
    if per_pub < FLEET_PUBS:
        log(f"[socket] cut: {per_pub} timed PUBLISHes a publisher, not the "
            f"fleet's {FLEET_PUBS}, to hold the whole run near 145 s")
    # the topics: Zipf(1.1) draws, seed 0; a publisher's timed window,
    # then 2 for the profiled window and 2 for the cProfile one
    topics = zipf_topics(np.random.default_rng(0), draw,
                         n_pub * (per_pub + 4))
    # the oracle's deliveries per socket subscriber, per topic
    subs_of = {}
    for c, flts in sub_filters.items():
        for f in flts:
            subs_of.setdefault(f, []).append(c)
    hits = {}
    for t in set(topics):
        got = [c for f in oracle.match(t) for c in subs_of.get(f, ())]
        if got:
            hits[t] = got
    # warm-up: the fan-out tables the subscriptions changed
    w = pubs[0]
    fut = w.expect("puback", 0xFFFF)
    w.send(Publish(topic="warmup/none", qos=1, packet_id=0xFFFF,
                   payload=b"w"))
    await fut

    async def publisher(c, mine, lat, out):
        for t in mine:
            j = len(out) + 1
            t0 = time.perf_counter()
            payload = b"%s:%d:%.9f" % (c.cid.encode(), j, t0)
            out.append((t, payload))
            fut = c.expect("puback", j)
            c.send(Publish(topic=t, qos=1, packet_id=j, payload=payload))
            await fut
            lat.append(time.perf_counter() - t0)

    async def window(lo, hi):
        sent = {c: topics[k * (per_pub + 4) + lo:k * (per_pub + 4) + hi]
                for k, c in enumerate(pubs)}
        want = {c: 0 for c in subs}
        for mine in sent.values():
            for t in mine:
                for c in hits.get(t, ()):
                    want[c] += 1
        cd = Countdown(want)
        for c in subs:
            c.on_publish = cd
        lat = []
        done = {c: [] for c in pubs}  # (topic, payload) as sent
        t0 = time.perf_counter()
        await asyncio.gather(*(publisher(c, sent[c], lat, done[c])
                               for c in pubs))
        await cd.done
        return done, lat, time.perf_counter() - t0

    for c in subs:
        c.got.clear()
    ing.device_batches = ing.device_msgs = 0
    _build.reset_launches()
    onloop0 = node.metrics.val("delivery.serialize.onloop")
    with GcPauses() as gcp:
        sent, puback_lat, wall = await window(0, per_pub)
    onloop = node.metrics.val("delivery.serialize.onloop") - onloop0
    launches = dict(_build.LAUNCHES)
    batches, batch_msgs = ing.device_batches, ing.device_msgs
    for name in PUBLISH_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the socket path launched no {name}")
    # every delivery against the oracle: (topic, payload) multisets
    from collections import Counter

    n_del = 0
    lat = []
    want = {c: Counter() for c in subs}
    for mine in sent.values():
        for t, payload in mine:
            for s in hits.get(t, ()):
                want[s][(t, payload)] += 1
    for c in subs:
        got = Counter((t, p) for t, p, _r, _a in c.got)
        if got != want[c]:
            raise AssertionError(f"{c.cid}: received {sum(got.values())} "
                                 f"PUBLISHes, the oracle gives "
                                 f"{sum(want[c].values())}")
        for _t, p, _r, arrival in c.got:
            lat.append(arrival - float(p.rsplit(b":", 1)[1]))
        n_del += len(c.got)
    n_msgs = sum(len(m) for m in sent.values())
    out = {"conns": n_conn, "connacks_per_s": n_conn / conn_s,
           "publishes_per_s": n_msgs / wall, "deliveries": n_del,
           "delivered_per_s": n_del / wall,
           "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
           "puback_p50_ms": _pct(puback_lat, 50),
           "puback_p99_ms": _pct(puback_lat, 99),
           "device_batches": batches,
           "mean_batch": batch_msgs / max(1, batches),
           "launches": launches, "serialize_onloop": onloop}
    log(f"[socket] {n_msgs} QoS 1 PUBLISHes ({per_pub} a publisher) in "
        f"{wall:.3f} s: {out['publishes_per_s']:.1f} publishes/s, "
        f"{n_del} socket deliveries ({out['delivered_per_s']:.1f}/s) equal "
        f"the TrieOracle's per subscriber; publish→delivery p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms; PUBACK p50 "
        f"{out['puback_p50_ms']:.3f} ms, p99 {out['puback_p99_ms']:.3f} ms; "
        f"ingress device batches {batches}, mean {out['mean_batch']:.1f} "
        f"messages; launches {launches}; preserialize="
        f"{node.broker.dispatch_config.preserialize}: {onloop} of {n_del} "
        f"deliveries serialized on the event loop; garbage-collector "
        f"pauses "
        f"{sum(gcp.secs):.3f} s ({gcp.count[2]} full collections, "
        f"{gcp.secs[2]:.3f} s) — {card}")
    # a profiled window: 2 more PUBLISHes a publisher
    for c in subs:
        c.got.clear()
    before = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush_trace()
        t0 = time.perf_counter()
        sent2, _l, _w = await window(per_pub, per_pub + 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    counted = {k: _build.LAUNCHES[k] - before[k] for k in PUBLISH_KERNELS}
    traced = {k: sum(e.count for e in events if f"{k}_kernel" in e.key)
              for k in PUBLISH_KERNELS}
    n2 = sum(len(c.got) for c in subs)
    if n2 != sum(len(hits.get(t, ())) for m in sent2.values()
                 for t, _p in m):
        raise AssertionError("profiled window: deliveries differ from the "
                             "oracle's count")
    if events and counted == traced:
        busy = sum(_dev_us(e) for e in events) / 1e3
        out["idle_share"] = 1 - busy / wall_ms
        log(f"[socket] profiled window ({2 * n_pub} PUBLISHes, {n2} socket "
            f"deliveries): wall {wall_ms:.3f} ms, device busy {busy:.3f} "
            f"ms, idle share {out['idle_share']:.4f}; launches in the trace "
            f"equal the counters' {counted} — {card}")
    else:
        out["idle_share"] = None
        log(f"[socket] profiled window: device busy not measured — the "
            f"trace holds {traced} launches, the counters saw {counted}")
    # where the event loop's time goes: 2 more PUBLISHes a publisher
    # under cProfile (the loop's thread only; the executor's fetch is
    # not in it, and the profiler's cost inflates Python-heavy parts)
    import cProfile

    for c in subs:
        c.got.clear()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    sent3, _l, _w = await window(per_pub + 2, per_pub + 4)
    prof.disable()
    wall = time.perf_counter() - t0
    n3 = sum(len(c.got) for c in subs)
    if n3 != sum(len(hits.get(t, ())) for m in sent3.values()
                 for t, _p in m):
        raise AssertionError("cProfile window: deliveries differ from the "
                             "oracle's count")
    split = host_split(prof)
    total = sum(sec for _g, sec in split)
    log(f"[socket] host split of {2 * n_pub} PUBLISHes and {n3} socket "
        f"deliveries under cProfile ({wall * 1e3:.1f} ms wall, {total:.3f} "
        f"s of self time on the loop): " + "; ".join(
            f"{g} {sec:.3f} s ({sec / total:.1%})" for g, sec in split)
        + f" — {card}")
    await asyncio.gather(*(c.close() for c in clients))
    return out


async def socket_native(node, lst, wl, draw, n_conn, card, oracle,
                        prefix="n", native=True):
    """``n_conn`` of the fleet's connections (half QoS 1 subscribers on
    a most-drawn '+' filter and a big filter, half publishers of 5
    QoS 1 PUBLISHes) through ``lst``: every socket delivery against the
    TrieOracle and, with ``native`` (a listener with the native frame
    parser), every packet the clients sent framed by the C parser
    (``frame.native.frames``). Returns the counts and, per topic sent,
    the socket deliveries the oracle gives (``hits``)."""
    from collections import Counter

    from emqx_tpu_torch.mqtt.packet import Publish, Subscribe

    n_sub = n_conn // 2
    plus_set = set(wl["plus"])
    top_plus = [f for f in draw if f in plus_set][:n_sub]
    specs = ([(f"{prefix}sub{i}", 4 + i % 2) for i in range(n_sub)]
             + [(f"{prefix}pub{i}", 4 + i % 2)
                for i in range(n_conn - n_sub)])
    frames0 = node.metrics.val("frame.native.frames")
    clients, conn_s = await connect_fleet(lst.port, specs)
    subs, pubs = clients[:n_sub], clients[n_sub:]
    subs_of = {}
    acks = []
    for i, c in enumerate(subs):
        flts = (top_plus[i % len(top_plus)], wl["big"][i % len(wl["big"])])
        for f in flts:
            subs_of.setdefault(f, []).append(c)
        acks.append(c.expect("suback", 1))
        c.send(Subscribe(packet_id=1,
                         topic_filters=[(f, {"qos": 1}) for f in flts]))
    await asyncio.gather(*acks)
    topics = zipf_topics(np.random.default_rng(5), draw, 5 * len(pubs))
    hits = {t: [c for f in oracle.match(t) for c in subs_of.get(f, ())]
            for t in set(topics)}
    want = {c: Counter() for c in subs}
    sent = []
    for k, c in enumerate(pubs):
        for j, t in enumerate(topics[5 * k:5 * k + 5]):
            payload = b"%s:%d:%.9f" % (c.cid.encode(), j, 0.0)
            sent.append((c, j + 1, t, payload))
            for s_ in hits[t]:
                want[s_][(t, payload)] += 1
    cd = Countdown({c: sum(want[c].values()) for c in subs})
    for c in subs:
        c.on_publish = cd

    async def publisher(c, mine):
        for _c, j, t, payload in mine:
            fut = c.expect("puback", j)
            c.send(Publish(topic=t, qos=1, packet_id=j, payload=payload))
            await fut

    t0 = time.perf_counter()
    await asyncio.gather(*(publisher(c, [x for x in sent if x[0] is c])
                           for c in pubs))
    await cd.done
    wall = time.perf_counter() - t0
    n_del = 0
    for c in subs:
        got = Counter((t, p) for t, p, _r, _a in c.got)
        if got != want[c]:
            raise AssertionError(f"{c.cid}: received {sum(got.values())} "
                                 f"PUBLISHes through the native parser's "
                                 f"listener, the oracle gives "
                                 f"{sum(want[c].values())}")
        n_del += len(c.got)
    n_sent = sum(c.sent for c in clients)
    await asyncio.gather(*(c.close() for c in clients))
    deadline = time.monotonic() + 30
    while lst._conns or lst._handshaking:
        if time.monotonic() > deadline:
            raise AssertionError("native listener: connections never closed")
        await asyncio.sleep(0.01)
    framed = node.metrics.val("frame.native.frames") - frames0
    out = {"conns": n_conn, "deliveries": n_del, "frames": framed,
           "sent": len(sent), "wall_s": wall,
           "hits": {t: len(v) for t, v in hits.items()}}
    if not native:
        return out
    if framed != n_sent:
        raise AssertionError(f"native listener: {framed} frames framed by "
                             f"the C parser, the clients sent {n_sent}")
    log(f"[socket] native frame parser: {n_conn} connections "
        f"({n_conn / conn_s:.1f} CONNACKs/s), {len(sent)} QoS 1 "
        f"PUBLISHes in {wall:.3f} s, {n_del} socket deliveries equal the "
        f"TrieOracle's; all {n_sent} packets the clients sent framed by "
        f"the C parser (frame.native.frames) — {card}")
    return out


async def ingress_burst(node, draw, card, oracle):
    """Phase 7a's open-loop burst on the running node, before the
    fleet connects: more messages than ``MAX_INFLIGHT`` batches and one
    capped batch hold, submitted to the ingress batcher in one event
    loop step, so every pipeline slot is busy (begin on the loop, fetch
    on the executor's threads) and the backlog flushes as a batch of
    ``batch_cap`` messages. Checks the acks' order (submission order),
    every delivery against the TrieOracle and each (subscriber, filter,
    topic)'s delivery order (publish order)."""
    from emqx_tpu_torch.ingress import MAX_INFLIGHT
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.types import Message

    ing = node.ingress
    n = MAX_INFLIGHT * ing.batch_size + ing.batch_cap + ing.batch_size // 2
    msgs = [Message(topic=t, payload=b"x")
            for t in zipf_topics(np.random.default_rng(3), draw, n)]
    index = {m.id: i for i, m in enumerate(msgs)}
    ing.max_batch = ing.device_batches = ing.device_msgs = 0
    flushes = ing.flushes
    order, futs = [], []
    _build.reset_launches()
    Sink.log = []
    t0 = time.perf_counter()
    for i, m in enumerate(msgs):
        fut = ing.submit(m)
        fut.add_done_callback(lambda _f, i=i: order.append(i))
        futs.append(fut)
    inflight = ing.stats()["ingress.inflight"]
    results = await asyncio.gather(*futs)
    wall = time.perf_counter() - t0
    deliveries, Sink.log = Sink.log, None
    launches = dict(_build.LAUNCHES)
    flushes = ing.flushes - flushes
    if inflight != MAX_INFLIGHT:
        raise AssertionError(f"burst: {inflight} batches in flight, not "
                             f"{MAX_INFLIGHT}")
    if ing.max_batch != ing.batch_cap:
        raise AssertionError(f"burst: largest batch {ing.max_batch}, the "
                             f"cap is {ing.batch_cap}")
    if ing.device_batches != flushes:
        raise AssertionError(f"burst: {ing.device_batches} of {flushes} "
                             f"batches took the device path")
    for name in PUBLISH_KERNELS:
        if launches[name] < flushes:
            raise AssertionError(f"burst: {launches[name]} {name} launches "
                                 f"for {flushes} batches")
    if order != list(range(n)):
        raise AssertionError("burst: the acks resolved out of submission "
                             "order")
    check_batches(node.broker, [(msgs, results)], deliveries, oracle)
    last = {}
    for mid, sid, flt in deliveries:
        key = (sid, flt, msgs[index[mid]].topic)
        if index[mid] < last.get(key, -1):
            raise AssertionError(f"burst: subscriber {sid} got "
                                 f"{key[2]!r} out of publish order")
        last[key] = index[mid]
    log(f"[ingress] open-loop burst: {n} messages submitted in one loop "
        f"step, {inflight} batches in flight, {flushes} flushes, largest "
        f"batch {ing.max_batch} (the cap), all on the device; acks in "
        f"submission order; {len(deliveries)} deliveries equal the "
        f"TrieOracle's, each topic's in publish order; {wall:.3f} s, "
        f"{n / wall:.1f} msgs/s; launches {launches} — {card}")


def phase_socket(node, wl, draw, opts, card, oracle):
    """Phase 7a: a listener on the publish node, the open-loop ingress
    burst, then the fleet and its run, then 200 connections through a
    second listener with the native frame parser."""
    from emqx_tpu_torch.connection import Listener

    node.add_listener(port=0)

    async def go():
        await node.start()
        try:
            await ingress_burst(node, draw, card, oracle)
            out = await socket_publish(node, wl, draw, opts, card, oracle)
            lst = Listener(node.broker, node.cm, port=0, zone=node.zone,
                           name="tcp:native", device=node.device,
                           frame="native")
            await lst.start()
            node.listeners.append(lst)
            out["native"] = await socket_native(node, lst, wl, draw,
                                                NATIVE_CONNS, card, oracle)
            t0 = time.perf_counter()
            out["observe"] = await phase_observe(node, wl, draw, card,
                                                 oracle)
            log(f"[time] phase 11 (observability): "
                f"{time.perf_counter() - t0:.1f} s")
            return out
        finally:
            await node.stop()

    return asyncio.run(go())


# -- phase 11: observability on the publish node ----------------------------

#: phase 11c's connections (half subscribers, half publishers of 5
#: QoS 1 PUBLISHes) and the tracing sample rate it runs at
TRACE_CONNS = 200
TRACE_RATE = 0.05


class SysBox:
    """A ``$SYS`` subscriber: the topics and payloads it received."""

    def __init__(self) -> None:
        self.got = []

    def deliver(self, topic_filter, msg) -> None:
        self.got.append((msg.topic, bytes(msg.payload)))


async def http_get(port: int, path: str = "/metrics"):
    """One HTTP/1.1 GET over loopback: ``(status line, body)``."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0], body.decode()


async def phase_observe(node, wl, draw, card, oracle):
    """Phase 11 on phase 5's running node, at 1.06M subscriptions:
    (11a) one ``$SYS`` heartbeat with a ``$SYS/brokers/#`` subscriber:
    the topic set (every stat, the info topics, the telemetry and
    slow_subs summaries, and the non-zero metrics), the heartbeat's ms
    and B1 launches and the stats flush's ms; (11b) one Prometheus
    scrape over loopback: the stage histograms and
    ``emqx_subscriptions_count`` equal to the broker's count; (11c)
    :data:`TRACE_CONNS` connections with tracing at
    :data:`TRACE_RATE`: every delivery against the TrieOracle, every
    sampled message's chain complete (ingress, match, dispatch,
    publish, and one flush per socket delivery), the ``SlowSubs`` rows
    non-empty and the Chrome-trace export loadable."""
    import os
    import tempfile

    from emqx_tpu_torch.modules.prometheus import PrometheusModule
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.telemetry import STAGES
    from emqx_tpu_torch.types import Message

    broker, pre = node.broker, f"$SYS/brokers/{node.name}/"
    out = {}
    # -- 11a: one heartbeat ---------------------------------------------
    box = SysBox()
    broker.subscribe(box, "$SYS/brokers/#")  # "$SYS/brokers" too
    # the first publish after a subscribe rebuilds the fan-out tables:
    # run one untimed
    broker.publish(Message(topic="$SYS/brokers/warm", payload=b""))
    box.got.clear()
    t0 = time.perf_counter()
    node.stats.tick()
    upd_ms = (time.perf_counter() - t0) * 1e3
    nonzero0 = {k for k, v in node.metrics.all().items() if v}
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    node.sys.heartbeat()
    hb_ms = (time.perf_counter() - t0) * 1e3
    walks = _build.LAUNCHES["walk"] - before["walk"]
    nonzero1 = {k for k, v in node.metrics.all().items() if v}
    # an alarm the heartbeat's own batches raise or clear (slow_publish,
    # the host monitors') publishes under alarms/: not the heartbeat's
    alarms = [t for t, _p in box.got if t.startswith(pre + "alarms/")]
    topics = [t for t, _p in box.got if not t.startswith(pre + "alarms/")]
    got = set(topics)
    want = ({"$SYS/brokers"}
            | {pre + x for x in ("version", "uptime", "datetime",
                                 "sysdescr", "telemetry/stages",
                                 "telemetry/slow", "slow_subs")}
            | {pre + "stats/" + k for k in node.stats.all()})
    metric_names = {t[len(pre + "metrics/"):] for t in got
                    if t.startswith(pre + "metrics/")}
    rest = got - {pre + "metrics/" + k for k in metric_names}
    if len(topics) != len(got) or rest != want \
            or not nonzero0 <= metric_names <= nonzero1:
        raise AssertionError(
            f"[11a] the heartbeat's topics differ: {len(topics)} "
            f"published, {len(got)} distinct; {sorted(rest ^ want)[:8]}; "
            f"metrics missing {sorted(nonzero0 - metric_names)[:8]}, "
            f"unexpected {sorted(metric_names - nonzero1)[:8]}")
    stages = json.loads(dict(box.got)[pre + "telemetry/stages"])
    nsubs = node.stats.getstat("subscriptions.count")
    log(f"[11a] $SYS heartbeat at {nsubs} subscriptions: {len(topics)} "
        f"topics ({len(metric_names)} metrics, "
        f"{len(node.stats.all())} stats), every one once and as expected, "
        f"and {len(alarms)} alarm publishes; "
        f"heartbeat {hb_ms:.3f} ms, B1 launches {walks}; the stats flush "
        f"(_update_stats) {upd_ms:.3f} ms; stages in it "
        f"{sorted(stages)} — {card}")
    broker.unsubscribe(box, "$SYS/brokers/#")
    out["11a"] = {"heartbeat_ms": hb_ms, "walk": walks, "update_ms": upd_ms,
                  "topics": len(topics)}
    # -- 11b: one scrape --------------------------------------------------
    mod = node.modules.load(PrometheusModule, {"port": 0})
    try:
        for _ in range(500):
            if mod.port:
                break
            await asyncio.sleep(0.01)
        t0 = time.perf_counter()
        status, body = await http_get(mod.port)
        scrape_ms = (time.perf_counter() - t0) * 1e3
    finally:
        node.modules.unload("prometheus")
    vals = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            k, v = line.rsplit(" ", 1)
            vals[k] = float(v)
    nsubs = sum(len(x) for x in broker._subscriptions.values())
    fams = [f"emqx_tpu_publish_stage_{st}_ms_count" for st in STAGES]
    if status != b"HTTP/1.1 200 OK" \
            or vals.get("emqx_subscriptions_count") != nsubs \
            or any(f not in vals for f in fams) \
            or vals[fams[STAGES.index("end_to_end")]] < 1:
        raise AssertionError(f"[11b] scrape {status!r}: "
                             f"emqx_subscriptions_count "
                             f"{vals.get('emqx_subscriptions_count')}, the "
                             f"broker's {nsubs}")
    log(f"[11b] Prometheus scrape over loopback: {status.decode()}, "
        f"{len(body)} bytes, {len(vals)} samples in {scrape_ms:.3f} ms; "
        f"emqx_subscriptions_count {int(vals['emqx_subscriptions_count'])} "
        f"equals the broker's; all {len(STAGES)} stage histograms there "
        f"(end_to_end count "
        f"{int(vals[fams[STAGES.index('end_to_end')]])}) — {card}")
    out["11b"] = {"scrape_ms": scrape_ms, "bytes": len(body)}
    # -- 11c: sampled tracing over the socket path -------------------------
    trc = node.tracing
    trc.drain_tick()
    trc.reset()
    stamped = {}
    stamp = trc.stamp

    def recording_stamp(msg):
        ctx = stamp(msg)
        if ctx is not None:
            stamped[ctx["tid"]] = msg.topic
        return ctx

    trc.stamp = recording_stamp
    trc.config.sample_rate = TRACE_RATE
    try:
        res = await socket_native(node, node.listeners[0], wl, draw,
                                  TRACE_CONNS, card, oracle, prefix="t",
                                  native=False)
    finally:
        trc.config.sample_rate = 0.0
        del trc.stamp
    node.stats.tick()  # the stats flush drains the rings
    chains = {}
    flushes = {}
    for tids, stage, _t0, _dur, _extra, _writer in trc._export:
        for tid in tids:
            chains.setdefault(tid, set()).add(stage)
            if stage == "flush":
                flushes[tid] = flushes.get(tid, 0) + 1
    need = {"ingress", "match", "dispatch", "publish"}
    bad = [(tid, t) for tid, t in stamped.items()
           if not need <= chains.get(tid, set())
           or flushes.get(tid, 0) != res["hits"].get(t, 0)]
    rows = trc.slow.top()
    with tempfile.TemporaryDirectory(prefix="chip_trace_", dir=".") as d:
        path = os.path.join(d, "trace_11c.json")
        n_ev = trc.export(path)
        with open(path) as f:
            doc = json.load(f)
    n_flush = sum(flushes.values())
    if bad or not stamped or not rows or len(doc["traceEvents"]) != n_ev \
            or n_flush == 0:
        raise AssertionError(f"[11c] {len(bad)} of {len(stamped)} sampled "
                             f"chains incomplete ({bad[:4]}), slow_subs "
                             f"rows {len(rows)}")
    log(f"[11c] tracing at sample_rate {TRACE_RATE}: {res['conns']} "
        f"connections, {res['sent']} QoS 1 PUBLISHes in "
        f"{res['wall_s']:.3f} s, {res['deliveries']} socket deliveries "
        f"equal the TrieOracle's; {len(stamped)} messages sampled, every "
        f"chain complete (ingress, match, dispatch, publish, and "
        f"{n_flush} flushes, one per socket delivery); tracing.spans "
        f"{node.metrics.val('tracing.spans')}, tracing.dropped "
        f"{node.metrics.val('tracing.dropped')}; slow_subs "
        f"{len(rows)} rows, worst {rows[0][0]} avg {rows[0][1]:.3f} ms; "
        f"the Chrome-trace export's {n_ev} events load — {card}")
    trc.reset()
    out["11c"] = {"sampled": len(stamped), "flushes": n_flush,
                  "slow_rows": len(rows)}
    return out


async def socket_replay(node, opts, card, tag="live"):
    """Phase 7b on a running node: bursts of live clients, each a
    CONNECT then a SUBSCRIBE; every replayed PUBLISH checked against
    the name family. Returns the numbers and each client's received
    bytes."""
    from emqx_tpu_torch.mqtt.packet import Subscribe
    from emqx_tpu_torch.ops import _build

    lst = node.listeners[-1]
    family = NameFamily(opts.names)
    bursts = retained_bursts(opts.names, opts.bursts, opts.burst, seed=21)
    waits, n_del, raw, spans = [], 0, [], []
    onloop0 = node.metrics.val("delivery.serialize.onloop")
    _build.reset_launches()
    for bi, flts in enumerate(bursts):
        clients, _s = await connect_fleet(
            lst.port, [(f"{tag}{bi}_{j}", 4 + j % 2)
                       for j in range(len(flts))])
        t_burst = time.perf_counter()
        want = {c: len(family.match(f)) for c, f in zip(clients, flts)}
        cd = Countdown(want)
        subacks = []
        for c, f in zip(clients, flts):
            c.on_publish = cd
            subacks.append(c.expect("suback", 1))
            c.send(Subscribe(packet_id=1, topic_filters=[(f, {"qos": 0})]))
        acked = []
        for c, fut in zip(clients, subacks):
            await fut
            acked.append(time.perf_counter())
        await cd.done
        for c, f, t_ack in zip(clients, flts, acked):
            names = sorted(t for t, _p, _r, _a in c.got)
            if names != sorted(retained_name(int(i))
                               for i in family.match(f)):
                raise AssertionError(f"burst {bi}: {f!r} replayed "
                                     f"{len(names)} messages over the "
                                     f"socket, expected {want[c]}")
            for t, p, retain, _a in c.got:
                if not retain or p != t.split("/")[2][1:].encode():
                    raise AssertionError(f"burst {bi}: {t!r} lost its "
                                         f"retain flag or payload")
            last = max((a for *_x, a in c.got), default=t_ack)
            waits.append(max(0.0, last - t_ack))
            n_del += len(c.got)
        spans.append(max((a for c in clients for *_x, a in c.got),
                         default=t_burst) - t_burst)
        raw.append([bytes(c.raw) for c in clients])
        await asyncio.gather(*(c.close() for c in clients))
    launches = _build.LAUNCHES["retained_match"]
    if launches < 1:
        raise AssertionError("the socket replay launched no B3")
    n_subs = sum(len(b) for b in bursts)
    pre = node.broker.dispatch_config.preserialize
    out = {"p50_ms": _pct(waits, 50), "p99_ms": _pct(waits, 99),
           "burst_p50_ms": _pct(spans, 50), "burst_p99_ms": _pct(spans, 99),
           "subs_per_s": n_subs / max(sum(spans), 1e-9),
           "deliveries": n_del, "launches": launches,
           "onloop": node.metrics.val("delivery.serialize.onloop")
           - onloop0, "waits": waits, "spans": spans}
    log(f"[socket] retained replay, preserialize={pre}: {len(bursts)} "
        f"bursts x {opts.burst} live clients (CONNECT, then SUBSCRIBE), "
        f"{n_del} replayed PUBLISHes equal the name family; SUBACK to the "
        f"last retained message p50 {out['p50_ms']:.3f} ms, p99 "
        f"{out['p99_ms']:.3f} ms; per burst (first SUBSCRIBE sent to the "
        f"last PUBLISH in) p50 {out['burst_p50_ms']:.3f} ms, p99 "
        f"{out['burst_p99_ms']:.3f} ms, {out['subs_per_s']:.1f} subs/s; "
        f"{out['onloop']} serialized on the event loop; B3 launches "
        f"{launches} — {card}")
    return out, raw


def phase_socket_replay(node, opts, card):
    """Phase 7b: a listener on the retained node after phase 6; the
    same bursts with pre-serialization on and off in
    :data:`REPLAY_ORDER`, every client's received bytes equal in every
    run."""
    node.add_listener(port=0)
    cfg = node.broker.dispatch_config

    async def go():
        await node.start()
        log(f"[socket] cut: live replay runs with preserialize "
            f"{list(REPLAY_ORDER)} (was on, off, off, on), to hold the "
            f"run's time")
        runs = []
        try:
            for i, pre in enumerate(REPLAY_ORDER):
                cfg.preserialize = pre
                runs.append(await socket_replay(node, opts, card,
                                                f"live{i}_"))
            return runs
        finally:
            cfg.preserialize = True
            await node.stop()

    runs = asyncio.run(go())
    if any(raw != runs[0][1] for _o, raw in runs):
        raise AssertionError("socket replay: the received bytes differ with "
                             "preserialize on and off")
    out = {}
    for pre in (True, False):
        mine = [o for (o, _r), p in zip(runs, REPLAY_ORDER) if p == pre]
        waits = [x for o in mine for x in o["waits"]]
        spans = [x for o in mine for x in o["spans"]]
        out["on" if pre else "off"] = {
            "p50_ms": _pct(waits, 50), "p99_ms": _pct(waits, 99),
            "burst_p50_ms": _pct(spans, 50), "burst_p99_ms": _pct(spans, 99),
            "onloop": [o["onloop"] for o in mine]}
    if not max(out["on"]["onloop"]) < min(out["off"]["onloop"]):
        raise AssertionError(f"socket replay: pre-serialization left "
                             f"{out['on']['onloop']} of "
                             f"{out['off']['onloop']} serializes on the "
                             f"loop")
    for label, o in out.items():
        log(f"[socket] retained replay, preserialize={label}, both runs: "
            f"SUBACK to the last retained message p50 {o['p50_ms']:.3f} ms, "
            f"p99 {o['p99_ms']:.3f} ms; per burst p50 "
            f"{o['burst_p50_ms']:.3f} ms, p99 {o['burst_p99_ms']:.3f} ms; "
            f"serialized on the event loop {o['onloop']} — {card}")
    log(f"[socket] retained replay: every client's received bytes equal in "
        f"all {len(runs)} runs, preserialize on and off — {card}")
    return {**out, "launches": runs[0][0]["launches"]}


def run_retained(opts, device, card):
    """Phases 6, 7b and 9c; returns the B3 kernel row."""
    from emqx_tpu_torch.ops import _build

    from emqx_tpu_torch.gc import GcPolicy

    mark = (dict.fromkeys(OVERLOAD_KEYS, 0), REFUSED["connects"])
    gmark = (GcPolicy.forced, 0)  # a node starts with its counters at 0
    node, index, bursts, launches, _pre = timed(
        "6 (retained)", phase_retained, opts, device, card)
    log_overload(node, "6", mark)
    check_quiet(node, "6", index)
    log_gc(node, "6", gmark)
    gmark = gc_mark(node)
    b3 = timed("6 (B3)", phase_retained_kernel, index, bursts,
               np.random.default_rng(opts.seed), card)
    mark = overload_mark(node)
    sock = timed("7b (socket replay)", phase_socket_replay, node, opts, card)
    log_overload(node, "7b", mark)
    check_quiet(node, "7b", index)
    log_gc(node, "7b", gmark)
    gmark = gc_mark(node)
    _build.reset_launches()
    timed("9c (replay riding the suspension)", phase_retained_devloss, node,
          index, bursts, NameFamily(opts.names), card)
    log_gc(node, "9c", gmark)
    return {"name": "retained_match", "route": "cuda",
            "source": "emqx_tpu_torch/csrc/retained_match.cu",
            "replaces": "emqx_tpu/ops/retained_match.py:92",
            "launches": launches["retained_match"],
            "socket_launches": sock["launches"],
            "devloss_launches": _build.LAUNCHES["retained_match"],
            "equal": True, "library_ms": None, **b3}

# -- phase 9: the device-path breaker and device-loss recovery ---------------

#: phase 9's breaker cooldown and first rebuild backoff (the defaults are
#: 5 s and 0.5 s; a few hundred milliseconds keep the phase short). The
#: cooldown holds 9a's two open batches (about 150 ms each at full
#: width) after the trip's own delivery tail
P9_COOLDOWN_S = 0.8
P9_BACKOFF_S = 0.2
#: fault triggers phase 9 made (the registry is process-wide): the
#: phases after it are checked for none beyond these
P9_INJECTED = {"n": 0}


def check_quiet(node, label, index=None, since=None):
    """Phases 1-8: no number is taken on the breaker's host path — no
    trip, no fallback batch, no fault injected, and (retained node) no
    failed retained match and no match served by the host scan in the
    device's place (the index's counters only grow). ``since`` holds the
    breaker's counters at a phase's start (:func:`breaker_mark`) on a
    node whose earlier phase tripped it on purpose (phase 9)."""
    from emqx_tpu_torch import faults

    m = node.metrics
    base = since or {"trips": 0, "fallback_batches": 0}
    got = {"trips": m.val("breaker.trips") - base["trips"],
           "fallback_batches": m.val("breaker.fallback.batches")
           - base["fallback_batches"],
           "injected_faults": faults.info()["injected_total"]
           - P9_INJECTED["n"]}
    if index is not None:
        got["retained_device_failures"] = index.device_failures
        got["retained_host_scans"] = index.fallbacks
    log(f"[{label}] breaker state "
        f"{node.broker.breaker.STATE_NAMES[node.broker.breaker.state]}: "
        + ", ".join(f"{k.replace('_', ' ')} {v}" for k, v in got.items()))
    if any(got.values()) or node.broker.breaker.state:
        raise AssertionError(f"[{label}] the breaker's host path ran: {got}")


def breaker_mark(node):
    m = node.metrics
    return {"trips": m.val("breaker.trips"),
            "fallback_batches": m.val("breaker.fallback.batches")}


OVERLOAD_KEYS = ("overload.transitions", "overload.shed.connect",
                 "overload.shed.qos0", "overload.shed.ingress_timeout",
                 "overload.force_shutdown")


def overload_mark(node):
    """The overload counters and the retried refusals, now."""
    return ({k: node.metrics.val(k) for k in OVERLOAD_KEYS},
            REFUSED["connects"])


def log_overload(node, label, mark):
    """The overload monitor's moves over a phase, since ``mark``
    (:func:`overload_mark`): its level changes, the work it shed and
    the CONNECTs the clients had refused and retried."""
    counts, refused = overload_mark(node)
    moved = {k: v - mark[0][k] for k, v in counts.items()}
    log(f"[{label}] overload level at the end "
        f"{('ok', 'warn', 'critical')[node.overload.level]}; over the "
        f"phase: {moved}, CONNECTs refused with ServerBusy and retried "
        f"{refused - mark[1]}")


class Breaker9:
    """Times and counts phase 9's recovery: wraps the router's rebuild
    and the broker's re-warm with timers, and snapshots the launch
    counters when the breaker moves."""

    def __init__(self, node) -> None:
        self.rebuild_s, self.warm_s, self.warm_batches = [], [], []
        self.warm_launches = None
        broker, router = node.broker, node.router
        rebuild, warm = router.rebuild_device_state, broker.warm_device_path

        def timed_rebuild():
            t0 = time.perf_counter()
            out = rebuild()
            self.rebuild_s.append(time.perf_counter() - t0)
            return out

        def timed_warm():
            from emqx_tpu_torch.ops import _build

            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            n = warm()
            self.warm_s.append(time.perf_counter() - t0)
            self.warm_batches.append(n)
            self.warm_launches = {k: _build.LAUNCHES[k] - before[k]
                                  for k in PUBLISH_KERNELS}
            return n

        router.rebuild_device_state = timed_rebuild
        broker.warm_device_path = timed_warm
        self._undo = (router, broker)

    def close(self) -> None:
        router, broker = self._undo
        del router.rebuild_device_state
        del broker.warm_device_path


def wait_until(cond, timeout: float, what: str) -> float:
    """Poll ``cond`` every 5 ms up to ``timeout`` seconds; returns the
    seconds waited, raises when it never held."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"phase 9: {what} did not happen within "
                                 f"{timeout:.0f} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


class Churner:
    """Route ops on a thread (strict add → delete pairs of filters no
    config-2 topic matches), each op timed."""

    def __init__(self, router, rate: float = 1000.0) -> None:
        import threading

        self.router, self.rate = router, rate
        self.lat = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="phase9-churn")

    def _run(self) -> None:
        i = 0
        gap = 1.0 / self.rate
        while not self._stop.is_set():
            f = f"churn9/{i}/leaf"
            for op in (self.router.add_route, self.router.delete_route):
                t0 = time.perf_counter()
                op(f)
                self.lat.append(time.perf_counter() - t0)
            i += 1
            self._stop.wait(gap)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._t.join(10)
        if self._t.is_alive():
            raise AssertionError("phase 9: the churner did not stop")


def phase_devloss(node, draw, n_batch, card, oracle):
    """9a and 9b on phase 5's node at full width, the match cache back
    on (phase 8 turned it off), over 20 batches of ``n_batch`` fresh
    Zipf(1.1) topics (seed 9: every batch holds topics the cache has
    not seen, so a device batch walks): every batch's deliveries
    against the TrieOracle."""
    import torch

    from emqx_tpu_torch import faults
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops.warmup import stamp_first_batch
    from emqx_tpu_torch.overload import DeviceBreaker
    from emqx_tpu_torch.types import Message

    broker, router = node.broker, node.router
    br, rec = broker.breaker, broker.breaker.recovery
    topics = zipf_topics(np.random.default_rng(9), draw, 21 * n_batch)
    batches = [topics[i * n_batch:(i + 1) * n_batch] for i in range(20)]
    router.config.match_cache = True
    br.cooldown_s = P9_COOLDOWN_S
    rec.backoff_s = P9_BACKOFF_S
    # phase 7a's node.stop() stopped the recovery; re-arm it, as the
    # node's start() does
    rec.start()
    log(f"[9] breaker: {br.threshold} failures trip it, cooldown "
        f"{br.cooldown_s} s, first rebuild backoff {rec.backoff_s} s, "
        f"sentinel timeout {rec.sentinel_timeout_s} s; "
        f"{len(router._filter_ids)} filters — {card}")
    checks, lat = [], {"device": [], "host": []}
    Sink.log = []

    def state():
        return DeviceBreaker.STATE_NAMES[br.state]

    def publish(topics, path):
        msgs = [Message(topic=t, payload=b"x") for t in topics]
        t0 = time.perf_counter()
        res = broker.publish_batch(msgs)
        if router.device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if path is not None:
            lat[path].append(ms)
        checks.append((msgs, res))
        return ms

    def launched():
        return {k: _build.LAUNCHES[k] for k in PUBLISH_KERNELS}

    # the node's first batch after 7a rebuilds the fan-out tables its
    # subscriptions changed: run it untimed
    publish(topics[20 * n_batch:21 * n_batch], None)

    try:
        # -- 9a: transient failures ------------------------------------
        _build.reset_launches()
        for i in range(2):
            publish(batches[i], "device")
        faults.arm("device.fetch", times=br.threshold)
        for i in range(2, 2 + br.threshold):
            publish(batches[i], "host")   # begin on the card, fetch fails
        if state() != "open" or "device_path_breaker" not in \
                [a.name for a in node.alarms.get_alarms("activated")]:
            raise AssertionError(f"9a: {br.threshold} failed fetches left "
                                 f"the breaker {state()}")
        wait_until(lambda: rec.last_classification == "transient", 30,
                   "the sentinel's transient verdict")
        before = launched()
        probes = node.metrics.val("breaker.probes")
        k = 2 + br.threshold
        for i in range(k, k + 2):
            publish(batches[i], "host")   # open: the host trie only
        if node.metrics.val("breaker.probes") != probes:
            raise AssertionError(f"9a: the cooldown of {br.cooldown_s} s "
                                 f"ended before the open batches did")
        if launched() != before:
            raise AssertionError(f"9a: kernels launched while the breaker "
                                 f"was open: {before} → {launched()}")
        time.sleep(max(0.0, br._open_until - time.monotonic()) + 0.01)
        publish(batches[k + 2], "device")    # the half-open probe
        probe = launched()
        if state() != "closed" or any(probe[n] <= before[n]
                                      for n in PUBLISH_KERNELS):
            raise AssertionError(f"9a: the probe left the breaker "
                                 f"{state()}, launches {before} → {probe}")
        if any(a.name == "device_path_breaker"
               for a in node.alarms.get_alarms("activated")):
            raise AssertionError("9a: the device_path_breaker alarm stayed")
        publish(batches[k + 3], "device")
        out = {"9a": {f"{p}_{q}_ms": float(np.percentile(v, q))
                      for p, v in lat.items() for q in (50, 99)}}
        out["9a"]["batches"] = {p: len(v) for p, v in lat.items()}
        log(f"[9a] {br.threshold} injected fetch failures: the breaker "
            f"opened; {len(lat['host'])} batches of {len(batches[0])} "
            f"served by the host trie (the failed-fetch ones after a begin "
            f"on the card) p50 {out['9a']['host_50_ms']:.3f} ms, p99 "
            f"{out['9a']['host_99_ms']:.3f} ms against "
            f"{len(lat['device'])} device batches p50 "
            f"{out['9a']['device_50_ms']:.3f} ms, p99 "
            f"{out['9a']['device_99_ms']:.3f} ms; B1/B2 launches "
            f"{before} while open, {probe} after the probe closed it — "
            f"{card}")
        # -- 9b: device loss -------------------------------------------
        rebuilds0 = node.metrics.val("breaker.rebuilds")
        fails0 = node.metrics.val("breaker.rebuild.failures")
        timer = Breaker9(node)
        outage = [b[:1024] for b in batches[k + 4:19]]
        n_out = 0
        at_arm = launched()
        try:
            faults.arm("device.lost", times=0)
            try:
                for b in outage[:br.threshold]:
                    n_out += len(b)
                    publish(b, None)   # each begin fails: host-served
                wait_until(lambda: br.state == DeviceBreaker.REBUILDING,
                           30, "REBUILDING")
                wait_until(lambda: node.metrics.val(
                    "breaker.rebuild.failures") > fails0, 30,
                    "a failed rebuild attempt")
                n_out += len(outage[br.threshold])
                publish(outage[br.threshold], None)
                lost = launched()
                if lost != at_arm:
                    raise AssertionError(f"9b: kernels launched while the "
                                         f"card was lost: {at_arm} → {lost}")
            finally:
                faults.disarm("device.lost")
            t_up = time.perf_counter()
            with Churner(router, rate=500.0) as churn:
                j = br.threshold + 1
                while br.state == DeviceBreaker.REBUILDING:
                    if time.perf_counter() - t_up > 120:
                        raise AssertionError("9b: the rebuild never ended")
                    if j < len(outage):
                        n_out += len(outage[j])
                        publish(outage[j], None)   # host-matched
                        j += 1
                    else:
                        time.sleep(0.01)
                up_s = time.perf_counter() - t_up
                first_ms = publish(batches[19], None)   # the probe
            op_ms = np.array(churn.lat) * 1e3
        finally:
            timer.close()
        after = launched()
        if state() != "closed" or node.metrics.val("breaker.rebuilds") \
                != rebuilds0 + 1 or router.device_suspended():
            raise AssertionError(f"9b: the recovery left the breaker "
                                 f"{state()}")
        if any(after[n] <= lost[n] for n in PUBLISH_KERNELS) or \
                not timer.warm_launches or \
                timer.warm_launches["walk"] < 1:
            raise AssertionError(f"9b: launches {lost} → {after}, re-warm "
                                 f"{timer.warm_launches}")
        first = {}
        stamp_first_batch(first, first_ms)
        out["9b"] = {"rebuild_s": timer.rebuild_s[-1],
                     "warm_ms": timer.warm_s[-1] * 1e3,
                     "warm_batches": timer.warm_batches[-1],
                     "warm_launches": timer.warm_launches,
                     "up_s": up_s,
                     "rebuild_failures": node.metrics.val(
                         "breaker.rebuild.failures") - fails0,
                     "route_ops": len(op_ms),
                     "route_op_p99_ms": float(np.percentile(op_ms, 99))
                     if len(op_ms) else None,
                     "outage_msgs": n_out, **first}
        out["launches"] = dict(_build.LAUNCHES)
        log(f"[9b] device.lost armed: the sentinel classified the card "
            f"lost, {out['9b']['rebuild_failures']} rebuild attempts failed "
            f"while it stayed armed; disarmed, the rebuild of the "
            f"{len(router._filter_ids)}-filter tables took "
            f"{out['9b']['rebuild_s']:.3f} s and the re-warm "
            f"{out['9b']['warm_ms']:.3f} ms ({out['9b']['warm_batches']} "
            f"batches, launches {timer.warm_launches}); {up_s:.3f} s from "
            f"the disarm to the half-open window; {len(op_ms)} route ops "
            f"during it, p99 {out['9b']['route_op_p99_ms']:.3f} ms; the "
            f"first live batch after recovery (the probe, "
            f"{len(batches[0])} messages) {first_ms:.3f} ms; "
            f"{n_out} messages published during the outage; B1/B2 "
            f"launches {lost} while lost, {after} after — {card}")
    finally:
        faults.clear()
        P9_INJECTED["n"] = faults.info()["injected_total"]
    deliveries, Sink.log = Sink.log, None
    check_batches(broker, checks, deliveries, oracle)
    n_msgs = sum(len(m) for m, _r in checks)
    log(f"[9] all {n_msgs} messages of {len(checks)} batches, the outage's "
        f"included: {len(deliveries)} deliveries equal the TrieOracle's, "
        f"none lost or duplicated — {card}")
    return out


def phase_retained_devloss(node, index, bursts, family, card):
    """9c on phase 6's node: one burst while the router is suspended
    (the host scan), the rebuild, then a burst through B3 again."""
    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.ops import _build

    router = node.router
    first = bursts[0]
    # the host scan reads every stored name per wildcard filter in
    # Python: a short burst, one of each kind
    pick = ([f for f in first if "+" in f][:1]
            + [f for f in first if f.endswith("#")][:1]
            + [f for f in first if not T.wildcard(f)][:2])

    async def go(flts, tag):
        return await one_burst(node, flts, tag)

    def check(boxes, flts, label):
        for box, flt in zip(boxes, flts):
            want = sorted(retained_name(int(i)) for i in family.match(flt))
            if sorted(m.topic for _p, m in box) != want:
                raise AssertionError(f"9c {label}: {flt!r} replayed "
                                     f"{len(box)}, expected {len(want)}")
        return sum(len(b) for b in boxes)

    router.suspend_device()
    b3 = _build.LAUNCHES["retained_match"]
    scans = index.fallbacks
    t0 = time.perf_counter()
    boxes, *_ = asyncio.run(go(pick, "9c_host"))
    host_s = time.perf_counter() - t0
    n_host = check(boxes, pick, "suspended")
    if _build.LAUNCHES["retained_match"] != b3 or index._dev is not None:
        raise AssertionError("9c: B3 launched while the router was "
                             "suspended")
    if index.fallbacks != scans + 1:
        raise AssertionError(f"9c: the suspended burst counted "
                             f"{index.fallbacks - scans} host scans, not 1")
    scans = index.fallbacks
    t0 = time.perf_counter()
    router.rebuild_device_state()
    rebuild_s = time.perf_counter() - t0
    flts = bursts[1]
    t0 = time.perf_counter()
    boxes, *_ = asyncio.run(go(flts, "9c_dev"))
    dev_s = time.perf_counter() - t0
    n_dev = check(boxes, flts, "rebuilt")
    if (_build.LAUNCHES["retained_match"] <= b3 or index.fallbacks != scans
            or index.device_failures):
        raise AssertionError("9c: B3 did not serve the burst after the "
                             "rebuild")
    log(f"[9c] retained_1m, router suspended: a burst of {len(pick)} "
        f"({n_host} messages) served by the host scan in "
        f"{host_s * 1e3:.3f} ms, exact, counted (host scans "
        f"{index.fallbacks}); the router's rebuild "
        f"{rebuild_s:.3f} s; then a burst of {len(flts)} ({n_dev} "
        f"messages) through B3 again in {dev_s * 1e3:.3f} ms, exact; B3 "
        f"launches {b3} → {_build.LAUNCHES['retained_match']} — {card}")
    return {"host_ms": host_s * 1e3, "dev_ms": dev_s * 1e3,
            "rebuild_s": rebuild_s}


def phase_sentinel(card):
    """9d: the real sentinel on the live card."""
    import torch

    from emqx_tpu_torch.devloss import sentinel_alive

    t0 = time.perf_counter()
    ok = sentinel_alive(5.0, torch.device("cuda"))
    ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        raise AssertionError("9d: the sentinel found the card lost")
    log(f"[9d] sentinel_alive on the card: true in {ms:.3f} ms "
        f"(timeout 5 s) — {card}")
    return ms


# -- phase 10: crash-consistent durability ----------------------------------

#: phase 10's persistent sessions, opened as the JAX package's recovery
#: bench opens them (bench.py:2281-2304): clean_start False, an
#: unbounded inflight window, session expiry 3,600 s, QoS 1 filters
P10_SESSIONS = 4096
#: phase 5's batches 10b drives as QoS 1 (the full checkpoint after
#: half of them), cut from all 20 (to 10, then 4 for phase 12, then 3
#: for phase 13) to hold the run's time (printed). Not below 3: with 2,
#: the full checkpoint takes every dirty session state and both
#: batches' journal flushes write none, so 10b would time an empty flush
P10_BATCHES = 3
#: the retained messages phase 10 journals, checkpoints and recovers,
#: cut from phase 6's 1M (to 500,000 for phase 13, then 250,000: the
#: phase took 333-509 s on the card's hosts at 500,000 and 1.02M
#: filters, and the whole script crossed the 1,200 s limit in it on a
#: slower one; printed)
P10_NAMES = 250_000
#: the filters phase 10's sessions hold: phase 5's set cut to this many,
#: every class whole but the '+' one, as 13a's (subscribe, checkpoint,
#: recovery and the collector's pauses in it grow with the table;
#: printed)
P10_ROUTES = 250_000
#: of those, the batches driven again after recovery (10d), cut from
#: all of them (to 4, then 2); the first after recovery is always
#: among them
P10_REPEAT = 2
#: 10e's replay bursts on the recovered store, cut from phase 6's 8
#: (to 4, then 2)
P10_BURSTS = 2
P10_EXPIRY_S = 3600.0
#: sessions that leave the last pre-crash batch's deliveries unacked
P10_UNACKED = 64
#: subscribe/unsubscribe ops between the full and the delta checkpoint
P10_ROUTE_OPS = 256
#: sessions whose subscriptions are journaled between two flushes while
#: the table is built: a live node's 50 ms timer flushes at least as
#: often, and the journal's buffer holds 100,000 records
P10_FLUSH_EVERY = 16


class HeldChannel:
    """What the cm registry holds for a live durable session opened
    without a transport (the recovery bench holds its sessions so)."""

    __slots__ = ("session", "client_id")

    def __init__(self, session) -> None:
        self.session = session
        self.client_id = session.client_id


def fs_of(path: str):
    """``(mount point, filesystem type)`` holding ``path``, from
    /proc/mounts (the longest mount point that prefixes it)."""
    import os

    path = os.path.realpath(path)
    best = ("/", "?")
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1].replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[0]):
                best = (mnt, parts[2])
    return best


def durable_keys(wl, n_sessions: int):
    """Each persistent session's subscription keys: an equal share of
    phase 5's '+' and literal filters and of its 10,000 ``$share``
    subscriptions (a filter's 4 members on 4 sessions), plus the 8 big
    filters on every session (4,096 members each: the bitmap path)."""
    per = [[] for _ in range(n_sessions)]
    for i, f in enumerate(wl["plus"] + wl["literal"]):
        per[i % n_sessions].append(f)
    k = 0
    for f in wl["shared"]:
        for _ in range(4):
            per[k % n_sessions].append(f"$share/g/{f}")
            k += 1
    for keys in per:
        keys.extend(wl["big"])
    return per


def p10_workload(opts):
    """Phase 5's filter set and batches: the same generator calls on
    the same seed (subscribe_all's big-member draws included), so the
    batches are phase 5's."""
    rng = np.random.default_rng(opts.seed)
    wl = make_workload(rng, opts.subs, opts.others, 8, 4096)
    n_plus = len(wl["plus"])
    for _f in wl["big"]:
        rng.choice(n_plus, size=wl["big_members"], replace=False)
    draw = wl["plus"] + wl["literal"] + wl["hash"] + wl["shared"]
    draw = [draw[i] for i in rng.permutation(len(draw))]
    at = min(1000, len(draw))
    draw[at:at] = wl["big"]
    topics = zipf_topics(rng, draw, opts.batch * (opts.batches + 1))
    batches = [topics[(i + 1) * opts.batch:(i + 2) * opts.batch]
               for i in range(opts.batches)]
    return wl, batches


def subscription_model(sessions):
    """The recovered subscriptions, apart from the broker's tables:
    inner filter -> Counter of local client ids, inner filter ->
    {group: member ids}, and a TrieOracle of every inner filter."""
    from collections import Counter

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.oracle import TrieOracle

    local, shared = {}, {}
    oracle = TrieOracle()
    seen = set()
    for s in sessions:
        for key in s.subscriptions:
            flt, popts = T.parse(key)
            if "share" in popts:
                shared.setdefault(flt, {}).setdefault(
                    popts["share"], set()).add(s.client_id)
            else:
                local.setdefault(flt, Counter())[s.client_id] += 1
            if flt not in seen:
                seen.add(flt)
                oracle.insert(flt)
    return local, shared, oracle


def check_session_batches(model, checks, deliveries, label="10d"):
    """Every message's (session, filter) deliveries against the
    subscription model's TrieOracle: every local subscription of every
    matched filter once, one member per shared group, nothing else.
    Returns the deliveries checked."""
    from collections import Counter

    local, shared, oracle = model
    by_msg = {}
    for mid, cid, flt in deliveries:
        by_msg.setdefault(mid, Counter())[(cid, flt)] += 1
    n = 0
    for msgs, results in checks:
        for i, msg in enumerate(msgs):
            want = Counter()
            groups = []
            for f in oracle.match(msg.topic):
                for cid, c in local.get(f, {}).items():
                    want[(cid, f)] += c
                for g, members in shared.get(f, {}).items():
                    groups.append((f, members))
            got = by_msg.get(msg.id, Counter())
            extra = got - want
            if want - got or sum(extra.values()) != len(groups):
                raise AssertionError(f"[{label}] deliveries of "
                                     f"{msg.topic!r} differ from the "
                                     f"TrieOracle")
            for f, members in groups:
                if sum(c for (cid, ff), c in extra.items()
                       if ff == f and cid in members) < 1:
                    raise AssertionError(f"[{label}] a shared group of "
                                         f"{f} missed {msg.topic!r}")
            if results[i] != sum(want.values()) + len(groups):
                raise AssertionError(f"[{label}] delivery count of "
                                     f"{msg.topic!r}")
            n += sum(got.values())
    return n


class SessionLog:
    """Records ``(message id, client id, filter)`` per delivery into a
    Session while installed (the broker delivers to a session through
    ``deliver_many`` or ``deliver``)."""

    def __init__(self) -> None:
        self.log = []

    def __enter__(self):
        from emqx_tpu_torch.session import Session

        rec = self.log
        many, one = Session.deliver_many, Session.deliver

        def deliver_many(s, items):
            items = list(items)
            rec.extend((m.id, s.client_id, f) for f, m, _o, _x in items)
            return many(s, items)

        def deliver(s, f, m):
            rec.append((m.id, s.client_id, f))
            return one(s, f, m)

        self._saved = (many, one)
        Session.deliver_many, Session.deliver = deliver_many, deliver
        return self

    def __exit__(self, *exc) -> None:
        from emqx_tpu_torch.session import Session

        Session.deliver_many, Session.deliver = self._saved


def ack_all(sessions, hold=()):
    """Each session acks what its outbox holds (QoS 1 PUBACKs); the
    sessions in ``hold`` leave theirs unacked. Returns the held
    deliveries per client id as a Counter of (topic, payload)."""
    from collections import Counter

    held = {}
    for s in sessions:
        if not s.outbox:
            continue
        out = s.drain_outbox()
        if s.client_id in hold:
            held[s.client_id] = Counter((m.topic, bytes(m.payload))
                                        for pid, m in out
                                        if isinstance(pid, int))
            continue
        for pid, _m in out:
            if isinstance(pid, int):
                s.puback(pid)
    return held


def drive_batches(node, sessions, batches, seq0, hold_last=0, label="10"):
    """Phase 5's batches as QoS 1 (a unique payload each) through
    ``publish_begin/fetch/finish``, every session acking after each
    batch; with ``hold_last``, that many sessions (those with the most
    deliveries in it) leave the last batch unacked. Returns the
    per-batch seconds, the (messages, results) pairs, the held
    deliveries and the B1/B2 launches of each batch."""
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.types import Message

    broker = node.broker
    lat, checks, launches = [], [], []
    held = {}
    seq = seq0
    for bi, topics in enumerate(batches):
        msgs = []
        for t in topics:
            msgs.append(Message(topic=t, payload=b"%d" % seq, qos=1))
            seq += 1
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        pb = broker.publish_begin(msgs)
        if pb.done:
            raise AssertionError(f"[{label}] batch {bi} did not take "
                                 f"the device path")
        broker.publish_fetch(pb)
        res = broker.publish_finish(pb)
        lat.append(time.perf_counter() - t0)
        launches.append({k: _build.LAUNCHES[k] - before[k]
                         for k in PUBLISH_KERNELS})
        checks.append((msgs, res))
        hold = ()
        if hold_last and bi == len(batches) - 1:
            ranked = sorted(sessions, key=lambda s: -len(s.outbox))
            hold = {s.client_id for s in ranked[:hold_last]}
        held.update(ack_all(sessions, hold))
    return lat, checks, held, launches, seq


def run_durable(opts, device, card):
    """Phase 10 on ``device``; returns its numbers, with the recovered
    node's B1, B2 and B3 launches under ``launches``."""
    out = asyncio.run(phase_durable(opts, device, card))
    gc.collect()
    return out


async def phase_durable(opts, device, card):
    """Phase 10 (10a-10f); returns the B1, B2 and B3 launches of the
    recovered node's run and the phase's numbers."""
    import os
    import shutil
    import tempfile
    import weakref
    from collections import Counter

    import torch

    from emqx_tpu_torch import checkpoint, wal
    from emqx_tpu_torch.channel import Channel
    from emqx_tpu_torch.durability import DurabilityConfig
    from emqx_tpu_torch.modules.retainer import RetainerModule
    from emqx_tpu_torch.mqtt import constants as MC
    from emqx_tpu_torch.mqtt.packet import Connect
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.oracle import TrieOracle
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.router import MatcherConfig, Router
    from emqx_tpu_torch.session import Session
    from emqx_tpu_torch.types import SubOpts

    on_card = device != "cpu"
    n_sess = opts.sessions
    names = min(opts.names, P10_NAMES)
    wl, batches = p10_workload(opts)
    others = sum(len(wl[k]) for k in ("literal", "hash", "shared", "big"))
    n_plus = max(0, min(len(wl["plus"]), P10_ROUTES - others))
    if len(batches) > P10_BATCHES or names < opts.names \
            or n_plus < len(wl["plus"]):
        log(f"[10] cut: {P10_BATCHES} of phase 5's {len(batches)} batches "
            f"in 10b, {P10_REPEAT} of them again in 10d, {P10_BURSTS} "
            f"replay bursts in 10e, {names} of the {opts.names} retained "
            f"messages, {n_plus} of phase 5's {len(wl['plus'])} '+' "
            f"filters (every other class whole), to hold the run's time")
        batches = batches[:P10_BATCHES]
        wl["plus"] = wl["plus"][:n_plus]
    per = durable_keys(wl, n_sess)
    # a fresh directory on the checkout's disk (the run's TMPDIR may be
    # a tmpfs, where fsync costs nothing)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_durability")
    os.makedirs(base, exist_ok=True)
    d = tempfile.mkdtemp(prefix="p10-", dir=base)
    mnt, fstype = fs_of(d)
    st = os.statvfs(d)
    free = st.f_bavail * st.f_frsize
    log(f"[10] durability directory {d}: filesystem {fstype} (mount "
        f"{mnt}), {free} bytes free; fsync on")
    if fstype in ("tmpfs", "ramfs"):
        raise AssertionError(f"[10] {d} lies on a {fstype}: fsync would "
                             f"cost nothing")

    def cfg():
        return DurabilityConfig(enabled=True, dir=d, fsync=True)

    out = {}
    try:
        # -- 10a: build -----------------------------------------------------
        from emqx_tpu_torch.gc import GcPolicy

        gmark = GcPolicy.forced
        node = Node(device=device, batch_size=opts.batch, durability=cfg(),
                    boot_listeners=False)
        mod = node.modules.load(RetainerModule)
        await node.start()  # an empty directory: the baseline generation
        dur = node.durability
        t0 = time.perf_counter()
        sessions = []
        for i in range(n_sess):
            s = Session(f"dev-{i}", broker=node.broker, clean_start=False,
                        max_inflight=0)
            dur.session_opened(s, P10_EXPIRY_S)
            node.cm.register_channel(s.client_id, HeldChannel(s))
            for key in per[i]:
                s.subscribe(key, SubOpts(qos=1))
            sessions.append(s)
            if (i + 1) % P10_FLUSH_EVERY == 0:
                dur.on_batch()
        clean = [Sink(j) for j in range(len(wl["hash"]))]
        for j, (sink, f) in enumerate(zip(clean, wl["hash"])):
            node.broker.subscribe(sink, f)
            if (j + 1) % 8192 == 0:
                dur.on_batch()
        dur.on_batch()
        sub_s = time.perf_counter() - t0
        n_keys = sum(len(p) for p in per) + len(clean)
        store_s = store_retained(node, names)
        dur.on_batch()
        wi = dur.wal.info()
        log(f"[10a] {n_sess} persistent sessions (clean_start=False, "
            f"expiry {P10_EXPIRY_S:.0f} s, QoS 1) hold {n_keys - len(clean)} "
            f"subscriptions ({len(node.router._filter_ids)} filters), "
            f"{len(clean)} '#' filters on clean subscribers: subscribe "
            f"{sub_s:.1f} s; {names} retained messages stored through "
            f"the broker {store_s:.1f} s; journal {wi['records']} records, "
            f"{wi['bytes'] / 1e6:.1f} MB, {wi['fsyncs']} fsyncs, last fsync "
            f"{wi['last_fsync_ms']:.3f} ms, dropped {wi['dropped']} — {card}")
        if wi["dropped"] or wi["degraded"]:
            raise AssertionError(f"[10a] the journal dropped records: {wi}")
        out["10a"] = {"subscribe_s": sub_s, "store_s": store_s,
                      "journal_records": wi["records"],
                      "journal_mb": wi["bytes"] / 1e6,
                      "last_fsync_ms": wi["last_fsync_ms"]}

        # -- 10b: traffic and checkpoints ------------------------------------
        ob_s = []
        split = []  # per batch: (states, write, fsync) seconds
        parts = {}  # one batch's states split into to_wire and encode
        real_on_batch = dur.on_batch

        def timed_on_batch():
            # on_batch's body, in its three parts: the dirty sessions'
            # to_wire + encode_record into the journal buffer, the
            # segment write, its one fsync (the journal's own timer)
            w = dur.wal
            if not parts and dur._dirty:
                # once, outside the timed flush: the states' two halves
                dirty = [x for x in dur._dirty if x.durable]
                t = time.perf_counter()
                wires = [x.to_wire() for x in dirty]
                t1 = time.perf_counter()
                for x, wd in zip(dirty, wires):
                    wal.encode_record(("sess.state", x.client_id, None, wd))
                parts.update(sessions=len(dirty),
                             to_wire_ms=(t1 - t) * 1e3,
                             encode_ms=(time.perf_counter() - t1) * 1e3)
            t = time.perf_counter()
            if dur._dirty:
                dur._flush_states()
            t1 = time.perf_counter()
            fs0 = w.info()["fsyncs"]
            if w.pending():
                w.flush()
            t2 = time.perf_counter()
            fs = (w.info()["last_fsync_ms"] / 1e3
                  if w.info()["fsyncs"] > fs0 else 0.0)
            ob_s.append(t2 - t)
            split.append((t1 - t, t2 - t1 - fs, fs))

        dur.on_batch = timed_on_batch  # the fetch's flush, timed
        half = len(batches) // 2
        lat1, _c, _h, _l, seq = drive_batches(node, sessions,
                                              batches[:half], 0)
        t0 = time.perf_counter()
        full = dur.checkpoint_now(full=True)
        full_s = time.perf_counter() - t0
        if full.get("kind") != "full":
            raise AssertionError(f"[10b] full checkpoint failed: {full}")
        man = checkpoint.read_manifest(d)
        seg = {k: os.path.getsize(os.path.join(d, man[k]))
               for k in ("router", "state")}
        rng = random.Random(opts.seed + 10)
        ops = []
        for k in range(P10_ROUTE_OPS // 2):
            s = sessions[rng.randrange(n_sess)]
            s.subscribe(f"p10/churn/{k}/+", SubOpts(qos=1))
            ops.append(("+", s.client_id))
            s = sessions[rng.randrange(n_sess)]
            key = next(x for x in s.subscriptions
                       if not x.startswith("$share/") and x not in wl["big"])
            s.unsubscribe(key)
            ops.append(("-", s.client_id))
        real_on_batch()
        t0 = time.perf_counter()
        delta = dur.checkpoint_now()
        delta_s = time.perf_counter() - t0
        if delta.get("kind") != "delta":
            raise AssertionError(f"[10b] delta checkpoint failed: {delta}")
        lat2, _c, held, _l, seq = drive_batches(
            node, sessions, batches[half:], seq, hold_last=P10_UNACKED)
        real_on_batch()  # the batch flush a crash cannot outrun
        del dur.on_batch
        lat = lat1 + lat2
        n_msgs = sum(len(b) for b in batches)
        ob_ms = np.array(ob_s) * 1e3
        lat_ms = np.array(lat) * 1e3
        n_held = sum(sum(c.values()) for c in held.values())
        log(f"[10b] {len(batches)} batches x {opts.batch} QoS 1 msgs: "
            f"{n_msgs / sum(lat):.1f} msgs/s, p50 "
            f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
            f"{np.percentile(lat_ms, 99):.3f} ms per batch; on_batch (the "
            f"journal flush, one fsync) p50 {np.percentile(ob_ms, 50):.3f} "
            f"ms, p99 {np.percentile(ob_ms, 99):.3f} ms, per batch "
            f"{[round(x, 3) for x in ob_ms.tolist()]} — {card}")
        sp_ms = np.array(split) * 1e3
        log(f"[10b] on_batch split, medians over {len(split)} flushes: "
            f"session states (to_wire + encode_record) "
            f"{np.median(sp_ms[:, 0]):.3f} ms, write "
            f"{np.median(sp_ms[:, 1]):.3f} ms, fsync "
            f"{np.median(sp_ms[:, 2]):.3f} ms; one batch's "
            f"{parts.get('sessions', 0)} dirty sessions: to_wire "
            f"{parts.get('to_wire_ms', 0.0):.3f} ms, encode_record "
            f"{parts.get('encode_ms', 0.0):.3f} ms — {card}")
        log(f"[10b] after batch {half}: full checkpoint {full_s:.3f} s "
            f"(generation {full['generation']}, router segment "
            f"{seg['router']} bytes, state segment {seg['state']} bytes, "
            f"{full['routes']} routes, {full['sessions']} sessions, "
            f"{full['retained']} retained); {len(ops)} subscribe/"
            f"unsubscribe ops, delta checkpoint {delta_s:.3f} s "
            f"({delta['records']} records, generation "
            f"{delta['generation']}); {len(held)} sessions left "
            f"{n_held} deliveries of the last batch unacked — {card}")
        out["10b"] = {"msgs_per_s": n_msgs / sum(lat),
                      "p50_ms": float(np.percentile(lat_ms, 50)),
                      "p99_ms": float(np.percentile(lat_ms, 99)),
                      "on_batch_p50_ms": float(np.percentile(ob_ms, 50)),
                      "on_batch_p99_ms": float(np.percentile(ob_ms, 99)),
                      "split_median_ms": {
                          k: float(np.median(sp_ms[:, j])) for j, k in
                          enumerate(("states", "write", "fsync"))},
                      "states_parts": parts,
                      "full_s": full_s, "delta_s": delta_s,
                      "segments": seg, "delta_records": delta["records"]}
        if n_held == 0:
            raise AssertionError("[10b] no delivery left unacked")
        check_quiet(node, "10b")

        # -- 10c: crash -----------------------------------------------------
        pre_routes = node.router.route_table()
        hash_set = set(wl["hash"])
        want_routes = {f: dd for f, dd in pre_routes.items()
                       if f not in hash_set}
        pruned_want = sum(sum(dd.values()) for f, dd in pre_routes.items()
                          if f in hash_set)
        pre_subs = {s.client_id: {k: (o.qos, o.share)
                                  for k, o in s.subscriptions.items()}
                    for s in sessions}
        name = node.name
        newest = dur.wal.info()["path"]  # the segment being written
        log_gc(node, "10a and 10b", (gmark, 0))
        node.broker.durability = None
        node.cm.durability = None
        node.durability = None
        await node.stop()
        await asyncio.sleep(0)
        rec = wal.encode_record(("sess.close", "torn-by-the-crash"))
        with open(newest, "ab") as f:
            f.write(rec[:len(rec) // 2])
        if on_card:
            torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated() if on_card else 0
        gone = weakref.ref(node)
        del node, mod, dur, sessions, clean, s, real_on_batch, timed_on_batch
        gc.collect()
        if gone() is not None:
            raise AssertionError("[10c] the crashed node is still alive")
        if on_card:
            torch.cuda.empty_cache()
        mem1 = torch.cuda.memory_allocated() if on_card else 0
        log(f"[10c] kill -9 analogue (durability detached, no graceful "
            f"path), half a frame appended to {os.path.basename(newest)}; "
            f"the node dropped: device memory allocated {mem0} -> {mem1} "
            f"bytes — {card}")

        # -- 10d: recovery --------------------------------------------------
        gmark = GcPolicy.forced
        node = Node(device=device, batch_size=opts.batch, name=name,
                    durability=cfg(), boot_listeners=False)
        mod = node.modules.load(RetainerModule)
        t0 = time.perf_counter()
        with GcPauses() as gcp:
            await node.start()
        total_s = time.perf_counter() - t0
        rec = node.durability.last_recovery
        mem2 = torch.cuda.memory_allocated() if on_card else 0
        log(f"[10d] recovery: start() {total_s:.3f} s (the baseline "
            f"checkpoint in it); duration before the baseline "
            f"{rec['duration_s']} s, {rec['journals']} journals, "
            f"{rec['replayed_records']} records replayed, "
            f"{rec.get('delta_records', 0)} delta records, "
            f"{rec['torn_journals']} torn, {rec['sessions']} sessions, "
            f"{rec['routes']} routes, {rec['pruned_refs']} refs pruned, "
            f"{rec['retained']} retained, tables_restored "
            f"{rec.get('tables_restored')}, generation {rec['generation']}, "
            f"baseline {rec['baseline']}; the collector's pauses "
            f"{sum(gcp.secs):.3f} s ({gcp.count} collections by "
            f"generation, {[round(x, 3) for x in gcp.secs]} s); device "
            f"memory allocated {mem2} bytes — {card}")
        got_routes = node.router.route_table()
        if got_routes != want_routes:
            raise AssertionError("[10d] the recovered route table is not the "
                                 "pre-crash table less the clean refs")
        if rec["pruned_refs"] != pruned_want or rec["sessions"] != n_sess \
                or rec["torn_journals"] < 1 or rec["degraded"] \
                or not rec.get("delta_records") or not rec["replayed_records"]:
            raise AssertionError(f"[10d] recovery summary {rec}")
        if not any(a.name == "journal_torn_tail"
                   for a in node.alarms.get_alarms("activated")):
            raise AssertionError("[10d] no journal_torn_tail alarm")
        sessions = [node.cm._detached[f"dev-{i}"][0] for i in range(n_sess)]
        for s in sessions:
            if {k: (o.qos, o.share) for k, o in s.subscriptions.items()} \
                    != pre_subs[s.client_id]:
                raise AssertionError(f"[10d] {s.client_id}'s subscriptions")
        store = mod._store
        if len(store) != names or any(
                store[retained_name(i)].payload != b"%d" % i
                for i in range(names)):
            raise AssertionError("[10d] the retained store differs")
        log(f"[10d] routes equal the pre-crash table less the "
            f"{pruned_want} refs of the clean subscribers; {n_sess} sessions "
            f"with their subscriptions, {len(store)} retained messages "
            f"exact")
        out["10d"] = {"start_s": total_s, "duration_s": rec["duration_s"],
                      "replayed": rec["replayed_records"],
                      "delta_records": rec.get("delta_records", 0),
                      "torn": rec["torn_journals"],
                      "sessions": rec["sessions"],
                      "routes": rec["routes"], "pruned": rec["pruned_refs"],
                      "tables_restored": rec.get("tables_restored"),
                      "gc_s": sum(gcp.secs)}
        # the held sessions resume through a sans-IO channel
        chans, n_dup = [], 0
        for cid, want in sorted(held.items()):
            for attempt in range(CONNECT_RETRIES + 1):
                ch = Channel(node.broker, node.cm)
                pk = ch.handle_in(Connect(
                    proto_ver=MC.MQTT_V5, client_id=cid, clean_start=False,
                    properties={"Session-Expiry-Interval":
                                int(P10_EXPIRY_S)}))
                if ch.session is not None:
                    break
                await refused_backoff(attempt)
            else:
                raise AssertionError(f"[10d] {cid}: CONNECT refused")
            if not pk[0].session_present:
                raise AssertionError(f"[10d] {cid}: no session present")
            pubs = [p for p in pk[1:] + ch.handle_deliver()
                    if getattr(p, "type", None) == MC.PUBLISH]
            got = Counter((p.topic, bytes(p.payload)) for p in pubs
                          if p.dup and p.qos == 1)
            if got != want or len(pubs) != sum(want.values()):
                raise AssertionError(
                    f"[10d] {cid}: redelivered {sum(got.values())} of "
                    f"{sum(want.values())} with DUP, {len(pubs)} PUBLISHes; "
                    f"missing {sorted(want - got)[:3]}, extra "
                    f"{[(p.topic, p.dup, p.qos) for p in pubs][:3] if len(pubs) != sum(want.values()) else sorted(got - want)[:3]}")
            n_dup += len(pubs)
            for p in pubs:
                ch.session.puback(p.packet_id)
            chans.append(ch)
        log(f"[10d] {len(chans)} sessions resumed through a sans-IO "
            f"Channel CONNECT (clean_start=False): session present, "
            f"{n_dup} unacked QoS 1 messages redelivered with DUP, none "
            f"lost")
        model = subscription_model(sessions)
        again = batches[:P10_REPEAT]
        _build.reset_launches()
        with SessionLog() as sl:
            first, checks, _h, fl, seq = drive_batches(
                node, sessions, again[:1], seq)
            lat, checks2, _h, bl, seq = drive_batches(node, sessions,
                                                      again[1:], seq)
        launches = dict(_build.LAUNCHES)
        n_ok = check_session_batches(model, checks + checks2, sl.log)
        lat_ms = np.array(lat) * 1e3
        n_rest = sum(len(b) for b in again[1:])
        log(f"[10d] {len(again)} of the batches again: the first after "
            f"recovery {first[0] * 1e3:.3f} ms (the flatten and the fan-out "
            f"build in it), B1 launches {fl[0]['walk']}, B2 launches "
            f"{fl[0]['bitmap_or']}; the other {len(again) - 1}: "
            f"{n_rest / sum(lat):.1f} msgs/s, p50 "
            f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
            f"{np.percentile(lat_ms, 99):.3f} ms; launches {launches}; "
            f"{n_ok} deliveries equal the TrieOracle of the recovered "
            f"subscriptions — {card}")
        if not fl[0]["walk"] or not fl[0]["bitmap_or"] \
                or any(not b["walk"] or not b["bitmap_or"] for b in bl):
            raise AssertionError("[10d] a batch missed B1 or B2")
        out["10d"].update({"first_ms": first[0] * 1e3,
                           "first_launches": fl[0],
                           "msgs_per_s": n_rest / sum(lat),
                           "p50_ms": float(np.percentile(lat_ms, 50)),
                           "p99_ms": float(np.percentile(lat_ms, 99))})
        check_quiet(node, "10d")

        # -- 10e: retained after recovery ----------------------------------
        bursts = retained_bursts(names, min(opts.bursts, P10_BURSTS),
                                 opts.burst)
        saves0 = node.durability.counters["checkpoint.saves"]
        r = await replay_bursts(node, mod._index, bursts,
                                NameFamily(names), "p10_")
        saves = node.durability.counters["checkpoint.saves"] - saves0
        blat = np.array(r[0]) * 1e3
        b3 = r[5]["retained_match"]
        log(f"[10e] {len(bursts)} bursts x {opts.burst} subscriptions on "
            f"the recovered store: p50 {np.percentile(blat, 50):.3f} ms, p99 "
            f"{np.percentile(blat, 99):.3f} ms per burst, {r[3]} replayed "
            f"messages equal to the pre-crash store, B3 launches {b3}; "
            f"bursts in order {[round(x, 3) for x in blat.tolist()]} ms, of "
            f"which the collector's pauses "
            f"{[round(x * 1e3, 3) for x in r[4]]} ms; checkpoints the "
            f"node's own cadence committed meanwhile {saves} — {card}")
        check_quiet(node, "10e", mod._index)
        out["10e"] = {"p50_ms": float(np.percentile(blat, 50)),
                      "p99_ms": float(np.percentile(blat, 99))}
        launches["retained_match"] = b3
        burst_oracle = TrieOracle()
        for flts in bursts:
            for f in set(flts):
                burst_oracle.insert(f)

        # -- 10f: the checkpoint fast path ---------------------------------
        t0 = time.perf_counter()
        node.router.set_delta(False)
        flatten_s = time.perf_counter() - t0
        path = os.path.join(d, "fastpath.npz")
        t0 = time.perf_counter()
        info = checkpoint.save(node.router, path)
        save_s = time.perf_counter() - t0
        if not info["tables"]:
            raise AssertionError("[10f] the snapshot holds no tables")
        log_gc(node, "10d to 10f", (gmark, 0))
        node.broker.durability = node.cm.durability = None
        node.durability = None
        await node.stop()
        await asyncio.sleep(0)
        gone = weakref.ref(node)
        del node, mod, sessions, chans, store, ch, s
        gc.collect()
        if gone() is not None:
            raise AssertionError("[10f] the recovered node is still alive")
        if on_card:
            torch.cuda.empty_cache()
        router = Router(MatcherConfig(delta=False), node=name, device=device)
        t0 = time.perf_counter()
        res = checkpoint.load(router, path)
        load_s = time.perf_counter() - t0
        rebuilds = router.stats()["rebuilds"]
        topics = batches[0]
        _build.reset_launches()
        t0 = time.perf_counter()
        got = router.match_filters(topics)
        first_ms = (time.perf_counter() - t0) * 1e3
        walks = _build.LAUNCHES["walk"]
        # the recovered subscriptions and 10e's burst filters
        oracle = OracleUnion(model[2], burst_oracle)
        bad = [t for t, m in zip(topics, got)
               if sorted(m) != sorted(oracle.match(t))]
        log(f"[10f] set_delta(False) {flatten_s:.3f} s; checkpoint.save "
            f"{save_s:.3f} s, {os.path.getsize(path) / 1e6:.1f} MB with "
            f"tables; checkpoint.load into a fresh delta=False router "
            f"{load_s:.3f} s: tables_restored {res['tables_restored']}, "
            f"{res['routes']} routes, rebuilds {rebuilds} -> "
            f"{router.stats()['rebuilds']}; first batch of {len(topics)} "
            f"{first_ms:.3f} ms, B1 launches {walks}, {len(bad)} topics "
            f"differ from the TrieOracle — {card}")
        if not res["tables_restored"] or rebuilds != 0 \
                or router.stats()["rebuilds"] != 0 or not walks or bad:
            raise AssertionError("[10f] the fast path did not hold")
        out["10f"] = {"flatten_s": flatten_s, "save_s": save_s,
                      "load_s": load_s, "mb": os.path.getsize(path) / 1e6,
                      "first_ms": first_ms, "walk": walks}
        launches["fastpath_walk"] = walks
        del router
        gc.collect()
        out["launches"] = launches
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


# -- phase 14: replicated durability and the drain ---------------------------

P14_BUDGET_S = 60.0
#: 14a/14b: the JAX failover bench's fleet (bench.py:2525, "5000 — a real
#: fleet, not a toy"), each session with its own ``fb/<i>/+``
P14_SESSIONS = 5000
#: 14a: the one filter every session of the fleet also holds (5,000
#: subscribers: past the fan-out threshold, so it rides B2's bitmap path),
#: and the topics of the adopted batch that hit it
P14_WIDE = "fbw/+"
P14_WIDE_TOPICS = 4
#: 14a: retained messages on the primary (13b's store instead of the
#: bench's 100, so B3's replay runs over a store of real size) and the
#: SUBSCRIBE burst on the promoted node
P14_RETAINED = P13_RETAINED
P14_BURST = 64
#: 14c: the JAX drain bench's fleet (emqx_tpu/bench_live.py:975-977):
#: detached sessions on ``bench/<i % 97>/+``, live v5 clients, wave size.
#: The sessions are cut from the bench's 5,000 to hold the phase's
#: budget (printed): at 5,000 the drain took 40.8 s of phase 14's 105.1 s
#: on the card's host (PERF.md §4)
P14_DRAIN_BENCH_SESSIONS = 5000
P14_DRAIN_SESSIONS = 1000
P14_DRAIN_LIVE = 50
P14_DRAIN_WAVE = 200
P14_DRAIN_FILTERS = 97
#: 14c's live clients keep persistent v5 sessions and take QoS 1 on one
#: topic, published on bd1 while bd0 finalizes their hand-off (the
#: fleet's finalize runs first: the publisher waits until only the live
#: sessions are left); each resumes on bd1 after its redirect and must
#: get every message, a repeat only with DUP (fault C.9: such a publish
#: was queued twice or lost). Each publish pays a fan-out rebuild on
#: bd1, whose membership every finalize changes, so the count is small
#: (78 took the drain to 23.177 s on an H100 80GB HBM3 at 700 W); a
#: broker without the C.9 fix lost 18 and 28 of the 16 x 50 deliveries
#: in two CPU rehearsals (``scripts/rehearse_14c.py --root`` on such a
#: checkout)
P14_DRAIN_LIVE_TOPIC = "drain-live/t"
P14_DRAIN_LIVE_MSGS = 16
P14_DRAIN_LIVE_EVERY_S = 0.002
#: 14c's router threshold: the drain bench's 97 filters sit below the
#: JAX default device threshold (1,024 filters), where the router
#: matches on the host; at 0 the target's batch walks them with B1
#: (printed)
P14_DRAIN_DEVICE_MIN = 0
#: 14a/14b's ClusterConfig: the JAX failover bench's (bench.py:2524-2528)
#: with the drain bench's steadier detector (a 2 s ping deadline,
#: suspect after 4 misses, down after 8, printed). At the failover bench's
#: own (a 0.5 s deadline, suspect after 1, down after 3) two nodes of one
#: process flap during a 5,000-session failback: 12 false downs in one
#: chip run, and in another the post-failback resync never settled in
#: 120 s (PERF.md §6)
FAILOVER_BENCH = dict(
    heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
    suspect_after=4, down_after=8, ok_after=1,
    anti_entropy_interval_s=0.5, call_timeout_s=10.0,
    redial_backoff_s=0.1, redial_backoff_max_s=0.5)
#: the JAX drain bench's ClusterConfig (emqx_tpu/bench_live.py:976-979)
DRAIN_BENCH = dict(
    heartbeat_interval_s=0.2, heartbeat_timeout_s=2.0, suspect_after=4,
    down_after=100, ok_after=1, anti_entropy_interval_s=5.0)


def repl_node(name, device, opts, cfg, cookie, durability=None):
    """A port node on ``device`` with the retainer (recovered from its
    directory when durable), a SocketTransport on loopback and a
    ``Cluster`` (``cfg``)."""
    from emqx_tpu_torch.cluster import Cluster
    from emqx_tpu_torch.cluster_net import SocketTransport
    from emqx_tpu_torch.modules.retainer import RetainerModule
    from emqx_tpu_torch.node import Node

    node = Node(name=name, device=device, batch_size=opts.batch,
                durability=durability)
    node.modules.load(RetainerModule)
    if node.durability is not None:
        node.durability.recover()
    tr = SocketTransport(name, cookie=cookie, config=cfg)
    tr.serve()
    return node, tr, Cluster(node, transport=tr, config=cfg)


def adopted_batch(node, sessions, topics, seq0, label):
    """One batch of QoS 1 publishes through ``publish_begin/fetch/
    finish`` on ``node``, the launch counts at 0 just before it and read
    just after; every message's deliveries into ``sessions`` against a
    TrieOracle of their subscriptions (apart from the router's engine),
    and the router's filters equal to the model's. Returns the batch
    seconds, the launches and the deliveries."""
    from emqx_tpu_torch.ops import _build

    model = subscription_model(sessions)
    want = {f for f in model[0]} | {f for f in model[1]}
    held = set(node.router.route_table())
    if not want <= held:
        raise AssertionError(f"[{label}] {len(want - held)} of the "
                             f"sessions' filters have no route")
    _build.reset_launches()
    with SessionLog() as slog:
        lat, checks, _held, _l, _seq = drive_batches(
            node, sessions, [topics], seq0, label=label)
    launches = dict(_build.LAUNCHES)
    n = check_session_batches(model, checks, slog.log, label=label)
    return lat[0], launches, n


def p14_kernels(node, topics, index, bursts, card, label,
                what="the adopted tables"):
    """B1 and B2 on ``node``'s tables (the adopted filters) and B3 on its
    retained index (the adopted store) at the main path's inputs, each
    held against its plain twin, with device times; launches made here
    do not count."""
    import torch

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops.retained_match import match_names_cuda

    out = cluster_kernels(node, topics, card, label)
    if index is not None:
        saved = dict(_build.LAUNCHES)
        dev = index._device_arrays()
        flts = list(dict.fromkeys(f for f in bursts[0] if T.wildcard(f)))
        fw, fn, hh = (torch.from_numpy(a).to(dev[2].device)
                      for a in index._encode(flts))
        args = [fw, fn, hh, *dev[2:]]
        out["max_abs_err"] = max(out["max_abs_err"], check_retained(
            args, f"{label} {len(index._row_of)}-name index F={len(flts)}"))
        out["b3_ms"] = kernel_ms(lambda: match_names_cuda(*args),
                                 "retained_match_kernel")
        torch.cuda.synchronize()
        _build.LAUNCHES.update(saved)
    log(f"[{label}] on {what}: B1 {out['walk_ms']:.5f} ms, B2 "
        f"{out['or_ms']:.5f} ms over {out['big_rows']} bitmap rows"
        + (f", B3 {out['b3_ms']:.5f} ms" if "b3_ms" in out else "")
        + f", each equal to its plain twin — {card}")
    return out


def fleet_topics(n_sessions, batch, rng):
    """A batch of ``batch`` topics on the fleet's own filters
    (``fb/<i>/x``, one per session drawn without repeats while there are
    enough) and :data:`P14_WIDE_TOPICS` on the wide filter."""
    n_own = batch - P14_WIDE_TOPICS
    own = rng.permutation(n_sessions)[:n_own].tolist()
    own += rng.integers(0, n_sessions, size=n_own - len(own)).tolist()
    topics = [f"fb/{i}/x" for i in own]
    topics += [P14_WIDE.replace("+", f"w{k}") for k in
               range(P14_WIDE_TOPICS)]
    return [topics[i] for i in rng.permutation(len(topics))]


def repl_14ab(opts, device, card, tmp):
    """14a, failover, and 14b, failback (the plan of bench.py:2495-2660),
    on two port nodes on ``device``."""
    import os

    from emqx_tpu_torch.cluster import ClusterConfig
    from emqx_tpu_torch.durability import DurabilityConfig
    from emqx_tpu_torch.replication import durable_digest
    from emqx_tpu_torch.session import Session
    from emqx_tpu_torch.types import Message, SubOpts

    cfg = ClusterConfig(**FAILOVER_BENCH)
    d0 = os.path.join(tmp, "fb0")

    def dcfg():
        return DurabilityConfig(enabled=True, dir=d0, fsync=False,
                                standby="fb1", wal_shards=4)

    rng = np.random.default_rng(opts.seed + 14)
    n_sess = opts.p14_sessions
    out = {"launches": {}}

    def count(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    nodes, trs, cls = [], [], []
    try:
        for name, dur in (("fb0", dcfg()), ("fb1", None)):
            n, tr, cl = repl_node(name, device, opts, cfg, "p14-failover",
                                  dur)
            nodes.append(n)
            trs.append(tr)
            cls.append(cl)
        cls[1].join_remote("127.0.0.1", trs[0].port)
        n0, n1 = nodes
        t0 = time.perf_counter()
        sessions = []
        for i in range(n_sess):
            s = Session(f"fdev-{i}", broker=n0.broker, clean_start=False)
            n0.durability.session_opened(s, 3600.0)
            n0.cm.register_channel(s.client_id, HeldChannel(s))
            s.subscribe(f"fb/{i}/+", SubOpts(qos=1))
            s.subscribe(P14_WIDE, SubOpts(qos=1))
            sessions.append(s)
            if i % 1000 == 999:
                n0.durability.on_batch()
        subscribe_s = time.perf_counter() - t0
        store_s = store_retained(n0, P14_RETAINED)
        n0.durability.on_batch()  # flush + ship: this is the acked set
        r = n0.replication
        wait_for(lambda: r.state == "replicating"
                 and r.acked_seq >= r.offered_seq, 120, "14a journal sync")
        ship_s = time.perf_counter() - t0
        acked = r.acked_seq
        for s in sessions:  # the digest compares the sessions detached
            n0.cm._detached[s.client_id] = (s, 0, 3600.0)
        want = durable_digest(n0)
        # kill -9: no graceful path, no final ship
        n0.broker.durability = None
        n0.cm.durability = None
        t_kill = time.perf_counter()
        trs[0].close()
        rep1 = n1.replication
        wait_for(lambda: "fb0" in rep1.replicas
                 and rep1.replicas["fb0"].promoted, 60, "14a promotion")
        failover_s = time.perf_counter() - t_kill
        cls[0].close()
        rep = rep1.replicas["fb0"]
        rpo = max(0, acked - rep.applied_seq)
        got = durable_digest(n1)
        lp = rep1.last_promotion
        if rpo or got != want:
            raise AssertionError(f"[14a] rpo_records {rpo}, digest "
                                 f"{'equal' if got == want else 'differs'}")
        adopted = [n1.cm._detached[f"fdev-{i}"][0] for i in range(n_sess)]
        log(f"[14a] the failover bench's ClusterConfig with a 2 s ping "
            f"deadline, suspect after 4 misses and down after 8 (the "
            f"bench's 0.5 s / 1 / 3 flap two nodes of one process); "
            f"{n_sess} persistent sessions (fb/<i>/+ and {P14_WIDE} "
            f"each: {n_sess} subscribers on the wide filter), "
            f"{P14_RETAINED} retained messages (13b's store, not the "
            f"bench's 100): subscribed {subscribe_s:.2f} s, stored "
            f"{store_s:.2f} s, shipped and acked at {ship_s:.2f} s "
            f"({acked} records); fb0 killed: failover {failover_s:.3f} s, "
            f"promotion {lp['failover_s']:.3f} s ({lp['sessions']} "
            f"sessions, {lp['routes']} routes, {lp['retained']} retained), "
            f"rpo_records {rpo}, durable_digest equal to fb0's pre-kill "
            f"digest — {card}")
        topics = fleet_topics(n_sess, opts.batch, rng)
        lat, launches, n_del = adopted_batch(n1, adopted, topics, 0, "14a")
        count(launches)
        if launches["walk"] < 1 or launches["bitmap_or"] != 1:
            raise AssertionError(f"[14a] launches {launches}")
        index = n1.modules._loaded["retainer"]._index
        bursts = retained_bursts(P14_RETAINED, 1, P14_BURST, seed=14)
        family = NameFamily(P14_RETAINED)
        rr = asyncio.run(replay_bursts(n1, index, bursts, family,
                                       tag="p14r"))
        count({"retained_match": rr[5]["retained_match"]})
        check_host_scan(index, bursts, family)
        k = p14_kernels(n1, topics, index, bursts, card, "14a")
        # the burst's clean sessions leave: fb1 then holds only what it
        # adopted (the failback digest compares exactly that)
        for cid, ch in list(n1.cm._channels.items()):
            if cid.startswith("p14r"):
                ch._shutdown()
        log(f"[14a] on fb1: a batch of {len(topics)} publishes to the "
            f"adopted filters ({P14_WIDE_TOPICS} on {P14_WIDE}): "
            f"{lat * 1e3:.3f} ms, B1 {launches['walk']} and B2 "
            f"{launches['bitmap_or']} launches, {n_del} deliveries equal "
            f"the TrieOracle of the adopted sessions; a burst of "
            f"{P14_BURST} SUBSCRIBEs replays the adopted store through "
            f"{rr[5]['retained_match']} B3 launch, {rr[3]} messages, "
            f"{rr[0][0] * 1e3:.3f} ms, equal to the host scan — {card}")
        check_quiet(n1, "14a fb1")
        out["14a"] = {"failover_s": failover_s,
                      "promote_s": lp["failover_s"], "rpo_records": rpo,
                      "batch_ms": lat * 1e3, "replay_ms": rr[0][0] * 1e3,
                      **k}
        # -- 14b: failback --
        n1.broker.publish(Message(topic="fb/0/state", payload=b"post-promo",
                                  qos=1, flags={"retain": True}))
        want2 = durable_digest(n1)
        t_fb = time.perf_counter()
        n0b, tr0b, cl0b = repl_node("fb0", device, opts, cfg,
                                    "p14-failover", dcfg())
        nodes.append(n0b)
        trs.append(tr0b)
        cls.append(cl0b)
        recover_s = time.perf_counter() - t_fb
        cl0b.join_remote("127.0.0.1", trs[1].port)
        wait_for(lambda: not rep.promoted, 120, "14b failback demotion")
        r0 = n0b.replication

        def resynced():
            # the journal flush a started node's timer runs: records the
            # failback apply journaled must flush to ship
            n0b.durability.on_batch()
            return r0.state == "replicating" and r0.acked_seq >= r0.offered_seq

        wait_for(resynced, 120, "14b post-failback resync")
        failback_s = time.perf_counter() - t_fb
        wait_for(lambda: durable_digest(n0b) == want2, 60,
                 "14b failback digest", poll=0.25)
        digest_s = time.perf_counter() - t_fb
        fb = rep1.last_failback
        left = [f for f, dests in n1.router.route_table().items()
                if any(x == "fb1" or (isinstance(x, tuple) and x[1] == "fb1")
                       for x in dests)]
        if left:
            raise AssertionError(f"[14b] fb1 still holds {len(left)} "
                                 f"handed routes ({left[:3]})")
        handed = [n0b.cm._detached[f"fdev-{i}"][0] for i in range(n_sess)]
        topics = fleet_topics(n_sess, opts.batch, rng)
        lat2, launches2, n_del2 = adopted_batch(n0b, handed, topics,
                                                opts.batch, "14b")
        count(launches2)
        if launches2["walk"] < 1 or launches2["bitmap_or"] < 1:
            raise AssertionError(f"[14b] launches {launches2}")
        k2 = p14_kernels(n0b, topics, None, None, card, "14b")
        log(f"[14b] fb0 restarted from its directory (recovery "
            f"{recover_s:.2f} s) and rejoined: failback_s {failback_s:.3f} "
            f"(demoted and resynced), the hand-off {fb['failback_s']:.3f} s "
            f"({fb['sessions']} sessions, {fb['kept']} kept, "
            f"{fb['closed']} closed), durable_digest equal to fb1's "
            f"pre-failback digest at {digest_s:.3f} s; fb1 holds none of "
            f"the handed routes; a batch on fb0: {lat2 * 1e3:.3f} ms, B1 "
            f"{launches2['walk']} and B2 {launches2['bitmap_or']} launches, "
            f"{n_del2} deliveries to the handed-back sessions equal the "
            f"TrieOracle — {card}")
        check_quiet(n0b, "14b fb0")
        out["14b"] = {"failback_s": failback_s, "handoff_s": fb["failback_s"],
                      "recover_s": recover_s, "batch_ms": lat2 * 1e3, **k2}
        return out
    finally:
        for n in nodes:
            d = n.durability
            if d is not None and d.wal is not None:
                d.wal.close()
        close_cluster(trs, cls)


async def repl_14c(opts, device, card, tmp):
    """14c, the drain (emqx_tpu/bench_live.py:953-1063): two durable
    nodes on ``device``, each the other's standby (ack_quorum 1), a
    detached fleet and live v5 QoS 1 subscribers on bd0, a publisher on
    bd1, ``bd0.drain.start(target="bd1")``; the subscribers resume on
    bd1; then a batch on bd1 and bd0's redirecting stop."""
    import os

    from emqx_tpu_torch.cluster import ClusterConfig
    from emqx_tpu_torch.drain import DrainConfig
    from emqx_tpu_torch.durability import DurabilityConfig
    from emqx_tpu_torch.mqtt import reason_codes as RC
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.replication import sessions_digest
    from emqx_tpu_torch.router import MatcherConfig
    from emqx_tpu_torch.session import Session
    from emqx_tpu_torch.types import Message, SubOpts

    n_sess = opts.p14_drain_sessions
    ccfg = ClusterConfig(**DRAIN_BENCH)
    nodes = []
    for i in range(2):
        node = Node(
            name=f"bd{i}", device=device, batch_size=opts.batch,
            matcher=MatcherConfig(device_min_filters=P14_DRAIN_DEVICE_MIN),
            durability=DurabilityConfig(
                enabled=True, dir=os.path.join(tmp, f"bd{i}"), fsync=False,
                standbys=(f"bd{1 - i}",), ack_quorum=1,
                quorum_timeout_ms=500.0, repl_ack_timeout_s=5.0),
            drain=DrainConfig(wave_size=P14_DRAIN_WAVE, wave_interval_s=0.1,
                              handoff_timeout_s=60.0))
        node.add_listener(port=0)
        node.enable_cluster(port=0, cookie="p14-drain", config=ccfg)
        await node.start()
        nodes.append(node)
    n0, n1 = nodes
    clients = []
    try:
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, n1.cluster.join_remote,
                                   "127.0.0.1", n0.cluster.transport.port)
        cids = [f"bench-d{i}" for i in range(n_sess)]
        now = time.time()
        for i, cid in enumerate(cids):
            s = Session(cid, broker=n0.broker, clean_start=False)
            n0.durability.session_opened(s, 3600.0)
            s.subscribe(f"bench/{i % P14_DRAIN_FILTERS}/+", SubOpts(qos=1))
            n0.cm._detached[cid] = (s, now, 3600.0)
        # the registry in one batched call (5,000 casts would starve the
        # heartbeats), as the bench does
        with n0.cluster._lock:
            for cid in cids:
                n0.cluster._registry[cid] = "bd0"
        n0.cluster.transport.call("bd1", "registry_sync", "bd0", cids)
        n0.broker.publish(Message(topic="bench/13/x", payload=b"queued",
                                  qos=1))
        await loop.run_in_executor(None, n0.durability.on_batch)
        pre = sessions_digest(n0, cids)
        port0 = n0.listeners[0].port
        repeats = [0]

        def on_live(c):
            payload = bytes(c.got[-1][1])
            if payload not in c.seen:
                c.seen.add(payload)
            elif not c.dup:
                repeats[0] += 1

        for i in range(P14_DRAIN_LIVE):
            c = WireClient(f"bench-l{i}", 5, clean_start=False, expiry=3600)
            c.seen = set()
            c.on_publish = on_live
            await c.connect(port0)
            await p17_subscribe(c, 1, [P14_DRAIN_LIVE_TOPIC])
            c.redirect = c.expect("disconnect", 0)
            clients.append(c)
        published = []

        async def live_publisher():
            while len(published) < P14_DRAIN_LIVE_MSGS \
                    and n0.drain.time_to_empty_s is None:
                await asyncio.sleep(P14_DRAIN_LIVE_EVERY_S)
                # the finalize has begun (the bulk rounds are done) and
                # reached the live sessions
                if n0.drain.handoff_ok is None \
                        or len(n0.cm._detached) > P14_DRAIN_LIVE:
                    continue
                seq = len(published)
                n1.broker.publish(Message(topic=P14_DRAIN_LIVE_TOPIC,
                                          payload=str(seq).encode(), qos=1))
                published.append(seq)

        t0 = time.perf_counter()
        n0.drain.start(target="bd1")
        pub_task = asyncio.get_running_loop().create_task(live_publisher())
        late = WireClient("bench-late", 5)
        refused = await late.connect_once(port0)
        await late.closed
        late_ref = (refused.properties or {}).get("Server-Reference")
        if refused.reason_code != RC.USE_ANOTHER_SERVER or late_ref != "bd1":
            raise AssertionError(f"[14c] a CONNECT while draining got "
                                 f"{refused.reason_code:#x} ref {late_ref!r}")
        while n0.drain.time_to_empty_s is None:
            await asyncio.sleep(0.02)
            if time.perf_counter() - t0 > 120:
                raise AssertionError("[14c] the drain did not empty bd0 "
                                     "in 120 s")
        await pub_task
        info = n0.drain.info()
        codes = set()
        for c in clients:
            pkt = await asyncio.wait_for(c.redirect, 10)
            codes.add((pkt.reason_code,
                       (pkt.properties or {}).get("Server-Reference")))
        on_target = sum(1 for cid in cids if cid in n1.cm._detached)
        one_holder = not any(cid in n0.cm._detached for cid in cids)
        digest_ok = sessions_digest(n1, cids) == pre
        if (info["redirected"] != P14_DRAIN_LIVE
                or info["handed_off"] != n_sess + P14_DRAIN_LIVE
                or not info["handoff_ok"] or on_target != n_sess
                or not one_holder or not digest_ok
                or codes != {(RC.USE_ANOTHER_SERVER, "bd1")}):
            raise AssertionError(f"[14c] drain {info}, on target {on_target}, "
                                 f"one holder {one_holder}, digest "
                                 f"{digest_ok}, redirects {codes}")
        tte = info["time_to_empty_s"]
        # the redirected live clients resume on the target and must get
        # every message published there, each repeat flagged DUP. First
        # the target's resync of the adopted set to its standby (bd0),
        # which the final marker started, must land: both nodes share
        # this loop, so a CONNECT meanwhile waits on its cluster lock
        # for an answer bd0 sends only after that resync's apply, which
        # needs this same loop (until the call times out)
        r1 = n1.replication
        await until_async(
            lambda: r1.state == "replicating"
            and not any(p.need_hello for p in r1.peers.values()),
            60, "bd1's resync to bd0", "14c")
        port1 = n1.listeners[0].port
        resumed = 0
        for c in clients:
            # the redirect's close reaches a client whose PUBACKs the
            # broker left unread as a reset: it ends that connection,
            # nothing more
            await asyncio.wait([c._task])
            if not c._task.cancelled():
                c._task.exception()
            await c.connect(port1)
            resumed += bool(c.connack.session_present)
        n_pub = len(published)
        t_wait = time.perf_counter()
        while any(len(c.seen) < n_pub for c in clients) \
                and time.perf_counter() - t_wait < 60:
            await asyncio.sleep(0.02)
        lost = sum(n_pub - len(c.seen) for c in clients)
        log(f"[14c] {P14_DRAIN_LIVE} live v5 QoS 1 clients on "
            f"{P14_DRAIN_LIVE_TOPIC}, redirected and resumed on bd1 "
            f"({resumed} with their session): {n_pub} messages published "
            f"on bd1 while their hand-off's finalize ran; {lost} lost "
            f"— {card}")
        log(f"[14c] repeats without DUP: {repeats[0]}")
        if resumed != P14_DRAIN_LIVE or lost or repeats[0]:
            raise AssertionError(f"[14c] live clients: {resumed} resumed, "
                                 f"{lost} lost, {repeats[0]} repeats "
                                 f"without DUP")
        # a batch on the target: one topic a filter (each reaching its
        # ~52 handed sessions) among topics that match nothing
        handed = [n1.cm._detached[cid][0] for cid in cids]
        topics = [f"bench/{k}/x" for k in range(P14_DRAIN_FILTERS)]
        topics += [f"none/{j}/x" for j in range(opts.batch - len(topics))]
        lat, launches, n_del = adopted_batch(n1, handed, topics, 0, "14c")
        if launches["walk"] < 1 or n_del != n_sess:
            raise AssertionError(f"[14c] launches {launches}, {n_del} "
                                 f"deliveries for {n_sess} handed sessions")
        # bd0's stop with the target set is a redirect: 0x9C + the
        # Server-Reference to a v5 client connected after the drain
        n0.drain.stop()
        last = WireClient("bench-stop", 5)
        await last.connect(port0)
        bye = last.expect("disconnect", 0)
        await n0.stop()
        pkt = await asyncio.wait_for(bye, 10)
        stop_ref = (pkt.properties or {}).get("Server-Reference")
        if pkt.reason_code != RC.USE_ANOTHER_SERVER or stop_ref != "bd1":
            raise AssertionError(f"[14c] the stop sent {pkt.reason_code:#x} "
                                 f"ref {stop_ref!r}")
        log(f"[14c] drain of bd0 to bd1 ({n_sess} detached sessions on "
            f"{P14_DRAIN_FILTERS} filters, {P14_DRAIN_LIVE} live v5 clients, "
            f"waves of {P14_DRAIN_WAVE} every 0.1 s; device_min_filters "
            f"{P14_DRAIN_DEVICE_MIN}, not the default 1,024, so the "
            f"{P14_DRAIN_FILTERS} filters take B1): time-to-empty "
            f"{tte:.3f} s, {info['handed_off'] / max(tte, 1e-9):.1f} "
            f"sessions/s, wave p99 {info['wave_p99_ms']} ms over "
            f"{info['waves']} waves, redirected {info['redirected']} (0x9C, "
            f"Server-Reference bd1), handed off {info['handed_off']}, digest "
            f"equal, one holder; a CONNECT meanwhile got 0x9C ref {late_ref}; "
            f"a batch on bd1: {lat * 1e3:.3f} ms, B1 {launches['walk']} "
            f"launches, {n_del} deliveries equal the TrieOracle of the "
            f"handed sessions; bd0's stop sent 0x9C ref {stop_ref} — {card}")
        check_quiet(n1, "14c bd1")
        return {"time_to_empty_s": tte, "wave_p99_ms": info["wave_p99_ms"],
                "sessions_per_s": info["handed_off"] / max(tte, 1e-9),
                "batch_ms": lat * 1e3, "launches": launches,
                "live_msgs": n_pub, "live_repeats_without_dup": repeats[0]}
    finally:
        for c in clients:
            try:
                c.writer.close()
            except Exception:
                pass
        for node in nodes:
            try:
                await node.stop()
            except Exception:
                pass


def run_repl(opts, device, card):
    """Phase 14 (see the module docstring); returns its numbers and the
    launches of its driven paths (each counted from 0)."""
    import os
    import shutil
    import tempfile

    t_start = time.perf_counter()
    log(f"[14] P14_BUDGET_S {P14_BUDGET_S:.0f} s; two port nodes on {device} "
        f"over SocketTransport on loopback: failover and failback at "
        f"{opts.p14_sessions} sessions, the drain at "
        f"{opts.p14_drain_sessions} (cut from the drain bench's "
        f"{P14_DRAIN_BENCH_SESSIONS} to hold the budget) — {card}")
    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(here, "chip_durability")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="p14-", dir=base)
    try:
        ab = timed("14a-14b (failover, failback)", repl_14ab, opts, device,
                   card, tmp)
        gc.collect()
        c = timed("14c (drain)", asyncio.run,
                  repl_14c(opts, device, card, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(ab["launches"])
    for k, v in c["launches"].items():
        launches[k] = launches.get(k, 0) + v
    took = time.perf_counter() - t_start
    log(f"[14] phase 14 took {took:.1f} s of its {P14_BUDGET_S:.0f} s "
        f"budget; launches {launches} — {card}")
    return {"14a": ab["14a"], "14b": ab["14b"], "14c": c,
            "launches": launches, "seconds": took}


# -- phase 15: the access plane and the built-in modules ---------------------

P15_BUDGET_S = 45.0
#: 15a: phase 5's batches published under the rewrite rule's prefix, the
#: literal topics of batch 0 that topic_metrics counts, and the delayed
#: messages (``$delayed/1/<topic>``, each republished alone)
P15_BATCHES = 3
P15_PREFIX = "mod/"
P15_REWRITE = ("pub", "mod/#", r"^mod/(.+)$", r"$1")
P15_METERED = 64
P15_DELAYED = 256
#: 15b: the retained names its wildcard SUBSCRIBEs replay through B3, a
#: loopback source address the default ACL rules treat as non-local, the
#: subscription module's template and the replayed filters
P15_RETAINED = P13_RETAINED
P15_NONLOCAL = "127.0.0.2"
P15_AUTOSUB = ("p15/%c/inbox", 1)
P15_REPLAY = ("s7/#", "s11/+/+/state")


def oracle_count(broker, oracle, topic: str) -> int:
    """The deliveries the oracle gives ``topic``: every local subscriber
    of every matched filter, one member per shared group."""
    n = 0
    for f in oracle.match(topic):
        n += len(broker.subscribers(f))
        n += sum(1 for r in broker.router.lookup_routes(f)
                 if isinstance(r.dest, tuple))
    return n


def modules_15a(node, batches, draw, card, oracle, tm, metered):
    """15a: phase 5's batches under the rewrite prefix through the
    node's modules (every count at 0 at the start), topic_metrics
    against the oracle, then the delayed path, one batch a message."""
    from collections import Counter

    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.types import Message

    broker = node.broker
    sent = [[P15_PREFIX + t for t in b] for b in batches[:P15_BATCHES]]
    # phase 5 published these batches on this node: a cold match cache
    # (the router builds a new one at the next dispatch), so 15a walks
    # them as phase 5 first did
    broker.router._match_cache_obj = None
    sl = phase_slice(broker, sent, card, oracle, label="15a")
    count = Counter(t for b in batches[:P15_BATCHES] for t in b)
    for t in metered:
        m = tm.metrics(t)
        want = (count[t], count[t] * oracle_count(broker, oracle, t))
        if (m["messages.in"], m["messages.out"]) != want:
            raise AssertionError(f"[15a] topic_metrics of {t!r}: in/out "
                                 f"{m['messages.in']}/{m['messages.out']}, "
                                 f"the oracle {want}")
    n_in = sum(tm.metrics(t)["messages.in"] for t in metered)
    n_out = sum(tm.metrics(t)["messages.out"] for t in metered)
    log(f"[15a] topic_metrics: {len(metered)} topics of batch 0, "
        f"messages.in {n_in}, messages.out {n_out}, each equal to the "
        f"oracle's — {card}")
    # the delayed path: distinct topics no batch sent, held, then each
    # republished alone by the tick
    dm = node.modules._loaded["delayed"]
    fresh = zipf_topics(np.random.default_rng(15), draw, 8 * P15_DELAYED)
    seen = set(count)
    topics = [t for t in dict.fromkeys(fresh) if t not in seen]
    topics = topics[:P15_DELAYED]
    if len(topics) < P15_DELAYED:
        raise AssertionError(f"[15a] {len(topics)} fresh topics drawn")
    d0 = node.metrics.val("messages.delayed")
    Sink.log = []
    held = broker.publish_batch([
        Message(topic=f"$delayed/1/{t}", payload=b"d%d" % i)
        for i, t in enumerate(topics)])
    if any(held) or Sink.log or len(dm) != P15_DELAYED \
            or node.metrics.val("messages.delayed") - d0 != P15_DELAYED:
        raise AssertionError(f"[15a] $delayed: results {sum(held)}, "
                             f"{len(Sink.log)} deliveries, {len(dm)} held, "
                             f"messages.delayed "
                             f"{node.metrics.val('messages.delayed') - d0}")
    # the tick republishes each topic alone: with a cold match cache
    # none is served from it, so each walks once
    broker.router._match_cache_obj = None
    import threading

    from emqx_tpu_torch.ops import delta as delta_ops

    done, per_msg, side, inner, frames = [], [], [0], [], []
    orig = broker.publish
    side_walk = delta_ops.match_batch_auto

    def walks():
        return np.array([tl.main().get("walk", 0), side[0]])

    def publish(msg):
        # one frame a publish; a publish made inside another (the
        # telemetry's slow_publish alarm's $SYS message at a batch's
        # close) is counted apart from the delayed message's own
        frames.append(np.zeros(2, np.int64))
        before = walks()
        try:
            res = orig(msg)
        finally:
            child = frames.pop()
        n = walks() - before
        if frames:
            frames[-1] += n
            inner.append((msg, res, n))
        else:
            done.append((msg, res))
            per_msg.append(n - child)
        return res

    def counted_side_walk(*a, **k):
        # B1 on the delta's side automaton (pending adds), apart from
        # the main automaton's one launch a message
        if threading.current_thread() is threading.main_thread():
            side[0] += 1
        return side_walk(*a, **k)

    broker.publish = publish
    delta_ops.match_batch_auto = counted_side_walk
    # the tick's own launches, on this thread (a background compaction
    # re-warms the kernels on its own thread)
    _build.reset_launches()
    saved = _build.LAUNCHES
    tl = _build.LAUNCHES = ThreadLaunches(saved)
    try:
        t0 = time.perf_counter()
        ticked = dm.tick(now=time.time() + 2)
        tick_s = time.perf_counter() - t0
    finally:
        del broker.publish
        delta_ops.match_batch_auto = side_walk
        _build.LAUNCHES = saved
        saved.update(tl)
    launches = tl.main()
    others = {t: d for t, d in tl.by_thread.items()
              if t != "MainThread" and any(d.values())}
    deliveries, Sink.log = Sink.log, None
    own = np.array(per_msg)
    main_walks = own[:, 0] - own[:, 1]
    if ticked != P15_DELAYED or len(dm) or len(done) != P15_DELAYED \
            or (main_walks != 1).any():
        raise AssertionError(f"[15a] the tick republished {ticked}, left "
                             f"{len(dm)}, B1 launches "
                             f"{launches.get('walk', 0)} (on the main "
                             f"automaton a message: {sorted(set(main_walks.tolist()))}; "
                             f"{side[0]} on the delta's side automaton; "
                             f"{len(inner)} publishes inside them; other "
                             f"threads {others})")
    done += [(m, r) for m, r, _n in inner]
    check_batches(broker, [([m for m, _r in done], [r for _m, r in done])],
                  deliveries, oracle)
    log(f"[15a] $delayed/1/<topic>: {P15_DELAYED} held (messages.delayed "
        f"+{P15_DELAYED}, nothing delivered), tick(now + 2) republished "
        f"them one batch a message in {tick_s * 1e3:.3f} ms, "
        f"{tick_s * 1e3 / P15_DELAYED:.3f} ms a message; "
        f"{len(deliveries)} deliveries equal the TrieOracle's; launches "
        f"{launches} (B1 once a message on the main automaton, "
        f"{int(own[:, 1].sum())} on the delta's side automaton; "
        f"{len(inner)} publishes inside them, the telemetry alarm's), on "
        f"other threads {others} — {card}")
    return {"slice": sl, "delayed_launches": launches,
            "delayed_ms_per_msg": tick_s * 1e3 / P15_DELAYED,
            "metered_in": n_in, "metered_out": n_out}


async def until_async(cond, timeout: float, what: str,
                      label: str = "15b") -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"[{label}] {what} not reached in "
                                 f"{timeout} s")
        await asyncio.sleep(0.002)


async def access_15b(node, card):
    """15b: a listener on ``node`` with flapping detection on; a banned
    client, a flapping client, a drained one, the default ACL rules for
    a non-local client, a wildcard replay through B3 and a presence
    publish, every count at 0 once the retained names are stored."""
    from emqx_tpu_torch.connection import Listener
    from emqx_tpu_torch.modules.subscription import SubscriptionModule
    from emqx_tpu_torch.mqtt import reason_codes as RC
    from emqx_tpu_torch.mqtt.packet import Subscribe
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.zone import Zone

    zone = Zone(name="p15", enable_flapping_detect=True)
    fcfg = node.flapping.config
    store_s = store_retained(node, P15_RETAINED)
    ret = node.modules._loaded["retainer"]
    if len(ret._index) != P15_RETAINED:
        raise AssertionError(f"[15b] {len(ret._index)} names indexed")
    lst = Listener(node.broker, node.cm, port=0, zone=zone, name="tcp:p15",
                   device=node.device, frame=node.frame)
    await lst.start()
    clients = []

    def client(cid, version, local_host=None):
        c = WireClient(cid, version, local_host)
        clients.append(c)
        return c

    steps = {}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = round(now - t_step[0], 3)
        t_step[0] = now

    _build.reset_launches()
    try:
        watch = client("p15-watch", 5)
        await watch.connect(lst.port)
        presence = f"$SYS/brokers/{node.name}/clients/+/connected"
        fut = watch.expect("suback", 1)
        watch.send(Subscribe(packet_id=1,
                             topic_filters=[(presence, {"qos": 0})]))
        if (await fut).reason_codes != [0]:
            raise AssertionError("[15b] the presence SUBSCRIBE was refused")
        step("watcher")
        # a client banned by clientid
        node.banned.create("clientid", "p15-banned", by="chip_smoke",
                           reason="15b")
        ack = await client("p15-banned", 5).connect_once(lst.port)
        if ack.reason_code != RC.BANNED:
            raise AssertionError(f"[15b] banned CONNACK {ack.reason_code}")
        step("banned")
        # a client that closes max_count times is auto-banned
        cid = "p15-flap"
        cycles = []
        for i in range(fcfg.max_count):
            t0 = time.perf_counter()
            c = client(cid, 4)
            await c.connect(lst.port)
            await c.close()

            def counted(n=i + 1):
                t = node.flapping._tracks.get(cid)
                if n == fcfg.max_count:
                    return node.banned.look_up("clientid", cid) is not None
                return t is not None and t.count >= n

            await until_async(counted, 30.0, f"disconnect {i + 1} counted")
            cycles.append(time.perf_counter() - t0)
            track = node.flapping._tracks.get(cid)
            if i + 1 < fcfg.max_count and track.count != i + 1:
                raise AssertionError(
                    f"[15b] disconnect {i + 1} counted as {track.count}; "
                    f"cycles {[round(x, 3) for x in cycles]} s")
        rule = node.banned.look_up("clientid", cid)
        if rule is None or rule.by != "flapping":
            raise AssertionError(f"[15b] no flapping ban: {rule}")
        ack = await client(cid, 5).connect_once(lst.port)
        if ack.reason_code != RC.BANNED:
            raise AssertionError(f"[15b] flapper's CONNACK {ack.reason_code}")
        step("flapping")
        # the drain's reason is not counted
        cid = "p15-drained"
        c = client(cid, 4)
        await c.connect(lst.port)
        node.cm.lookup_channel(cid).drain_redirect(None)
        await c.closed
        await until_async(lambda: node.cm.lookup_channel(cid) is None, 5.0,
                          "the drained channel's close")
        if cid in node.flapping._tracks or node.banned.check(clientid=cid):
            raise AssertionError("[15b] a drained disconnect was counted")
        step("drained")
        # auto-subscribe loads only now: with it, every connect and clean
        # disconnect is a fan-out membership change, and the next
        # publish (a presence event) rebuilds the fan-out tables, 2.6 s
        # at 1.03M filters, so the default 15 cycles would outlast the
        # 60 s window (PERF.md §6)
        node.modules.load(SubscriptionModule, {"topics": [P15_AUTOSUB]})
        # a non-local client under DEFAULT_RULES: $SYS/# denied, the
        # wildcard filters replay through B3
        b3 = _build.LAUNCHES["retained_match"]
        c = client("p15-acl", 5, local_host=P15_NONLOCAL)
        await c.connect(lst.port)
        fut = c.expect("suback", 1)
        c.send(Subscribe(packet_id=1, topic_filters=[
            ("$SYS/#", {"qos": 0})] + [(f, {"qos": 0}) for f in P15_REPLAY]))
        suback = (await fut).reason_codes
        if suback != [RC.NOT_AUTHORIZED] + [0] * len(P15_REPLAY):
            raise AssertionError(f"[15b] SUBACK {suback}")
        step("acl")
        family = NameFamily(P15_RETAINED)
        want = sorted(retained_name(int(i)) for f in P15_REPLAY
                      for i in family.match(f))
        await until_async(lambda: len(c.got) >= len(want), 10.0,
                          f"{len(want)} replayed messages")
        got = sorted(t for t, _p, _r, _a in c.got)
        b3 = _build.LAUNCHES["retained_match"] - b3
        if got != want or not all(r for _t, _p, r, _a in c.got) or b3 < 1:
            raise AssertionError(f"[15b] replayed {len(got)} of "
                                 f"{len(want)}, B3 launches {b3}")
        step("replay")
        sess = node.cm.lookup_channel("p15-acl").session
        auto = P15_AUTOSUB[0].replace("%c", "p15-acl")
        if auto not in sess.subscriptions:
            raise AssertionError(f"[15b] no auto-subscription {auto}")
        await until_async(
            lambda: any(t.endswith("/p15-acl/connected")
                        for t, *_x in watch.got), 5.0, "the presence event")
        body = next(json.loads(bytes(p)) for t, p, *_x in watch.got
                    if t.endswith("/p15-acl/connected"))
        if body["clientid"] != "p15-acl" or \
                body["ipaddress"] != P15_NONLOCAL:
            raise AssertionError(f"[15b] presence payload {body}")
        step("presence")
    finally:
        for c in clients:
            if c.closed is not None and not c.closed.done():
                await c.close()
        await lst.stop()
    launches = dict(_build.LAUNCHES)
    log(f"[15b] a listener with enable_flapping_detect: {P15_RETAINED} "
        f"retained names stored in {store_s:.2f} s; a banned clientid got "
        f"CONNACK 0x{RC.BANNED:02X}; {fcfg.max_count} connect-close cycles "
        f"(window {fcfg.window:.0f} s) took {sum(cycles):.3f} s (the "
        f"slowest {max(cycles):.3f} s) and auto-banned p15-flap (by "
        f"flapping, {fcfg.ban_time:.0f} s); its next CONNECT got "
        f"0x{RC.BANNED:02X}; "
        f"a drained client was not counted; the non-local client "
        f"({P15_NONLOCAL}) under DEFAULT_RULES got SUBACK {suback}, "
        f"{len(got)} retained messages replayed through B3 ({b3} "
        f"launches), equal to the host match, auto-subscribed to {auto}; "
        f"{sum(1 for t, *_x in watch.got if t.endswith('/connected'))} "
        f"presence events on {presence}, keys {sorted(body)}; seconds a "
        f"step {steps}; launches {launches} — {card}")
    return {"launches": launches, "index": ret._index, "steps": steps,
            "flap_cycles_s": cycles}


def run_modules(node, batches, draw, card, oracle, p5):
    """Phase 15a-15b on phase 5's node (see the module docstring);
    returns its numbers and launches."""
    from emqx_tpu_torch.modules.presence import PresenceModule
    from emqx_tpu_torch.modules.rewrite import RewriteModule
    from emqx_tpu_torch.modules.topic_metrics import TopicMetricsModule

    t_start = time.perf_counter()
    quiet = breaker_mark(node)
    node.load_default_modules()
    node.modules.load(RewriteModule, {"rules": [P15_REWRITE]})
    metered = list(dict.fromkeys(batches[0]))[:P15_METERED]
    tm = node.modules.load(TopicMetricsModule, {"topics": metered})
    node.modules.load(PresenceModule)
    log(f"[15] P15_BUDGET_S {P15_BUDGET_S:.0f} s; modules loaded on phase "
        f"5's node ({len(node.router._filter_ids)} filters): "
        f"{node.modules.loaded()} (subscription in 15b); rewrite "
        f"{P15_REWRITE}; "
        f"{P15_BATCHES} of phase 5's {len(batches)} batches (cut to hold "
        f"the budget) — {card}")
    a = modules_15a(node, batches, draw, card, oracle, tm, metered)
    sl = a["slice"]
    log(f"[15a] with the modules' hooks: {sl['msgs_per_s']:.1f} msgs/s, p50 "
        f"{sl['p50_ms']:.3f} ms, p99 {sl['p99_ms']:.3f} ms over "
        f"{P15_BATCHES} batches; phase 5 on the same node "
        f"{p5['msgs_per_s']:.1f} msgs/s, p50 {p5['p50_ms']:.3f} ms, p99 "
        f"{p5['p99_ms']:.3f} ms over {len(batches)} — {card}")
    b = asyncio.run(access_15b(node, card))
    k = p14_kernels(node, batches[0], b["index"], [P15_REPLAY], card, "15",
                    what="phase 5's node with the modules loaded")
    check_quiet(node, "15", b["index"], since=quiet)
    took = time.perf_counter() - t_start
    log(f"[15] phase 15a-15b took {took:.1f} s of its {P15_BUDGET_S:.0f} s "
        f"budget — {card}")
    return {"15a": a, "15b": b, "kernels": k, "seconds": took}


# -- phase 16: the operations surface and the secure front door --------------

P16_BUDGET_S = 40.0
#: 16b: connections a listener (half subscribers at QoS 1 on one
#: config-2 '+' filter and one big literal filter, half publishers of
#: P16_PUBS QoS 1 PUBLISHes each: 7a's shape on each transport)
P16_CONNS = 100
P16_PUBS = 5
#: 16a: the topics match_routes runs on, the module-level API's
#: filters (past device_min_filters, so the device path serves) and
#: publishes
P16_MATCH_ROUTES = 1000
P16_API_FILTERS = 4096
P16_API_PUBLISHES = 64
#: 16b: a retained SUBSCRIBE a secure listener, over 15b's stored names
P16_REPLAY = {"ssl:p16": "s3/#", "wss:p16": "s5/+/+/state",
              "psk:p16": "s9/+/+/state"}
#: the test-only certificates the repository carries
P16_CERTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "emqx_tpu_torch", "etc", "certs")


class OpsPlugin:
    """The plugin 16a discovers from the spec ``chip_smoke:OpsPlugin``:
    records the env it was loaded with."""

    name = "p16_ops"
    env = None

    def load(self, node, env):
        OpsPlugin.env = dict(env)

    def unload(self, node):
        OpsPlugin.env = None


class WsPipe:
    """One WebSocket client's MQTT byte stream over ``(reader,
    writer)``: ``write`` sends masked binary frames, ``read`` returns the
    payloads of the server's binary frames (``b""`` at a CLOSE or EOF).
    Stands in for both streams of a :class:`WireClient`."""

    def __init__(self, reader, writer) -> None:
        self.r, self.w = reader, writer
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        mask = os.urandom(4)
        n = len(data)
        head = bytearray([0x82])
        if n < 126:
            head.append(0x80 | n)
        elif n < 65536:
            head.append(0x80 | 126)
            head += n.to_bytes(2, "big")
        else:
            head.append(0x80 | 127)
            head += n.to_bytes(8, "big")
        full = (mask * (n // 4 + 1))[:n]
        body = (int.from_bytes(data, "big") ^ int.from_bytes(full, "big")
                ).to_bytes(n, "big") if n else b""
        self.w.write(bytes(head) + mask + body)

    async def read(self, _n: int) -> bytes:
        out = bytearray()
        while not out:
            buf = self.buf
            while len(buf) >= 2:
                op, n, pos = buf[0] & 0x0F, buf[1] & 0x7F, 2
                if n == 126:
                    if len(buf) < 4:
                        break
                    n, pos = int.from_bytes(buf[2:4], "big"), 4
                elif n == 127:
                    if len(buf) < 10:
                        break
                    n, pos = int.from_bytes(buf[2:10], "big"), 10
                if len(buf) < pos + n:
                    break
                payload = bytes(buf[pos:pos + n])
                del buf[:pos + n]
                if op == 0x8:
                    return bytes(out)
                if op == 0x2:
                    out += payload
            if out:
                break
            data = await self.r.read(1 << 16)
            if not data:
                return bytes(out)
            self.buf += data
        return bytes(out)

    def close(self) -> None:
        self.w.close()


async def ws_open(port: int, ssl_ctx=None):
    """The WebSocket upgrade on ``/mqtt`` with the ``mqtt`` subprotocol;
    returns the :class:`WsPipe` twice (reader and writer)."""
    import base64

    reader, writer = await asyncio.open_connection("127.0.0.1", port,
                                                   ssl=ssl_ctx)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET /mqtt HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                  "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n"
                  "Sec-WebSocket-Protocol: mqtt\r\n\r\n").encode())
    head = await reader.readuntil(b"\r\n\r\n")
    if b" 101 " not in head.split(b"\r\n")[0]:
        raise ConnectionError(f"WS upgrade refused: {head[:40]!r}")
    pipe = WsPipe(reader, writer)
    return pipe, pipe


def launches_now():
    from emqx_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def run_counted(fn, *args):
    """``fn(*args)`` with every launch counter at 0 just before;
    returns its result and the launches it made."""
    from emqx_tpu_torch.ops import _build

    _build.reset_launches()
    out = fn(*args)
    return out, launches_now()


def add_launches(total, more):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def ops_ctl(node, card):
    """16a: every ported ``ctl`` command on the node, each checked
    against the node's own state where the contract names one; returns
    the commands' seconds."""
    import torch

    ctl = node.ctl
    secs = {}
    outs = {}
    names = sorted(ctl._commands)
    if "reload" not in names:
        # without a file it prints its usage here; 17a reloads a file
        raise AssertionError("[16a] the port lacks ctl reload")
    runs = [[c] for c in names if c != "profile"] + [
        ["profile"], ["profile", "loops"],
        ["clients", "list"], ["banned", "list"], ["telemetry", "slow"],
        ["drain", "status"], ["trace", "list"], ["log", "show"]]
    for argv in runs:
        t0 = time.perf_counter()
        out = ctl.run(argv)
        secs[" ".join(argv)] = round(time.perf_counter() - t0, 3)
        outs[" ".join(argv)] = out
        if out.startswith("error:") or out.startswith("unknown command"):
            raise AssertionError(f"[16a] ctl {argv}: {out[:200]}")
    router = node.router
    topics = router.topics()
    status = dict(line.split(": ", 1) for line in outs["status"].splitlines())
    if int(status["topics"]) != len(topics):
        raise AssertionError(f"[16a] status topics {status['topics']}, the "
                             f"router {len(topics)}")
    n_routes = sum(len(d) for d in router._routes.values())
    lines = outs["routes"].count("\n") + 1
    if lines != n_routes:
        raise AssertionError(f"[16a] routes: {lines} lines, {n_routes} "
                             f"routes")
    if outs["topics"].count("\n") + 1 != len(topics):
        raise AssertionError("[16a] topics: a line a topic")
    lst = json.loads(outs["listeners"])
    if [d["name"] for d in lst] != [x.name for x in node.listeners] or \
            [d["current_connections"] for d in lst] != \
            [x.current_connections() for x in node.listeners]:
        raise AssertionError(f"[16a] listeners {lst}")
    cache = json.loads(outs["cache"])
    if "hit_rate" not in cache.get("single", {}):
        raise AssertionError(f"[16a] cache: no hit rate: {sorted(cache)}")
    ret = node.modules._loaded["retainer"]
    rinfo = json.loads(outs["retained"])
    if rinfo["index"]["epoch"] != ret._index._epoch or \
            rinfo["store"] != len(ret._store):
        raise AssertionError(f"[16a] retained {rinfo['index']}")
    vm = json.loads(outs["vm"])
    dev = vm["devices"][0]
    total = torch.cuda.get_device_properties(0).total_memory
    if dev["kind"] != torch.cuda.get_device_name(0) or \
            dev["bytes_limit"] != total or dev["platform"] != "gpu":
        raise AssertionError(f"[16a] vm devices {vm['devices']}")
    log(f"[16a] ctl: {len(runs)} runs of {len(names)} commands (reload "
        f"without a file, its usage; 17a reloads files): status topics "
        f"{len(topics)} = the router's; routes {lines} lines = "
        f"{n_routes} routes; listeners {len(lst)} entries with their "
        f"connections; cache hit rate {cache['single']['hit_rate']}; "
        f"retained epoch {rinfo['index']['epoch']}, {rinfo['store']} "
        f"stored; vm {dev['kind']}, bytes_limit {dev['bytes_limit']} = "
        f"total_memory, bytes_in_use {dev['bytes_in_use']}; the slowest "
        f"{sorted(secs.items(), key=lambda kv: -kv[1])[:3]} s — {card}")
    return secs


#: 16a's profiled batch runs inside this ``record_function`` range: the
#: trace's kernel launches made within it (the host-side launch events
#: of the CUDA APIs, joined to their kernel events by correlation id)
#: are the batch's
P16_TRACE_RANGE = "chip_smoke.16a.batch"


def range_kernels(events, name):
    """In a Chrome trace's ``events``, the kernels launched inside the
    ``record_function`` range ``name``: per key of
    :data:`PUBLISH_KERNELS`, the kernel events whose correlation id is
    that of a host-side launch event within the range's span
    (the kernels' own timestamps may lie milliseconds off their
    launches'). Returns those counts, the launch events in the span and
    how many of them have no kernel event."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == name]
    if len(spans) != 1:
        raise AssertionError(f"{len(spans)} ranges {name} in the trace")
    lo = spans[0]["ts"]
    hi = lo + spans[0]["dur"]
    launch = {e["args"]["correlation"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "LaunchKernel" in e.get("name", "")
              and lo <= e["ts"] <= hi and "correlation" in e.get("args", {})}
    found = {k: 0 for k in PUBLISH_KERNELS}
    kept = set()
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") != "kernel" or c not in launch:
            continue
        kept.add(c)
        for k in PUBLISH_KERNELS:
            if f"{k}_kernel" in e.get("name", ""):
                found[k] += 1
    return found, len(launch), len(launch) - len(kept)


def ops_profile(node, batch, tmp, card):
    """16a: ``profile start <dir>``, one of phase 5's batches, ``profile
    stop``: the Chrome trace holds the batch's B1 and B2 launches, told
    from the rest by the range :data:`P16_TRACE_RANGE` around the batch.
    The window opens with :func:`flush_trace` (torch.profiler drops a
    window's first kernel records; see :data:`TRACE_FLUSH`), and up to
    :data:`TRACE_WINDOWS` windows are traced until one holds every
    launch; each window's batch is counted."""
    import torch
    from torch.profiler import record_function

    from emqx_tpu_torch.types import Message

    total = {}
    seen = []
    for window in range(TRACE_WINDOWS):
        d = os.path.join(tmp, f"profile{window}")
        started = node.ctl.run(["profile", "start", d])
        if not started.startswith("tracing to"):
            raise AssertionError(f"[16a] profile start: {started}")
        flush_trace()
        node.router._match_cache_obj = None  # the batch walks, as 5's
        t0 = time.perf_counter()
        with record_function(P16_TRACE_RANGE):
            res, launches = run_counted(node.broker.publish_batch,
                                        [Message(topic=t) for t in batch])
            torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        stopped = node.ctl.run(["profile", "stop"])
        path = os.path.join(d, "trace.json")
        if stopped != f"trace written to {path}":
            raise AssertionError(f"[16a] profile stop: {stopped}")
        add_launches(total, launches)
        events = json.load(open(path))["traceEvents"]
        traced, n_launch, lost = range_kernels(events, P16_TRACE_RANGE)
        want = {k: launches[k] for k in PUBLISH_KERNELS}
        flushed = sum(1 for e in events if e.get("cat") == "kernel"
                      and FLUSH_KERNEL in e.get("name", ""))
        seen.append({**traced, "launch_events": n_launch, "lost": lost,
                     "flush_dropped": TRACE_FLUSH - flushed})
        if min(want.values()) < 1:
            raise AssertionError(f"[16a] the profiled batch launched "
                                 f"{want}")
        if all(traced[k] >= want[k] for k in PUBLISH_KERNELS):
            break
    else:
        raise AssertionError(f"[16a] no trace of {TRACE_WINDOWS} held the "
                             f"batch's launches: {seen}, the counters "
                             f"{want}")
    log(f"[16a] profile start/stop around one batch of {len(batch)} "
        f"({sum(res)} deliveries, {batch_ms:.3f} ms under the profiler): "
        f"{os.path.getsize(path)} bytes of Chrome trace, {len(events)} "
        f"events; the batch's kernel launches in it {traced}, the "
        f"counters {want}; windows traced {len(seen)} ({seen}) — {card}")
    return total


def ops_match_routes(node, topics, oracle, card):
    """16a: ``Router.match_routes`` on distinct topics, a cold match
    cache: B1 once a topic, every route the oracle's."""
    router = node.router
    router._match_cache_obj = None
    t0 = time.perf_counter()

    def run():
        return [router.match_routes(t) for t in topics]

    got, launches = run_counted(run)
    secs = time.perf_counter() - t0
    for t, routes in zip(topics, got):
        want = sorted((f, str(r.dest)) for f in oracle.match(t)
                      for r in router.lookup_routes(f))
        if sorted((r.topic, str(r.dest)) for r in routes) != want:
            raise AssertionError(f"[16a] match_routes({t!r}) differs from "
                                 f"the oracle's")
    if launches["walk"] < len(topics):
        raise AssertionError(f"[16a] match_routes: {launches['walk']} B1 "
                             f"launches for {len(topics)} topics")
    n = sum(len(r) for r in got)
    log(f"[16a] match_routes on {len(topics)} of phase 5's topics: {n} "
        f"routes, each topic's equal to the TrieOracle's; {secs:.3f} s, "
        f"{secs * 1e3 / len(topics):.3f} ms a call; launches "
        f"{ {k: launches[k] for k in PUBLISH_KERNELS} } — {card}")
    return launches


def ops_module_api(device, card):
    """16a: the module-level API on the process-default broker (built
    on the card): subscribe past device_min_filters, then publishes,
    each count the oracle's, B1 on each."""
    import emqx_tpu_torch
    from emqx_tpu_torch.oracle import TrieOracle
    from emqx_tpu_torch.types import Message

    saved = emqx_tpu_torch._default_broker
    emqx_tpu_torch._default_broker = None
    try:
        b = emqx_tpu_torch.default_broker()
        if b.device.type != device.type:
            raise AssertionError(f"[16a] default broker on {b.device}")
        from collections import Counter

        oracle = TrieOracle()
        members = Counter()
        rng = np.random.default_rng(16)
        k = int(np.sqrt(P16_API_FILTERS)) * 2
        t0 = time.perf_counter()
        for i in range(P16_API_FILTERS):
            a, c = int(rng.integers(k)), int(rng.integers(k))
            f = (f"api/{a}/+/{c}", f"api/+/{a}/{c}", f"api/{a}/{c}/#")[i % 3]
            oracle.insert(f)
            members[f] += 1
            emqx_tpu_torch.subscribe(Sink(i), f)
        sub_s = time.perf_counter() - t0
        if not b.router.use_device_now():
            raise AssertionError("[16a] the default broker is below its "
                                 "device threshold")
        topics = list(dict.fromkeys(
            f"api/{int(rng.integers(k))}/{int(rng.integers(k))}/"
            f"{int(rng.integers(k))}" for _ in range(4 * P16_API_PUBLISHES)
        ))[:P16_API_PUBLISHES]
        emqx_tpu_torch.publish(Message(topic="api/warm"))  # the first flatten
        counts, per = [], []

        def run():
            for t in topics:
                before = launches_now()["walk"]
                counts.append(emqx_tpu_torch.publish(Message(topic=t)))
                per.append(launches_now()["walk"] - before)

        t0 = time.perf_counter()
        _r, launches = run_counted(run)
        pub_s = time.perf_counter() - t0
        want = [sum(members[f] for f in oracle.match(t)) for t in topics]
        if counts != want or min(per) < 1:
            raise AssertionError(f"[16a] module-level publish counts "
                                 f"{counts[:8]}..., the oracle {want[:8]}..."
                                 f"; B1 a publish {sorted(set(per))}")
        log(f"[16a] the module-level API: emqx_tpu_torch.subscribe of "
            f"{P16_API_FILTERS} subscriptions ({len(members)} filters) in "
            f"{sub_s:.3f} s on the default "
            f"broker ({b.device}, device_min_filters "
            f"{b.router.config.device_min_filters}); {len(topics)} "
            f"emqx_tpu_torch.publish calls in {pub_s * 1e3:.3f} ms, "
            f"{sum(counts)} deliveries, each count the oracle's, B1 on "
            f"each; launches {launches} — {card}")
        return launches
    finally:
        emqx_tpu_torch._default_broker = saved


def ops_plugin(node, tmp, card):
    """16a: a plugin discovered from a spec string, its
    ``<config_dir>/<name>.toml`` env, loaded, listed, unloaded through
    ``ctl plugins``."""
    with open(os.path.join(tmp, "p16_ops.toml"), "w") as f:
        f.write('greeting = "p16"\nlevel = 16\n')
    node.plugins.config_dir = tmp
    plugin = node.plugins.discover("chip_smoke:OpsPlugin")
    steps = [node.ctl.run(["plugins", "load", "p16_ops"]),
             node.ctl.run(["plugins", "list"])]
    env = type(plugin).env
    steps.append(node.ctl.run(["plugins", "unload", "p16_ops"]))
    steps.append(node.ctl.run(["plugins", "list"]))
    if steps != ["ok", "p16_ops (active)", "ok", "p16_ops (inactive)"] or \
            env != {"greeting": "p16", "level": 16} or type(plugin).env:
        raise AssertionError(f"[16a] plugin steps {steps}, env {env}")
    log(f"[16a] plugin chip_smoke:OpsPlugin discovered, loaded with its "
        f"p16_ops.toml env {env}, listed, unloaded: {steps} — {card}")


def ops_checkpoint(node, pairs, batch, oracle, opts, tmp, card):
    """16a: ``ctl checkpoint save`` of the node's router (its tables
    placed in the file: ``set_delta(False)`` first), ``ctl checkpoint
    load`` into a fresh ``delta=False`` node, then one of phase 5's
    batches on it against the TrieOracle, B1 and B2 counted: the loaded
    tables are the ones the card serves."""
    import torch

    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.router import MatcherConfig
    from emqx_tpu_torch.types import Message

    path = os.path.join(tmp, "router.npz")
    t0 = time.perf_counter()
    node.router.set_delta(False)
    flip_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    saved = node.ctl.run(["checkpoint", "save", path])
    save_s = time.perf_counter() - t0
    if not (saved.startswith("saved ") and saved.endswith("+ tables")):
        raise AssertionError(f"[16a] checkpoint save: {saved}")
    fresh = Node(device=node.device, name=node.name, boot_listeners=False,
                 batch_size=opts.batch,
                 matcher=MatcherConfig(delta=False))
    t0 = time.perf_counter()
    loaded = fresh.ctl.run(["checkpoint", "load", path])
    load_s = time.perf_counter() - t0
    if loaded != saved.replace("saved", "restored"):
        raise AssertionError(f"[16a] checkpoint load: {loaded}")
    rebuilds = fresh.router._rebuilds
    # the batch's subscribers: every big filter's members and every
    # shared group's (their routes came back with the file)
    keep = [(s, f) for s, f in pairs
            if f.startswith("$share/") or "/big" in f]
    sub_s = subscribe_pairs(fresh.broker, keep)
    if fresh.router._rebuilds != rebuilds or fresh.router._dirty:
        raise AssertionError("[16a] the subscriptions changed the loaded "
                             "tables")
    msgs = [Message(topic=t) for t in batch]
    Sink.log = []
    t0 = time.perf_counter()
    res, launches = run_counted(fresh.broker.publish_batch, msgs)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    deliveries, Sink.log = Sink.log, None
    n_big = check_batches(fresh.broker, [(msgs, res)], deliveries, oracle)
    if launches["walk"] < 1 or launches["bitmap_or"] < 1 or \
            fresh.router._rebuilds != rebuilds:
        raise AssertionError(f"[16a] the batch after the load: launches "
                             f"{launches}, rebuilds {rebuilds} -> "
                             f"{fresh.router._rebuilds}")
    size = os.path.getsize(path)
    log(f"[16a] ctl checkpoint: set_delta(False) {flip_s:.3f} s; save "
        f"{save_s:.3f} s ({saved}, {size / 2**20:.1f} MiB); load into a "
        f"fresh delta=False node {load_s:.3f} s ({loaded}, rebuilds "
        f"{rebuilds}); {len(keep)} big-filter and shared subscriptions in "
        f"{sub_s:.3f} s, no re-flatten; one of phase 5's batches "
        f"({len(batch)}) on the loaded tables in {batch_ms:.3f} ms: "
        f"{len(deliveries)} deliveries ({n_big} on the bitmap path) equal "
        f"the TrieOracle's, launches "
        f"{ {k: launches[k] for k in PUBLISH_KERNELS} } — {card}")
    del fresh
    gc.collect()
    return launches, {"save_s": save_s, "load_s": load_s,
                      "flip_s": flip_s, "bytes": size}


async def front_door_16b(node, wl, draw, oracle, card):
    """16b: TLS (server certificate, ``peer_cert_as_username="cn"``),
    WSS, WS and PSK-TLS (the native engine) listeners on the node,
    :data:`P16_CONNS` connections each: every delivery against the
    oracle, connects/s, publish→delivery and PUBACK p50/p99 and the
    launches per listener; a retained SUBSCRIBE through B3 on each
    secure listener; a certificate's CN as a username; a listener with
    ``max_connections = 2`` refusing the third connect; ``ctl
    listeners``."""
    from collections import Counter

    from emqx_tpu_torch.mqtt.packet import Publish, Subscribe
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.psk import PskAuth
    from emqx_tpu_torch.psk_tls import PskTlsListener, open_psk_connection
    from emqx_tpu_torch.tls import TlsOptions, make_client_context

    cert = {n: os.path.join(P16_CERTS, f"{n}.pem")
            for n in ("cacert", "cert", "key", "client-cert",
                      "client-key")}
    n_sub = P16_CONNS // 2
    n_pub = P16_CONNS - n_sub
    kinds = ("ssl:p16", "wss:p16", "ws:p16", "psk:p16")
    keys = {f"{k}-{r}{i}": f"key-{i}".encode() for k in kinds
            for r in ("s", "p", "r") for i in range(max(n_sub, n_pub))}
    psk = PskAuth(node.hooks, keys=keys)
    tls = node.add_tls_listener(
        port=0, name="ssl:p16", peer_cert_as_username="cn",
        tls_options=TlsOptions(certfile=cert["cert"], keyfile=cert["key"],
                               cacertfile=cert["cacert"],
                               verify="verify_peer"))
    wss = node.add_wss_listener(port=0, name="wss:p16", tls_options=
                                TlsOptions(certfile=cert["cert"],
                                           keyfile=cert["key"]))
    ws = node.add_ws_listener(port=0, name="ws:p16")
    pskl = node.add_tls_listener(port=0, name="psk:p16",
                                 tls_options=TlsOptions(psk=psk))
    if not isinstance(pskl, PskTlsListener):
        raise AssertionError(f"[16b] the PSK listener is {type(pskl)}")
    cap = node.add_listener(port=0, name="tcp:p16max", max_connections=2)
    lsts = {"ssl:p16": tls, "wss:p16": wss, "ws:p16": ws, "psk:p16": pskl}
    for lst in (*lsts.values(), cap):
        await lst.start()
    ctx = make_client_context(cacertfile=cert["cacert"])

    def opener(kind, cid):
        port = lsts[kind].port
        if kind == "ssl:p16":
            return lambda _p: asyncio.open_connection("127.0.0.1", port,
                                                      ssl=ctx)
        if kind == "wss:p16":
            return lambda _p: ws_open(port, ctx)
        if kind == "ws:p16":
            return lambda _p: ws_open(port)
        return lambda _p: open_psk_connection("127.0.0.1", port, cid,
                                              keys[cid])

    def client(kind, cid, version):
        c = WireClient(cid, version)
        c.opener = opener(kind, cid)
        return c

    plus_set = set(wl["plus"])
    top_plus = [f for f in draw if f in plus_set][:n_sub]
    fleets = {}
    clients = []
    out = {}
    try:
        # every listener's subscribers first: one fan-out rebuild for
        # the four fleets' subscriptions (the warm-up publish below)
        for kind in kinds:
            subs = [client(kind, f"{kind}-s{i}", 4 + i % 2)
                    for i in range(n_sub)]
            pubs = [client(kind, f"{kind}-p{i}", 4 + i % 2)
                    for i in range(n_pub)]
            clients += subs + pubs
            t0 = time.perf_counter()
            await asyncio.gather(*(c.connect(0) for c in subs + pubs))
            conn_s = time.perf_counter() - t0
            acks, flts = [], {}
            for i, c in enumerate(subs):
                flts[c] = (top_plus[i % len(top_plus)],
                           wl["big"][i % len(wl["big"])])
                acks.append(c.expect("suback", 1))
                c.send(Subscribe(packet_id=1, topic_filters=[
                    (f, {"qos": 1}) for f in flts[c]]))
            for a in await asyncio.gather(*acks):
                if a.reason_codes != [1, 1]:
                    raise AssertionError(f"[16b] {kind} SUBACK "
                                         f"{a.reason_codes}")
            fleets[kind] = (subs, pubs, flts, conn_s)
        listed = json.loads(node.ctl.run(["listeners"]))
        by_name = {d["name"]: d for d in listed}
        want_tls = {"ssl:p16": True, "wss:p16": True, "ws:p16": False,
                    "psk:p16": False, "tcp:p16max": False}
        for name, flag in want_tls.items():
            d = by_name[name]
            lst = lsts.get(name, cap)
            if d["tls"] != flag or d["current_connections"] != \
                    lst.current_connections() or \
                    d["current_connections"] != (0 if name == "tcp:p16max"
                                                 else P16_CONNS):
                raise AssertionError(f"[16b] ctl listeners: {d}")
        if len(listed) != len(node.listeners):
            raise AssertionError("[16b] ctl listeners: an entry a listener")
        w = fleets["ssl:p16"][1][0]
        fut = w.expect("puback", 0xFFFF)
        w.send(Publish(topic="warmup/none", qos=1, packet_id=0xFFFF,
                       payload=b"w"))
        t0 = time.perf_counter()
        await fut
        warm_s = time.perf_counter() - t0
        topics = zipf_topics(np.random.default_rng(0), draw,
                             len(kinds) * n_pub * P16_PUBS)
        # a window's PUBLISHes reach the subscribers of every listener
        # (the big filters are shared): each window waits for and checks
        # every subscriber's deliveries, and times its own listener's
        subs_of = {}
        all_subs = []
        for kind in kinds:
            for c, fs in fleets[kind][2].items():
                all_subs.append(c)
                for f in fs:
                    subs_of.setdefault(f, []).append(c)
        for k_i, kind in enumerate(kinds):
            subs, pubs, flts, conn_s = fleets[kind]
            base = k_i * n_pub * P16_PUBS
            sent = {c: topics[base + j * P16_PUBS:base + (j + 1) * P16_PUBS]
                    for j, c in enumerate(pubs)}
            hits = {t: [c for f in oracle.match(t)
                        for c in subs_of.get(f, ())]
                    for m in sent.values() for t in m}
            want_n = {c: 0 for c in all_subs}
            for m in sent.values():
                for t in m:
                    for c in hits[t]:
                        want_n[c] += 1
            cd = Countdown(want_n)
            for c in all_subs:
                c.got.clear()
                c.on_publish = cd
            puback = []
            done = {c: [] for c in pubs}

            async def publisher(c, mine):
                for j, t in enumerate(mine, 1):
                    t0 = time.perf_counter()
                    payload = b"%s:%d:%.9f" % (c.cid.encode(), j, t0)
                    done[c].append((t, payload))
                    fut = c.expect("puback", j)
                    c.send(Publish(topic=t, qos=1, packet_id=j,
                                   payload=payload))
                    await fut
                    puback.append(time.perf_counter() - t0)

            _build.reset_launches()
            t0 = time.perf_counter()
            await asyncio.gather(*(publisher(c, sent[c]) for c in pubs))
            await asyncio.wait_for(cd.done, 60)
            wall = time.perf_counter() - t0
            launches = launches_now()
            for c in all_subs:
                c.on_publish = None
            lat = []
            n_all = 0
            want = {c: Counter() for c in all_subs}
            for mine in done.values():
                for t, payload in mine:
                    for s in hits[t]:
                        want[s][(t, payload)] += 1
            mine_subs = set(subs)
            for c in all_subs:
                got = Counter((t, p) for t, p, _r, _a in c.got)
                if got != want[c]:
                    raise AssertionError(f"[16b] {c.cid}: received "
                                         f"{sum(got.values())}, the oracle "
                                         f"gives {sum(want[c].values())}")
                n_all += len(c.got)
                if c in mine_subs:
                    lat += [a - float(p.rsplit(b":", 1)[1])
                            for _t, p, _r, a in c.got]
            for k in PUBLISH_KERNELS:
                if launches[k] < 1:
                    raise AssertionError(f"[16b] {kind}: no {k} launch")
            n_msgs = n_pub * P16_PUBS
            row = {"connects_per_s": P16_CONNS / conn_s,
                   "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
                   "puback_p50_ms": _pct(puback, 50),
                   "puback_p99_ms": _pct(puback, 99),
                   "deliveries": len(lat), "all_deliveries": n_all,
                   "msgs_per_s": n_msgs / wall,
                   "launches": launches}
            out[kind] = row
            log(f"[16b] {kind}: {P16_CONNS} connections, "
                f"{row['connects_per_s']:.1f} connects/s (handshake "
                f"included); {n_msgs} QoS 1 PUBLISHes in {wall:.3f} s, "
                f"{n_all} deliveries over the four listeners equal the "
                f"TrieOracle's, {len(lat)} of them on {kind} itself: "
                f"publish→delivery p50 "
                f"{row['p50_ms']:.3f} ms, p99 {row['p99_ms']:.3f} ms; "
                f"PUBACK p50 {row['puback_p50_ms']:.3f} ms, p99 "
                f"{row['puback_p99_ms']:.3f} ms; launches "
                f"{ {k: launches[k] for k in PUBLISH_KERNELS} } — {card}")
        # a retained SUBSCRIBE over each secure listener, the replay
        # through B3 (after every window: a new filter is a fan-out
        # membership change, which the next publish would rebuild)
        for kind, flt in P16_REPLAY.items():
            r = client(kind, f"{kind}-r0", 5)
            clients.append(r)
            await r.connect(0)
            names = sorted(retained_name(int(i))
                           for i in NameFamily(P15_RETAINED).match(flt))
            _build.reset_launches()
            fut = r.expect("suback", 1)
            r.send(Subscribe(packet_id=1, topic_filters=[(flt, {"qos": 0})]))
            await fut
            await until_async(lambda: len(r.got) >= len(names), 10.0,
                              f"{kind}'s replay of {flt}")
            b3 = launches_now()["retained_match"]
            got = sorted(t for t, _p, ret, _a in r.got if ret)
            if got != names or b3 < 1:
                raise AssertionError(f"[16b] {kind} replay of {flt}: "
                                     f"{len(got)} of {len(names)}, B3 {b3}")
            out[kind]["replay"] = {"filter": flt, "names": len(names),
                                   "b3": b3}
            add_launches(out[kind]["launches"], {"retained_match": b3})
            log(f"[16b] {kind}: retained SUBSCRIBE {flt}: {len(names)} "
                f"names replayed through B3 ({b3} launches), equal to the "
                f"name family — {card}")
        # a certificate's CN as the username
        cc = make_client_context(cacertfile=cert["cacert"],
                                 certfile=cert["client-cert"],
                                 keyfile=cert["client-key"])
        c = WireClient("p16-cert", 5)
        c.opener = lambda _p: asyncio.open_connection(
            "127.0.0.1", tls.port, ssl=cc)
        clients.append(c)
        await c.connect(0)
        user = node.cm.lookup_channel("p16-cert").username
        if user != "test-client":
            raise AssertionError(f"[16b] peer_cert_as_username cn: {user}")
        # max_connections = 2 refuses the third connect
        held = [WireClient(f"p16-max{i}", 4) for i in range(2)]
        clients.extend(held)
        for h in held:
            await h.connect(cap.port)
        from emqx_tpu_torch.mqtt.frame import serialize
        from emqx_tpu_torch.mqtt.packet import Connect

        r3, w3 = await asyncio.open_connection("127.0.0.1", cap.port)
        w3.write(serialize(Connect(client_id="p16-max2", proto_ver=4,
                                   proto_name="MQTT", keepalive=0), 4))
        try:
            answer = await asyncio.wait_for(r3.read(), 5.0)
        except ConnectionError:
            answer = b""
        w3.close()
        refused = answer == b""
        if not refused or cap.current_connections() != 2:
            raise AssertionError("[16b] max_connections = 2 let a third in")
        log(f"[16b] the fan-out rebuild for the fleets' subscriptions "
            f"(warm-up publish) {warm_s:.3f} s; ctl listeners: "
            f"{len(listed)} entries, tls flags "
            f"{ {n: by_name[n]['tls'] for n in want_tls} }, "
            f"{P16_CONNS} connections on each of the four; a client "
            f"certificate's CN on ssl:p16 (peer_cert_as_username = cn) "
            f"became the username {user!r}; tcp:p16max (max_connections "
            f"= 2) held 2 and closed the third connect — {card}")
        return out
    finally:
        await asyncio.gather(*(c.close() for c in clients
                               if c.closed is not None
                               and not c.closed.done()))
        for lst in (*lsts.values(), cap):
            await lst.stop()


def run_ops(node, pairs, batches, wl, draw, oracle, opts, card):
    """Phase 16 on phase 5's node after phase 15 (see the module
    docstring); returns its launches and numbers."""
    import tempfile

    t_start = time.perf_counter()
    quiet = breaker_mark(node)
    raise_fd_limit(8 * P16_CONNS + 512)
    log(f"[16] P16_BUDGET_S {P16_BUDGET_S:.0f} s; on phase 5's node "
        f"({len(node.router._filter_ids)} filters, modules "
        f"{node.modules.loaded()}); {P16_CONNS} connections a listener "
        f"over TLS, WSS, WS and PSK-TLS, {P16_PUBS} QoS 1 PUBLISHes a "
        f"publisher — {card}")
    # with auto-subscribe every connect, and with presence every connect
    # and disconnect, is a publish after a fan-out membership change: a
    # full rebuild of the fan-out tables each (2.0 s at 1.03M filters;
    # 400 connects and closes took 700 s with them): 16b runs without
    # both
    for name in ("subscription", "presence"):
        node.modules.unload(name)
    launches = {"16a": {}, "16b": {}}
    with tempfile.TemporaryDirectory(prefix="chip_trace_p16_",
                                     dir=os.getcwd()) as tmp:
        add_launches(launches["16a"], ops_profile(node, batches[0], tmp,
                                                  card))
        ctl_s = ops_ctl(node, card)
        topics = list(dict.fromkeys(t for b in batches for t in b))
        add_launches(launches["16a"], ops_match_routes(
            node, topics[:P16_MATCH_ROUTES], oracle, card))
        add_launches(launches["16a"], ops_module_api(node.device, card))
        ops_plugin(node, tmp, card)
        b = asyncio.run(front_door_16b(node, wl, draw, oracle, card))
        for row in b.values():
            add_launches(launches["16b"], row["launches"])
        ret = node.modules._loaded["retainer"]
        k = p14_kernels(node, batches[0], ret._index,
                        [list(P16_REPLAY.values())], card, "16",
                        what="phase 5's node after 16b")
        check_quiet(node, "16", ret._index, since=quiet)
        ck_launches, ck = ops_checkpoint(node, pairs, batches[1], oracle,
                                         opts, tmp, card)
        add_launches(launches["16a"], ck_launches)
    took = time.perf_counter() - t_start
    log(f"[16] phase 16 took {took:.1f} s of its {P16_BUDGET_S:.0f} s "
        f"budget; launches {launches} — {card}")
    return {"launches": launches, "16b": b, "kernels": k,
            "checkpoint": ck, "ctl_s": ctl_s, "seconds": took}


# -- phase 17: the multi-loop front door, the worker pool, the command line --

#: phase 17's time budget, printed beside its seconds
P17_BUDGET_S = 200.0
#: 17a's front-door loops, connections (half subscribers, half
#: publishers: 7a's shape) and QoS 1 PUBLISHes a publisher
P17_LOOPS = 4
P17_CONNS = 400
P17_PUBS = 5
#: retained names stored on 17a's node (13b's store), and one retained
#: filter for each peer loop's replay through B3
P17_RETAINED = P13_RETAINED
P17_REPLAY = ("s3/#", "s5/+/+/state", "s7/g1/+/state")
#: QoS 1 messages left unacked before 17a's cross-loop takeover
P17_BACKLOG = 8
#: 17b's workers; 17c's loops
P17B_WORKERS = 2
P17C_LOOPS = 2
#: seconds 17c's process may take to listen, and to exit after SIGTERM
P17C_BOOT_S = 180.0
P17C_TERM_S = 20.0

P17_BOOT = """[node]
name = "{name}"
loops = {loops}

[[listeners]]
type = "tcp"
port = 0
"""


def p17_file(path, loops, extra="", name="p17@127.0.0.1"):
    with open(path, "w") as f:
        f.write(P17_BOOT.format(name=name, loops=loops) + extra)
    return path


async def p17_subscribe(c, pid, flts, qos=1):
    """SUBSCRIBE ``flts`` at ``qos``; raises unless every code grants
    it."""
    from emqx_tpu_torch.mqtt.packet import Subscribe

    fut = c.expect("suback", pid)
    c.send(Subscribe(packet_id=pid, topic_filters=[(f, {"qos": qos})
                                                   for f in flts]))
    ack = await asyncio.wait_for(fut, 30)
    if ack.reason_codes != [qos] * len(flts):
        raise AssertionError(f"{c.cid}: SUBACK {ack.reason_codes}")


async def p17_publish(c, pid, topic, payload):
    """One QoS 1 PUBLISH; returns once its PUBACK arrived."""
    from emqx_tpu_torch.mqtt.packet import Publish

    fut = c.expect("puback", pid)
    c.send(Publish(topic=topic, qos=1, packet_id=pid, payload=payload))
    await asyncio.wait_for(fut, 30)


def loop_of(node, cid):
    """The front-door loop index serving ``cid``'s connection."""
    chan = node.cm.lookup_channel(cid)
    return node.loop_group.index_of(chan.owner_loop)


async def loops_17a(node, wl, draw, oracle, path, card):
    """17a on the booted four-loop node (see the module docstring);
    returns its numbers and launches."""
    from collections import Counter

    from emqx_tpu_torch.ops import _build

    await node.start()
    lg = node.loop_group
    lst = node.listeners[0]
    n_sub = P17_CONNS // 2
    n_pub = P17_CONNS - n_sub
    subs = [WireClient(f"p17-s{i}", 4 + i % 2) for i in range(n_sub)]
    pubs = [WireClient(f"p17-p{i}", 4 + i % 2) for i in range(n_pub)]
    clients = subs + pubs
    accepted = 0
    out = {"launches": {}}
    try:
        t0 = time.perf_counter()
        for i in range(0, len(clients), 100):
            await asyncio.gather(*(c.connect(lst.port)
                                   for c in clients[i:i + 100]))
        conn_s = time.perf_counter() - t0
        accepted += len(clients)
        per_loop = lst.loop_connections()
        if per_loop != [P17_CONNS // P17_LOOPS] * P17_LOOPS:
            raise AssertionError(f"[17a] connections a loop {per_loop}")
        plus_set = set(wl["plus"])
        top_plus = [f for f in draw if f in plus_set][:n_sub]
        flts = {}
        for i, c in enumerate(subs):
            flts[c] = (top_plus[i % len(top_plus)],
                       wl["big"][i % len(wl["big"])])
        await asyncio.gather(*(p17_subscribe(c, 1, flts[c]) for c in subs))
        # the fan-out tables' rebuild for the fleet's subscriptions
        t0 = time.perf_counter()
        await p17_publish(pubs[0], 0xFFFF, "warmup/none", b"w")
        warm_s = time.perf_counter() - t0
        topics = zipf_topics(np.random.default_rng(0), draw,
                             n_pub * P17_PUBS)
        sent = {c: topics[j * P17_PUBS:(j + 1) * P17_PUBS]
                for j, c in enumerate(pubs)}
        subs_of = {}
        for c, fs in flts.items():
            for f in fs:
                subs_of.setdefault(f, []).append(c)
        hits = {t: [c for f in oracle.match(t) for c in subs_of.get(f, ())]
                for m in sent.values() for t in m}
        want_n = {c: 0 for c in subs}
        for m in sent.values():
            for t in m:
                for c in hits[t]:
                    want_n[c] += 1
        cd = Countdown(want_n)
        for c in subs:
            c.got.clear()
            c.on_publish = cd
        puback = []
        done = {c: [] for c in pubs}

        async def publisher(c, mine):
            for j, t in enumerate(mine, 1):
                t0 = time.perf_counter()
                payload = b"%s:%d:%.9f" % (c.cid.encode(), j, t0)
                done[c].append((t, payload))
                await p17_publish(c, j, t, payload)
                puback.append(time.perf_counter() - t0)

        m0 = {k: node.metrics.val(k) for k in (
            "delivery.xloop.handoffs", "delivery.xloop.deliveries",
            "delivery.xloop.orphaned")}
        _build.reset_launches()
        t0 = time.perf_counter()
        await asyncio.gather(*(publisher(c, sent[c]) for c in pubs))
        await asyncio.wait_for(cd.done, 60)
        wall = time.perf_counter() - t0
        window = launches_now()
        xl = {k: node.metrics.val(k) - v for k, v in m0.items()}
        for c in subs:
            c.on_publish = None
        want = {c: Counter() for c in subs}
        for mine in done.values():
            for t, payload in mine:
                for s in hits[t]:
                    want[s][(t, payload)] += 1
        lat = []
        for c in subs:
            got = Counter((t, p) for t, p, _r, _a in c.got)
            if got != want[c]:
                raise AssertionError(f"[17a] {c.cid}: received "
                                     f"{sum(got.values())}, the oracle "
                                     f"gives {sum(want[c].values())}")
            lat += [a - float(p.rsplit(b":", 1)[1])
                    for _t, p, _r, a in c.got]
        for k in PUBLISH_KERNELS:
            if window[k] < 1:
                raise AssertionError(f"[17a] no {k} launch in the window")
        if xl["delivery.xloop.handoffs"] < 1 or \
                xl["delivery.xloop.deliveries"] < 1 or \
                xl["delivery.xloop.orphaned"]:
            raise AssertionError(f"[17a] the delivery ring: {xl}")
        add_launches(out["launches"], window)
        n_msgs = n_pub * P17_PUBS
        out.update({"connects_per_s": P17_CONNS / conn_s,
                    "msgs_per_s": n_msgs / wall, "deliveries": len(lat),
                    "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
                    "puback_p50_ms": _pct(puback, 50),
                    "puback_p99_ms": _pct(puback, 99), "xloop": xl,
                    "per_loop": per_loop, "warm_s": warm_s})
        log(f"[17a] {P17_CONNS} connections over {P17_LOOPS} loops "
            f"{per_loop} in {conn_s:.3f} s ({out['connects_per_s']:.1f} "
            f"connects/s); fan-out rebuild (warm-up publish) {warm_s:.3f} "
            f"s; {n_msgs} QoS 1 PUBLISHes in {wall:.3f} s "
            f"({out['msgs_per_s']:.1f} msgs/s), {len(lat)} deliveries equal "
            f"the TrieOracle's: publish→delivery p50 {out['p50_ms']:.3f} "
            f"ms, p99 {out['p99_ms']:.3f} ms; PUBACK p50 "
            f"{out['puback_p50_ms']:.3f} ms, p99 {out['puback_p99_ms']:.3f}"
            f" ms; the ring: {xl['delivery.xloop.handoffs']} handoffs, "
            f"{xl['delivery.xloop.deliveries']} deliveries, "
            f"{xl['delivery.xloop.orphaned']} orphaned; launches "
            f"{ {k: window[k] for k in PUBLISH_KERNELS} } — {card}")
        # a retained SUBSCRIBE on each peer loop: its replay (B3) runs on
        # that loop's thread (ThreadLaunches names the launching thread)
        replay = {}
        while len(replay) < P17_LOOPS - 1:
            r = WireClient(f"p17-r{accepted}", 5)
            clients.append(r)
            await r.connect(lst.port)
            accepted += 1
            idx = loop_of(node, r.cid)
            if idx and idx not in replay:
                replay[idx] = r
        saved = _build.LAUNCHES
        tl = _build.LAUNCHES = ThreadLaunches({k: 0 for k in saved})
        try:
            for idx, r in sorted(replay.items()):
                flt = P17_REPLAY[idx - 1]
                names = sorted(retained_name(int(i))
                               for i in NameFamily(P17_RETAINED).match(flt))
                await p17_subscribe(r, 1, [flt], qos=0)
                await until_async(lambda: len(r.got) >= len(names), 10.0,
                                  f"loop {idx}'s replay of {flt}",
                                  label="17a")
                got = sorted(t for t, _p, ret, _a in r.got if ret)
                if got != names:
                    raise AssertionError(f"[17a] loop {idx}'s replay of "
                                         f"{flt}: {len(got)} of "
                                         f"{len(names)}")
        finally:
            _build.LAUNCHES = saved
        by_thread = {t: dict(d) for t, d in tl.by_thread.items()}
        for idx in replay:
            b3 = by_thread.get(f"frontdoor-loop-{idx}", {}).get(
                "retained_match", 0)
            if b3 < 1:
                raise AssertionError(f"[17a] no B3 launch on loop {idx}'s "
                                     f"thread: {by_thread}")
        if by_thread.get("MainThread", {}).get("retained_match", 0):
            raise AssertionError(f"[17a] a replay launched B3 on the main "
                                 f"loop: {by_thread}")
        add_launches(out["launches"], {k: tl[k] for k in tl})
        out["replay_threads"] = by_thread
        log(f"[17a] a retained SUBSCRIBE on each peer loop "
            f"{ {i: P17_REPLAY[i - 1] for i in sorted(replay)} }: every "
            f"replay equal to the name family, B3 launched on the loop's "
            f"own thread {by_thread} — {card}")
        # the cross-loop takeover of a session with a QoS 1 backlog
        tk1 = WireClient("p17-tk", 5, clean_start=False, expiry=300,
                         auto_ack=False)
        clients.append(tk1)
        await tk1.connect(lst.port)
        accepted += 1
        idx1 = loop_of(node, tk1.cid)
        await p17_subscribe(tk1, 1, ["p17/tk/t"])
        _build.reset_launches()
        for j in range(1, P17_BACKLOG + 1):
            await p17_publish(pubs[0], 100 + j, "p17/tk/t", b"tk%d" % j)
        await until_async(lambda: len(tk1.got) >= P17_BACKLOG, 10.0,
                          "the unacked backlog", label="17a")
        taken = node.metrics.val("session.takeovered")
        # the subscriptions since the window changed the fan-out
        # membership: the backlog's first publish rebuilt the tables,
        # a loop stall the overload monitor may read as critical (it
        # then refuses CONNECTs); the reconnect waits for ok
        await until_async(lambda: node.overload.level == 0, 60.0,
                          "the overload level's return to ok",
                          label="17a")
        if accepted % P17_LOOPS == idx1:
            filler = WireClient(f"p17-f{accepted}", 4)
            clients.append(filler)
            await filler.connect(lst.port)
            accepted += 1
        tk1.expect("disconnect", 0)   # 0x8E, Session-Taken-Over
        tk2 = WireClient("p17-tk", 5, clean_start=False, expiry=300)
        clients.append(tk2)
        refused = REFUSED["connects"]
        await tk2.connect(lst.port)
        ack = tk2.connack
        # a CONNECT refused with ServerBusy (the fan-out rebuild's lag can
        # read as critical overload) is retried on a new connection
        accepted += 1 + REFUSED["connects"] - refused
        idx2 = loop_of(node, tk2.cid)
        await until_async(lambda: len(tk2.got) >= P17_BACKLOG, 30.0,
                          "the backlog after the takeover", label="17a")
        backlog = sorted(p for _t, p, _r, _a in tk2.got)
        if ack.reason_code or not ack.session_present or idx2 == idx1 \
                or backlog != sorted(b"tk%d" % j
                                     for j in range(1, P17_BACKLOG + 1)) \
                or node.metrics.val("session.takeovered") != taken + 1:
            raise AssertionError(f"[17a] the cross-loop takeover: loop "
                                 f"{idx1} -> {idx2}, CONNACK {ack}, "
                                 f"backlog {backlog}")
        add_launches(out["launches"], launches_now())
        log(f"[17a] cross-loop takeover: p17-tk moved from loop {idx1} to "
            f"loop {idx2} with session present, its {P17_BACKLOG} unacked "
            f"QoS 1 messages redelivered on the new loop — {card}")
        # the per-loop rows of the stats flush
        node.tick()
        lags = {i: node.stats.getstat(f"loop.{i}.lag_ms")
                for i in range(P17_LOOPS)}
        conns = {i: node.stats.getstat(f"loop.{i}.connections")
                 for i in range(P17_LOOPS)}
        out["lag_ms"] = lags
        log(f"[17a] loop.<i>.lag_ms {lags}, loop.<i>.connections {conns} "
            f"— {card}")
        # ctl reload: a reloadable knob applied with the clients
        # connected, then a boot-only edit rejected whole
        held = lst.current_connections()
        edited = p17_file(path + ".telemetry.toml", P17_LOOPS,
                          "\n[telemetry]\nslow_threshold_ms = 250.0\n")
        t0 = time.perf_counter()
        text = node.ctl.run(["reload", edited])
        reload_ms = (time.perf_counter() - t0) * 1000.0
        if "applied: telemetry.slow_threshold_ms 100.0 -> 250.0" not in \
                text or node.telemetry.config.slow_threshold_ms != 250.0 \
                or lst.current_connections() != held:
            raise AssertionError(f"[17a] ctl reload: {text!r}")
        await p17_publish(pubs[1], 0xFFFE, "p17/tk/t", b"after-reload")
        loops2 = p17_file(path + ".loops.toml", 2)
        rejected = node.ctl.run(["reload", loops2])
        if not rejected.startswith("reload rejected") or \
                "node.loops: 4 -> 2" not in rejected or lg.n != P17_LOOPS:
            raise AssertionError(f"[17a] ctl reload: {rejected!r}")
        log(f"[17a] ctl reload of an edited copy in {reload_ms:.3f} ms: "
            f"{text.splitlines()[-1]!r}, {held} connections held; a copy "
            f"with loops = 2: {rejected.splitlines()[-1].strip()!r} — "
            f"{card}")
        if lg.errors:
            raise AssertionError(f"[17a] errors on the peer loops: "
                                 f"{lg.errors}")
        return out
    finally:
        await asyncio.gather(*(c.close() for c in clients
                               if c.closed is not None
                               and not c.closed.done()))
        await node.stop()


async def pool_17b(device, card):
    """17b: the JAX tests' three worker-pool scenarios, each worker a
    node on ``device``."""
    from emqx_tpu_torch.workers import WorkerPool

    out = {}
    with WorkerPool(P17B_WORKERS, port=0, device=device,
                    cookie="p17b") as pool:
        port = pool.port
        out["ready_s"] = list(pool.ready_s)
        log(f"[17b] {P17B_WORKERS} workers on port {port}, each a node on "
            f"{device} in its own process: seconds to READY "
            f"{[round(s, 3) for s in pool.ready_s]} — {card}")
        # delivery across workers: 6 subscribers x 3 publishes
        subs = [WireClient(f"p17b-s{i}", 5) for i in range(6)]
        for s in subs:
            await s.connect(port)
            await p17_subscribe(s, 1, ["p17b/+"], qos=0)
        await asyncio.sleep(0.7)  # route replication settles
        pub = WireClient("p17b-p", 5)
        await pub.connect(port)
        for k in range(3):
            await p17_publish(pub, k + 1, f"p17b/{k}", b"m%d" % k)
        await until_async(lambda: all(len(s.got) >= 3 for s in subs), 30.0,
                          "the cross-worker deliveries", label="17b")
        got = sorted((s.cid, t, p) for s in subs for t, p, _r, _a in s.got)
        want = sorted((s.cid, f"p17b/{k}", b"m%d" % k) for s in subs
                      for k in range(3))
        stats = pool.stats()
        if got != want or sum(c for c, _ in stats) != 7:
            raise AssertionError(f"[17b] cross-worker delivery: {len(got)} "
                                 f"of 18, stats {stats}")
        log(f"[17b] 6 subscribers x 3 publishes across the workers: 18 "
            f"deliveries exact; (connections, delivered) a worker {stats} "
            f"— {card}")
        for c in subs + [pub]:
            await c.close()
        # one client id across the workers: one live session
        c1 = WireClient("p17b-dup", 5)
        await c1.connect(port)
        c2 = WireClient("p17b-dup", 5)
        c1.expect("disconnect", 0)
        await c2.connect(port)
        await asyncio.sleep(0.7)
        stats = pool.stats()
        if sum(c for c, _ in stats) != 1:
            raise AssertionError(f"[17b] duplicate client id: {stats}")
        log(f"[17b] one client id twice through the shared port: one live "
            f"session, {stats} — {card}")
        await c2.close()
        # a worker killed mid-traffic, then restarted into the cluster
        subs = [WireClient(f"p17b-k{i}", 5) for i in range(6)]
        for s in subs:
            await s.connect(port)
            await p17_subscribe(s, 1, ["p17b/k/+"])
        await asyncio.sleep(0.7)
        pub = WireClient("p17b-kp", 5)
        await pub.connect(port)
        await p17_publish(pub, 1, "p17b/k/a", b"before")
        await until_async(lambda: all(len(s.got) >= 1 for s in subs), 30.0,
                          "the deliveries before the kill", label="17b")
        pool.procs[1].kill()
        t_kill = time.perf_counter()
        await asyncio.sleep(4.0)  # the probe declares the worker down
        live = [s for s in subs if not s.closed.done()]
        fresh = WireClient("p17b-fresh", 5)
        await fresh.connect(port)
        await p17_subscribe(fresh, 1, ["p17b/k/+"])
        pub2 = WireClient("p17b-kp2", 5)
        await pub2.connect(port)
        await p17_publish(pub2, 1, "p17b/k/b", b"after")
        await until_async(lambda: all(len(s.got) >= 2 for s in live)
                          and len(fresh.got) >= 1, 30.0,
                          "the deliveries after the kill", label="17b")
        bad = [s.cid for s in live + [fresh]
               if [p for _t, p, _r, _a in s.got][-1] != b"after"]
        if bad:
            raise AssertionError(f"[17b] after the kill: {bad}")
        t0 = time.perf_counter()
        pool.restart_worker(1)
        restart_s = time.perf_counter() - t0
        await asyncio.sleep(1.0)
        more = [WireClient(f"p17b-r{i}", 5) for i in range(6)]
        for s in more:
            await s.connect(port)
            await p17_subscribe(s, 1, ["p17b/r/t"])
        await asyncio.sleep(0.7)
        pub3 = WireClient("p17b-rp", 5)
        await pub3.connect(port)
        await p17_publish(pub3, 1, "p17b/r/t", b"rebuilt")
        await until_async(lambda: all(len(s.got) >= 1 for s in more), 30.0,
                          "the deliveries after the restart", label="17b")
        stats = pool.stats()
        if any(p.poll() is not None for p in pool.procs) or \
                any(s.got[0][1] != b"rebuilt" for s in more) or \
                min(c for c, _ in stats) < 1:
            raise AssertionError(f"[17b] after the restart: {stats}")
        out.update({"restart_s": restart_s,
                    "restart_ready_s": pool.ready_s[1],
                    "killed_at": t_kill})
        log(f"[17b] worker 1 killed under traffic: {len(live)} of 6 "
            f"subscribers kept their socket, they and a fresh one got the "
            f"next publish exactly; restart_worker(1) in {restart_s:.3f} s "
            f"({pool.ready_s[1]:.3f} s to READY), 6 new subscribers spread "
            f"{stats} all got the next publish — {card}")
        for c in live + more + [fresh, pub, pub2, pub3]:
            if not c.closed.done():
                await c.close()
    return out


async def p17c_boot(cfg, device, label):
    """Start ``python -m emqx_tpu_torch --config cfg`` (on the card, its
    default; ``--device`` otherwise); returns the process, its listener
    port, its output, the task that keeps reading it and the seconds to
    the ``listening:`` line."""
    repo = os.path.dirname(os.path.abspath(__file__))
    dev = [] if device == "cuda" else ["--device", device]
    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "emqx_tpu_torch", "--config", cfg, *dev,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
        cwd=repo)
    lines = []
    port = None
    try:
        while port is None:
            line = await asyncio.wait_for(proc.stdout.readline(),
                                          P17C_BOOT_S)
            if not line:
                raise AssertionError(f"[17c] {label}: the process exited "
                                     f"before listening: {lines[-20:]}")
            lines.append(line.decode(errors="replace").rstrip())
            if b"listening:" in line:
                port = int(line.rsplit(b":", 1)[1])
    except BaseException:
        proc.kill()
        await proc.wait()
        raise

    async def drain():
        # keep the pipe empty: a full one would block the node's logging
        while True:
            line = await proc.stdout.readline()
            if not line:
                return
            lines.append(line.decode(errors="replace").rstrip())

    task = asyncio.get_running_loop().create_task(drain())
    return proc, port, lines, task, time.perf_counter() - t0


async def p17c_term(proc, task, label):
    proc.send_signal(signal.SIGTERM)
    t0 = time.perf_counter()
    try:
        rc = await asyncio.wait_for(proc.wait(), P17C_TERM_S)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise AssertionError(f"[17c] {label}: no exit {P17C_TERM_S:.0f} s "
                             f"after SIGTERM")
    await task
    if rc != 0:
        raise AssertionError(f"[17c] {label}: SIGTERM exit code {rc}")
    return time.perf_counter() - t0


async def cli_17c(tmp, device, card):
    """17c: ``python -m emqx_tpu_torch --config`` on ``device``, two loops
    and durability on: a persistent session's queued messages survive a
    SIGTERM through the 2-shard journal and checkpoint."""
    d = os.path.join(tmp, "p17c")
    os.makedirs(d)
    cfg = p17_file(os.path.join(d, "p17c.toml"), P17C_LOOPS,
                   '\n[durability]\nenabled = true\ndir = "data"\n',
                   name="p17c@127.0.0.1")
    proc, port, lines, task, boot1 = await p17c_boot(cfg, device, "boot 1")
    s = WireClient("p17c-s", 5, clean_start=False, expiry=300)
    p = WireClient("p17c-p", 5)
    try:
        await s.connect(port)
        await p17_subscribe(s, 1, ["p17c/t"])
        await s.close()
        await p.connect(port)
        await p17_publish(p, 1, "p17c/t", b"queued")
        await p17_publish(p, 2, "p17c/t", b"queued-2")
        await p.close()
    except BaseException:
        proc.kill()
        await proc.wait()
        raise
    term1 = await p17c_term(proc, task, "boot 1")
    data = os.path.join(d, "data")
    shards = sorted(f for f in os.listdir(data) if f.startswith("journal-"))
    if len(shards) != P17C_LOOPS:
        raise AssertionError(f"[17c] journal shards {shards}")
    proc, port, lines2, task, boot2 = await p17c_boot(cfg, device,
                                                      "boot 2")
    s2 = WireClient("p17c-s", 5, clean_start=False, expiry=300)
    try:
        await s2.connect(port)
        ack = s2.connack
        await until_async(lambda: len(s2.got) >= 2, 10.0,
                          "the recovered queue", label="17c")
        got = [pl for _t, pl, _r, _a in s2.got]
        await s2.close()
    except BaseException:
        proc.kill()
        await proc.wait()
        raise
    term2 = await p17c_term(proc, task, "boot 2")
    if ack.reason_code or not ack.session_present or \
            got != [b"queued", b"queued-2"]:
        raise AssertionError(f"[17c] the recovered session: {ack}, {got}")
    out = {"boot_s": [boot1, boot2], "term_s": [term1, term2],
           "shards": shards}
    log(f"[17c] python -m emqx_tpu_torch --config (loops = {P17C_LOOPS}, "
        f"durability on, on {device}): listening after {boot1:.3f} s, "
        f"SIGTERM exit 0 in {term1:.3f} s, journal shards {shards}; "
        f"booted again from the same file and directory in {boot2:.3f} s: "
        f"p17c-s resumed with session present and its 2 queued QoS 1 "
        f"messages in order; exit 0 in {term2:.3f} s — {card}")
    return out


def run_loops(pairs, wl, draw, oracle, batches, device, card):
    """Phase 17 (see the module docstring): 17a on a four-loop node
    booted from a config file at phase 5's full width, 17b the worker
    pool, 17c the command line; returns its numbers and 17a's
    launches."""
    import tempfile

    from emqx_tpu_torch.config import boot_from_file

    t_start = time.perf_counter()
    raise_fd_limit(4 * P17_CONNS + 512)
    log(f"[17] P17_BUDGET_S {P17_BUDGET_S:.0f} s; 17a: {P17_LOOPS} loops, "
        f"{P17_CONNS} connections, {P17_PUBS} QoS 1 PUBLISHes a publisher, "
        f"{P17_RETAINED} retained names; 17b: {P17B_WORKERS} workers; 17c: "
        f"{P17C_LOOPS} loops with durability — {card}")
    with tempfile.TemporaryDirectory(prefix="chip_p17_",
                                     dir=os.getcwd()) as tmp:
        path = p17_file(os.path.join(tmp, "p17a.toml"), P17_LOOPS,
                        "\n[modules.retainer]\n")
        t0 = time.perf_counter()
        node = boot_from_file(path, device=device)
        boot_s = time.perf_counter() - t0
        sub_s = subscribe_pairs(node.broker, pairs)
        t0 = time.perf_counter()
        node.router.automaton()
        build_s = time.perf_counter() - t0
        store_s = store_retained(node, P17_RETAINED)
        log(f"[17a] booted from a config file in {boot_s:.3f} s (loops "
            f"{node.loop_group.n}, modules {node.modules.loaded()}); "
            f"{len(node.router._filter_ids)} filters subscribed in "
            f"{sub_s:.1f} s, the automaton in {build_s:.1f} s, "
            f"{P17_RETAINED} retained names in {store_s:.1f} s — {card}")
        a = asyncio.run(loops_17a(node, wl, draw, oracle, path, card))
        ret = node.modules._loaded["retainer"]
        k = p14_kernels(node, batches[0], ret._index, [list(P17_REPLAY)],
                        card, "17a", what="the four-loop node's tables")
        check_quiet(node, "17a", ret._index)
        del node, ret
        gc.collect()
        b = asyncio.run(pool_17b(device, card))
        c = asyncio.run(cli_17c(tmp, device, card))
    took = time.perf_counter() - t_start
    log(f"[17] phase 17 took {took:.1f} s of its {P17_BUDGET_S:.0f} s "
        f"budget; 17a launches {a['launches']} — {card}")
    return {"launches": a["launches"], "17a": a, "17b": b, "17c": c,
            "kernels": k, "seconds": took}


def ban_plane_15c(nodes, trs, cls, card):
    """15c in 13d's cluster: a ban created on the first node reaches
    every node and the ``bans`` digests; a CONNECT of that clientid on
    the second node is refused; a delete on the third clears it
    everywhere."""
    from emqx_tpu_torch.channel import Channel
    from emqx_tpu_torch.mqtt import constants as MC
    from emqx_tpu_torch.mqtt import reason_codes as RC
    from emqx_tpu_torch.mqtt.packet import Connect, Disconnect

    cid = "p15-cluster-banned"
    empty = cls[0]._digest([])

    def connect(node):
        ch = Channel(node.broker, node.cm)
        return ch, ch.handle_in(Connect(proto_ver=MC.MQTT_V5,
                                        client_id=cid))[0]

    t0 = time.perf_counter()
    nodes[0].banned.create("clientid", cid, by="chip_smoke", reason="15c",
                           duration=600.0)
    barrier(trs)
    add_ms = (time.perf_counter() - t0) * 1e3
    held = [n.banned.look_up("clientid", cid) is not None for n in nodes]
    digests = {c.plane_digests()["bans"] for c in cls}
    entries = cls[0]._plane_entries("bans", None)
    if not all(held) or len(digests) != 1 or empty in digests \
            or not entries:
        raise AssertionError(f"[15c] the ban on {nodes[0].name}: held "
                             f"{held}, {len(digests)} bans digests")
    ch, ack = connect(nodes[1])
    if ch.session is not None or ack.reason_code != RC.BANNED:
        raise AssertionError(f"[15c] CONNECT on {nodes[1].name}: "
                             f"{ack.reason_code}")
    t0 = time.perf_counter()
    nodes[2].banned.delete("clientid", cid)
    barrier(trs)
    del_ms = (time.perf_counter() - t0) * 1e3
    left = [n.banned.look_up("clientid", cid) for n in nodes]
    after = {c.plane_digests()["bans"] for c in cls}
    ch, ack = connect(nodes[1])
    if any(left) or after != {empty} or ch.session is None:
        raise AssertionError(f"[15c] the delete on {nodes[2].name}: left "
                             f"{left}, digests {after}, CONNACK "
                             f"{ack.reason_code}")
    ch.handle_in(Disconnect())
    log(f"[15c] a ban created on {nodes[0].name} held on all "
        f"{len(nodes)} nodes after {add_ms:.3f} ms (to the barrier), the "
        f"bans digests equal and non-empty ({len(entries)} entry); a "
        f"CONNECT of {cid} on {nodes[1].name} got CONNACK "
        f"0x{RC.BANNED:02X}; the delete on {nodes[2].name} cleared it "
        f"everywhere after {del_ms:.3f} ms and the next CONNECT was "
        f"accepted — {card}")
    return {"add_ms": add_ms, "del_ms": del_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subs", type=int, default=1_000_000,
                    help="'+' subscriptions (BASELINE config 2: 1M)")
    ap.add_argument("--others", type=int, default=10_000,
                    help="literal, '#' and $share subscriptions each")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--names", type=int, default=1_000_000,
                    help="retained names (the retained_1m shape: 1M)")
    ap.add_argument("--bursts", type=int, default=8)
    ap.add_argument("--burst", type=int, default=64)
    ap.add_argument("--conns", type=int, default=2000,
                    help="phase 7a's connections: half subscribers, half "
                         "publishers (the fleet default)")
    ap.add_argument("--pubs-per-conn", type=int, default=5,
                    help="phase 7a's timed QoS 1 PUBLISHes a publisher "
                         f"(the fleet's is {FLEET_PUBS}, cut to hold "
                         "the run's time)")
    ap.add_argument("--churn-iters", type=int, default=60,
                    help="phase 8a's batches of 256 a pass (the "
                         "reference's churn bench: 60)")
    ap.add_argument("--sessions", type=int, default=P10_SESSIONS,
                    help="phase 10's persistent sessions (the recovery "
                         "bench's fleet: 4,096)")
    ap.add_argument("--p14-sessions", type=int, default=P14_SESSIONS,
                    help="phase 14a/14b's persistent sessions (the "
                         "failover bench's fleet: 5,000)")
    ap.add_argument("--p14-drain-sessions", type=int,
                    default=P14_DRAIN_SESSIONS,
                    help="phase 14c's detached sessions (the drain "
                         "bench's fleet: 5,000; cut to 1,000, printed)")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import emqx_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the emqx_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    card = phase_env()
    phase_build(card)
    t0 = time.perf_counter()
    p13, p15, p16, p17, rows = run(opts, "cuda", card)
    t1 = time.perf_counter()
    rows.append(run_retained(opts, "cuda", card))
    rows[-1]["cluster_launches"] = p13["13b"]["launches"]
    rows[-1]["modules_launches"] = {
        "15b": p15["15b"]["launches"].get("retained_match", 0)}
    rows[-1]["modules_ms"] = p15["kernels"]["b3_ms"]
    rows[-1]["ops_launches"] = {
        g: p16["launches"][g].get("retained_match", 0)
        for g in ("16a", "16b")}
    rows[-1]["ops_ms"] = p16["kernels"]["b3_ms"]
    rows[-1]["loops_launches"] = p17["launches"].get("retained_match", 0)
    rows[-1]["loops_ms"] = p17["kernels"]["b3_ms"]
    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"],
                                  p15["kernels"]["max_abs_err"],
                                  p16["kernels"]["max_abs_err"],
                                  p17["kernels"]["max_abs_err"])
    timed("9d (sentinel)", phase_sentinel, card)
    t2 = time.perf_counter()
    p10 = timed("10 (durability)", run_durable, opts, "cuda", card)
    for row in rows:
        row["durability_launches"] = p10["launches"].get(row["name"], 0)
    t3 = time.perf_counter()
    p14 = timed("14 (replicated durability, drain)", run_repl, opts, "cuda",
                card)
    for row in rows:
        row["repl_launches"] = p14["launches"].get(row["name"], 0)
    log(f"[time] publish phases {t1 - t0:.1f} s, retained phases "
        f"{t2 - t1:.1f} s, durability phase {t3 - t2:.1f} s, replication "
        f"phase {time.perf_counter() - t3:.1f} s — {card}")
    log(card)
    log(json.dumps({"kernels": rows}))
    # the run uses one card, whatever the host shows
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
