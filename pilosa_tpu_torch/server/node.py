"""One serving node and cluster member: holder, data directory, stats
client, the cluster plane, API, HTTP server and the observability planes
(counterpart of ``pilosa_tpu/server/node.py``; reference server.go
composition root).

The node opens its data directory with :class:`HolderStore` on the
holder's device (``cuda`` unless the caller passes ``device="cpu"``) and
serves it over HTTP, with the JAX node's defaults: the serving plane (the
batcher, ``batch_window=0.002``, ``batch_max_size=64``; the result cache,
``rescache_entries=512``; the flight planner, the QoS governor and the
ingest pipeline, ``server/api.py``) and every observability plane a
one-node JAX node runs:

* the diagnostics collector (``/internal/diagnostics``);
* the flight recorder (``flight_recorder=True``: every thread's stack
  each 25 ms, 1 s segments, 60 kept, a 504-spike threshold of 5), whose
  incidents the QoS ladder and the device ledger's storm callback reach;
* the metrics history (``history_enabled=True``: a 1 s sampler over every
  plane, tiers ``300@1,240@15``, the three trend detectors), which feeds
  the flight recorder's incident bundles;
* the runtime monitor and GC notifier (the ``memory_rss_bytes``,
  ``threads``, ``garbage_collections`` gauges, every 10 s);
* with a data directory, the black box (``blackbox_enabled=True``: a 5 s
  checkpoint of the planes under ``<data_dir>/_blackbox/``, the fatal
  signal handler's last words, and the postmortem of a previous life
  that died dirty, ``self.postmortem``), to which each incident is
  flushed as it freezes.

Every node builds its cluster plane as JAX's does, even standing alone:
a ``Cluster`` (static, ``replica_n=1`` by default, disabled until a
join), an ``InternalClient`` (a 30 s timeout, two retries with seeded
jitter, a breaker per peer that opens after 5 transport failures and
probes after 2 s), an ``HTTPBroadcaster`` for schema and shard news, a
``PrimaryTranslateStore`` that sends new keys to the translation primary,
and the API's ``DistributedExecutor``. ``join_static`` fixes the
membership and pulls the coordinator's schema and shard map. With
``mesh_dispatch=True`` (the default) ``start`` registers the holder in
the process's placement map (``parallel/meshplace.py``), so in-process
peers answer this node's shards on the mesh route, one launch on the
card over a holder facade, instead of over HTTP; ``stop`` withdraws it
first.

The elastic planes run as JAX's do: the resize watchdog
(``resize_watchdog_deadline=15.0``, on by default) re-pulls the cluster
status from the coordinator when a resize outlives its deadline;
``resize_coordinator()`` adds and removes nodes online
(``cluster/resize.py``, the migration sessions of ``cluster/migration.py``);
``start_anti_entropy(interval)`` runs ``syncer().sync_holder()`` each
interval (``cluster/antientropy.py``; ``cli server`` starts it); and
``start_membership()`` probes the peers and marks them DOWN and READY
(``cluster/membership.py``). ``stop`` ends every one of them.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
import zlib

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster.broadcast import HTTPBroadcaster
from pilosa_tpu_torch.cluster.client import InternalClient
from pilosa_tpu_torch.cluster.antientropy import AntiEntropyLoop, HolderSyncer
from pilosa_tpu_torch.cluster.cluster import STATE_RESIZING, Cluster
from pilosa_tpu_torch.cluster.membership import MembershipMonitor
from pilosa_tpu_torch.cluster.resize import ResizeCoordinator, ResizeError
from pilosa_tpu_torch.cluster.topology import Node
from pilosa_tpu_torch.cluster.translate_proxy import PrimaryTranslateStore
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.obs import blackbox as bb
from pilosa_tpu_torch.obs import devledger
from pilosa_tpu_torch.obs import events as ev
from pilosa_tpu_torch.obs import slo as slo_mod
from pilosa_tpu_torch.obs.diagnostics import Diagnostics
from pilosa_tpu_torch.obs.flightrec import FlightRecorder
from pilosa_tpu_torch.obs.history import MetricsHistory
from pilosa_tpu_torch.obs.stats import MemStatsClient
from pilosa_tpu_torch.obs.sysinfo import GCNotifier, RuntimeMonitor
from pilosa_tpu_torch.parallel import meshplace
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.http import Server
from pilosa_tpu_torch.shardwidth import SHARD_WORDS
from pilosa_tpu_torch.storage.disk import HolderStore

logger = logging.getLogger(__name__)


class ResizeWatchdog:
    """Follower-side backstop for a coordinator that dies mid-resize.

    A node that received MSG_RESIZE_PREPARE but never hears the commit
    or cancel would hold its pending membership forever (the legacy
    equivalent: a node gated in RESIZING with nobody left to lift the
    gate).  This loop watches for resize state that outlives
    ``deadline`` and then re-requests the cluster status straight from
    the coordinator:

    * coordinator reachable and still resizing -> not stuck; re-arm.
    * coordinator reachable, no resize in flight -> this node missed
      the commit/cancel broadcast; apply the authoritative status
      (membership + state) as if the broadcast had arrived.
    * coordinator unreachable -> keep the pending state (the data is
      still placed on the current ring) and retry next deadline; the
      operator path is set_coordinator + resize resume/abort.

    Every action lands on the event journal as ``resize-watchdog``.
    """

    def __init__(self, node: "NodeServer", deadline: float = 15.0,
                 interval: float = 2.0):
        self.node = node
        self.deadline = float(deadline)
        self.interval = min(float(interval), max(0.05, self.deadline / 3))
        self._since: float | None = None
        self._stop = None
        self._thread = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="resize-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception:  # graftlint: disable=exception-hygiene -- watchdog must outlive any single bad tick
                logger.exception("resize watchdog tick failed")

    def _tick(self) -> None:
        cluster = self.node.cluster
        stuck = cluster.resize_pending or cluster.state == STATE_RESIZING
        if not stuck or cluster.is_coordinator:
            # The coordinator's own pending state is the resize journal's
            # concern (resume/abort), not the watchdog's.
            self._since = None
            return
        now = time.monotonic()
        if self._since is None:
            self._since = now
            return
        if now - self._since < self.deadline:
            return
        self._since = now  # one probe per deadline window
        coord = cluster.node(cluster.coordinator_id)
        journal = self.node.holder.events
        if coord is None or not coord.uri:
            journal.record(
                ev.EVENT_RESIZE_WATCHDOG, action="no-coordinator",
                coordinator=cluster.coordinator_id,
            )
            return
        try:
            status = self.node.client.status(coord.uri)
        except Exception as e:
            journal.record(
                ev.EVENT_RESIZE_WATCHDOG, action="coordinator-unreachable",
                coordinator=coord.id, error=f"{type(e).__name__}: {e}",
            )
            return
        if status.get("resizePending"):
            # Coordinator alive and mid-migration: a long resize is not a
            # stuck resize.
            journal.record(
                ev.EVENT_RESIZE_WATCHDOG, action="still-resizing",
                coordinator=coord.id,
            )
            return
        # The coordinator has no resize in flight — this node missed the
        # commit or cancel.  Apply its authoritative status as if the
        # broadcast had arrived.
        self.node.api.receive_message(
            {
                "type": bc.MSG_CLUSTER_STATUS,
                "state": status.get("state", cluster.state),
                "coordinator": status.get("coordinator", coord.id),
                "nodes": status.get("nodes") or [],
                "availableShards": status.get("availableShards"),
            }
        )
        journal.record(
            ev.EVENT_RESIZE_WATCHDOG, action="recovered",
            coordinator=coord.id, state=status.get("state"),
        )


class NodeServer:
    def __init__(
        self,
        data_dir: str | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        device: str = "cuda",
        replica_n: int = 1,
        n_words: int = SHARD_WORDS,
        long_query_time: float = 0.0,
        stats_client=None,
        metric_poll_interval: float = 10.0,
        tls_cert: str | None = None,
        tls_key: str | None = None,
        tls_skip_verify: bool = False,
        tls_ca_cert: str | None = None,
        import_workers: int = 2,
        import_queue_depth: int = 16,
        max_writes_per_request: int | None = None,
        default_deadline: float = 0.0,
        client_timeout: float = 30.0,
        client_retry_budget: int = 2,
        breaker_threshold: int = 5,
        breaker_cooldown: float = 2.0,
        slow_query_time: float = 0.0,
        batch_window: float = 0.002,
        batch_max_size: int = 64,
        rescache_entries: int = 512,
        planner_enabled: bool = True,
        slo_objectives: dict | None = None,
        slo_burn_rules: list[dict] | None = None,
        slo_slot_seconds: float | None = None,
        slo_latency_window: float | None = None,
        trace_store_capacity: int = 256,
        trace_baseline_n: int = 128,
        flight_recorder: bool = True,
        flightrec_segment_seconds: float = 1.0,
        flightrec_sample_interval: float = 0.025,
        flightrec_segments: int = 60,
        flightrec_spike_504: int = 5,
        history_enabled: bool = True,
        history_cadence: float = 1.0,
        history_tiers: str = "300@1,240@15",
        history_detectors: str = "latency,throughput,errors",
        history_warmup: int = 10,
        history_trips: int = 3,
        history_latency_factor: float = 2.0,
        history_latency_min_ms: float = 20.0,
        resize_watchdog_deadline: float = 15.0,
        mesh_dispatch: bool = True,
        devledger_storm_threshold: int = 8,
        devledger_storm_window: float = 60.0,
        devledger_warmup: float = 120.0,
        qos_enabled: bool = True,
        blackbox_enabled: bool = True,
        blackbox_interval: float = 5.0,
        blackbox_max_segments: int = 64,
        blackbox_max_bytes: int = 16 << 20,
        blackbox_keep_postmortems: int = 4,
        blackbox_history_window: float = 60.0,
    ):
        self.host = host
        self.tls = bool(tls_cert)
        # the mesh route (parallel/meshplace.py): False keeps the node off
        # it both ways: it never registers, and its own fan-outs stay on
        # the HTTP relay
        self.mesh_dispatch = mesh_dispatch
        self.holder = Holder(n_words, device=device)
        # metrics backend; MemStatsClient serves /metrics and /debug/vars
        # (reference server.go:397-411 metric.service selection)
        self.holder.set_stats(
            stats_client if stats_client is not None else MemStatsClient()
        )
        # SLO knobs: any of them replaces the holder's default tracker
        # (tests and load runs shrink windows so burn shows in seconds)
        if (
            slo_objectives is not None
            or slo_burn_rules is not None
            or slo_slot_seconds is not None
            or slo_latency_window is not None
        ):
            rules = None
            if slo_burn_rules is not None:
                rules = tuple(
                    slo_mod.BurnRule(r["name"], r["long"], r["short"], r["factor"])
                    for r in slo_burn_rules
                )
            self.holder.slo = slo_mod.SLOTracker(
                objectives=(
                    slo_mod.objectives_from_dict(slo_objectives)
                    if slo_objectives is not None
                    else None
                ),
                burn_rules=rules,
                slot_seconds=slo_slot_seconds if slo_slot_seconds is not None else 5.0,
                latency_window=(
                    slo_latency_window if slo_latency_window is not None else 300.0
                ),
            )
            # the trace store's slow-keep thresholds and exemplar sink
            # live on the tracker
            self.holder.traces.slo = self.holder.slo
            self.holder.traces.on_keep = self.holder.slo.attach_exemplar
        self.holder.traces.capacity = max(1, int(trace_store_capacity))
        self.holder.traces.baseline_n = int(trace_baseline_n)
        self.store = None
        if data_dir is not None:
            self.store = HolderStore(self.holder, data_dir)
            self.store.open()
        node_id = self.store.node_id() if self.store else uuid.uuid4().hex
        # the journal, job tracker and trace store stamp this node's id
        self.holder.events.node_id = node_id
        self.holder.jobs.node_id = node_id
        self.holder.traces.node_id = node_id
        self.cluster = Cluster(node_id, replica_n=replica_n, disabled=True)
        # every cluster-state transition, local or from a peer's
        # broadcast, lands on the timeline
        self.cluster.on_state_change = lambda state: self.holder.events.record(
            ev.EVENT_CLUSTER_STATE, state=state
        )
        self.client = InternalClient(
            timeout=client_timeout,
            skip_verify=tls_skip_verify,
            ca_cert=tls_ca_cert,
            stats=self.holder.stats,
            retry_budget=client_retry_budget,
            breaker_threshold=breaker_threshold,
            breaker_cooldown=breaker_cooldown,
            # the jitter is seeded per node, so a fault run replays
            rng_seed=zlib.crc32(node_id.encode()),
            journal=self.holder.events,
        )
        self.broadcaster = HTTPBroadcaster(self.cluster, self.client, node_id)
        self.api = API(
            self.holder,
            self.store,
            cluster=self.cluster,
            client=self.client,
            broadcaster=self.broadcaster,
            import_workers=import_workers,
            import_queue_depth=import_queue_depth,
            max_writes_per_request=max_writes_per_request,
            batch_window=batch_window,
            batch_max_size=batch_max_size,
            rescache_entries=rescache_entries,
            planner_enabled=planner_enabled,
            qos_enabled=qos_enabled,
        )
        self._wire_shard_broadcasts()
        # new keys go to the translation primary (reference
        # translate.go:91-97); standing alone the proxy is the local store
        proxy = PrimaryTranslateStore(
            self.api.executor.translator, self.cluster, self.client
        )
        self.api.executor.translator = proxy
        self.server = Server(
            self.api,
            host=host,
            port=port,
            long_query_time=long_query_time,
            tls_cert=tls_cert,
            tls_key=tls_key,
            default_deadline=default_deadline,
            slow_query_time=slow_query_time,
        )
        # diagnostics and runtime metrics (reference server.go:433-436
        # monitorDiagnostics/monitorRuntime, gcnotify)
        self.diagnostics = Diagnostics(self.holder, self.cluster, version=__version__)
        self.api.diagnostics = self.diagnostics
        # the flight recorder and incident engine (obs/flightrec.py):
        # the segment ring, SLO-alert and 504-spike captures
        self.flightrec = None
        if flight_recorder:
            self.flightrec = FlightRecorder(
                self.holder,
                api=self.api,
                client=self.client,
                segment_seconds=flightrec_segment_seconds,
                sample_interval=flightrec_sample_interval,
                segments=flightrec_segments,
                spike_504=flightrec_spike_504,
            )
            self.api.flightrec = self.flightrec
        # the metrics history (obs/history.py): ring-buffer series sampled
        # each cadence, and trend detectors whose incidents carry their
        # own series windows
        self.history = None
        if history_enabled:
            self.history = MetricsHistory(
                self.holder,
                api=self.api,
                node_id=self.node_id,
                cadence=history_cadence,
                tiers=history_tiers,
                detectors=history_detectors,
                warmup=history_warmup,
                trips=history_trips,
                latency_factor=history_latency_factor,
                latency_min_ms=history_latency_min_ms,
            )
            self.api.history = self.history
            if self.flightrec is not None:
                self.history.flightrec = self.flightrec
                self.flightrec.series_provider = self.history.incident_series
        # the device ledger's storm detector, wired as JAX's (it never
        # trips here: no launch compiles, obs/devledger.py). The ledger is
        # process-global: the last node configured wins.
        devledger.configure_storm(
            threshold=devledger_storm_threshold,
            window_s=devledger_storm_window,
            warmup_s=devledger_warmup,
        )
        if self.flightrec is not None:
            devledger.on_storm(self.flightrec.capture_incident)
        # the black box (obs/blackbox.py): only with a data dir, since a
        # diskless node has nowhere to survive a crash. Opening it seals a
        # dirty previous life's spool into the postmortem.
        self.blackbox = None
        self.postmortem = None
        if blackbox_enabled and data_dir is not None:
            self.blackbox = bb.BlackBox(
                self.holder,
                data_dir,
                api=self.api,
                flightrec=self.flightrec,
                history=self.history,
                node_id=self.node_id,
                interval=blackbox_interval,
                max_segments=blackbox_max_segments,
                max_bytes=blackbox_max_bytes,
                keep_postmortems=blackbox_keep_postmortems,
                history_window=blackbox_history_window,
            )
            self.api.blackbox = self.blackbox
            self.postmortem = self.blackbox.open()
            if self.flightrec is not None:
                # an incident reaches disk the moment it freezes
                self.flightrec.on_incident = self.blackbox.flush_incident
        self.gc_notifier = GCNotifier()
        self.runtime_monitor = RuntimeMonitor(
            self.holder.stats,
            interval=metric_poll_interval,
            gc_notifier=self.gc_notifier,
        )
        self.membership = None  # started on demand (start_membership)
        self._ae_loop = None  # the anti-entropy loop (start_anti_entropy)
        # the stuck-resize backstop, on by default as JAX's (0 turns it off)
        self.resize_watchdog = None
        if resize_watchdog_deadline > 0:
            self.resize_watchdog = ResizeWatchdog(
                self, deadline=resize_watchdog_deadline
            )
        self._stopped = False
        self._done = threading.Event()

    @property
    def uri(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.host}:{self.server.port}"

    @property
    def node_id(self) -> str:
        return self.cluster.node_id

    # -- shard availability broadcasts (reference view.go:239-261
    #    CreateShardMessage) ------------------------------------------------

    def _wire_shard_broadcasts(self) -> None:
        """Chain a create-shard broadcast after any existing (storage)
        fragment-creation hook, so peers learn the shards this node
        holds."""

        def wire_field(idx, field):
            prev = field.on_create_fragment

            def on_fragment(view, shard, _prev=prev, _index=idx.name, _field=field.name):
                if _prev is not None:
                    _prev(view, shard)
                self._broadcast_shard(_index, _field, shard)

            field.on_create_fragment = on_fragment
            for view in field.views.values():
                view.on_create_fragment = on_fragment

        def wire_index(idx):
            prev = idx.on_create_field

            def on_field(idx2, field, _prev=prev):
                if _prev is not None:
                    _prev(idx2, field)
                wire_field(idx2, field)

            idx.on_create_field = on_field
            for f in list(idx.fields.values()):
                wire_field(idx, f)

        prev_idx = self.holder.on_create_index

        def on_index(idx, _prev=prev_idx):
            if _prev is not None:
                _prev(idx)
            wire_index(idx)

        self.holder.on_create_index = on_index
        for idx in list(self.holder.indexes.values()):
            wire_index(idx)

    def _broadcast_shard(self, index: str, field: str, shard: int) -> None:
        if len(self.cluster.nodes) <= 1:
            return
        try:
            self.broadcaster.send_sync(
                {
                    "type": bc.MSG_CREATE_SHARD,
                    "index": index,
                    "field": field,
                    "shard": shard,
                }
            )
        except Exception:
            # an advisory broadcast must not fail the write path: shard
            # availability converges again through the status exchange
            self.holder.stats.count("broadcast_errors", 1)

    def join_static(self, members: list[tuple[str, str]], coordinator_id: str) -> None:
        """Fix the cluster's membership (reference cluster.go:2000
        setStatic); ``members`` is ``[(node_id, uri), ...]``, this node
        included, of either package.

        Joining also makes the state handshake: the coordinator's status
        (schema and available-shard map) is pulled and applied at once, so
        a (re)started node answers schema-dependent queries before any
        later repair (the reference exchanges the full NodeStatus on every
        memberlist push/pull, gossip.go:321-357). Best effort: at a
        cluster's first formation the coordinator may not be up yet."""
        self.cluster.coordinator_id = coordinator_id
        self.cluster.disabled = False
        self.cluster.set_static([Node(id=i, uri=u) for i, u in members])
        self.holder.events.record(
            ev.EVENT_MEMBERSHIP_SET,
            members=[i for i, _ in members],
            coordinator=coordinator_id,
        )
        if coordinator_id == self.cluster.node_id:
            return
        coord = self.cluster.node(coordinator_id)
        if coord is None or not coord.uri:
            return
        try:
            status = self.client.status(coord.uri)
        except Exception as e:
            logger.warning(
                "join handshake with coordinator %s failed: %s", coordinator_id, e
            )
            return
        schema = status.get("schema")
        if schema:
            try:
                self.holder.apply_schema(schema)
            except Exception as e:
                logger.warning("join handshake schema apply failed: %s", e)
        if status.get("availableShards"):
            self.api.merge_available_shards(status["availableShards"])

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.server.serve_background()
        self.cluster.local_node.uri = self.uri
        if self.mesh_dispatch and meshplace.enabled():
            meshplace.default_placement().register(self.node_id, self.holder)
        else:
            self.api.dist.mesh_enabled = False
        self.runtime_monitor.start()
        if self.flightrec is not None:
            self.flightrec.start()
        if self.history is not None:
            self.history.start()
        if self.resize_watchdog is not None:
            self.resize_watchdog.start()
        if self.blackbox is not None:
            self.blackbox.start()
        self.holder.events.record(
            ev.EVENT_NODE_START, uri=self.uri, state=self.api.state
        )

    # -- the elastic planes -------------------------------------------------

    def start_anti_entropy(self, interval: float) -> None:
        """The anti-entropy loop (reference server.go:494-546
        monitorAntiEntropy): one ``sync_holder`` pass per interval, block
        checksum repair between replicas and the translate-log pull. It
        keeps running in DEGRADED (repair between survivors matters most
        then); only RESIZING and STARTING skip. Idempotent; ``stop`` ends
        it."""
        if interval <= 0:
            return
        old = self._ae_loop
        if old is not None:
            if old._thread is not None and old._thread.is_alive():
                return  # running, or a stopped pass still draining
            self._ae_loop = None
        self._ae_loop = AntiEntropyLoop(
            self.syncer(), interval, state_fn=lambda: self.api.state
        )
        self._ae_loop.start()

    def resize_coordinator(self) -> ResizeCoordinator:
        """The resize entry point; valid only on the coordinator
        (reference cluster.go:1171 unprotectedGenerateResizeJob)."""
        if not self.cluster.is_coordinator:
            raise ResizeError("resize must run on the coordinator")
        return ResizeCoordinator(self.cluster, self.client, self.api)

    def syncer(self) -> HolderSyncer:
        """The anti-entropy syncer of this node (reference holderSyncer)."""
        return HolderSyncer(self.holder, self.cluster, self.client, self.api)

    def start_membership(
        self, probe_interval: float = 1.0, confirm_retries: int = 10,
        confirm_interval: float = 0.1,
    ) -> MembershipMonitor:
        """Heartbeat failure detection over the current membership
        (reference gossip probes and confirmNodeDown,
        cluster.go:1699-1768)."""
        if self.membership is None:
            self.membership = MembershipMonitor(
                self.cluster,
                self.client,
                broadcaster=self.broadcaster,
                probe_interval=probe_interval,
                confirm_retries=confirm_retries,
                confirm_interval=confirm_interval,
                journal=self.holder.events,
            )
            self.membership.start()
        return self.membership

    def shutdown_graceful(self) -> None:
        """The orderly SIGTERM path: journal ``node-stop`` (so the black
        box's final checkpoint carries it), then the full stop: drain the
        batcher and QoS queues, stop the samplers, write the clean-shutdown
        marker. Callers (the signal handler, the CLI) exit 0 afterwards."""
        if self._stopped:
            return
        self.holder.events.record(ev.EVENT_NODE_STOP, uri=self.uri)
        self.stop()

    def install_signal_handlers(self) -> bool:
        """Route SIGTERM through :meth:`shutdown_graceful`. Returns False
        off the main thread, where Python cannot install handlers."""
        return bb.install_signal_handlers(self)

    def stop(self) -> None:
        if self._stopped:
            return  # the SIGTERM handler and the CLI's finally both land here
        self._stopped = True
        bb.uninstall_signal_handlers(self)
        # withdraw from the placement map first: peers must stop reading
        # this holder's fragments before it tears down
        meshplace.default_placement().unregister(self.node_id)
        try:
            if self._ae_loop is not None:
                # the reference is kept even when a slow pass outlives the
                # join, so a restart cannot run a second loop beside it
                self._ae_loop.stop()
            if self.membership is not None:
                self.membership.stop()
            if self.resize_watchdog is not None:
                self.resize_watchdog.stop()
            if self.history is not None:
                self.history.stop()
            if self.flightrec is not None:
                self.flightrec.stop()
            self.runtime_monitor.stop()
            self.diagnostics.stop()
            self.gc_notifier.close()
            self.server.close()
            if self.blackbox is not None:
                # last: the final checkpoint captures the drained planes,
                # then the clean marker seals this life as orderly
                self.blackbox.close(clean=True)
        finally:
            self._done.set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until :meth:`stop` has finished; True once it has."""
        return self._done.wait(timeout)
