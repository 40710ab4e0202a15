"""One serving node: holder, data directory, stats client, API and HTTP
server (counterpart of ``pilosa_tpu/server/node.py``; reference
server.go composition root).

The node opens its data directory with :class:`HolderStore` on the
holder's device (``cuda`` unless the caller passes ``device="cpu"``) and
serves it over HTTP, with the JAX node's serving defaults: the batcher
(``batch_window=0.002``, ``batch_max_size=64``), the result cache
(``rescache_entries=512``), the flight planner, the QoS governor and the
ingest pipeline (``server/api.py``). It is one node: no cluster,
membership, anti-entropy or resize, and none of the JAX node's flight
recorder, metrics history or black box.
"""

from __future__ import annotations

import signal
import threading
import uuid

from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.obs import events as ev
from pilosa_tpu_torch.obs.stats import MemStatsClient
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.http import Server
from pilosa_tpu_torch.storage.disk import HolderStore


class NodeServer:
    def __init__(
        self,
        data_dir: str | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        device: str = "cuda",
        long_query_time: float = 0.0,
        stats_client=None,
        tls_cert: str | None = None,
        tls_key: str | None = None,
        import_workers: int = 2,
        import_queue_depth: int = 16,
        max_writes_per_request: int | None = None,
        batch_window: float = 0.002,
        batch_max_size: int = 64,
        rescache_entries: int = 512,
        planner_enabled: bool = True,
        qos_enabled: bool = True,
    ):
        self.host = host
        self.tls = bool(tls_cert)
        self.holder = Holder(device=device)
        # metrics backend; MemStatsClient serves /metrics and /debug/vars
        # (reference server.go:397-411 metric.service selection)
        self.holder.set_stats(
            stats_client if stats_client is not None else MemStatsClient()
        )
        self.store = None
        if data_dir is not None:
            self.store = HolderStore(self.holder, data_dir)
            self.store.open()
        self.node_id = self.store.node_id() if self.store else uuid.uuid4().hex
        # the journal, job tracker and trace store stamp this node's id
        self.holder.events.node_id = self.node_id
        self.holder.jobs.node_id = self.node_id
        self.holder.traces.node_id = self.node_id
        self.api = API(
            self.holder,
            self.store,
            import_workers=import_workers,
            import_queue_depth=import_queue_depth,
            max_writes_per_request=max_writes_per_request,
            batch_window=batch_window,
            batch_max_size=batch_max_size,
            rescache_entries=rescache_entries,
            planner_enabled=planner_enabled,
            qos_enabled=qos_enabled,
        )
        self.server = Server(
            self.api,
            host=host,
            port=port,
            long_query_time=long_query_time,
            tls_cert=tls_cert,
            tls_key=tls_key,
        )
        self._stopped = False
        self._done = threading.Event()
        self._prev_sigterm = None

    @property
    def uri(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.host}:{self.server.port}"

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.server.serve_background()
        self.holder.events.record(
            ev.EVENT_NODE_START, uri=self.uri, state=self.api.state
        )

    def shutdown_graceful(self) -> None:
        """The orderly SIGTERM path: journal ``node-stop``, then the full
        stop. Callers (the signal handler, the CLI) exit 0 afterwards."""
        if self._stopped:
            return
        self.holder.events.record(ev.EVENT_NODE_STOP, uri=self.uri)
        self.stop()

    def install_signal_handlers(self) -> bool:
        """Route SIGTERM through :meth:`shutdown_graceful`. Returns False
        off the main thread, where Python cannot install handlers."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def on_term(signum, frame):
            # the handler runs on the main thread: stop from a helper so a
            # main thread parked in the server's own loop is not the one
            # waiting for that loop to end
            threading.Thread(target=self.shutdown_graceful, name="node-stop").start()

        self._prev_sigterm = signal.signal(signal.SIGTERM, on_term)
        return True

    def stop(self) -> None:
        if self._stopped:
            return  # the SIGTERM handler and the CLI's finally both land here
        self._stopped = True
        if (
            self._prev_sigterm is not None
            and threading.current_thread() is threading.main_thread()
        ):
            signal.signal(signal.SIGTERM, self._prev_sigterm)
        try:
            self.server.close()
        finally:
            self._done.set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until :meth:`stop` has finished; True once it has."""
        return self._done.wait(timeout)
