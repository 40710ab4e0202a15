"""Internal node↔node HTTP client (counterpart of
``pilosa_tpu/cluster/client.py``; reference: client.go InternalClient
interface :47-76, http/client.go implementation).

All node↔node data-plane traffic goes through this client: query
fan-out, import forwarding, fragment block retrieval for anti-entropy,
whole-fragment streaming for resize, and control messages. JSON replaces
the reference's protobuf codec.
"""

from __future__ import annotations

import gzip
import http.client
import json
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

import numpy as np

from pilosa_tpu_torch import deadline
from pilosa_tpu_torch.deadline import DeadlineExceeded
from pilosa_tpu_torch.obs import events as ev
from pilosa_tpu_torch.obs import tracing
from pilosa_tpu_torch.obs.stats import NOP
from pilosa_tpu_torch.testing import faults


class ClientError(Exception):
    def __init__(self, msg: str, code: int = 0):
        super().__init__(msg)
        self.code = code


# -- circuit breaker ---------------------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"


class CircuitBreaker:
    """Per-peer transport-failure breaker (closed -> open after
    ``threshold`` consecutive transport failures -> half-open probe
    after ``cooldown`` -> closed on success / open on failure).

    Purely ADVISORY: the client never refuses a request because of a
    tripped breaker — routing layers (``dist._group_by_live_owner``)
    consult :meth:`allow` to steer fan-outs around a flapping peer
    BEFORE the membership monitor confirms it down, and recovery flows
    through the half-open probe that routing sends.  HTTP status errors
    do not count (the peer's transport is alive); only connect/send/
    receive failures and timeouts do.

    State transitions are counted on the stats client
    (``circuit_breaker_transitions{peer:..,to:..}``) so breaker churn is
    observable at /metrics and /debug/vars.
    """

    def __init__(
        self,
        peer: str,
        threshold: int = 5,
        cooldown: float = 2.0,
        stats=NOP,
        journal=None,
    ):
        self.peer = peer
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self.stats = stats
        self.journal = journal  # EventJournal, optional
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        """Move to ``to`` (lock held) and count the edge."""
        from_state = self._state
        self._state = to
        self.stats.count_with_tags(
            "circuit_breaker_transitions", 1, 1.0,
            (f"peer:{self.peer}", f"to:{to}"),
        )
        if self.journal is not None:
            # EventJournal.record takes its own independent lock and
            # never calls back into the breaker, so recording under this
            # lock cannot deadlock.
            self.journal.record(
                ev.EVENT_CIRCUIT_BREAKER, peer=self.peer,
                from_state=from_state, to=to,
                failures=self._failures,
            )

    def allow(self) -> bool:
        """May a NEW request be routed at this peer right now?  In the
        open state, the first call after the cooldown converts to a
        half-open probe slot (exactly one in flight)."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN:
                if time.monotonic() - self._opened_at >= self.cooldown:
                    self._transition(BREAKER_HALF_OPEN)
                    self._probing = True
                    return True
                return False
            # half-open: one probe at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != BREAKER_CLOSED:
                self._transition(BREAKER_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == BREAKER_HALF_OPEN or (
                self._state == BREAKER_CLOSED
                and self._failures >= self.threshold
            ):
                self._opened_at = time.monotonic()
                self._transition(BREAKER_OPEN)


class _ConnPool:
    """Keep-alive connection pool per (scheme, host:port).

    urllib opens a fresh TCP connection per request, so every
    node↔node call paid connection setup (plus a TLS handshake on
    https clusters); the serving HTTP stack speaks HTTP/1.1 with
    persistent connections, so pooled ``http.client`` connections cut
    the per-call floor the way the reference's ``http.Transport``
    connection reuse does (reference http/client.go uses Go's pooled
    default transport)."""

    MAX_IDLE_PER_HOST = 8

    def __init__(self, timeout: float, ssl_ctx):
        self._timeout = timeout
        self._ssl_ctx = ssl_ctx
        self._idle: dict[tuple[str, str], list] = {}
        self._lock = threading.Lock()

    def _new_conn(self, scheme: str, netloc: str):
        if scheme == "https":
            import ssl

            ctx = self._ssl_ctx
            if ctx is None:
                ctx = ssl.create_default_context()
            conn = http.client.HTTPSConnection(
                netloc, timeout=self._timeout, context=ctx
            )
        else:
            conn = http.client.HTTPConnection(netloc, timeout=self._timeout)
        # TCP_NODELAY: without it, Nagle + delayed-ACK adds ~40 ms to
        # every small request/response pair on a reused connection
        conn.connect()
        import socket

        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _checkout(self, key):
        with self._lock:
            conns = self._idle.get(key)
            if conns:
                return conns.pop()
        return None

    def _checkin(self, key, conn) -> None:
        with self._lock:
            conns = self._idle.setdefault(key, [])
            if len(conns) < self.MAX_IDLE_PER_HOST:
                conns.append(conn)
                return
        conn.close()

    def request(
        self,
        method: str,
        url: str,
        body: bytes | None,
        headers: dict,
        idempotent: bool = True,
        timeout: float | None = None,
    ) -> tuple[int, bytes, str]:
        """(status, body, content-type); raises OSError-family on
        transport failure after one retry on a stale pooled
        connection.  ``idempotent=False`` restricts that retry to
        failures during the SEND phase: once the request has been
        handed to the kernel, the server may have executed it, and
        replaying a non-idempotent request could double-apply it.

        ``timeout`` overrides the pool default for THIS request — the
        deadline-aware client derives it from the remaining budget so a
        request with 0.3s left doesn't block 30s on a stalled peer."""
        parts = urllib.parse.urlsplit(url)
        key = (parts.scheme, parts.netloc)
        path = parts.path + (f"?{parts.query}" if parts.query else "")
        t = self._timeout if timeout is None else timeout
        injected = faults.network_fault(parts.netloc, parts.path, t)
        if injected is not None:
            return injected
        # a pooled connection may have been closed by the server's
        # keep-alive timeout: retry ONCE on a fresh connection, but only
        # when the stale candidate came from the pool
        pooled = self._checkout(key)
        for attempt, conn in enumerate(
            (pooled, None) if pooled is not None else (None,)
        ):
            fresh = conn is None
            if fresh:
                conn = self._new_conn(parts.scheme, parts.netloc)
            conn.timeout = t
            if conn.sock is not None:
                conn.sock.settimeout(t)
            sent = False
            try:
                conn.request(method, path, body=body, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError):
                conn.close()
                if fresh or (sent and not idempotent):
                    raise
                continue  # stale pooled connection; retry fresh
            if resp.will_close:
                conn.close()
            else:
                self._checkin(key, conn)
            if (resp.headers.get("Content-Encoding") or "").lower() == "gzip":
                # transparent decode: callers asked for gzip on the wire
                # (Accept-Encoding), not in their hands
                data = gzip.decompress(data)
            return (
                resp.status,
                data,
                resp.headers.get("Content-Type") or "",
            )
        raise ClientError("connection retry logic exhausted")  # unreachable


class InternalClient:
    def __init__(
        self,
        timeout: float = 30.0,
        skip_verify: bool = False,
        ca_cert: str | None = None,
        stats=None,
        retry_budget: int = 2,
        backoff_base: float = 0.05,
        backoff_cap: float = 1.0,
        breaker_threshold: int = 5,
        breaker_cooldown: float = 2.0,
        rng_seed: int | None = None,
        journal=None,
    ):
        self.timeout = timeout
        self.stats = NOP if stats is None else stats
        self.journal = journal  # EventJournal; breakers record into it
        # Retry budget: transport failures retry with full-jitter
        # exponential backoff, at most ``retry_budget`` extra attempts
        # per request, never past the remaining deadline, and only for
        # idempotent requests (reference retries imports once,
        # http/client.go; we generalise with a bounded budget).
        self.retry_budget = max(0, int(retry_budget))
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        # Seeded so chaos tests replay the same jitter sequence.
        self._rng = random.Random(rng_seed)
        self._rng_lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self._netlocs: dict[str, str] = {}  # uri -> netloc (peers only)
        # TLS: a None context means urlopen verifies with the default
        # verifying context; ``ca_cert`` pins a private CA for
        # intra-cluster certs, and verification is only skipped when the
        # operator explicitly opts in (reference honours tls.skip-verify
        # only when set, server/server.go:230; CA option
        # server/config.go:36-152 tls.ca-certificate).
        self._ssl_ctx = None
        if skip_verify:
            import ssl

            self._ssl_ctx = ssl._create_unverified_context()
        elif ca_cert:
            import ssl

            self._ssl_ctx = ssl.create_default_context(cafile=ca_cert)
        self._pool = _ConnPool(timeout, self._ssl_ctx)

    # -- circuit breakers ---------------------------------------------------

    def _breaker(self, netloc: str) -> CircuitBreaker:
        with self._breakers_lock:
            br = self._breakers.get(netloc)
            if br is None:
                br = CircuitBreaker(
                    netloc,
                    threshold=self.breaker_threshold,
                    cooldown=self.breaker_cooldown,
                    stats=self.stats,
                    journal=self.journal,
                )
                self._breakers[netloc] = br
            return br

    def breaker_states(self) -> dict[str, str]:
        """Current per-peer breaker state by netloc (flight-recorder
        segment field: breaker flaps line up with latency segments)."""
        with self._breakers_lock:
            return {n: br.state for n, br in self._breakers.items()}

    def peer_available(self, uri: str) -> bool:
        """Advisory routing check: False while ``uri``'s breaker is open
        (and not yet due for a half-open probe).  ``dist`` consults this
        to steer fan-outs toward surviving replicas; it never blocks a
        request that routing decides to send anyway."""
        # memoized: this sits on the per-query routing path and peers
        # are a small fixed set — parsing the uri each call shows up in
        # profiles at serving qps
        netloc = self._netlocs.get(uri)
        if netloc is None:
            netloc = urllib.parse.urlsplit(uri).netloc
            self._netlocs[uri] = netloc
        return self._breaker(netloc).allow()

    def _backoff(self, attempt: int) -> float:
        """Full-jitter exponential backoff for retry ``attempt`` (1-based)."""
        ceiling = min(self.backoff_cap, self.backoff_base * (2 ** (attempt - 1)))
        with self._rng_lock:
            return self._rng.random() * ceiling

    # -- plumbing -----------------------------------------------------------

    def _do_full(
        self,
        method: str,
        uri: str,
        path: str,
        body: bytes | None = None,
        content_type: str = "application/json",
        accept: str | None = None,
        idempotent: bool = True,
        retries: int | None = None,
        gzip_ok: bool = False,
    ) -> tuple[bytes, str]:
        """(body, response content-type).

        ``idempotent`` defaults True because every internal endpoint
        today is a merge or find-or-create (imports union bits, schema
        ops are create-if-absent, translate appends are keyed by name,
        resize ops are target-state): replaying any of them is safe.  A
        FUTURE endpoint with execute-once semantics must pass False so
        the pool won't replay it after a stale-connection failure.

        ``retries`` overrides the client retry budget for this call
        (liveness probes pass 0 so a down-check stays prompt)."""
        headers: dict = {}
        if body is not None:
            headers["Content-Type"] = content_type
        if accept is not None:
            headers["Accept"] = accept
        if gzip_ok:
            # large debug snapshots (history/traces/postmortem) compress
            # ~10x; the pool decodes transparently on the way back
            headers["Accept-Encoding"] = "gzip"
        # Propagate the active trace across the node boundary (reference
        # tracing/opentracing.go:58-66 InjectHTTPHeaders).
        span = tracing.active_span()
        if span is not None:
            tracing.get_tracer().inject_headers(span.context, headers)
        netloc = urllib.parse.urlsplit(uri).netloc
        breaker = self._breaker(netloc)
        budget = self.retry_budget if retries is None else max(0, int(retries))
        if not idempotent:
            budget = 0  # backoff retries would replay a received request
        attempt = 0
        while True:
            # Per-hop timeout from the remaining deadline budget: fail
            # fast when it is already spent, and never let the socket
            # outlive what the caller is willing to wait.
            rem = deadline.remaining()
            if rem is not None:
                if rem <= 0:
                    self.stats.count("client_deadline_exceeded", 1, 1.0)
                    raise DeadlineExceeded(
                        f"deadline exceeded before {method} {path} to {netloc}"
                    )
                headers[deadline.HEADER] = format(rem, ".4f")
                hop_timeout = min(self.timeout, rem)
            else:
                hop_timeout = self.timeout
            try:
                status, data, ctype = self._pool.request(
                    method,
                    uri.rstrip("/") + path,
                    body,
                    headers,
                    idempotent=idempotent,
                    timeout=hop_timeout,
                )
            except (http.client.HTTPException, OSError, TimeoutError) as e:
                breaker.record_failure()
                if attempt >= budget:
                    raise ClientError(f"{method} {path}: {e}") from e
                attempt += 1
                delay = self._backoff(attempt)
                rem = deadline.remaining()
                if rem is not None and rem <= delay:
                    # no budget left to wait out the backoff
                    self.stats.count("client_deadline_exceeded", 1, 1.0)
                    raise DeadlineExceeded(
                        f"deadline exceeded retrying {method} {path} to "
                        f"{netloc}: {e}"
                    ) from e
                self.stats.count("client_retries", 1, 1.0)
                time.sleep(delay)
                continue
            breaker.record_success()
            if status >= 400:
                detail = data.decode(errors="replace")[:500]
                raise ClientError(f"{method} {path}: {status} {detail}", status)
            return data, ctype

    def _do(
        self,
        method: str,
        uri: str,
        path: str,
        body: bytes | None = None,
        content_type: str = "application/json",
        gzip_ok: bool = False,
    ) -> bytes:
        return self._do_full(
            method, uri, path, body, content_type, gzip_ok=gzip_ok
        )[0]

    def _json(
        self,
        method: str,
        uri: str,
        path: str,
        obj: Any = None,
        gzip_ok: bool = False,
    ) -> Any:
        body = None if obj is None else json.dumps(obj).encode()
        out = self._do(method, uri, path, body, gzip_ok=gzip_ok)
        return json.loads(out) if out else None

    # -- queries (reference http/client.go QueryNode) -----------------------

    def query_node(
        self, uri: str, index: str, query: str, shards: list[int],
        profile: bool = False,
    ) -> dict:
        """Execute on a remote node against its shard list; returns the
        response dict — ``"wireResults"`` plus, when ``profile`` is set,
        the remote node's ``"profile"`` sub-tree for the coordinator's
        merge (reference executor.go:2416-2434 remoteExec)."""
        req = {"query": query, "shards": shards, "remote": True}
        if profile:
            req["profile"] = True
        return self._json("POST", uri, f"/index/{index}/query", req)

    # -- imports (reference http/client.go Import/ImportRoaring) ------------

    def import_bits(self, uri: str, index: str, field: str, req: dict) -> None:
        """Forward an import slice.  Translated id batches travel as
        packed roaring/array blobs (cluster/wire.py encode_import — the
        reference protobuf-encodes every import, proto.go); key-carrying
        or timestamped requests fall back to JSON."""
        from pilosa_tpu_torch.cluster import wire

        body = wire.encode_import(dict(req, remote=True))
        if body is not None:
            self._do(
                "POST",
                uri,
                f"/index/{index}/field/{field}/import",
                body,
                content_type="application/octet-stream",
            )
            return
        jr = {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in req.items()
            if not k.startswith("_")
        }
        self._json(
            "POST", uri, f"/index/{index}/field/{field}/import", dict(jr, remote=True)
        )

    def import_roaring(
        self, uri: str, index: str, field: str, shard: int, data: bytes,
        clear: bool = False, view: str = "standard",
    ) -> dict:
        q = f"?remote=true&clear={'true' if clear else 'false'}&view={view}"
        out = self._do(
            "POST",
            uri,
            f"/index/{index}/field/{field}/import-roaring/{shard}{q}",
            data,
            content_type="application/octet-stream",
        )
        return json.loads(out) if out else {}

    # -- fragment data (anti-entropy + resize) ------------------------------

    def fragment_blocks(
        self, uri: str, index: str, field: str, view: str, shard: int
    ) -> list[dict]:
        """Block checksums (reference http/client.go FragmentBlocks)."""
        resp = self._json(
            "GET",
            uri,
            f"/internal/fragment/blocks?index={index}&field={field}"
            f"&view={view}&shard={shard}",
        )
        return resp["blocks"]

    def block_data(
        self, uri: str, index: str, field: str, view: str, shard: int,
        block: int, width: int | None = None,
    ) -> dict:
        """Row/col pairs of one block (reference BlockData). With
        ``width`` (the fragment's shard width) the transfer is a packed
        roaring blob of row*width+col positions; JSON only when the peer
        declines (unencodable row ids or legacy node)."""
        body = json.dumps(
            {"index": index, "field": field, "view": view,
             "shard": shard, "block": block}
        ).encode()
        out, ctype = self._do_full(
            "POST",
            uri,
            "/internal/fragment/block/data",
            body,
            accept="application/octet-stream" if width else None,
        )
        if width and "application/octet-stream" in ctype:
            from pilosa_tpu_torch.storage import roaring

            positions = roaring.deserialize(out)
            w = int(width)
            return {
                "rows": (positions // w).tolist(),
                "cols": (positions % w).tolist(),
            }
        return json.loads(out)

    def attr_blocks(self, uri: str, index: str, field: str | None) -> list[dict]:
        """Attr block checksums (reference http/client.go attr diff calls,
        holder.go:747-839 syncIndex/syncField)."""
        q = f"?index={index}" + (f"&field={field}" if field else "")
        return self._json("GET", uri, f"/internal/attr/blocks{q}")["blocks"]

    def attr_block_data(
        self, uri: str, index: str, field: str | None, block: int
    ) -> dict:
        resp = self._json(
            "POST",
            uri,
            "/internal/attr/block/data",
            {"index": index, "field": field, "block": block},
        )
        return {int(k): v for k, v in resp["attrs"].items()}

    def retrieve_fragment(
        self, uri: str, index: str, field: str, view: str, shard: int
    ) -> bytes:
        """Whole-fragment snapshot stream for resize (reference
        RetrieveShardFromURI http/client.go)."""
        return self._do(
            "GET",
            uri,
            f"/internal/fragment/data?index={index}&field={field}"
            f"&view={view}&shard={shard}",
        )

    def fragment_list(self, uri: str) -> list[dict]:
        """Node's full fragment inventory for resize planning (reference
        fragsByHost cluster.go:687)."""
        return self._json("GET", uri, "/internal/fragments")["fragments"]

    def resize_fetch(self, uri: str, req: dict) -> None:
        """Tell a node to fetch the listed fragments from their sources
        (reference followResizeInstruction cluster.go:1272)."""
        self._json("POST", uri, "/internal/resize/fetch", req)

    # -- online migration (snapshot stream + op-log catch-up) ---------------

    def migrate_begin(
        self, uri: str, index: str, field: str, view: str, shard: int,
        chunk_bytes: int | None = None,
    ) -> dict:
        """Open a migration session on the source: pins a snapshot cut
        and installs the delta tap.  Returns ``{token, size, opN}``."""
        req: dict = {
            "index": index, "field": field, "view": view, "shard": shard,
        }
        if chunk_bytes:
            req["chunkBytes"] = int(chunk_bytes)
        return self._json("POST", uri, "/internal/migrate/begin", req)

    def migrate_chunk(self, uri: str, token: str, offset: int) -> bytes:
        """One snapshot chunk at ``offset``.  GET + offset-addressed =
        idempotent, so a crashed/retried target resumes mid-stream."""
        return self._do(
            "GET", uri,
            f"/internal/migrate/chunk?token={token}&offset={int(offset)}",
        )

    def migrate_delta(self, uri: str, token: str) -> tuple[dict, bytes]:
        """Drain one op-log catch-up round; returns the frame header
        (``ops``, ``pending``) and the raw op-record blob."""
        from pilosa_tpu_torch.cluster import wire

        body = self._do(
            "POST", uri, "/internal/migrate/delta",
            json.dumps({"token": token}).encode(),
        )
        return wire.decode_migrate_frame(body)

    def migrate_end(self, uri: str, token: str) -> None:
        """Close a migration session (uninstalls the tap)."""
        self._json("POST", uri, "/internal/migrate/end", {"token": token})

    def migrate_fetch(self, uri: str, req: dict) -> dict:
        """Tell a target to pull the listed fragments (snapshot stream +
        catch-up) and HOLD the sessions open for the finalize drain."""
        return self._json("POST", uri, "/internal/migrate/fetch", req)

    def migrate_finalize(self, uri: str, req: dict) -> dict:
        """Tell a target to drain final deltas + close its held sessions
        (called after the ownership flip broadcast)."""
        return self._json("POST", uri, "/internal/migrate/finalize", req)

    # -- control plane ------------------------------------------------------

    def send_message(self, uri: str, msg: dict) -> None:
        self._json("POST", uri, "/internal/cluster/message", msg)

    def status(self, uri: str) -> dict:
        return self._json("GET", uri, "/status")

    def version(self, uri: str) -> dict:
        """Liveness double-check (reference confirmNodeDown
        cluster.go:1699-1726 probes /version).  ``retries=0``: a probe
        that backs off just delays the down-confirmation it exists to
        speed up — MembershipMonitor owns the retry cadence."""
        out, _ = self._do_full("GET", uri, "/version", retries=0)
        return json.loads(out) if out else None

    def debug_events(self, uri: str, since: int = 0) -> dict:
        """Pull a peer's local event journal (coordinator timeline merge
        fans out through here)."""
        return self._json("GET", uri, f"/debug/events?since={int(since)}")

    def debug_traces(self, uri: str, limit: int = 100) -> dict:
        """Pull a peer's kept-trace summaries (cluster trace list)."""
        return self._json(
            "GET", uri, f"/debug/traces?limit={int(limit)}", gzip_ok=True
        )

    def debug_trace_spans(self, uri: str, trace_id: str) -> dict:
        """Pull the spans a peer holds for one trace id (cluster trace
        assembly) — kept or merely recent on that node."""
        return self._json(
            "GET", uri, f"/debug/traces?id={trace_id}&spans=true",
            gzip_ok=True,
        )

    def debug_history(
        self,
        uri: str,
        series=None,
        since: int | None = None,
        step: float | None = None,
        limit: int | None = None,
    ) -> dict:
        """Pull a peer's local metrics-history window (the cluster
        timeline merge fans out through here)."""
        params = []
        if series:
            if not isinstance(series, str):
                series = ",".join(series)
            params.append("series=" + urllib.parse.quote(series, safe=""))
        if since is not None:
            params.append(f"since={int(since)}")
        if step is not None:
            params.append(f"step={float(step)}")
        if limit is not None:
            params.append(f"limit={int(limit)}")
        qs = ("?" + "&".join(params)) if params else ""
        return self._json("GET", uri, f"/debug/history{qs}", gzip_ok=True)

    def debug_postmortem(self, uri: str, postmortem_id: str | None = None) -> dict:
        """Pull a peer's sealed crash bundles (the coordinator's
        ``?cluster=true`` merge fans out through here)."""
        qs = f"?id={postmortem_id}" if postmortem_id else ""
        return self._json(
            "GET", uri, f"/debug/postmortem{qs}", gzip_ok=True
        )

    def shards_max(self, uri: str) -> dict:
        """Per-index max shard seen by ``uri`` (reference
        client.go:176 MaxShardByIndex)."""
        return self._json("GET", uri, "/internal/shards/max")

    def nodes(self, uri: str) -> list:
        """Cluster node list as seen by ``uri`` (reference
        client.go:139 Nodes)."""
        return self._json("GET", uri, "/internal/nodes")

    def translate_keys(
        self, uri: str, index: str, field: str | None, keys: list[str]
    ) -> list[int]:
        return self._json(
            "POST",
            uri,
            "/internal/translate/keys",
            {"index": index, "field": field, "keys": keys},
        )["ids"]

    def translate_log(
        self, uri: str, offset: int
    ) -> tuple[list[tuple[str, str, str, int]], int, int]:
        """(entries, new_offset, primary_log_len) since ``offset`` — the
        replica streaming pull (reference translate.go:91-97)."""
        out = self._json(
            "GET", uri, f"/internal/translate/log?offset={int(offset)}", None
        )
        entries = [
            (e[0], e[1], e[2], int(e[3])) for e in out.get("entries", [])
        ]
        return entries, int(out.get("offset", offset)), int(out.get("len", 0))

    def translate_restore(self, uri: str, entries: list) -> dict:
        return self._json(
            "POST", uri, "/internal/translate/restore", {"entries": entries}
        )

    def translate_ids(
        self, uri: str, index: str, field: str | None, ids: list[int]
    ) -> list[str]:
        return self._json(
            "POST",
            uri,
            "/internal/translate/ids",
            {"index": index, "field": field, "ids": ids},
        )["keys"]


class NopInternalClient:
    """reference client.go:103 nopInternalClient."""

    def query_node(self, uri, index, query, shards, profile=False):
        return {"wireResults": []}

    def import_bits(self, uri, index, field, req):
        pass

    def import_roaring(self, uri, index, field, shard, data, clear=False, view="standard"):
        pass

    def fragment_blocks(self, uri, index, field, view, shard):
        return []

    def attr_blocks(self, uri, index, field):
        return []

    def attr_block_data(self, uri, index, field, block):
        return {}

    def block_data(self, uri, index, field, view, shard, block, width=None):
        return {"rows": [], "cols": []}

    def retrieve_fragment(self, uri, index, field, view, shard):
        return b""

    def fragment_list(self, uri):
        return []

    def resize_fetch(self, uri, req):
        pass

    def migrate_begin(self, uri, index, field, view, shard, chunk_bytes=None):
        return {"token": "", "size": 0, "opN": 0}

    def migrate_chunk(self, uri, token, offset):
        return b""

    def migrate_delta(self, uri, token):
        return {"ops": 0, "pending": 0}, b""

    def migrate_end(self, uri, token):
        pass

    def migrate_fetch(self, uri, req):
        return {}

    def migrate_finalize(self, uri, req):
        return {}

    def send_message(self, uri, msg):
        pass

    def status(self, uri):
        return {}

    def version(self, uri):
        return {}

    def debug_events(self, uri, since=0):
        return {"events": [], "nextSeq": since, "truncated": False}

    def debug_history(self, uri, series=None, since=None, step=None,
                      limit=None):
        return {"series": {}, "nextSeq": 0, "truncated": False}

    def debug_traces(self, uri, limit=100):
        return {"traces": []}

    def debug_trace_spans(self, uri, trace_id):
        return {"spans": []}

    def debug_postmortem(self, uri, postmortem_id=None):
        return {"postmortems": [], "latest": None, "postmortem": None}

    def breaker_states(self):
        return {}

    def shards_max(self, uri):
        return {}

    def nodes(self, uri):
        return []

    def translate_keys(self, uri, index, field, keys):
        return []

    def translate_ids(self, uri, index, field, ids):
        return []

    def translate_log(self, uri, offset):
        return [], offset, 0

    def translate_restore(self, uri, entries):
        return {"restored": 0}
