"""Anti-entropy replica repair (counterpart of
``pilosa_tpu/cluster/antientropy.py``, the port's own copy; reference:
holder.go:683-839 holderSyncer,
fragment.go:2849-3011 fragmentSyncer, server.go:494-546 monitorAntiEntropy).

Periodically, each node walks the fragments it owns and reconciles them
with the other replicas:

1. schema sync — pull every peer's schema and apply the union locally
   (the reference exchanges full NodeStatus incl. schema on gossip
   push/pull, gossip/gossip.go:321-357), healing missed broadcasts;
2. per-fragment block sync — fetch 100-row block checksums from each
   replica (fragment.go Blocks), and for every differing block fetch the
   raw (row, col) pairs and merge to consensus: a bit survives when set
   on >= ceil(n/2) replicas, ties keep the bit (fragment.go:1914
   majorityN); each replica then receives exactly its set/clear diff.

The algorithm and the wire are JAX's. The port holds a block's pairs as
sorted uint64 keys ``row * width + col`` in numpy arrays, and counts the
consensus with ``np.unique``, where JAX builds Python sets of tuples: a
diverged 64-row block at the serving density holds millions of pairs.
Row ids too large for that key take JAX's set path. A repair applied here
goes through the fragment's mutators (versions, the executor's stack
patch) and invalidates the result cache of its field.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pilosa_tpu_torch.cluster.client import ClientError
from pilosa_tpu_torch.obs import events as ev
from pilosa_tpu_torch.obs import tracing

logger = logging.getLogger(__name__)


class HolderSyncer:
    """reference holder.go:683 holderSyncer."""

    # fragments of one pass synced at once
    _FRAGMENT_WORKERS = 4

    def __init__(self, holder, cluster, client, api):
        self.holder = holder
        self.cluster = cluster
        self.client = client
        self.api = api
        # what this syncer's passes read, beside JAX's stats: the block
        # checksums compared with a replica's, and the (row, col) pairs
        # fetched from replicas for the blocks that differed, with their
        # bytes on the wire
        self.blocks_compared = 0
        self.block_pairs = 0
        self.block_bytes = 0
        self._counters_lock = threading.Lock()

    # -- entry point --------------------------------------------------------

    def sync_holder(self) -> dict:
        """One full anti-entropy pass. Returns counters for observability
        (reference SyncHolder holder.go:683)."""
        stats = {
            "fragments": 0, "blocks_diff": 0, "bits_set": 0,
            "bits_cleared": 0, "attrs_merged": 0, "translate_entries": 0,
        }
        job = self.holder.jobs.start("antientropy")
        if len(self.cluster.nodes) <= 1:
            # Single node: the pass is a no-op, but it still counts as a
            # completed round (the loop ran; there was nothing to repair).
            self._finish_round(job, stats, time.monotonic())
            return stats
        t0 = time.monotonic()
        try:
            self._sync_holder(stats, job)
        except Exception as e:
            job.finish("error", error=f"{type(e).__name__}: {e}")
            raise
        self._finish_round(job, stats, t0)
        return stats

    def _finish_round(self, job, stats: dict, t0: float) -> None:
        """Round bookkeeping: summary counters into the stats sink
        (instead of dropping the dict), a journal event, and the job's
        terminal state."""
        hstats = self.holder.stats
        hstats.count("antientropy_rounds", 1)
        hstats.count(
            "antientropy_bits_repaired",
            stats["bits_set"] + stats["bits_cleared"],
        )
        hstats.count("antientropy_blocks_merged", stats["blocks_diff"])
        self.holder.events.record(
            ev.EVENT_ANTIENTROPY_ROUND,
            duration=time.monotonic() - t0,
            job=job.id,
            **stats,
        )
        job.finish("done")

    def _sync_holder(self, stats: dict, job) -> None:
        # span per pass (reference holder.go:683 SyncHolder spans)
        with tracing.start_span("holderSyncer.SyncHolder"):
            # translate-log replication rides the anti-entropy carrier
            # (reference replicas stream continuously, translate.go:91-97;
            # one pull per pass converges replicas the same way)
            translator = (
                self.api.executor.translator if self.api is not None else None
            )
            if translator is not None and hasattr(
                translator, "sync_from_primary"
            ):
                try:
                    stats["translate_entries"] = translator.sync_from_primary()
                except Exception:
                    logger.warning(
                        "translate-log sync failed", exc_info=True
                    )
            job.set_phase("schema")
            self.sync_schema()
            job.set_phase("fragments")
            job.set_progress(fragments_total=self._count_owned_fragments())
            owned = []
            for index_name in list(self.holder.index_names()):
                idx = self.holder.index(index_name)
                if idx is None:
                    continue
                # column attrs (reference holder.go:747-790 syncIndex)
                self.sync_attrs(index_name, None, idx.column_attrs, stats)
                for fname in idx.field_names(include_internal=True):
                    field = idx.field(fname)
                    if field is None:
                        continue
                    # row attrs (reference holder.go:793-839 syncField)
                    self.sync_attrs(index_name, fname, field.row_attrs, stats)
                    for vname in field.view_names():
                        view = field.view(vname)
                        for shard in sorted(view.fragments):
                            if self.cluster.owns_shard(
                                self.cluster.node_id, index_name, shard
                            ):
                                owned.append((index_name, fname, vname, shard))

            def one(key) -> dict:
                local = dict.fromkeys(stats, 0)
                # One bad fragment must not abort the whole pass — the
                # loop retries next interval anyway.
                try:
                    self.sync_fragment(*key, local)
                except Exception as e:
                    logger.warning("sync of %s/%s/%s/%d failed: %s", *key, e)
                return local

            # the fragments are independent: _FRAGMENT_WORKERS at once
            # (JAX visits them in turn), each waiting mostly on its replicas
            with ThreadPoolExecutor(max_workers=self._FRAGMENT_WORKERS) as workers:
                for local in workers.map(one, owned):
                    for k, v in local.items():
                        stats[k] += v
                    stats["fragments"] += 1
                    job.advance(fragments_done=1)
                    job.set_progress(
                        bits_repaired=stats["bits_set"] + stats["bits_cleared"],
                        blocks_merged=stats["blocks_diff"],
                    )

    def _count_owned_fragments(self) -> int:
        """How many fragments this pass will visit (job progress total)."""
        n = 0
        for index_name in list(self.holder.index_names()):
            idx = self.holder.index(index_name)
            if idx is None:
                continue
            for fname in idx.field_names(include_internal=True):
                field = idx.field(fname)
                if field is None:
                    continue
                for vname in field.view_names():
                    view = field.view(vname)
                    for shard in sorted(view.fragments):
                        if self.cluster.owns_shard(
                            self.cluster.node_id, index_name, shard
                        ):
                            n += 1
        return n

    def sync_schema(self) -> None:
        """Apply the union of all peers' schemas locally (missed
        create-index/create-field broadcasts heal here)."""
        for node in self.cluster.nodes:
            if node.id == self.cluster.node_id:
                continue
            try:
                status = self.client.status(node.uri)
            except ClientError:
                continue
            schema = status.get("schema")
            if schema:
                try:
                    self.holder.apply_schema(schema)
                except Exception as e:
                    logger.warning("schema sync from %s failed: %s", node.id, e)
            # shard-availability exchange (reference NodeStatus carries
            # available-shard bitmaps, gossip.go:321-357)
            if status.get("availableShards"):
                self.api.merge_available_shards(status["availableShards"])

    # -- attr sync (reference holder.go:747-839 syncIndex/syncField) --------

    def sync_attrs(self, index: str, field: str | None, store, stats: dict) -> None:
        """Pull-merge attribute blocks that differ from any peer. Attrs
        replicate to every node at write time (broadcast writes); each
        node's pass pulls blocks it is missing, so all converge without a
        push path (the reference does the same via AttrStore diffs)."""
        local = {bid: chk.hex() for bid, chk in store.blocks()}
        for node in self.cluster.nodes:
            if node.id == self.cluster.node_id:
                continue
            try:
                remote = {
                    b["id"]: b["checksum"]
                    for b in self.client.attr_blocks(node.uri, index, field)
                }
            except ClientError:
                continue
            for bid, chk in remote.items():
                if local.get(bid) == chk:
                    continue
                try:
                    attrs = self.client.attr_block_data(
                        node.uri, index, field, bid
                    )
                except ClientError as e:
                    logger.warning(
                        "attr block fetch from %s failed: %s", node.id, e
                    )
                    continue
                if attrs:
                    store.set_bulk_attrs(attrs)
                    stats["attrs_merged"] += len(attrs)
            # refresh local checksums after merging this peer
            local = {bid: chk.hex() for bid, chk in store.blocks()}

    # -- fragment sync (reference fragment.go:2849 syncFragment) ------------

    def sync_fragment(
        self, index: str, field: str, view: str, shard: int, stats: dict
    ) -> None:
        replicas = [
            n
            for n in self.cluster.shard_nodes(index, shard)
            if n.id != self.cluster.node_id
        ]
        if not replicas:
            return
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            return
        local_blocks = {b["id"]: b["checksum"] for b in frag.blocks()}
        # Union of block ids that differ from ANY replica.
        remote_blocks: dict[str, dict[int, str]] = {}
        diff_ids: set[int] = set()
        for node in replicas:
            try:
                blocks = self.client.fragment_blocks(
                    node.uri, index, field, view, shard
                )
                rb = {b["id"]: b["checksum"] for b in blocks}
            except ClientError as e:
                if e.code == 404:
                    rb = {}  # replica has no fragment yet: all blocks differ
                else:
                    logger.warning("blocks fetch from %s failed: %s", node.id, e)
                    continue
            remote_blocks[node.id] = rb
            with self._counters_lock:
                self.blocks_compared += len(set(local_blocks) | set(rb))
            for bid in set(local_blocks) | set(rb):
                if local_blocks.get(bid) != rb.get(bid):
                    diff_ids.add(bid)
        for bid in sorted(diff_ids):
            stats["blocks_diff"] += 1
            self._merge_block(
                index, field, view, shard, bid, frag, replicas,
                remote_blocks, stats, local_blocks.get(bid),
            )

    def _merge_block(
        self, index, field, view, shard, block, frag, replicas,
        remote_blocks, stats, local_sum=None,
    ) -> None:
        """Majority-consensus merge of one block (reference
        fragment.go:1873-1991 mergeBlock + syncBlock :2900-3011)."""
        width = frag.shard_width
        lrows, lcols = frag.block_data(block)
        pairs: dict[str, tuple] = {self.cluster.node_id: (lrows, lcols)}
        for node in replicas:
            if node.id not in remote_blocks:
                continue  # unreachable earlier; skip from consensus
            # Matching checksum => identical pair set; skip the fetch
            # (only blocks differing from SOME replica reach here).
            if local_sum is not None and remote_blocks[node.id].get(block) == local_sum:
                pairs[node.id] = (lrows, lcols)
                continue
            try:
                data = self.client.block_data(
                    node.uri, index, field, view, shard, block, width=width,
                )
                pairs[node.id] = (
                    np.asarray(data["rows"], dtype=np.uint64),
                    np.asarray(data["cols"], dtype=np.int64),
                )
                with self._counters_lock:
                    self.block_pairs += len(pairs[node.id][0])
                    self.block_bytes += int(data.get("bytes", 0))
            except ClientError as e:
                if e.code == 404:
                    pairs[node.id] = (np.empty(0, np.uint64), np.empty(0, np.int64))
                else:
                    logger.warning("block data from %s failed: %s", node.id, e)
        n = len(pairs)
        if n <= 1:
            return
        majority = (n + 1) // 2  # ties keep the bit (fragment.go:1914)
        max_row = (2**64 - 1 - (width - 1)) // width
        if all(not len(r) or int(r.max()) <= max_row for r, _ in pairs.values()):
            diffs = _keyed_diffs(pairs, width, majority)
        else:
            diffs = _set_diffs(pairs, majority)
        # Per-replica diffs: sets = keep - have, clears = have - keep, as
        # (rows, cols) arrays.
        for node_id, (to_set, to_clear) in diffs.items():
            if not len(to_set[0]) and not len(to_clear[0]):
                continue
            if node_id == self.cluster.node_id:
                self._apply_local(frag, to_set, to_clear)
                stats["bits_set"] += len(to_set[0])
                stats["bits_cleared"] += len(to_clear[0])
            else:
                node = self.cluster.node(node_id)
                # count only bits actually shipped (the wire format may
                # drop unencodable rows)
                n_set, n_clear = self._push_remote(
                    node, index, field, view, shard, frag, to_set, to_clear
                )
                stats["bits_set"] += n_set
                stats["bits_cleared"] += n_clear

    def _apply_local(self, frag, to_set, to_clear) -> None:
        """Apply (rows, cols) through the fragment's mutators, then
        invalidate the result cache of the field."""
        for (rows, cols), clear in ((to_set, False), (to_clear, True)):
            if len(rows):
                frag.import_bits(rows, cols, clear=clear)
        if self.api is not None and (len(to_set[0]) or len(to_clear[0])):
            self.api.executor.rescache.note_write(frag.index, frag.field)

    def _push_remote(
        self, node, index, field, view, shard, frag, to_set, to_clear
    ) -> tuple[int, int]:
        """Ship the diffs as roaring batches (the reference pushes syncs
        through ImportRoaring too, fragment.go:2975-3011). Returns the
        (set, clear) counts shipped."""
        from pilosa_tpu_torch.storage import roaring

        width = frag.shard_width
        # the wire format is uint64 positions (row*width + col), so rows
        # beyond 2^64/width are unrepresentable: skip them rather than
        # abort the pass (arbitrary uint64 row ids are legal locally)
        max_row = (2**64 - 1 - (width - 1)) // width
        shipped = [0, 0]
        try:
            for i, ((rows, cols), clear) in enumerate(((to_set, False), (to_clear, True))):
                if not len(rows):
                    continue
                fit = rows <= np.uint64(max_row)
                if not fit.all():
                    logger.warning(
                        "skipping %d bits with row ids too large for the "
                        "position wire format", int((~fit).sum()),
                    )
                if not fit.any():
                    continue
                positions = np.sort(
                    rows[fit] * np.uint64(width) + cols[fit].astype(np.uint64)
                )
                self.client.import_roaring(
                    node.uri, index, field, shard,
                    roaring.serialize(positions), clear=clear, view=view,
                )
                shipped[i] = int(fit.sum())
        except ClientError as e:
            logger.warning("sync push to %s failed: %s", node.id, e)
        return shipped[0], shipped[1]


def _keyed_diffs(pairs: dict, width: int, majority: int) -> dict:
    """node id -> ((rows, cols) to set, (rows, cols) to clear), counted on
    position keys ``row * width + col``: one sort of every replica's keys
    together, then each replica's keys found in it by binary search."""
    w = np.uint64(width)
    have = {}
    for nid, (rows, cols) in pairs.items():
        keys = rows * w + cols.astype(np.uint64)
        if len(keys) > 1 and not (keys[1:] > keys[:-1]).all():
            keys = np.unique(keys)  # block data comes sorted; a peer's may not
        have[nid] = keys
    union = np.unique(np.concatenate(list(have.values())))
    at = {nid: np.searchsorted(union, h) for nid, h in have.items()}
    counts = np.zeros(len(union), dtype=np.int32)
    for idx in at.values():
        counts[idx] += 1
    keep = counts >= majority

    def split(keys):
        return keys // w, (keys % w).astype(np.int64)

    out = {}
    for nid, idx in at.items():
        present = np.zeros(len(union), dtype=bool)
        present[idx] = True
        out[nid] = (split(union[keep & ~present]), split(union[~keep & present]))
    return out


def _set_diffs(pairs: dict, majority: int) -> dict:
    """JAX's set-of-tuples merge, for row ids too large for a position
    key; the same result shape as :func:`_keyed_diffs`."""
    sets = {
        nid: set(zip(rows.tolist(), cols.tolist())) for nid, (rows, cols) in pairs.items()
    }
    counts: dict[tuple[int, int], int] = {}
    for ps in sets.values():
        for p in ps:
            counts[p] = counts.get(p, 0) + 1
    keep = {p for p, c in counts.items() if c >= majority}

    def arrays(diff):
        diff = sorted(diff)
        return (
            np.array([r for r, _ in diff], dtype=np.uint64),
            np.array([c for _, c in diff], dtype=np.int64),
        )

    return {nid: (arrays(keep - h), arrays(h - keep)) for nid, h in sets.items()}


class AntiEntropyLoop:
    """Background interval loop (reference server.go:494-546).

    ``state_fn`` (when given) gates each pass: only RESIZING/STARTING
    skip — DEGRADED deliberately still syncs, because repair between
    the surviving replicas matters MOST during an outage (the
    reference's monitorAntiEntropy skips only resizing)."""

    _SKIP_STATES = ("RESIZING", "STARTING")

    def __init__(self, syncer: HolderSyncer, interval: float, state_fn=None):
        self.syncer = syncer
        self.interval = interval
        self.state_fn = state_fn
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="pilosa-antientropy", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if (
                self.state_fn is not None
                and self.state_fn() in self._SKIP_STATES
            ):
                continue
            t0 = time.monotonic()
            try:
                self.syncer.sync_holder()
                # duration metric (reference server.go:532)
                self.syncer.holder.stats.timing(
                    "anti_entropy", time.monotonic() - t0
                )
            except Exception as e:
                logger.warning("anti-entropy pass failed: %s", e)

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
