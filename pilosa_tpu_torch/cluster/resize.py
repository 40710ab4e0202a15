"""Online cluster resize (counterpart of ``pilosa_tpu/cluster/resize.py``,
the port's own copy; reference: cluster.go:687-844 fragSources /
fragsDiff, :1038-1536 resizeJob / followResizeInstruction).

This implements the reference's *cluster-level* elasticity: adding or removing
a host re-runs jump-hash placement over the new membership and moves only
the fragments whose owner set changed (jump consistent hashing guarantees
that set is minimal).

Unlike the reference (which gates the whole cluster to RESIZING and 503s
every write until the transfer finishes), this resize is **online**: the
cluster state stays NORMAL end to end and ownership moves one shard at a
time behind per-fragment migration:

1. **prepare** — every member (old + joining) learns the PENDING
   membership and the resize epoch (MSG_RESIZE_PREPARE).  Placement
   stays on the current ring; an unreachable *surviving* member aborts
   the resize here (committing a membership it never heard of would
   strand it on the old ring).
2. **inventory** — which old member holds which fragments (reference
   fragsByHost cluster.go:687).  Removing an unreachable node surfaces
   any un-replicated fragments as a journaled ``resize-data-loss`` event
   plus a ``resize_data_loss_fragments`` counter — never silently.
3. **migrate, per shard group** — each new owner pulls the shard's
   fragments from a live holder: snapshot cut streamed in resumable
   chunks, then bounded op-log catch-up rounds while writes keep landing
   on the current owner (server/api.py migrate_fetch; source half in
   cluster/migration.py).
4. **flip** — one broadcast moves that shard's placement onto the
   pending ring (MSG_EPOCH_FLIP, fenced by the epoch).  Reads were
   replica-served throughout; writes start routing to the new owner.
5. **finalize** — the new owners drain the final op-log delta the flip
   raced with and close their source sessions. Once every shard has
   flipped, the fragments a write made on an old owner after the
   inventory are pulled to their new owners too (the port's addition:
   JAX's coordinator leaves them to the old owner, which drops them at
   the commit).
6. **commit** — full membership + shard map to every node
   (MSG_CLUSTER_STATUS; reference mergeClusterStatus), and each node
   drops fragments it no longer owns (reference holderCleaner).

Every phase is crash-survivable: the plan persists as a resize journal
(``resize.json`` in the data dir, mirrored in-process for storeless
clusters) before any state moves, progress is checkpointed per shard
group, and ``resume()`` re-dispatches idempotently from the journal — a
coordinator that dies mid-migrate leaves a resumable plan, not a wedged
cluster.  ``testing/faults.py`` crash rules fire at every
``coordinator:*`` stage boundary below.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster.client import ClientError
from pilosa_tpu_torch.cluster.cluster import Cluster, STATE_NORMAL
from pilosa_tpu_torch.cluster.topology import Node
from pilosa_tpu_torch.obs import events as ev
from pilosa_tpu_torch.testing import faults

logger = logging.getLogger(__name__)

JOURNAL_FILE = "resize.json"


class ResizeError(Exception):
    pass


class ResizeCoordinator:
    """Runs on the coordinator node (reference: only the coordinator
    generates resize jobs, cluster.go:1171)."""

    # shard groups migrated at once
    _GROUP_WORKERS = 4

    def __init__(self, cluster: Cluster, client, api):
        self.cluster = cluster
        self.client = client
        self.api = api

    # -- public entry points ------------------------------------------------

    def add_node(self, node_id: str, uri: str) -> None:
        if self.cluster.node(node_id) is not None:
            return
        new_nodes = [
            Node(id=n.id, uri=n.uri) for n in self.cluster.nodes
        ] + [Node(id=node_id, uri=uri)]
        self._resize(sorted(new_nodes, key=lambda n: n.id))

    def remove_node(self, node_id: str) -> None:
        if self.cluster.node(node_id) is None:
            raise ResizeError(f"node not in cluster: {node_id}")
        if node_id == self.cluster.node_id:
            raise ResizeError("coordinator cannot remove itself")
        new_nodes = [
            Node(id=n.id, uri=n.uri)
            for n in self.cluster.nodes
            if n.id != node_id
        ]
        if not new_nodes:
            raise ResizeError("cannot remove the last node")
        self._resize(new_nodes, removed=node_id)

    def resume(self) -> dict:
        """Re-dispatch an interrupted resize from the persisted journal.
        Completed shard groups are skipped (checkpointed per group);
        re-dispatching the rest is idempotent — snapshot applies are
        set-merges and delta replay follows file order."""
        plan = self._load_journal()
        if plan is None:
            raise ResizeError("no interrupted resize to resume")
        new_nodes = [Node(id=d["id"], uri=d["uri"]) for d in plan["nodes"]]
        self.api.holder.events.record(
            ev.EVENT_RESIZE_RESUME,
            action=plan.get("action"),
            epoch=plan.get("epoch"),
            done=len(plan.get("done") or []),
        )
        self._resize(new_nodes, removed=plan.get("removed"), resume_plan=plan)
        return {"resumed": True, "members": [n.id for n in new_nodes]}

    # -- the job ------------------------------------------------------------

    def _resize(
        self,
        new_nodes: list[Node],
        removed: str | None = None,
        resume_plan: dict | None = None,
    ) -> None:
        if self.cluster.resize_pending and resume_plan is None:
            raise ResizeError(
                "a resize is already in flight; resume or abort it first"
            )
        old_nodes = list(self.cluster.nodes)
        all_nodes = {n.id: n for n in old_nodes}
        for n in new_nodes:
            all_nodes.setdefault(n.id, n)
        epoch = (
            int(resume_plan["epoch"]) if resume_plan
            else self.cluster.epoch + 1
        )
        plan = resume_plan or {
            "action": "remove" if removed else "add",
            "removed": removed,
            "epoch": epoch,
            "nodes": [{"id": n.id, "uri": n.uri} for n in new_nodes],
            "done": [],
        }
        done: set[str] = set(plan.get("done") or [])
        # Persist BEFORE any cluster state moves: from here on a
        # coordinator death leaves a resumable plan, not a mystery.
        self._write_journal(plan)

        journal = self.api.holder.events
        job = self.api.holder.jobs.start(
            "resize",
            action=plan["action"],
            old_nodes=len(old_nodes),
            new_nodes=len(new_nodes),
            epoch=epoch,
            resumed=bool(resume_plan),
        )
        journal.record(
            ev.EVENT_RESIZE_START,
            action=plan["action"],
            old=[n.id for n in old_nodes],
            new=[n.id for n in new_nodes],
            removed=removed,
            epoch=epoch,
            job=job.id,
        )
        try:
            # 1. prepare: pending membership + epoch everywhere.  The
            # cluster state stays NORMAL — no read/write gate.
            job.set_phase("prepare")
            journal.record(
                ev.EVENT_RESIZE_PHASE, phase="prepare", job=job.id,
            )
            faults.stage_fault("coordinator:prepare")
            self._send_prepare(all_nodes.values(), new_nodes, epoch, removed)
            if resume_plan is not None:
                # Nodes that restarted since the crash lost their flip
                # state; re-broadcasting completed flips is idempotent.
                for key in sorted(done):
                    index, shard = key.rsplit(":", 1)
                    self._broadcast_flip(
                        all_nodes.values(), index, int(shard), epoch
                    )
            # 2. inventory: which old member holds which fragments.
            job.set_phase("inventory")
            journal.record(
                ev.EVENT_RESIZE_PHASE, phase="inventory", job=job.id,
            )
            holders = self._gather_inventory(old_nodes, exclude=removed)
            # 3. placement under the new membership -> per-shard plan.
            new_cluster = Cluster(
                self.cluster.node_id,
                replica_n=self.cluster.replica_n,
                partition_n=self.cluster.partition_n,
                coordinator_id=self.cluster.coordinator_id,
            )
            new_cluster.set_static(
                [Node(id=n.id, uri=n.uri) for n in new_nodes]
            )
            old_ids = {n.id for n in old_nodes}
            joining = [n for n in new_nodes if n.id not in old_ids]
            groups = self._plan_groups(
                holders, new_cluster, all_nodes, removed
            )
            total = sum(
                len(ins)
                for by_target in groups.values()
                for ins in by_target.values()
            )
            job.set_phase("migrate")
            job.set_progress(
                fragments_total=total, shards_total=len(groups),
            )
            journal.record(
                ev.EVENT_RESIZE_PHASE, phase="migrate", job=job.id,
                shards=len(groups), fragments=total,
            )
            faults.stage_fault("coordinator:migrate")
            # Joining nodes need the schema before any fragment lands
            # (reference cluster.go:1304-1323); idempotent on resume.
            schema = self.api.holder.schema()
            for n in joining:
                self._dispatch(
                    n, "migrate_fetch",
                    {"instructions": [], "schema": schema},
                )
            # 4. per shard group: fetch -> flip -> finalize.  Reads are
            # replica-served throughout; writes follow the flip. The port
            # runs _GROUP_WORKERS groups at once (JAX one after another):
            # each waits mostly on its targets' pulls
            done_lock = threading.Lock()
            failed = threading.Event()

            def migrate_group(group_key) -> None:
                if failed.is_set():
                    return  # a group failed: start no other
                try:
                    run_group(group_key)
                except BaseException:
                    failed.set()
                    raise

            def run_group(group_key) -> None:
                index, shard = group_key
                by_target = groups[group_key]
                for tid, instructions in by_target.items():
                    self._dispatch(
                        all_nodes[tid], "migrate_fetch",
                        {"instructions": instructions},
                    )
                faults.stage_fault("coordinator:flip")
                self._broadcast_flip(
                    all_nodes.values(), index, shard, epoch
                )
                journal.record(
                    ev.EVENT_MIGRATE_FRAGMENT,
                    index=index, shard=shard, epoch=epoch,
                    targets=sorted(by_target),
                    fragments=sum(len(i) for i in by_target.values()),
                    job=job.id,
                )
                for tid, instructions in by_target.items():
                    self._dispatch(
                        all_nodes[tid], "migrate_finalize",
                        {"instructions": instructions},
                    )
                job.advance(
                    shards_done=1,
                    fragments_done=sum(
                        len(i) for i in by_target.values()
                    ),
                )
                with done_lock:
                    done.add(f"{index}:{shard}")
                    plan["done"] = sorted(done)
                    self._write_journal(plan)  # checkpoint per shard group

            todo = [g for g in sorted(groups) if f"{g[0]}:{g[1]}" not in done]
            with ThreadPoolExecutor(
                max_workers=max(1, min(self._GROUP_WORKERS, len(todo)))
            ) as workers:
                futures = [workers.submit(migrate_group, g) for g in todo]
            for fut in futures:
                fut.result()  # the first group's failure, in plan order
            self._migrate_late(old_nodes, holders, new_cluster, all_nodes, removed,
                               epoch, job)
        except faults.CrashError:
            # Simulated coordinator death: no abort, no cleanup — the
            # journal stays on disk and resume() picks the plan back up.
            job.finish("aborted", error="coordinator crash (injected)")
            raise
        except Exception as e:
            journal.record(
                ev.EVENT_RESIZE_ABORT, job=job.id,
                error=f"{type(e).__name__}: {e}",
            )
            job.finish("aborted", error=f"{type(e).__name__}: {e}")
            self._cancel(all_nodes.values(), f"{type(e).__name__}: {e}")
            self._delete_journal()
            raise
        # 5. commit: new membership + NORMAL everywhere, then cleanup.
        # The commit carries the global shard-availability map so every
        # node re-learns which shards exist cluster-wide (local holdings
        # changed; stale remote sets would shrink query fan-out).
        faults.stage_fault("coordinator:commit")
        shard_map: dict = {}
        for (index, field, _view, shard) in holders:
            shard_map.setdefault(index, {}).setdefault(field, set()).add(shard)
        shard_map = {
            i: {f: sorted(s) for f, s in fields.items()}
            for i, fields in shard_map.items()
        }
        job.set_phase("commit")
        journal.record(ev.EVENT_RESIZE_PHASE, phase="commit", job=job.id)
        self._commit_membership(all_nodes.values(), new_nodes, shard_map)
        journal.record(
            ev.EVENT_RESIZE_COMMIT, job=job.id, epoch=epoch,
            members=[n.id for n in new_nodes],
        )
        self._delete_journal()
        job.finish("done")

    def _migrate_late(
        self, old_nodes, holders: dict, new_cluster: Cluster, all_nodes: dict,
        removed: str | None, epoch: int, job,
    ) -> None:
        """Pull the fragments made after the inventory to their new owners.

        A write that lands on an old owner before its shard flips may make
        a fragment that no instruction names; the old owner would drop it
        at the commit, and a new owner would never see its bits (JAX's
        coordinator loses them where the old owner leaves the shard). Every
        shard has flipped by now, so no new write reaches an old owner
        alone: each such fragment goes to every new owner, from the old
        nodes that hold it (a set-merge, so an owner that already has it
        loses nothing)."""
        job.set_phase("late")
        now = self._gather_inventory(old_nodes, exclude=removed, journal_loss=False)
        groups: dict[tuple, dict[str, list[dict]]] = {}
        for frag_key, holder_ids in now.items():
            if frag_key in holders:
                continue
            index, field, view, shard = frag_key
            for target in new_cluster.shard_nodes(index, shard):
                sources = [all_nodes[h].uri for h in holder_ids if h != target.id]
                if not sources:
                    continue
                groups.setdefault((index, int(shard)), {}).setdefault(
                    target.id, []
                ).append(
                    {
                        "index": index, "field": field, "view": view,
                        "shard": int(shard), "sourceURIs": sources,
                    }
                )
        for (index, shard), by_target in sorted(groups.items()):
            for tid, instructions in by_target.items():
                self._dispatch(all_nodes[tid], "migrate_fetch", {"instructions": instructions})
                self._dispatch(all_nodes[tid], "migrate_finalize", {"instructions": instructions})
            self.api.holder.events.record(
                ev.EVENT_MIGRATE_FRAGMENT,
                index=index, shard=shard, epoch=epoch, targets=sorted(by_target),
                fragments=sum(len(i) for i in by_target.values()), late=True,
                job=job.id,
            )

    # -- planning -----------------------------------------------------------

    def _plan_groups(
        self, holders: dict, new_cluster: Cluster, all_nodes: dict,
        removed: str | None,
    ) -> dict[tuple, dict[str, list[dict]]]:
        """(index, shard) -> {target node id -> fetch instructions}.
        Each instruction lists EVERY live holder as a source (staying
        members first, a gracefully-leaving node last) so the target can
        fail over mid-pull."""
        groups: dict[tuple, dict[str, list[dict]]] = {}
        for frag_key, holder_ids in holders.items():
            index, field, view, shard = frag_key
            src_uris = [
                all_nodes[h].uri for h in holder_ids if h != removed
            ]
            if removed in holder_ids:
                src_uris.append(all_nodes[removed].uri)
            for target in new_cluster.shard_nodes(index, shard):
                if target.id in holder_ids:
                    continue
                if not src_uris:
                    raise ResizeError(
                        f"no live source for fragment {frag_key}"
                    )
                groups.setdefault((index, int(shard)), {}).setdefault(
                    target.id, []
                ).append(
                    {
                        "index": index,
                        "field": field,
                        "view": view,
                        "shard": int(shard),
                        "sourceURIs": src_uris,
                    }
                )
        return groups

    # -- fan-out helpers ----------------------------------------------------

    def _dispatch(self, target: Node, method: str, req: dict):
        if target.id == self.cluster.node_id:
            return getattr(self.api, method)(req)
        return getattr(self.client, method)(target.uri, req)

    def _send_prepare(
        self, nodes, new_nodes: list[Node], epoch: int,
        removed: str | None,
    ) -> None:
        msg = {
            "type": bc.MSG_RESIZE_PREPARE,
            "epoch": epoch,
            "nodes": [{"id": n.id, "uri": n.uri} for n in new_nodes],
        }
        for n in nodes:
            if n.id == self.cluster.node_id:
                self.api.receive_message(msg)
                continue
            try:
                self.client.send_message(n.uri, msg)
            except ClientError as e:
                if n.id == removed:
                    # Removing a dead node IS the recovery path; its
                    # missing ack must not block the resize.
                    logger.warning(
                        "prepare to leaving node %s failed: %s", n.id, e
                    )
                    continue
                # A SURVIVING member that never hears the prepare would
                # keep routing on the old ring after the commit — abort
                # instead of carrying on with a warning.
                raise ResizeError(
                    f"prepare fan-out to surviving member {n.id} "
                    f"failed: {e}"
                )

    def _broadcast_flip(
        self, nodes, index: str, shard: int, epoch: int
    ) -> None:
        msg = {
            "type": bc.MSG_EPOCH_FLIP,
            "index": index,
            "shard": int(shard),
            "epoch": epoch,
        }
        for n in nodes:
            if n.id == self.cluster.node_id:
                self.api.receive_message(msg)
                continue
            try:
                self.client.send_message(n.uri, msg)
            except ClientError as e:
                # Best-effort: a node that misses a flip keeps routing
                # this shard to the old owner — reads stay correct (the
                # source holds the fragment until commit cleanup) and
                # the commit converges membership for good.
                logger.warning("flip fan-out to %s failed: %s", n.id, e)

    def _cancel(self, nodes, reason: str) -> None:
        """Broadcast a resize cancel: every node drops its pending
        membership and flip state; placement snaps back to the current
        ring (where the data still lives)."""
        msg = {"type": bc.MSG_RESIZE_CANCEL, "reason": reason}
        for n in nodes:
            if n.id == self.cluster.node_id:
                self.api.receive_message(msg)
                continue
            try:
                self.client.send_message(n.uri, msg)
            except ClientError as e:
                logger.warning("resize-cancel to %s failed: %s", n.id, e)

    def _gather_inventory(
        self, old_nodes, exclude: str | None, journal_loss: bool = True,
    ) -> dict[tuple, list[str]]:
        """fragment key -> node ids actually holding it (reference
        fragsByHost cluster.go:687)."""
        holders: dict[tuple, list[str]] = {}
        dead: list[str] = []
        for n in old_nodes:
            if n.id == self.cluster.node_id:
                frags = self.api.fragment_inventory()
            else:
                try:
                    frags = self.client.fragment_list(n.uri)
                except ClientError as e:
                    if exclude is not None and n.id == exclude:
                        dead.append(n.id)
                        continue
                    raise ResizeError(
                        f"inventory fetch from {n.id} failed: {e}"
                    )
            for fr in frags:
                key = (fr["index"], fr["field"], fr["view"], fr["shard"])
                holders.setdefault(key, []).append(n.id)
        if dead and journal_loss:
            self._journal_data_loss(dead[0], holders)
        return holders

    def _journal_data_loss(self, node_id: str, holders: dict) -> None:
        """Removing an unreachable node can lose its un-replicated
        fragments: anything the cluster-wide shard-availability map says
        exists but no SURVIVING member holds.  Surface it loudly — a
        journaled event plus a /metrics counter — instead of silently
        skipping the dead node's inventory."""
        known = self.api.available_shards_map()
        held = {(i, f, int(s)) for (i, f, _v, s) in holders}
        lost = []
        for index, fields in known.items():
            for field, shards in fields.items():
                for s in shards:
                    if (index, field, int(s)) not in held:
                        lost.append((index, field, int(s)))
        if not lost:
            return
        self.api.holder.events.record(
            ev.EVENT_RESIZE_DATA_LOSS,
            node=node_id,
            count=len(lost),
            fragments=[list(k) for k in lost[:32]],
        )
        self.api.holder.stats.count(
            "resize_data_loss_fragments", len(lost)
        )
        logger.error(
            "resize removed dead node %s: %d un-replicated fragment(s)"
            " lost", node_id, len(lost),
        )

    # -- resize journal (crash-survivable plan) -----------------------------

    def _journal_path(self) -> str | None:
        store = self.api.store
        if store is None or not getattr(store, "path", None):
            return None
        return os.path.join(store.path, JOURNAL_FILE)

    def _write_journal(self, plan: dict) -> None:
        self.api._resize_journal = plan
        path = self._journal_path()
        if path is None:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(plan, f)
        os.replace(tmp, path)  # atomic: a crash mid-write keeps the old plan

    def _load_journal(self) -> dict | None:
        plan = getattr(self.api, "_resize_journal", None)
        if plan is not None:
            return plan
        path = self._journal_path()
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            logger.error("unreadable resize journal %s: %s", path, e)
            return None

    def _delete_journal(self) -> None:
        self.api._resize_journal = None
        path = self._journal_path()
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass

    # -- commit -------------------------------------------------------------

    def _commit_membership(
        self, all_nodes, members: list[Node], shard_map: dict | None = None
    ) -> None:
        """The membership commit, in two sweeps (the port's addition). The
        first carries ``deferCleanup``: every member takes the new
        membership and keeps what it no longer owns, so a read planned on
        the old ring, anywhere, still finds its fragments. The second,
        sent once every member has the new ring, is the same status
        without it: each member then drops what it no longer owns. A JAX
        node ignores the flag and cleans at the first sweep, as JAX's
        coordinator has it do; a distributed executor re-runs a read that
        a membership change overtook (``cluster/dist.py``)."""
        all_nodes = list(all_nodes)
        status = {
            "type": bc.MSG_CLUSTER_STATUS,
            "state": STATE_NORMAL,
            "coordinator": self.cluster.coordinator_id,
            "nodes": [{"id": n.id, "uri": n.uri} for n in members],
        }
        if shard_map:
            status["availableShards"] = shard_map
        member_ids = {n.id for n in members}
        self._send_status(all_nodes, dict(status, deferCleanup=True), member_ids)
        self._send_status(all_nodes, status, member_ids)

    def _send_status(self, all_nodes, status: dict, member_ids: set) -> None:
        # First sweep: one attempt per node, so a slow/dead node can't
        # head-of-line-block healthy members' commit.
        retry: list = []
        for n in all_nodes:
            if n.id == self.cluster.node_id:
                self.api.receive_message(status)
                continue
            try:
                self.client.send_message(n.uri, status)
            except ClientError:
                # A removed node that is already gone is expected; a
                # surviving member missing the commit keeps routing on
                # the pre-resize ring (its watchdog re-pulls status from
                # the coordinator as the backstop), so retry below.
                if n.id in member_ids:
                    retry.append(n)
        for n in retry:
            for attempt in range(4):
                try:
                    self.client.send_message(n.uri, status)
                    break
                except ClientError as e:
                    if attempt < 3:
                        time.sleep(0.2 * 2**attempt)
                    else:
                        logger.error(
                            "commit to %s failed after %d attempts: %s "
                            "(its resize watchdog re-pulls the cluster "
                            "status from the coordinator to recover)",
                            n.id, attempt + 2, e,
                        )
