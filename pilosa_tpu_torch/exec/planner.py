"""Flight-level query planner: cross-query CSE, cost-based reordering,
and measured lane choice (counterpart of ``pilosa_tpu/exec/planner.py``).

The continuous-batching plane (server/batcher.py) coalesces concurrent
queries into flights, but before this module every flight-mate's tree
was evaluated independently — a dashboard fan-in where 50 queries share
the same ``Intersect(Row(...), Row(...))`` filter paid for that operand
50 times per flight.  The planner runs once per flight shard-group
inside ``Executor.execute_batch``, after the semantic-cache probe and
before the batched device passes, and applies three transformations:

**Flight-level CSE** — every eligible subtree is hashed by its rescache
canonical form (commutative children sorted, exec/rescache.py).  A
canonical form occurring two or more times across the flight is
evaluated ONCE through :meth:`Executor.cached_execute_call` — so the
materialized row rides the same per-fragment ``(epoch, version)``
vector the result cache tracks, which is what keeps sharing correct
under concurrent ingest — and the row is grafted into each consumer as
an internal ``__shared__`` node.  Unlike JAX, whose grafted trees fall
to Row algebra on device arrays, the port keeps grafted trees on the
tree kernel: ``astbatch`` signs a graft node as a leaf of one stack that
holds the flight's shared rows (``Executor._shared_stack``, uploaded
once a flight), so the flight pays one subtree evaluation (itself on the
tree kernel when its stacks are live or the flight demands them) plus
its consumers' launches, never a host combine per consumer.

**Cost-based reordering** — children of commutative operators
(``Intersect``/``Union``/``Xor``, and the subtrahend tail of
``Difference``) are reordered cheapest-first using per-fragment
density stats cached per fragment version (``Fragment.
container_profile`` — the same numbers ``/debug/fragments`` reports),
so the host fold short-circuits early: ``Executor._combine`` stops an
Intersect the moment the running row is provably empty.  Reordering
never changes cache keys: canonical forms sort commutative children
anyway, and lookup tokens are captured before planning runs.

**Measured lane choice** — the gram-vs-host-scan and batch-vs-solo
warm-up gates (``_PAIR_SINGLE_WARM``, the ``demand >= 2`` stack gate)
are overridden by measured prices once the device cost ledger has
samples: the device lane's per-sig-class EWMA device-ms
(``devledger.measured_ms``) against the host lane's EWMA wall-ms noted
by the executor's latency tier.  Until BOTH lanes have
``MIN_SAMPLES`` the hardcoded heuristics stand — cache-vs-compute
stays always-cache (a rescache hit is strictly cheaper than any lane).
In the port the device lane's price is the device time of one launch of
the kernel that serves it, read from the kernel's CUDA event pairs
(``kernels.gram`` for a pair Count, ``kernels.tree_count`` for a tree
Count), never host wall time.

Observability: decisions surface as ``planner.cse`` / ``planner.
reorder`` spans under ``?profile=true``, ``pilosa_planner_{cse_hits,
reorders,lane_overrides}`` series in ``/metrics`` (booked through the
holder stats client like rescache's counters), a ``planner`` block in
``/debug/vars``, and per-flight deltas annotated by the batcher.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec import rescache
from pilosa_tpu_torch.obs import devledger, qprofile
from pilosa_tpu_torch.pql.ast import Call

# Internal graft node name: never parseable from PQL, a shared-stack leaf
# to astbatch.match_tree, and unknown to rescache.collect_fields
# (uncacheable — a grafted tree can never leak into a cache entry's key or
# a maintained recompute closure).
SHARED = "__shared__"

# Subtree shapes worth sharing: operator nodes whose evaluation combines
# children (a bare Row is as cheap to re-read as to graft).
_CSE_OPS = {"Intersect", "Union", "Difference", "Xor", "Not"}

# Fully-commutative operators; Difference commutes only past its head.
_COMMUTATIVE = {"Intersect", "Union", "Xor"}

# Unpriceable subtrees sort last (stable), never first.
_UNKNOWN_COST = float("inf")


def make_shared(row) -> Call:
    """A graft node carrying a materialized Row.  The row rides as an
    instance attribute, NOT an arg: ``Call.__str__`` renders args, and a
    Row must never leak into a serialized form."""
    node = Call(SHARED)
    node._planner_row = row
    return node


def shared_row(call: Call):
    """The materialized Row a graft node carries (Executor._bitmap_call
    copies it before segment algebra, like a cache hit)."""
    return call._planner_row


def shared_rows(call: Call, out: dict) -> dict:
    """Add the row of every graft node in ``call`` to ``out`` under the
    row's identity (the key ``astbatch`` signs the leaf with)."""
    if call.name == SHARED:
        row = shared_row(call)
        out[id(row)] = row
    for c in call.children:
        shared_rows(c, out)
    return out


def contains_shared(call: Call) -> bool:
    """Whether a tree holds any graft node — lane-choice wall-ms notes
    skip such trees (a post-CSE combine is not a solo-evaluation price)."""
    if call.name == SHARED:
        return True
    return any(contains_shared(c) for c in call.children)


class LaneChooser:
    """Measured gram-vs-scan / batch-vs-solo arbitration.

    The device lane's price comes from the cost ledger's per-sig-class
    EWMA device-ms (obs/devledger.py); the host lane's price is noted
    here by the executor's latency tier.  ``decide`` keeps the caller's
    heuristic until both lanes have ``MIN_SAMPLES`` — a cold ledger
    must never flip behavior — then picks the cheaper lane, counting an
    override whenever that differs from what the heuristic chose."""

    MIN_SAMPLES = 4
    _ALPHA = 0.25

    # op class -> the ledger (site, sig class) that prices its device
    # lane: the device ms of one launch of the kernel serving it
    DEVICE_SOURCES = {
        "pair_count": ("kernels.gram", "gram"),
        "tree_count": ("kernels.tree_count", "tree_count"),
    }

    def __init__(self):
        self._lock = threading.Lock()
        self._host: dict[str, list] = {}  # op class -> [n, EWMA wall-ms]

    def note_host(self, op_class: str, wall_ms: float) -> None:
        with self._lock:
            row = self._host.get(op_class)
            if row is None:
                self._host[op_class] = [1, wall_ms]
            else:
                row[0] += 1
                row[1] += self._ALPHA * (wall_ms - row[1])

    def prefer_device(self, op_class: str) -> bool | None:
        """True/False once both lanes are priced; None = no opinion."""
        src = self.DEVICE_SOURCES.get(op_class)
        if src is None:
            return None
        dev = devledger.measured_ms(*src)
        if dev is None or dev[0] < self.MIN_SAMPLES:
            return None
        with self._lock:
            host = self._host.get(op_class)
            if host is None or host[0] < self.MIN_SAMPLES:
                return None
            return dev[1] <= host[1]

    def snapshot(self) -> dict:
        with self._lock:
            host = {
                cls: {"samples": row[0], "ewmaMs": round(row[1], 4)}
                for cls, row in sorted(self._host.items())
            }
        device = {}
        for cls, src in self.DEVICE_SOURCES.items():
            m = devledger.measured_ms(*src)
            if m is not None:
                device[cls] = {"launches": m[0], "ewmaMs": round(m[1], 4)}
        return {"host": host, "device": device}


class FlightPlanner:
    """One planner per Executor; all counters are monotonic (the batcher
    snapshots them around a flight to annotate per-flight deltas)."""

    def __init__(self, executor, enabled: bool = True):
        self.executor = executor
        self.enabled = enabled
        self.lanes = LaneChooser()
        self._lock = threading.Lock()
        # consumers served from a flight-shared evaluation beyond the
        # first (the CSE analogue of a cache hit)
        self.cse_hits = 0
        # distinct canonical subtrees materialized once per flight
        self.cse_shared = 0
        # operator nodes whose child order actually changed
        self.reorders = 0
        # lane decisions that contradicted the warm-up heuristic
        self.lane_overrides = 0
        # planning passes that degraded to unplanned execution
        self.errors = 0

    # ------------------------------------------------------------- stats

    def _count(self, counter: str, n: int = 1) -> None:
        if not n:
            return
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)
        stats = getattr(self.executor.holder, "stats", None)
        if stats is not None:
            # same client pattern as rescache: surfaces as
            # pilosa_planner_<counter> in /metrics
            stats.count(f"planner_{counter}", n)

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "enabled": self.enabled,
                "cseHits": self.cse_hits,
                "cseShared": self.cse_shared,
                "reorders": self.reorders,
                "laneOverrides": self.lane_overrides,
                "errors": self.errors,
            }
        snap["lanes"] = self.lanes.snapshot()
        return snap

    # -------------------------------------------------------- lane choice

    def choose_lane(self, op_class: str, heuristic: bool) -> bool:
        """The engage/decline verdict for a device-lane gate: measured
        price when both lanes are sampled, the caller's heuristic
        otherwise."""
        if not self.enabled:
            return heuristic
        pref = self.lanes.prefer_device(op_class)
        if pref is None:
            return heuristic
        if pref != heuristic:
            self._count("lane_overrides")
        return pref

    def note_host_lane(self, op_class: str, wall_ms: float) -> None:
        if self.enabled:
            self.lanes.note_host(op_class, wall_ms)

    # ----------------------------------------------------------- planning

    def plan_group(
        self,
        idx: Index,
        calls: list[Call],
        shards: list[int] | None,
        results: list[Any],
        unset: Any,
    ) -> None:
        """Plan one shard-group of a flight in place: reorder commutative
        children cheapest-first, then share canonical subtrees.  Runs
        AFTER the rescache probe (tokens/keys are already captured, so
        mutation here cannot shift cache identity) and BEFORE the batch
        passes (grafted trees must decline them).  Any planning failure
        degrades that transformation to a no-op — the flight still
        executes unplanned."""
        if not self.enabled:
            return
        try:
            t0 = time.perf_counter()
            reorders = self._reorder_pass(idx, calls, shards, results, unset)
            if reorders:
                qprofile.annotate(
                    "planner.reorder",
                    (time.perf_counter() - t0) * 1e3,
                    reorders=reorders,
                )
        except Exception:
            self._count("errors")
        try:
            t0 = time.perf_counter()
            shared, hits = self._cse_pass(
                idx, calls, shards, results, unset
            )
            if shared:
                qprofile.annotate(
                    "planner.cse",
                    (time.perf_counter() - t0) * 1e3,
                    shared=shared,
                    hits=hits,
                )
        except Exception:
            self._count("errors")

    # -- cost-based reordering --------------------------------------------

    def _reorder_pass(self, idx, calls, shards, results, unset) -> int:
        shard_list = self.executor._shards_for(idx, shards)
        cache: dict[str, tuple[int, int]] = {}
        changed = 0
        for i, call in enumerate(calls):
            if results[i] is not unset:
                continue
            root = None
            if call.name in _CSE_OPS:
                root = call
            elif call.name == "Count" and len(call.children) == 1:
                root = call.children[0]
            if root is not None:
                changed += self._reorder_tree(idx, root, shard_list, cache)
        self._count("reorders", changed)
        return changed

    def _reorder_tree(self, idx, node, shard_list, cache) -> int:
        if node.name == SHARED:
            return 0
        changed = 0
        for c in node.children:
            changed += self._reorder_tree(idx, c, shard_list, cache)
        kids = node.children
        if node.name in _COMMUTATIVE and len(kids) > 1:
            order = self._cost_order(idx, kids, shard_list, cache)
            if order != list(range(len(kids))):
                node.children = [kids[j] for j in order]
                changed += 1
        elif node.name == "Difference" and len(kids) > 2:
            order = self._cost_order(idx, kids[1:], shard_list, cache)
            if order != list(range(len(kids) - 1)):
                node.children = [kids[0]] + [kids[1 + j] for j in order]
                changed += 1
        return changed

    def _cost_order(self, idx, kids, shard_list, cache) -> list[int]:
        costs = [
            self._subtree_cost(idx, c, shard_list, cache) for c in kids
        ]
        # stable: original position breaks ties, so equal-cost flights
        # reorder identically and compiled sigs stay put
        return sorted(range(len(kids)), key=lambda j: (costs[j], j))

    def _subtree_cost(self, idx, call, shard_list, cache) -> float:
        """Expected result mass of a subtree, from version-cached
        fragment density stats — a selectivity proxy, not a latency
        model: Intersect is bounded by its sparsest child, Union/Xor
        accumulate, Difference is bounded by its head."""
        name = call.name
        if name == SHARED:
            # already materialized: free to combine, so it sorts first
            # and empty shared rows short-circuit the whole fold
            return 0.0
        if name in ("Row", "Range"):
            fname = call.args.get("_field") or call.field_arg()
            if not isinstance(fname, str):
                return _UNKNOWN_COST
            bits, rows = self._field_mass(idx, fname, shard_list, cache)
            if call.has_conditions():
                # a BSI predicate can select any fraction of the column
                # space; price the full field mass
                return float(bits)
            # one plain row: the field's average row density
            return bits / rows if rows else 0.0
        if name in ("Not", "All"):
            bits, _ = self._field_mass(idx, "_exists", shard_list, cache)
            return float(bits)
        if name in _COMMUTATIVE or name == "Difference":
            kid_costs = [
                self._subtree_cost(idx, c, shard_list, cache)
                for c in call.children
            ]
            if not kid_costs:
                return _UNKNOWN_COST
            if name == "Intersect":
                return min(kid_costs)
            if name == "Difference":
                return kid_costs[0]
            return sum(kid_costs)
        return _UNKNOWN_COST

    def _field_mass(self, idx, fname, shard_list, cache):
        """(set bits, materialized rows) over one field's fragments for
        the shard list, from the per-version container_profile cache."""
        hit = cache.get(fname)
        if hit is not None:
            return hit
        bits = rows = 0
        field = idx.field(fname)
        if field is not None:
            vname = (
                field.bsi_view_name() if field.is_bsi() else VIEW_STANDARD
            )
            view = field.view(vname)
            if view is not None:
                for s in shard_list:
                    frag = view.fragment(s)
                    if frag is not None:
                        prof = frag.container_profile(containers=False)
                        bits += prof["bits"]
                        rows += prof["rows"]
        cache[fname] = (bits, rows)
        return bits, rows

    # -- flight-level CSE ---------------------------------------------------

    def _cse_pass(self, idx, calls, shards, results, unset):
        """Returns (shared subtrees materialized, consumer grafts beyond
        the first).  Occurrence collection and grafting are two passes:
        counting first over every candidate node, then grafting
        top-down so an occurrence nested inside an already-grafted
        subtree is never double-evaluated."""
        occurrences: dict[str, int] = {}
        roots: list[tuple[int, Call, Call | None]] = []
        for i, call in enumerate(calls):
            if results[i] is not unset:
                continue
            if call.name in _CSE_OPS:
                roots.append((i, call, None))
                self._collect(idx, call, occurrences)
            elif call.name == "Count" and len(call.children) == 1:
                child = call.children[0]
                if child.name in _CSE_OPS:
                    roots.append((i, child, call))
                    self._collect(idx, child, occurrences)
        shared_keys = {k for k, n in occurrences.items() if n >= 2}
        if not shared_keys:
            return 0, 0
        rows: dict[str, Any] = {}
        failed: set[str] = set()
        grafts = 0

        def materialize(key: str, node: Call):
            if key in rows:
                return rows[key]
            # Evaluate a CLONE: the consumer's own node gets grafted
            # over afterwards, and the evaluated tree must stay intact
            # for per-fragment version tracking in the cache layer.
            row = self.executor.cached_execute_call(
                idx, node.clone(), shards, consumers=occurrences[key]
            )
            rows[key] = row
            return row

        def graft(node: Call) -> Call | None:
            """Top-down: replace the HIGHEST shared node and do not
            descend into it; returns the replacement or None."""
            nonlocal grafts
            key = self._subtree_key(idx, node)
            if key in shared_keys and key not in failed:
                try:
                    row = materialize(key, node)
                except Exception:
                    # evaluation failure belongs to each consumer's own
                    # demux scope — leave every occurrence unplanned
                    failed.add(key)
                    return None
                grafts += 1
                return make_shared(row)
            for ci, c in enumerate(node.children):
                rep = graft(c)
                if rep is not None:
                    node.children[ci] = rep
            return None

        for i, root, parent in roots:
            rep = graft(root)
            if rep is None:
                continue
            if parent is not None:
                parent.children[0] = rep
            else:
                # whole top-level call shared: serve the slot directly,
                # copied like a cache hit so attrs/keys attach per query
                results[i] = rescache.copy_result(shared_row(rep))
        hits = max(0, grafts - len(rows)) if rows else 0
        self._count("cse_shared", len(rows))
        self._count("cse_hits", hits)
        return len(rows), hits

    def _collect(self, idx, node, occurrences) -> None:
        key = self._subtree_key(idx, node)
        if key is not None:
            occurrences[key] = occurrences.get(key, 0) + 1
        for c in node.children:
            if c.name in _CSE_OPS:
                self._collect(idx, c, occurrences)

    def _subtree_key(self, idx, node) -> str | None:
        if node.name not in _CSE_OPS:
            return None
        return rescache.subtree_key(idx, node)
