"""Flight-driven predictive prefetch: stage the next flight's device
assets while the previous one computes (counterpart of
``pilosa_tpu/server/prefetch.py``).

The batcher's admission queue is an oracle the storage tier never had:
at window close (and at every submit) the full (index, query, shards)
set of an upcoming flight is known before any kernel launches.  This
module resolves that set to the *field stacks* the batched dispatch will
consume (exec/executor.py ``_field_stack`` — the serving tier's
device-resident unit; per-call reads answer from host mirrors), filters
to the ones not currently cached, and rides them onto the ingest
``DeviceUploader``'s low-priority queue (ingest/pipeline.py) — the H2D
build overlaps the in-flight dispatch instead of stalling the next one.
On the card the build runs on the uploader's own stream through its
pinned slots, and the stack's cache entry carries the event after the
copy, which the dispatch's stream waits for (``ops/streams.py``).
Everything here is advisory and bounded:

* resolution never takes a stack lock (the ``_stack_cached`` peek is
  racy by design; a stale read costs at most a wasted, booked build);
* fully-resident processes skip the whole path (a budget with no cap
  can never evict, so there is nothing to predict). The port's budget
  caps at 80 % of the card's memory unless told otherwise
  (``core/membudget.py``), so on the card the prefetcher is on;
* a busy uploader drops prefetches rather than queueing unboundedly —
  the dispatch then pays its own build, exactly the pre-prefetch
  behavior;
* a dispatch that needs a stack whose prefetch is still queued claims it
  (``Executor.prefetch_issued``) and builds the stack itself, never
  waiting for the uploader; the uploader then skips the job. A prefetch
  already started races the dispatch for the stack lock, as in JAX.

Accounting flows through core/residency.py: issued at submit, useful on
the first query hit against a prefetch-built stack or when a dispatch
claims the prefetch (the bar is useful/issued >= 0.5).
"""

from __future__ import annotations

import time

from pilosa_tpu_torch.core import membudget, residency
from pilosa_tpu_torch.obs import qprofile

# Per-flight ceiling: a pathological flight (hundreds of distinct
# fields) must not convert the prefetch queue into a full index crawl;
# beyond this the tail pays cold builds as before.
MAX_TARGETS_PER_FLIGHT = 32

# Once a stack is staged, don't re-issue it for this long: the uploader
# dedups keys while they sit in its queue, but between dequeue and the
# build landing in the cache the racy ``_stack_cached`` peek reads cold
# and a burst would book one issued-but-wasted build per submit.  Kept
# short — it only needs to cover that dequeue->landed gap; anything
# longer blocks legitimate RE-staging after the budget evicts the stack
# (under heavy oversubscription that demotes warm-tail queries to the
# per-call fallback path for the whole suppression window).
REISSUE_TTL = 0.05  # seconds


def fields_of_query(query) -> set[str]:
    """Field names a parsed PQL query can touch, from the call tree:
    ``Row(f=1)``-style field args, explicit ``_field``/``field`` args,
    and every nested call (children and call-valued args)."""
    names: set[str] = set()

    def walk(call):
        f = call.args.get("_field")
        if isinstance(f, str):
            names.add(f)
        f = call.args.get("field")
        if isinstance(f, str):
            names.add(f)
        fa = call.field_arg()
        if fa is not None:
            names.add(fa)
        for v in call.args.values():
            if hasattr(v, "args") and hasattr(v, "children"):
                walk(v)
        for c in call.children:
            walk(c)

    for call in query.calls:
        walk(call)
    return names


class _StackTarget:
    """Uploadable wrapper: quacks like a fragment for the DeviceUploader
    (``device_bits`` = build the stack; ``device`` = the card it goes to;
    ``prefetch_key`` = stable dedup identity across flights)."""

    __slots__ = ("executor", "field", "shards", "view", "prefetch_key", "device", "note")

    def __init__(self, executor, field, shards, view):
        self.executor = executor
        self.field = field
        self.shards = shards
        self.view = view
        self.prefetch_key = (id(field), tuple(shards), view)
        self.device = executor.holder.device
        # the executor's note of this prefetch (Executor.prefetch_issued)
        self.note = None

    def device_bits(self):
        self.executor.prefetch_stack(self.field, self.shards, self.view, self.note)


def stack_pairs_of_query(idx, query) -> list[tuple[str, str]]:
    """The distinct (field, view) stack pairs the batched dispatch would
    demand for this query — resolved with the *same* matcher
    ``_batch_general`` compiles with (exec/astbatch.py), so the
    prediction is exact: a bare ``Count(Row)`` (segment path, host-side)
    stages nothing, while a ``Count(Intersect(...))`` stages every leaf
    view including time-range covers and the Not existence row."""
    from pilosa_tpu_torch.exec import astbatch

    out: list[tuple[str, str]] = []
    for call in query.calls:
        leaves: list = []
        pairs: list[tuple[str, str]] = []
        if astbatch.match_count(idx, call, leaves, pairs) is None:
            if call.name not in (
                "Intersect", "Union", "Difference", "Xor", "Not",
            ):
                continue
            leaves, pairs = [], []
            if astbatch.match_tree(idx, call, leaves, pairs) is None:
                continue
        for pair in pairs:
            if pair not in out:
                out.append(pair)
    return out


class FlightPrefetcher:
    """Resolves flights to not-yet-resident field stacks and stages them
    on the shared DeviceUploader (ingest keeps strict priority)."""

    def __init__(
        self,
        holder,
        uploader,
        executor,
        max_per_flight: int = MAX_TARGETS_PER_FLIGHT,
    ):
        self.holder = holder
        self.uploader = uploader
        self.executor = executor
        self.max_per_flight = max_per_flight
        self.flights = 0  # flights that issued at least one prefetch
        # prefetch_key -> monotonic issue time (REISSUE_TTL suppression);
        # touched only from submit/dispatch threads under no lock — a
        # lost update just re-issues one prefetch
        self._recent: dict[tuple, float] = {}

    def _candidates(self, index: str, query, shards):
        idx = self.holder.index(index)
        if idx is None:
            return
        if shards is None:
            shard_list = sorted(idx.available_shards())
        else:
            shard_list = sorted(shards)
        if not shard_list:
            return
        for fname, vname in stack_pairs_of_query(idx, query):
            field = idx.field(fname)
            if field is None or field.view(vname) is None:
                continue
            # racy peek by design: a stale read costs one wasted build
            if self.executor._stack_cached(field, shard_list, vname):
                continue
            yield _StackTarget(self.executor, field, shard_list, vname)

    def prefetch_flight(self, flights) -> int:
        """Stage every not-yet-cached stack the flight set will touch;
        returns the number of prefetches actually queued.  Must never
        raise into the serving path."""
        budget = membudget.default_budget(self.holder.device)
        if budget.cap is None:
            return 0  # nothing can be evicted; nothing to predict
        tracker = residency.default_tracker()
        t0 = time.perf_counter()
        now = time.monotonic()
        issued = 0
        seen: set[tuple] = set()
        try:
            for index, query, shards in flights:
                for target in self._candidates(index, query, shards):
                    if target.prefetch_key in seen:
                        continue
                    seen.add(target.prefetch_key)
                    if now - self._recent.get(target.prefetch_key, -1e9) < REISSUE_TTL:
                        continue  # staged moments ago; let it land
                    if issued >= self.max_per_flight:
                        tracker.note_prefetch_dropped()
                        continue
                    # noted before it is queued, so its end cannot come first
                    target.note = self.executor.prefetch_issued(
                        target.field, target.shards, target.view)
                    if target.note is None:
                        # a prefetch of this stack is already staging
                        tracker.note_prefetch_dropped()
                        continue
                    if self.uploader.submit_prefetch(target, self._done):
                        issued += 1
                        tracker.note_prefetch_issued()
                        self._recent[target.prefetch_key] = now
                        if len(self._recent) > 4096:
                            self._recent = {
                                k: t
                                for k, t in self._recent.items()
                                if now - t < REISSUE_TTL
                            }
                    else:
                        self._done(target, None)
                        tracker.note_prefetch_dropped()
        except Exception:
            tracker.note_prefetch_error()
            return issued
        if issued:
            self.flights += 1
            qprofile.annotate(
                "residency.prefetch",
                duration_ms=(time.perf_counter() - t0) * 1e3,
                issued=issued,
            )
        return issued

    def prefetch_query(self, index: str, query, shards) -> int:
        """Submit-time staging for one query (handler thread): overlaps
        the build with whatever flight is currently dispatching."""
        return self.prefetch_flight([(index, query, shards)])

    def _done(self, target, err) -> None:
        self.executor.prefetch_ended(target.field, target.shards, target.view, target.note)
        if err is not None:
            residency.default_tracker().note_prefetch_error()

    def snapshot(self) -> dict:
        return {
            "flights": self.flights,
            "maxPerFlight": self.max_per_flight,
        }
