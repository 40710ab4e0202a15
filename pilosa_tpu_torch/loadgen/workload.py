"""Deterministic workload generation for the SLO load harness
(counterpart of ``pilosa_tpu/loadgen/workload.py``, kept equal to it: the
same seed and configuration give the same ops, byte for byte, and so the
same :func:`fingerprint`).

The generator pre-computes the ENTIRE request sequence from a seed
before any request is sent: op kinds from configurable mix weights,
row/column popularity from a zipfian sampler (the YCSB access-skew
model — a few hot keys take most of the traffic, the "millions of
users" shape), timestamps from a fixed base instant.  Two generators
built from the same config emit byte-identical sequences
(:func:`fingerprint` proves it), which is what makes an SLO_r*.json
report reproducible and diffable across code changes.

Op kinds map onto the server's SLO op classes (obs/slo.py):

    count / row / topn / range_time / groupby  -> read.*
    range_bsi                                  -> read.range, int-field
                                                  predicates that ride
                                                  the query-batched BSI
                                                  lane
    set / set_tq / set_val                     -> write
    key_set / key_count                        -> write / read.count,
                                                  via string keys (the
                                                  translation hot path)
    translate                                  -> translate
    import_batch                               -> import
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

# Fixed time base for time-quantum ops: generation must not read the
# wall clock (determinism), and 2026-01 spans month/day view edges.
TIME_BASE_YEAR = 2026
TIME_BASE_MONTH = 1
N_TQ_DAYS = 28
N_TQ_HOURS = N_TQ_DAYS * 24

# Int (BSI) field driven by range_bsi/set_val: bounds sized so the
# depth matches a realistic metric column and predicates land in-band.
BSI_FIELD = "val"
BSI_VAL_MIN = -4096
BSI_VAL_MAX = 4096

DEFAULT_MIX: dict[str, float] = {
    "count": 22.0,
    "row": 8.0,
    "topn": 6.0,
    "range_time": 8.0,
    "range_bsi": 6.0,
    "groupby": 4.0,
    "set": 12.0,
    "set_val": 4.0,
    "set_tq": 12.0,
    "key_set": 8.0,
    "key_count": 8.0,
    "translate": 6.0,
    "import_batch": 2.0,
}

# Expected server-side SLO class per op kind (report verdicts join on
# these).
OP_CLASS: dict[str, str] = {
    "count": "read.count",
    "row": "read.row",
    "topn": "read.topn",
    "range_time": "read.range",
    "range_bsi": "read.range",
    "groupby": "read.groupby",
    "set": "write",
    "set_tq": "write",
    "set_val": "write",
    "key_set": "write",
    "key_count": "read.count",
    "translate": "translate",
    "import_batch": "import",
}


class WorkloadConfig:
    """Seeded workload shape.  ``index`` is the unkeyed segmentation
    index (fields ``seg`` set + ``ev`` time-quantum); ``keys_index`` is
    the keyed index (field ``tag``, row+column keys) that puts string
    translation on the hot path."""

    def __init__(
        self,
        seed: int = 42,
        index: str = "slo_bench",
        keys_index: str = "slo_keys",
        n_rows: int = 32,
        n_cols: int = 50_000,
        n_user_keys: int = 2_000,
        zipf_theta: float = 0.99,
        import_batch_size: int = 256,
        mix: dict[str, float] | None = None,
    ):
        self.seed = int(seed)
        self.index = index
        self.keys_index = keys_index
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.n_user_keys = int(n_user_keys)
        self.zipf_theta = float(zipf_theta)
        self.import_batch_size = int(import_batch_size)
        self.mix = dict(DEFAULT_MIX if mix is None else mix)
        unknown = set(self.mix) - set(OP_CLASS)
        if unknown:
            raise ValueError(f"unknown op kinds in mix: {sorted(unknown)}")

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "index": self.index,
            "keysIndex": self.keys_index,
            "nRows": self.n_rows,
            "nCols": self.n_cols,
            "nUserKeys": self.n_user_keys,
            "zipfTheta": self.zipf_theta,
            "importBatchSize": self.import_batch_size,
            "mix": self.mix,
        }


class Zipf:
    """Seedless zipfian rank sampler over ``[0, n)``: rank r drawn with
    probability ∝ 1/(r+1)^theta via inverse-CDF lookup.  The caller
    owns the rng so one generator stream drives every sampler
    (determinism is a property of the whole sequence, not each
    sampler)."""

    def __init__(self, n: int, theta: float):
        # JAX's arithmetic, element for element, done in place: at the
        # serving size (2^27 columns and more) each temporary is over 1 GB
        cdf = np.arange(1, n + 1, dtype=np.float64)
        np.power(cdf, -theta, out=cdf)
        np.cumsum(cdf, out=cdf)
        cdf /= cdf[-1]
        self._cdf = cdf

    def sample(self, rng: np.random.Generator) -> int:
        return int(np.searchsorted(self._cdf, rng.random(), side="right"))


class Op:
    """One generated request: kind + the HTTP request to issue."""

    __slots__ = ("kind", "op_class", "method", "path", "body", "ctype")

    def __init__(self, kind: str, method: str, path: str, body: bytes, ctype: str):
        self.kind = kind
        self.op_class = OP_CLASS[kind]
        self.method = method
        self.path = path
        self.body = body
        self.ctype = ctype

    def to_wire(self) -> dict:
        return {
            "kind": self.kind,
            "method": self.method,
            "path": self.path,
            "body": self.body.decode("utf-8", "replace"),
        }


def fingerprint(ops: list[Op]) -> str:
    """sha256 over the canonical serialization of the full sequence —
    two same-seed runs must produce the same value."""
    h = hashlib.sha256()
    for op in ops:
        h.update(op.method.encode())
        h.update(op.path.encode())
        h.update(op.body)
        h.update(b"\x00")
    return h.hexdigest()


class WorkloadGenerator:
    """Pre-computes deterministic op sequences from the config seed.
    Each :meth:`sequence` call advances the generator's single rng
    stream, so consecutive stage sequences are distinct but the overall
    run replays exactly from the seed."""

    def __init__(self, config: WorkloadConfig):
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        self._row_zipf = Zipf(config.n_rows, config.zipf_theta)
        self._col_zipf = Zipf(config.n_cols, config.zipf_theta)
        self._key_zipf = Zipf(config.n_user_keys, config.zipf_theta)

    # -- op builders ---------------------------------------------------

    def _ts(self, hour: int) -> str:
        day, h = divmod(hour, 24)
        return (
            f"{TIME_BASE_YEAR}-{TIME_BASE_MONTH:02d}-"
            f"{day + 1:02d}T{h:02d}:00"
        )

    def _query_op(self, kind: str, index: str, pql: str) -> Op:
        return Op(
            kind, "POST", f"/index/{index}/query", pql.encode(), "text/plain"
        )

    def _build(self, kind: str) -> Op:
        cfg = self.config
        rng = self._rng
        if kind == "count":
            r = self._row_zipf.sample(rng)
            if rng.random() < 0.3:
                r2 = self._row_zipf.sample(rng)
                return self._query_op(
                    kind, cfg.index,
                    f"Count(Intersect(Row(seg={r}), Row(seg={r2})))",
                )
            return self._query_op(kind, cfg.index, f"Count(Row(seg={r}))")
        if kind == "row":
            r = self._row_zipf.sample(rng)
            return self._query_op(kind, cfg.index, f"Row(seg={r})")
        if kind == "topn":
            return self._query_op(kind, cfg.index, "TopN(seg, n=5)")
        if kind == "range_time":
            r = self._row_zipf.sample(rng)
            d1 = int(rng.integers(0, N_TQ_DAYS - 1))
            span = int(rng.integers(1, 4))
            d2 = min(d1 + span, N_TQ_DAYS - 1)
            return self._query_op(
                kind, cfg.index,
                f"Range(ev={r}, {self._ts(d1 * 24)}, {self._ts(d2 * 24)})",
            )
        if kind == "range_bsi":
            # Top-level Range() so obs/slo.py classifies it read.range;
            # concurrent emitters coalesce into one query-batched BSI
            # flight server-side (ops/bsi.py range_count_batch and kin).
            b = int(rng.integers(BSI_VAL_MIN, BSI_VAL_MAX))
            shape = rng.random()
            if shape < 0.4:
                pql = f"Range({BSI_FIELD} < {b})"
            elif shape < 0.8:
                pql = f"Range({BSI_FIELD} > {b})"
            else:
                span = int(rng.integers(1, (BSI_VAL_MAX - BSI_VAL_MIN) // 8))
                pql = (
                    f"Range({BSI_FIELD} >< "
                    f"[{b}, {min(b + span, BSI_VAL_MAX)}])"
                )
            return self._query_op(kind, cfg.index, pql)
        if kind == "groupby":
            return self._query_op(kind, cfg.index, "GroupBy(Rows(seg), limit=8)")
        if kind == "set":
            r = self._row_zipf.sample(rng)
            c = self._col_zipf.sample(rng)
            return self._query_op(kind, cfg.index, f"Set({c}, seg={r})")
        if kind == "set_tq":
            r = self._row_zipf.sample(rng)
            c = self._col_zipf.sample(rng)
            hour = int(rng.integers(0, N_TQ_HOURS))
            return self._query_op(
                kind, cfg.index, f"Set({c}, ev={r}, {self._ts(hour)})"
            )
        if kind == "set_val":
            c = self._col_zipf.sample(rng)
            v = int(rng.integers(BSI_VAL_MIN, BSI_VAL_MAX))
            return self._query_op(
                kind, cfg.index, f"Set({c}, {BSI_FIELD}={v})"
            )
        if kind == "key_set":
            k = self._key_zipf.sample(rng)
            r = self._row_zipf.sample(rng)
            return self._query_op(
                kind, cfg.keys_index, f'Set("user{k}", tag="t{r}")'
            )
        if kind == "key_count":
            r = self._row_zipf.sample(rng)
            return self._query_op(
                kind, cfg.keys_index, f'Count(Row(tag="t{r}"))'
            )
        if kind == "translate":
            ks = sorted({self._key_zipf.sample(rng) for _ in range(8)})
            body = json.dumps(
                {
                    "index": cfg.keys_index,
                    "field": "",
                    "keys": [f"user{k}" for k in ks],
                }
            ).encode()
            return Op(
                kind, "POST", "/internal/translate/keys", body,
                "application/json",
            )
        if kind == "import_batch":
            n = cfg.import_batch_size
            rows = [self._row_zipf.sample(rng) for _ in range(n)]
            cols = [self._col_zipf.sample(rng) for _ in range(n)]
            body = json.dumps({"rowIDs": rows, "columnIDs": cols}).encode()
            return Op(
                kind, "POST", f"/index/{cfg.index}/field/seg/import", body,
                "application/json",
            )
        raise ValueError(f"unknown op kind: {kind}")

    # -- sequence ------------------------------------------------------

    def sequence(self, n: int, mix: dict[str, float] | None = None) -> list[Op]:
        """The next ``n`` ops of this generator's stream, kinds drawn
        from ``mix`` (default: the config mix)."""
        weights = dict(self.config.mix if mix is None else mix)
        kinds = sorted(weights)
        p = np.array([weights[k] for k in kinds], dtype=np.float64)
        if p.sum() <= 0:
            raise ValueError("mix weights must sum > 0")
        p /= p.sum()
        choices = self._rng.choice(len(kinds), size=n, p=p)
        return [self._build(kinds[i]) for i in choices]

    def sequence_repeat(
        self,
        n: int,
        mix: dict[str, float] | None = None,
        pool_size: int = 16,
        pool_theta: float | None = None,
    ) -> list[Op]:
        """The next ``n`` ops with a repeat-heavy read side: reads are
        drawn ZIPFIAN FROM A SMALL POOL of ``pool_size`` pre-built query
        templates instead of being freshly randomized, so the same exact
        queries recur the way dashboard refreshes do — the traffic shape
        the semantic result cache (docs/caching.md) exists for.  Writes
        (and every non-read kind) still randomize per-op from the mix,
        so cache entries face live invalidation pressure.  Deterministic
        like :meth:`sequence`: one rng stream drives the pool build, the
        kind draws, and the pool picks."""
        weights = dict(self.config.mix if mix is None else mix)
        read_weights = {
            k: w
            for k, w in weights.items()
            if OP_CLASS[k].startswith("read.") and w > 0
        }
        if not read_weights:
            return self.sequence(n, mix)
        # pool build advances the same stream (replays from the seed)
        pool = self.sequence(max(1, int(pool_size)), read_weights)
        pool_zipf = Zipf(
            len(pool),
            self.config.zipf_theta if pool_theta is None else pool_theta,
        )
        kinds = sorted(weights)
        p = np.array([weights[k] for k in kinds], dtype=np.float64)
        if p.sum() <= 0:
            raise ValueError("mix weights must sum > 0")
        p /= p.sum()
        choices = self._rng.choice(len(kinds), size=n, p=p)
        out: list[Op] = []
        for i in choices:
            kind = kinds[i]
            if kind in read_weights:
                out.append(pool[pool_zipf.sample(self._rng)])
            else:
                out.append(self._build(kind))
        return out

    def sequence_shared(
        self,
        n: int,
        mix: dict[str, float] | None = None,
        pool_size: int = 8,
        pool_theta: float | None = None,
    ) -> list[Op]:
        """The next ``n`` ops with reads replaced by shared-subtree
        FLIGHTS: each read op is one multi-call query whose calls embed
        a common canonical subtree (one occurrence commutatively
        flipped), so calls landing in one server-side batch group are
        the flight planner's CSE shape (docs/serving.md "Flight
        planning").  The shared subtrees carry a BSI condition, keeping
        them off the compiled count path — the dashboard burst where
        planning pays.  Flights are drawn zipfian from ``pool_size``
        pre-built templates; writes still randomize from the mix.
        Deterministic like :meth:`sequence`."""
        weights = dict(self.config.mix if mix is None else mix)
        read_weights = {
            k: w
            for k, w in weights.items()
            if OP_CLASS[k].startswith("read.") and w > 0
        }
        if not read_weights:
            return self.sequence(n, mix)
        rng = self._rng
        pool: list[Op] = []
        for _ in range(max(1, int(pool_size))):
            r = self._row_zipf.sample(rng)
            r2 = self._row_zipf.sample(rng)
            b = int(rng.integers(BSI_VAL_MIN, BSI_VAL_MAX))
            shared = f"Intersect(Row({BSI_FIELD} > {b}), Row(seg={r}))"
            # same canonical form, different child order
            flipped = f"Intersect(Row(seg={r}), Row({BSI_FIELD} > {b}))"
            # 4 of 6 calls consume the shared subtree (>= 50% per flight)
            flight = " ".join(
                [
                    f"Count({shared})",
                    f"Count(Union({flipped}, Row(seg={r2})))",
                    f"Count(Difference({shared}, Row(seg={r2})))",
                    f"Count(Intersect({shared}, Row(seg={r2})))",
                    f"Count(Row(seg={r2}))",
                    f"Count(Row(seg={r}))",
                ]
            )
            pool.append(self._query_op("count", self.config.index, flight))
        pool_zipf = Zipf(
            len(pool),
            self.config.zipf_theta if pool_theta is None else pool_theta,
        )
        kinds = sorted(weights)
        p = np.array([weights[k] for k in kinds], dtype=np.float64)
        if p.sum() <= 0:
            raise ValueError("mix weights must sum > 0")
        p /= p.sum()
        choices = self._rng.choice(len(kinds), size=n, p=p)
        out: list[Op] = []
        for i in choices:
            kind = kinds[i]
            if kind in read_weights:
                out.append(pool[pool_zipf.sample(rng)])
            else:
                out.append(self._build(kind))
        return out


def schema_ops(config: WorkloadConfig) -> list[tuple[str, str, dict]]:
    """Schema the workload needs, as (kind, name, options) steps the
    harness applies through the API before driving load."""
    return [
        ("index", config.index, {}),
        ("field", f"{config.index}/seg", {}),
        ("field", f"{config.index}/ev", {"type": "time", "timeQuantum": "YMD"}),
        (
            "field",
            f"{config.index}/{BSI_FIELD}",
            {"type": "int", "min": BSI_VAL_MIN, "max": BSI_VAL_MAX},
        ),
        ("index", config.keys_index, {"keys": True}),
        ("field", f"{config.keys_index}/tag", {"keys": True}),
    ]
