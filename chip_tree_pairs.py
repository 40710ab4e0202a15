"""Two checkouts of pilosa_tpu_torch in one process, on one CUDA card: the
trees path's queries of ``chip_smoke.py`` (the 1024-call tree batch through
``execute_batch``, the Count of a Union of 300 rows and the three bitmap
trees through ``execute``) in alternating pairs, before and after the same
64 writes, so that a change can be held to its parent query by query.

    python3 chip_tree_pairs.py --a PARENT_DIR --b CHANGE_DIR [--pairs 10]
        [--kernels ROUNDS] [--out FILE] [--device cuda] [--shards 160]

Each checkout's package is imported in turn and its modules kept apart;
before a version runs, its modules are put back in ``sys.modules``. Both
build the same seeded index (``chip_smoke.build_index``). Each query is
timed on the host's clock (``perf_counter`` around ``execute``), with the
time spent in the tree wrappers (``tree_count``, ``tree_words``) beside it.
Every query starts from a full collection (outside its time), so that no
version inherits the other's garbage; then two series: the collector on,
its pauses timed by ``gc.callbacks`` and reported inside each query; and
the collector frozen and off. (Without that collection, a full collection
every other round locks onto one slot of the alternation and lands in the
same version's batch, whichever checkout holds that slot.) The
first query of each kind after the writes (the stacks patched) is kept
apart from the steady rounds. The answers of the two versions must be
equal, and those of one version equal across rounds.

With ``--kernels ROUNDS`` it first times the tree wrappers and the BSI
range scan alone, version by version in turns (a, b, then b, a), on seeded
stacks of the serving shape: the count at ``chip_smoke.direct_tree_shapes``,
one bitmap tree, and ``bsi_range`` at ``chip_smoke.bsi_range_tables`` (the
bench's 128 counts, a words launch at the executor's cap, a lone
condition in both modes), each held to its plain version, with the ms
around the wrapper (CUDA events) and the kernels' device ms
(``torch.profiler``) of each round.

Prints one line per version, phase, series and query (median, least and
greatest ms over the rounds), and writes every time to ``--out`` as JSON.
``--device cpu --shards 2`` runs it on the CPU at a small size (the
wrappers' plain versions), as a check of the script.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (sets the shard width before the port loads)

PKG = "pilosa_tpu_torch"
QUERIES = ("batch", "wide", "bitmap")


def _purge() -> None:
    for m in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[m]


def load(checkout: Path) -> dict:
    """The modules of ``checkout``'s package, imported afresh."""
    if not (checkout / PKG / "__init__.py").is_file():
        raise SystemExit(f"{checkout} holds no {PKG}/")
    _purge()
    sys.path.insert(0, str(checkout))
    try:
        import pilosa_tpu_torch.exec.executor  # noqa: F401
        from pilosa_tpu_torch import convert  # noqa: F401
        from pilosa_tpu_torch.ops import kernels  # noqa: F401
    finally:
        sys.path.remove(str(checkout))
    mods = {m: v for m, v in sys.modules.items() if m == PKG or m.startswith(PKG + ".")}
    origin = Path(mods[PKG].__file__).resolve().parent.parent
    if origin != checkout.resolve():
        raise SystemExit(f"{PKG} loaded from {origin}, not {checkout}")
    return mods


def activate(mods: dict) -> None:
    _purge()
    sys.modules.update(mods)


class Version:
    """One checkout: its modules, index, executor, and a timer on its tree
    wrappers."""

    def __init__(self, label: str, checkout: Path, device: str):
        self.label = label
        self.mods = load(checkout)
        self.wrapper_s = 0.0
        tk = self.mods[PKG + ".ops.kernels"]
        for name in ("tree_count", "tree_words"):
            setattr(tk, name, self._timed(getattr(tk, name)))
        self.holder, _ = cs.build_index(device)
        self.ex = self.mods[PKG + ".exec.executor"].Executor(self.holder)

    def _timed(self, fn):
        def call(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self.wrapper_s += time.perf_counter() - t
        return call


class GcTimer:
    """Seconds of garbage collection, from ``gc.callbacks``."""

    def __init__(self):
        self.total = 0.0
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.total += time.perf_counter() - self._t


def answers(out):
    """A query's answers in a form two versions can compare."""
    if isinstance(out, list) and out and hasattr(out[0], "segments"):
        return [row.count() for row in out]
    return [o[0] if isinstance(o, list) else o for o in out]


def run_query(v: Version, kind: str, q, gct: GcTimer, device: str):
    import torch

    args = ("i", [(c, None) for c in q]) if kind == "batch" else ("i", q)
    fn = v.ex.execute_batch if kind == "batch" else v.ex.execute
    gc.collect()
    w0, g0 = v.wrapper_s, gct.total
    t = time.perf_counter()
    out = fn(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    for o in out:
        if isinstance(o, Exception):
            raise o
    return ms, (v.wrapper_s - w0) * 1e3, (gct.total - g0) * 1e3, answers(out)


def kernel_rounds(versions, rounds: int, device: str) -> dict:
    """``{version: {shape: [(ms, device ms), ...]}}``: each version's tree
    wrappers at the direct shapes and one bitmap tree, and its bsi_range at
    the range shapes, ``rounds`` rounds in turns; every answer equal to the
    plain version's."""
    import numpy as np
    import torch

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 12)

    def stack(rows):
        bits = [torch.randint(-2**31, 2**31 - 1, (cs.S_FULL, rows, cs.W_FULL), dtype=torch.int32,
                              device=dev, generator=gen) for _ in range(2)]
        return bits[0] & bits[1]  # about 25 % dense

    stacks = (stack(cs.R_FULL), stack(cs.R_FULL), stack(cs.H_ROWS))
    # an int field's stack: exists, sign and BSI_DEPTH planes (values in
    # about three quarters of the columns)
    bsi = torch.randint(-2**31, 2**31 - 1, (cs.S_FULL, 2 + cs.BSI_DEPTH, cs.W_FULL),
                        dtype=torch.int32, device=dev, generator=gen)
    bsi[:, 0] |= torch.randint(-2**31, 2**31 - 1, (cs.S_FULL, cs.W_FULL), dtype=torch.int32,
                               device=dev, generator=gen)
    activate(versions[0].mods)
    shapes = cs.direct_tree_shapes(np.random.default_rng(cs.SEED + 13), stacks)
    and3 = shapes[2][1]
    words_slots = shapes[2][2][0]
    range_tables = cs.bsi_range_tables(np.random.default_rng(cs.SEED + 14), cs.S_FULL, cs.W_FULL)
    out = {v.label: {} for v in versions}
    want = {}
    for r in range(rounds):
        for v in versions if r % 2 == 0 else versions[::-1]:
            activate(v.mods)
            tk = v.mods[PKG + ".ops.kernels"]
            tb = v.mods[PKG + ".ops.bsi"]
            calls = [(name, lambda p=p, s=sl: tk.tree_count(stacks, p.code, p.leaf_stack, s),
                      lambda p=p, s=sl: tk.tree_count_plain(stacks, p.code, p.leaf_stack, s))
                     for name, p, sl in shapes]
            calls.append(("words", lambda: tk.tree_words(stacks, and3.code, and3.leaf_stack,
                                                         words_slots),
                          lambda: tk.tree_words_plain(stacks, and3.code, and3.leaf_stack,
                                                      words_slots)))
            views = (bsi[:, 2:], bsi[:, 0], bsi[:, 1])
            calls += [(f"bsi_range {name}",
                       lambda t=t, c=c: tb.bsi_range(*views, t, count=c),
                       lambda t=t, c=c: tb.bsi_range_plain(*views, t, c))
                      for name, (t, c) in range_tables.items()]
            for name, fn, plain in calls:
                if not torch.equal(fn(), want.setdefault(name, plain())):
                    raise AssertionError(f"{v.label} {name}: differs from the plain version")
                if device == "cuda":
                    timing = (cs.cuda_ms(fn, reps=10), cs.device_ms(fn, reps=3))
                else:
                    t = time.perf_counter()
                    fn()
                    timing = ((time.perf_counter() - t) * 1e3, None)
                out[v.label].setdefault(name, []).append(timing)
    for v in versions:
        for name, rows in out[v.label].items():
            dev_ms = [d for _, d in rows if d is not None]
            cs.log(f"{v.label} kernel {name}: median {statistics.median(m for m, _ in rows):.4f} "
                   f"ms around the wrapper, device median "
                   f"{statistics.median(dev_ms) if dev_ms else None} ms over {len(rows)} "
                   f"rounds; all {[round(m, 4) for m, _ in rows]}, device {dev_ms}")
    del stacks, bsi
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", type=Path, required=True, help="the first checkout (the parent)")
    ap.add_argument("--b", type=Path, required=True, help="the second checkout (the change)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--kernels", type=int, default=0,
                    help="rounds of the tree wrappers and bsi_range alone (0: none)")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=cs.S_FULL)
    args = ap.parse_args()
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    cs.S_FULL = args.shards
    if args.device == "cuda":
        cs.log(f"card: {cs.card_line()}")
    versions = [Version("a", args.a, args.device), Version("b", args.b, args.device)]
    kernels = kernel_rounds(versions, args.kernels, args.device) if args.kernels else {}
    _, calls, _, bitmap_q, _, wide_q = cs.tree_queries(np.random.default_rng(cs.SEED + 6))
    queries = {"batch": calls, "wide": wide_q, "bitmap": bitmap_q}
    gct = GcTimer()
    gc.callbacks.append(gct)
    times = {v.label: {} for v in versions}
    truth = {}

    def record(v, phase, series, kind, got):
        ms, wrap, gcm, ans = got
        key = (phase, kind)
        if truth.setdefault(key, ans) != ans:
            raise AssertionError(f"{v.label} {phase} {kind}: answers differ")
        cell = times[v.label].setdefault(phase, {}).setdefault(series, {})
        cell.setdefault(kind, []).append({"ms": ms, "wrapper_ms": wrap, "gc_ms": gcm})

    for v in versions:  # warm: kernels built, stacks and plans made
        activate(v.mods)
        for kind in QUERIES:
            run_query(v, kind, queries[kind], gct, args.device)
    for phase in ("before_writes", "after_writes"):
        if phase == "after_writes":
            for v in versions:
                activate(v.mods)
                cs.apply_writes(v.ex, v.holder, np.random.default_rng(cs.SEED + 7),
                                ("f", "g", "h"), 64)
            for i, kind in enumerate(QUERIES):  # the first of each kind patches
                for v in versions if i % 2 == 0 else versions[::-1]:
                    activate(v.mods)
                    record(v, phase, "first", kind,
                           run_query(v, kind, queries[kind], gct, args.device))
        for series in ("gc_on", "gc_frozen"):
            for r in range(args.pairs):
                for v in versions if r % 2 == 0 else versions[::-1]:
                    activate(v.mods)
                    if series == "gc_frozen":
                        gc.freeze()
                        gc.disable()
                    try:
                        for kind in QUERIES:
                            record(v, phase, series, kind,
                                   run_query(v, kind, queries[kind], gct, args.device))
                    finally:
                        if series == "gc_frozen":
                            gc.enable()
                            gc.unfreeze()
    gc.callbacks.remove(gct)
    for v in versions:
        for phase, by_series in times[v.label].items():
            for series, by_kind in by_series.items():
                for kind, rows in by_kind.items():
                    ms = [x["ms"] for x in rows]
                    cs.log(f"{v.label} {phase} {series} {kind}: median "
                           f"{statistics.median(ms):.3f} ms, least {min(ms):.3f}, greatest "
                           f"{max(ms):.3f} over {len(ms)}; wrappers median "
                           f"{statistics.median(x['wrapper_ms'] for x in rows):.3f} ms, gc "
                           f"{sum(x['gc_ms'] for x in rows):.3f} ms in all")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"a": str(args.a), "b": str(args.b),
                                        "times": times, "kernels": kernels}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
