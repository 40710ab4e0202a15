"""The port's staged ingest pipeline (``pilosa_tpu_torch/ingest/``) against
``pilosa_tpu/ingest/``, on the CPU.

The same scripts run on both packages' objects and must give the same
traces: the staging pool's bounds (acquire blocks when every buffer is
out, a release is idempotent, an undersized buffer grows), the decode of
roaring payloads into staging buffers, the uploader's coalescing of
queued fragments and the strict priority of ingest over prefetch uploads,
and the group commit of queued same-key segments on the pool. Then a JAX
API and a port API on data directories take the same imports through
their pipelines (JSON bits with the existence field, values, and roaring
payloads of one shard posted at once from several threads): every
fragment holds the same rows after the directories are reopened, and the
port's uploader reports no failed upload.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import gc
import queue
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.ingest import DeviceUploader as JaxUploader
from pilosa_tpu.ingest import IngestPipeline as JaxPipeline
from pilosa_tpu.ingest import StagingPool as JaxStaging
from pilosa_tpu.server.api import API as JaxAPI
from pilosa_tpu.server.importpool import ImportPool as JaxPool
from pilosa_tpu.storage import roaring as jax_roaring
from pilosa_tpu.storage.disk import HolderStore as JaxStore
from pilosa_tpu_torch.core.holder import Holder as TorchHolder
from pilosa_tpu_torch.ingest import DeviceUploader as TorchUploader
from pilosa_tpu_torch.ingest import IngestPipeline as TorchPipeline
from pilosa_tpu_torch.ingest import StagingPool as TorchStaging
from pilosa_tpu_torch.server.api import API as TorchAPI
from pilosa_tpu_torch.server.importpool import ImportPool as TorchPool
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.storage import roaring as torch_roaring
from pilosa_tpu_torch.storage.disk import HolderStore as TorchStore

PKGS = {
    "jax": (JaxStaging, JaxUploader, JaxPipeline, JaxPool),
    "torch": (TorchStaging, TorchUploader, TorchPipeline, TorchPool),
}


@pytest.fixture(autouse=True)
def _collect_after_each_test():
    yield
    gc.collect()


def _staging_trace(pkg):
    Staging = PKGS[pkg][0]
    trace = []
    positions = np.array([1, 5, 70000, 70001, 2**33, 2**33 + 9], dtype=np.uint64)
    blob = jax_roaring.serialize(positions)
    pool = Staging(buffers=2, capacity=2)
    a = pool.acquire()
    trace.append(a.decode_grow(blob))
    trace.append(a.positions.tolist())
    trace.append(a.capacity >= len(positions))
    b = pool.acquire()
    trace.append(pool.outstanding)
    try:
        pool.acquire(timeout=0.05)
        trace.append("acquired")
    except queue.Empty:
        trace.append("blocked")
    a.release()
    a.release()  # idempotent
    trace.append(pool.outstanding)
    c = pool.acquire()
    trace.append(c.decode(blob))  # the grown buffer came back
    try:
        c.decode(b"\x00\x01garbage!!")
        trace.append("decoded garbage")
    except Exception as e:  # the codec's parse error, named alike
        trace.append(type(e).__name__)
    b.release()
    c.release()
    snap = pool.snapshot()
    snap.pop("blockedSeconds")
    trace.append(snap)
    return trace


def test_staging_pool_bounds_and_decode_trace_as_jax():
    assert _staging_trace("torch") == _staging_trace("jax")


def test_staging_row_words_equal_jaxs_positions():
    """The row-words form import-roaring stages (``decode_rows``) holds the
    bits of JAX's positions decode, empty rows dropped, and the buffer
    grows to the largest payload and is reused."""
    rng = np.random.default_rng(4)
    n_words = SHARD_WIDTH // 32
    pool = TorchStaging(buffers=1, capacity=4)
    buf = pool.acquire()
    for rows in ([0, 3, 9], [2], [1, 5, 6, 7, 40]):
        pos = np.concatenate([
            np.unique(rng.integers(0, SHARD_WIDTH, 300)).astype(np.uint64)
            + np.uint64(r * SHARD_WIDTH) for r in rows
        ])
        blob = jax_roaring.serialize(pos)
        jbuf = JaxStaging(buffers=1, capacity=4).acquire()
        jbuf.decode_grow(blob)
        assert buf.decode_rows(blob, n_words) == len(rows)
        want = np.zeros((len(rows), n_words), dtype=np.uint32)
        jp = jbuf.positions
        r_of = {r: k for k, r in enumerate(rows)}
        for p_ in jp.tolist():
            k, c = r_of[p_ // SHARD_WIDTH], p_ % SHARD_WIDTH
            want[k, c // 32] |= np.uint32(1 << (c % 32))
        assert buf.row_ids.tolist() == rows
        assert np.array_equal(buf.rows, want)
    assert buf.words.size >= 5 * n_words
    with pytest.raises(Exception, match="short|roaring|cookie|magic|invalid"):
        buf.decode_rows(b"\x00\x01", n_words)
    buf.release()


class _Frag:
    """A fragment stand-in: device_bits waits on ``gate`` and logs."""

    def __init__(self, name, log, gate, fail=False):
        self.name, self.log, self.gate, self.fail = name, log, gate, fail
        self.last_sync_h2d_bytes = 100

    def device_bits(self):
        self.gate.wait(10)
        self.log.append(self.name)
        if self.fail:
            raise RuntimeError("upload failed")


def _uploader_trace(pkg):
    Uploader = PKGS[pkg][1]
    log, gate = [], threading.Event()
    active = [1]
    up = Uploader(slots=2, applies_active=lambda: active[0])
    try:
        first = _Frag("first", log, gate)
        up.submit(first)  # the thread takes it and parks on the gate
        for _ in range(200):
            if not up._queued:
                break
            time.sleep(0.005)
        a, b = _Frag("a", log, gate), _Frag("b", log, gate, fail=True)
        p = [_Frag(f"p{i}", log, gate) for i in range(3)]
        done = []
        queued = [up.submit_prefetch(x, lambda f, err: done.append((f.name, err is None)))
                  for x in p]
        up.submit(a)
        up.submit(a)  # staged already: coalesced
        up.submit(b)
        queued.append(up.submit_prefetch(a))  # rides the ingest sync instead
        gate.set()
        assert up.flush(10)
        active[0] = 0
        snap = up.snapshot()
        keep = ("uploads", "uploadsCoalesced", "uploadErrors", "h2dBytes",
                "h2dBytesOverlapped", "prefetchUploads", "prefetchDropped")
        return [log, queued, sorted(done), {k: snap[k] for k in keep}]
    finally:
        gate.set()
        up.close()


def test_uploader_coalescing_and_priority_trace_as_jax():
    got = _uploader_trace("torch")
    assert got == _uploader_trace("jax")
    log, queued, _done, snap = got
    # ingest first (after the parked one), then the prefetches in order
    assert log == ["first", "a", "b", "p0", "p1", "p2"]
    assert queued == [True, True, True, False]
    assert snap["uploadsCoalesced"] == 1 and snap["uploadErrors"] == 1


class _Parked:
    """A stand-in fragment whose sync waits for ``gate``."""

    def __init__(self, gate, log, name):
        self.gate, self.log, self.name = gate, log, name

    def device_bits(self):
        self.gate.wait(10)
        self.log.append(self.name)


@pytest.mark.parametrize("lane", ["ingest", "prefetch"])
def test_the_uploader_is_woken_after_its_job_is_queued(lane):
    """The wake-up comes after the put, on both lanes: a woken uploader
    finds the job it was woken for (woken before the put, it could find the
    queues empty and sleep out its 50 ms poll with the job waiting)."""
    up = TorchUploader(slots=2)
    gate, log, seen = threading.Event(), [], []
    real = up._wake.notify

    def notify(n=1):
        seen.append(up._q.qsize() + up._prefetch_q.qsize())
        real(n)

    try:
        submit = up.submit if lane == "ingest" else up.submit_prefetch
        submit(_Parked(gate, log, "busy"))
        t_end = time.monotonic() + 10
        while up._q.qsize() + up._prefetch_q.qsize() and time.monotonic() < t_end:
            time.sleep(0.001)  # the uploader took the parked job
        up._wake.notify = notify
        submit(_Parked(gate, log, "next"))
        assert seen == [1]
        gate.set()
        assert up.flush(10) and log == ["busy", "next"]
    finally:
        gate.set()
        up.close()


def _group_trace(pkg):
    _, _, Pipeline, Pool = PKGS[pkg]
    pool = Pool(workers=1, depth=4)
    pipe = Pipeline(pool, upload=False)
    gate = threading.Event()
    calls, applied = [], []
    pipe.on_apply = applied.append
    try:
        pool.submit(lambda: gate.wait(10))

        def apply_group(payloads):
            calls.append(list(payloads))
            return {"n": len(payloads)}, "frag"

        hs = [pipe.submit_segment("k", x, apply_group) for x in "abc"]
        hs.append(pipe.submit_segment("other", "d", apply_group))
        gate.set()
        results = [h.wait() for h in hs]
        snap = pipe.snapshot()
        return [calls, results, applied, pool.jobs_coalesced, snap["segments"]]
    finally:
        gate.set()
        pipe.close()
        pool.close()


def test_segment_group_commit_traces_as_jax():
    got = _group_trace("torch")
    assert got == _group_trace("jax")
    assert got[0][0] == ["a", "b", "c"]


def _rows_of(holder):
    out = {}
    for iname in holder.index_names():
        idx = holder.index(iname)
        for fname, field in idx.fields.items():
            for vname, view in field.views.items():
                for shard, frag in view.fragments.items():
                    ids, words = frag.rows_matrix_host()
                    keep = words.any(axis=1)
                    out[(iname, fname, vname, shard)] = (
                        [int(r) for r, k in zip(ids, keep) if k],
                        words[keep].tobytes(),
                    )
    return out


def _import_everything(api, rng_seed, roaring_mod):
    rng = np.random.default_rng(rng_seed)
    n_cols = 3 * SHARD_WIDTH
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "v", {"type": "int", "min": -50, "max": 5000})
    api.create_field("i", "r")
    for k in range(3):
        cols = rng.integers(0, n_cols, 700).tolist()
        api.import_bits("i", "f", {"rowIDs": rng.integers(0, 9, 700).tolist(),
                                   "columnIDs": cols})
    api.import_bits("i", "f", {"rowIDs": [1, 2], "columnIDs": [3, 4], "clear": True})
    vcols = rng.choice(n_cols, 300, replace=False).tolist()
    api.import_bits("i", "v", {"columnIDs": vcols, "values": rng.integers(-50, 5000, 300).tolist()})
    # payloads of one shard from several threads at once: they group-commit
    payloads = []
    for k in range(6):
        pos = np.unique(rng.integers(0, 8 * SHARD_WIDTH, 2000)).astype(np.uint64)
        payloads.append(roaring_mod.serialize(pos))
    changed = [None] * len(payloads)

    def post(k):
        changed[k] = api.import_roaring("i", "r", 1, payloads[k])["changed"]

    ts = [threading.Thread(target=post, args=(k,)) for k in range(len(payloads))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return sum(1 for c in changed if c is not None)


def test_pipelined_imports_leave_equal_data_directories(tmp_path):
    views = {}
    for name, (H, Store, A, roaring_mod, kw) in {
        "jax": (JaxHolder, JaxStore, JaxAPI, jax_roaring, {}),
        "torch": (lambda: TorchHolder(device="cpu"), TorchStore, TorchAPI, torch_roaring, {}),
    }.items():
        holder = H()
        store = Store(holder, str(tmp_path / name))
        store.open()
        api = A(holder, store, **kw)
        try:
            assert _import_everything(api, 11, roaring_mod) == 6
            snap = api.ingest.snapshot()
            assert snap["segments"] >= 3 and snap["decoded"] == 6
            if name == "torch":
                up = snap["uploader"]
                assert up["uploadErrors"] == 0 and up["uploads"] >= 1
                # the uploaded fragments' copies live on the device
                frag = holder.index("i").field("f").view("standard").fragment(0)
                assert frag._device is not None
        finally:
            api.close()
        reopened = H()
        s2 = Store(reopened, str(tmp_path / name))
        s2.open()
        views[name] = _rows_of(reopened)
        s2.close()
    assert views["torch"] == views["jax"]
    assert any(k[1] == "r" for k in views["torch"])
