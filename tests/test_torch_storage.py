"""The port's storage against ``pilosa_tpu.storage``: data directories,
fragment files, op logs, the key log and keyed queries.

Both packages get the same writes, made from seeded numpy, and must leave
the same bytes on disk: snapshot files, op-log records (every mutator of
the fragment; a BSI value is one batch record), ``.keys`` logs and meta.
A directory written by either package opens in the other with equal
fragments, meta (BSI base and depth too), attrs and keys, the port
decoding each file straight into row words where JAX groups positions.
Then the file's life: a snapshot once the op log passes ``MAX_OP_N``, an
op landing mid-encode, the locked fallback, a torn key log, the journal
and the fault hook. Last, keyed queries through both executors: equal
results, keys included, and equal errors.
"""

import gc
import os
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.exec.executor import Executor as JaxExecutor
from pilosa_tpu.storage import fragmentfile as jff
from pilosa_tpu.storage.disk import HolderStore as JaxStore
from pilosa_tpu.storage.translatelog import TranslateLog as JaxLog
from pilosa_tpu.core.translate import TranslateStore as JaxTranslate
from pilosa_tpu_torch.core.field import FieldOptions as TorchFieldOptions
from pilosa_tpu_torch.core.fragment import Fragment as TorchFragment
from pilosa_tpu_torch.core.holder import Holder as TorchHolder
from pilosa_tpu_torch.core.translate import TranslateStore as TorchTranslate
from pilosa_tpu_torch.core import translate as torch_translate
from pilosa_tpu_torch.exec.executor import Executor as TorchExecutor
from pilosa_tpu_torch.storage import fragmentfile as tff
from pilosa_tpu_torch.storage import roaring as tr
from pilosa_tpu_torch.storage.disk import HolderStore as TorchStore
from pilosa_tpu_torch.storage.translatelog import TranslateLog as TorchLog

W = 512  # words a row at the tests' shard width (2^14)
WIDTH = W * 32


@pytest.fixture(autouse=True)
def _collect_after_each_test():
    """Collect each test's garbage at its end, where no lock is held: the
    JAX holders' device-budget entries release their bytes in finalizers
    that take the budget's lock, and left to a later collection they may
    run while another test's code holds a lock (a collection can start at
    any allocation)."""
    yield
    gc.collect()


def _tree(path: Path) -> dict:
    """relative path -> bytes of every file under ``path``."""
    return {
        str(p.relative_to(path)): p.read_bytes()
        for p in sorted(path.rglob("*")) if p.is_file()
    }


def _mirror(frag) -> tuple:
    """A fragment's rows holding a bit as (sorted ids, words), whichever
    package (a row left empty in memory is absent from its file)."""
    ids, words = frag.rows_matrix_host()
    order = [i for i in np.argsort(ids) if words[i].any()]
    return [int(ids[i]) for i in order], words[order]


def _same_mirror(a, b):
    ia, wa = _mirror(a)
    ib, wb = _mirror(b)
    assert ia == ib and np.array_equal(wa, wb)


def _fragments(holder) -> dict:
    return {
        (i.name, f.name, v.name, s): frag
        for i in holder.indexes.values() for f in i.fields.values()
        for v in f.views.values() for s, frag in v.fragments.items()
    }


# -- fragment files: the records of every mutator


def _seed(frag, rng):
    frag.import_bits(rng.integers(0, 6, 300).astype(np.uint64), rng.integers(0, WIDTH, 300))


def _mutate(frag, name, rng):
    cols = rng.integers(0, WIDTH, 40)
    if name == "set_bit":
        return [frag.set_bit(3, int(c)) for c in cols[:5]] + [frag.set_bit(9, 7)]
    if name == "clear_bit":
        return [frag.clear_bit(int(r), int(c)) for r, c in zip(rng.integers(0, 6, 30), cols)]
    if name == "set_row_words":
        words = rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32)
        return [frag.set_row_words(2, words), frag.set_row_words(20, words)]
    if name == "clear_row":
        return [frag.clear_row(1), frag.clear_row(77)]
    if name == "set_mutex":
        return [frag.set_mutex(int(r), int(c)) for r, c in zip(rng.integers(0, 8, 10), cols)]
    if name.startswith("import_bits"):
        rows = rng.integers(0, 9, 500).astype(np.uint64)
        # the port's numpy merge logs what its native one logs (JAX: native)
        imp = getattr(frag, "import_bits_plain", None) if "plain" in name else None
        return (imp or frag.import_bits)(rows, rng.integers(0, WIDTH, 500),
                                         clear=name.endswith("clear"))
    if name == "set_value":
        return [frag.set_value(int(c), 8, int(v))
                for c, v in zip(cols[:6], rng.integers(-200, 200, 6))]
    if name == "clear_value":
        frag.set_value(int(cols[0]), 8, 77)
        return [frag.clear_value(int(cols[0])), frag.clear_value(int(cols[1]))]
    if name in ("import_values", "import_values_clear"):
        vals = rng.integers(-255, 256, 40)
        frag.import_values(cols, vals, 8)
        if name == "import_values_clear":
            frag.import_values(cols[:10], vals[:10], 8, clear=True)
        return None
    raise AssertionError(name)


MUTATORS = ["set_bit", "clear_bit", "set_row_words", "clear_row", "set_mutex",
            "import_bits", "import_bits_clear", "import_bits_plain",
            "import_bits_plain_clear", "set_value", "clear_value",
            "import_values", "import_values_clear"]


@pytest.mark.parametrize("name", MUTATORS)
def test_mutator_records_match_jax(tmp_path, name):
    """Each mutator appends JAX's records, byte for byte, and the file
    opens in either package to the other's mirror."""
    files = {}
    frags = {}
    for pkg, Frag, FF in (("jax", JaxFragment, jff.FragmentFile),
                          ("torch", TorchFragment, tff.FragmentFile)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        frag = Frag("i", "f", "standard", 0, W, **kw)
        path = str(tmp_path / pkg / "0")
        store = FF(frag, path)
        store.open()
        rng = np.random.default_rng(len(name))
        _seed(frag, rng)
        frags[pkg] = (frag, _mutate(frag, name, rng))
        store.close()
        files[pkg] = Path(path).read_bytes()
    assert files["torch"] == files["jax"]
    assert frags["torch"][1] == frags["jax"][1]  # the changed flags/counts
    _same_mirror(frags["torch"][0], frags["jax"][0])
    # each file reopened by the other package
    for pkg, Frag, FF, other in (("jax", JaxFragment, jff.FragmentFile, "torch"),
                                 ("torch", TorchFragment, tff.FragmentFile, "jax")):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        frag = Frag("i", "f", "standard", 0, W, **kw)
        store = FF(frag, str(tmp_path / other / "0"))
        store.open()
        _same_mirror(frag, frags[other][0])
        store.close()


def test_a_bsi_value_is_one_batch_record(tmp_path):
    frag = TorchFragment("i", "v", "bsig_v", 0, W, device="cpu")
    store = tff.FragmentFile(frag, str(tmp_path / "0"))
    store.open()
    head = os.path.getsize(store.path)
    frag.set_value(5, 8, 0b1011)
    data = Path(store.path).read_bytes()
    records = list(tr.decode_ops(data, head))
    # exists, planes 0, 1 and 3 set in one record; nothing to clear
    assert [(op, list(v)) for op, v, _ in records] == [
        (tr.OP_ADD_BATCH, [0 * WIDTH + 5, 2 * WIDTH + 5, 3 * WIDTH + 5, 5 * WIDTH + 5])]
    frag.set_value(5, 8, -0b0010)
    records = list(tr.decode_ops(Path(store.path).read_bytes(), head))[1:]
    assert [(op, list(v)) for op, v, _ in records] == [
        (tr.OP_ADD_BATCH, [1 * WIDTH + 5]),
        (tr.OP_REMOVE_BATCH, [2 * WIDTH + 5, 5 * WIDTH + 5])]
    store.close()


@pytest.mark.parametrize("kind", ["dense", "sparse", "log_empties_a_row", "bsi"])
def test_word_decode_equals_jax_positions_open(tmp_path, kind):
    """The port's open (words decoded in place) and JAX's (positions
    grouped by row) give the same mirror, op log replayed."""
    rng = np.random.default_rng(len(kind))
    jfrag = JaxFragment("i", "f", "standard", 3, W)
    store = jff.FragmentFile(jfrag, str(tmp_path / "3"))
    store.open()
    if kind == "dense":
        for r in (0, 1, 5, 1 << 30):
            jfrag.set_row_words(r, rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32))
        store.snapshot()
    elif kind == "sparse":
        _seed(jfrag, rng)
        store.snapshot()
        jfrag.set_bit(70, 3)
    elif kind == "log_empties_a_row":
        jfrag.set_bit(4, 10)
        jfrag.set_bit(4, 11)
        jfrag.set_bit(6, 1)
        store.snapshot()
        jfrag.clear_row(4)
        jfrag.set_bit(2, WIDTH - 1)
    else:
        jfrag.import_values(rng.integers(0, WIDTH, 200), rng.integers(-1000, 1000, 200), 11)
        store.snapshot()
        jfrag.set_value(9, 11, -5)
    store.close()
    tfrag = TorchFragment("i", "f", "standard", 3, W, device="cpu")
    tstore = tff.FragmentFile(tfrag, str(tmp_path / "3"))
    tstore.open()
    jfrag2 = JaxFragment("i", "f", "standard", 3, W)
    jstore2 = jff.FragmentFile(jfrag2, str(tmp_path / "3"))
    jstore2.open()
    _same_mirror(tfrag, jfrag2)
    _same_mirror(tfrag, jfrag)
    assert tstore.op_n == jstore2.op_n
    tfrag.check_invariants()
    tstore.close()
    jstore2.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_snapshot_once_the_op_log_passes_max_op_n(tmp_path, monkeypatch, pkg):
    mod, Frag, kw = ((jff, JaxFragment, {}) if pkg == "jax"
                     else (tff, TorchFragment, {"device": "cpu"}))
    monkeypatch.setattr(mod, "MAX_OP_N", 5)
    frag = Frag("i", "f", "standard", 0, W, **kw)
    store = mod.FragmentFile(frag, str(tmp_path / "0"))
    store.open()
    for c in range(5):
        frag.set_bit(1, c)
    assert store.op_n == 5 and store.last_snapshot_at is None
    frag.set_bit(2, 9)  # the sixth op passes MAX_OP_N: a snapshot, no queue
    assert store.op_n == 0 and store.last_snapshot_at is not None
    rids, words = frag.snapshot_rows()
    assert Path(store.path).read_bytes() == tr.serialize_rows(rids, words)
    store.close()


def test_op_landing_mid_encode_survives_a_reopen(tmp_path):
    frag = TorchFragment("i", "f", "standard", 0, W, device="cpu")
    store = tff.FragmentFile(frag, str(tmp_path / "0"))
    store.open()
    frag.set_bit(1, 1)
    encode = store._encode_rows
    calls = []

    def racing(rids, words):
        calls.append(store._lock.locked())
        if len(calls) == 1:
            frag.set_bit(2, 2)  # lands after the copy: that attempt is void
        return encode(rids, words)

    store._encode_rows = racing
    store.snapshot()
    assert calls == [False, False]
    store.close()
    again = TorchFragment("i", "f", "standard", 0, W, device="cpu")
    tff.FragmentFile(again, str(tmp_path / "0")).open()
    assert again.get_bit(1, 1) and again.get_bit(2, 2)
    _same_mirror(again, frag)


def test_locked_fallback_after_continuous_writes(tmp_path):
    """A writer that lands in every optimistic attempt: the fourth encode
    holds the locks, and the file ends with every bit."""
    frag = TorchFragment("i", "f", "standard", 0, W, device="cpu")
    store = tff.FragmentFile(frag, str(tmp_path / "0"))
    store.open()
    encode = store._encode_rows
    locked = []

    def writer(rids, words):
        locked.append(store._lock.locked())
        if not locked[-1]:
            frag.set_bit(5, len(locked))
        return encode(rids, words)

    store._encode_rows = writer
    store.snapshot()
    assert locked == [False] * tff.FragmentFile._SNAPSHOT_RETRIES + [True]
    assert store.op_n == 0
    store.close()
    again = TorchFragment("i", "f", "standard", 0, W, device="cpu")
    tff.FragmentFile(again, str(tmp_path / "0")).open()
    assert [again.get_bit(5, c) for c in range(1, 5)] == [True, True, True, False]


def test_journal_and_fault_hook(tmp_path, monkeypatch):
    class Journal:
        def __init__(self):
            self.events = []

        def record(self, type, **data):
            self.events.append((type, data))

    journal = Journal()
    frag = TorchFragment("i", "f", "standard", 4, W, device="cpu")
    store = tff.FragmentFile(frag, str(tmp_path / "4"), journal=journal)
    store.open()
    frag.set_bit(1, 2)
    store.snapshot()
    [(kind, data)] = journal.events
    assert kind == tff.EVENT_SNAPSHOT == "snapshot"
    assert data["ops_compacted"] == 1 and data["shard"] == 4
    assert data["bytes"] == os.path.getsize(store.path)

    def full(path):
        raise OSError(f"fault-injected disk write failure: {path}")

    monkeypatch.setattr(tff, "disk_write_fault", full)
    with pytest.raises(OSError, match="fault-injected"):
        frag.set_bit(1, 3)
    with pytest.raises(OSError, match="fault-injected"):
        store.snapshot()
    store.close()


def test_rows_too_large_to_persist_raise_before_the_change(tmp_path):
    frag = TorchFragment("i", "f", "standard", 0, W, device="cpu")
    store = tff.FragmentFile(frag, str(tmp_path / "0"))
    store.open()
    big = (2**64 - 1) // WIDTH + 1
    for write in (lambda: frag.set_bit(big, 1),
                  lambda: frag.import_bits(np.array([1, big], dtype=np.uint64), [2, 3]),
                  lambda: frag.set_row_words(big, np.ones(W, np.uint32))):
        with pytest.raises(ValueError, match="too large to persist"):
            write()
    assert frag.row_ids() == [] and store.op_n == 0
    store.close()


# -- the key log


@pytest.mark.parametrize("pkg_write,pkg_read", [("jax", "torch"), ("torch", "jax")])
def test_key_log_bytes_and_torn_tail(tmp_path, pkg_write, pkg_read):
    logs = {"jax": (JaxTranslate, JaxLog), "torch": (TorchTranslate, TorchLog)}
    trees = {}
    for pkg, (Store, Log) in logs.items():
        store = Store()
        log = Log(store, str(tmp_path / pkg / ".keys"))
        os.makedirs(tmp_path / pkg)
        log.open()
        store.translate_keys("i", "", ["a", "b", "ü"])
        store.translate_keys("i", "f", ["x"])
        store.set_mapping("i", "", ["z"], [7])
        store.translate_keys("i", "", ["b", "c"])
        log.close()
        trees[pkg] = _tree(tmp_path / pkg)
    assert trees["torch"] == trees["jax"]
    path = tmp_path / pkg_write / ".keys"
    good = path.stat().st_size
    with open(path, "ab") as f:
        f.write(b"\x01\x05\x00")  # a torn record
    Store, Log = logs[pkg_read]
    store = Store()
    Log(store, str(path)).open()
    assert path.stat().st_size == good
    assert store.to_dict() == {"i|": ["a", "b", "ü", "", "", "", "z", "c"], "i|f": ["x"]}
    assert store.translate_key("i", "", "c", create=False) == 8


def test_translate_telemetry_keeps_its_keys():
    before = torch_translate.telemetry_snapshot()
    store = TorchTranslate()
    store.translate_keys("t", "", ["a", "b"])
    store.translate_keys("t", "", ["a"])
    store.translate_ids("t", "", [1, 2, 9])
    snap = torch_translate.telemetry_snapshot()
    assert set(snap) == {"keysCreated", "keysFound", "idsLookedUp", "logAppends", "lookup"}
    assert snap["keysCreated"] - before["keysCreated"] == 2
    assert snap["keysFound"] - before["keysFound"] == 1
    assert snap["idsLookedUp"] - before["idsLookedUp"] == 3
    assert snap["lookup"]["count"] >= 2
    with pytest.raises(torch_translate.TranslateStoreReadOnlyError):
        TorchTranslate(read_only=True).translate_key("t", "", "a")


# -- data directories


def _populate(holder, store, pkg):
    """The same schema, writes, attrs and keys through either package."""
    FO = JaxFieldOptions if pkg == "jax" else TorchFieldOptions
    Exe = JaxExecutor if pkg == "jax" else TorchExecutor
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("m", FO(field_type="mutex"))
    idx.create_field("b", FO(field_type="bool"))
    idx.create_field("v", FO(field_type="int", min_=100, max_=5000))
    k = holder.create_index("k", keys=True)
    k.create_field("kf", FO(keys=True))
    ex = Exe(holder, translator=store.translator)
    rng = np.random.default_rng(5)
    cols = rng.integers(0, 3 * WIDTH, 60)
    q = [f"Set({c}, f={r})" for c, r in zip(cols, rng.integers(0, 5, 60))]
    q += [f"Set({c}, m={r})" for c, r in zip(cols[:10], rng.integers(0, 3, 10))]
    q += [f"Set({c}, b=true)" for c in cols[10:14]]
    q += [f"Set({c}, v={val})" for c, val in zip(cols[:12], rng.integers(100, 5001, 12))]
    q += [f"Clear({c}, f={r})" for c, r in zip(cols[:20], rng.integers(0, 5, 20))]
    ex.execute("i", " ".join(q))
    view = holder.field("i", "f").view("standard")
    for shard in (0, 2, 5):
        view.create_fragment_if_not_exists(shard).import_bits(
            rng.integers(0, 5, 400).astype(np.uint64), rng.integers(0, WIDTH, 400))
    ex.execute("k", " ".join(f'Set("c{c}", kf="r{c % 4}")' for c in range(30)))
    # snapshots of two fragments; the rest stay snapshot + op log
    for frag in (holder.field("i", "f").view("standard").fragment(0),
                 holder.field("k", "kf").view("standard").fragment(0)):
        frag.store.snapshot()
    ex.execute("i", "Set(5, f=1) Clear(5, v=4)")
    idx.column_attrs.set_attrs(7, {"name": "seven", "n": 7})
    holder.field("i", "f").row_attrs.set_attrs(250, {"color": "red"})
    return ex


def _written(tmp_path, pkg):
    path = tmp_path / pkg
    holder = JaxHolder() if pkg == "jax" else TorchHolder(device="cpu")
    Store = JaxStore if pkg == "jax" else TorchStore
    store = Store(holder, str(path))
    store.open()
    _populate(holder, store, pkg)
    store.close()
    return path, holder


def _opened(path, pkg):
    holder = JaxHolder() if pkg == "jax" else TorchHolder(device="cpu")
    store = (JaxStore if pkg == "jax" else TorchStore)(holder, str(path))
    store.open()
    return holder, store


def test_both_packages_write_the_same_bytes(tmp_path):
    jpath, _ = _written(tmp_path, "jax")
    tpath, _ = _written(tmp_path, "torch")
    jt, tt = _tree(jpath), _tree(tpath)
    assert sorted(tt) == sorted(jt)
    assert [n for n in tt if tt[n] != jt[n]] == []
    assert any(n.endswith(".keys") for n in tt) and any("/fragments/" in n for n in tt)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_a_data_dir_opens_in_the_other_package(tmp_path, writer, reader):
    path, wrote = _written(tmp_path, writer)
    holder, store = _opened(path, reader)
    assert holder.schema() == wrote.schema()
    want, got = _fragments(wrote), _fragments(holder)
    assert sorted(got) == sorted(want)
    for key in want:
        _same_mirror(got[key], want[key])
    for name in ("f", "v", "b", "m"):
        a, b = holder.field("i", name), wrote.field("i", name)
        assert (a.base, a.bit_depth) == (b.base, b.bit_depth)
    assert holder.field("i", "v").bit_depth > 0
    assert holder.index("i").column_attrs.attrs(7) == {"name": "seven", "n": 7}
    assert holder.field("i", "f").row_attrs.attrs(250) == {"color": "red"}
    assert store.translator.to_dict() == {"k|": [f"c{c}" for c in range(30)],
                                          "k|kf": ["r0", "r1", "r2", "r3"]}
    store.close()


def test_reads_after_a_reopen_match_jax(tmp_path):
    """Writes after a reopen replay on the next one: the port's reopened
    holder answers what JAX's answers, and the bytes stay equal."""
    answers = {}
    for pkg in ("jax", "torch"):
        path, _ = _written(tmp_path, pkg)
        holder, store = _opened(path, pkg)
        Exe = JaxExecutor if pkg == "jax" else TorchExecutor
        ex = Exe(holder, translator=store.translator)
        ex.execute("i", "Set(9, f=2) Clear(9, f=2) Set(10, v=300) Set(11, m=1)")
        ex.execute("k", 'Set("new", kf="r1") Clear("c1", kf="r1")')
        store.close()
        holder, store = _opened(path, pkg)
        ex = Exe(holder, translator=store.translator)
        answers[pkg] = (
            _plain(ex.execute("i", "Count(Row(f=2)) Sum(field=v) Row(m=1) TopN(f, n=3)")),
            _plain(ex.execute("k", 'Row(kf="r1") TopN(kf) Rows(kf)')),
        )
        store.close()
    assert answers["torch"] == answers["jax"]
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")


def test_legacy_keys_and_attrs_migrate(tmp_path):
    """A legacy ``.keys.json`` and ``.attrs.json`` migrate on open into the
    key log and the attr blocks, as JAX migrates them."""
    import json

    for pkg in ("jax", "torch"):
        path = tmp_path / pkg
        (path / "i").mkdir(parents=True)
        (path / ".keys.json").write_text(json.dumps({"i|": ["a", "", "c"]}))
        (path / "i" / ".meta.json").write_text(json.dumps({"keys": True,
                                                           "trackExistence": True}))
        (path / "i" / ".attrs.json").write_text(json.dumps({"3": {"x": 1}}))
        holder, store = _opened(path, pkg)
        assert store.translator.translate_key("i", "", "c", create=False) == 3
        assert holder.index("i").column_attrs.attrs(3) == {"x": 1}
        assert store.node_id() == store.node_id()
        store.close()
    jt, tt = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    jt.pop(".id"), tt.pop(".id")
    assert tt == jt and ".keys.json" not in tt


def test_delete_dirs_detach_their_files(tmp_path):
    path, _ = _written(tmp_path, "torch")
    holder, store = _opened(path, "torch")
    frag = holder.field("i", "f").view("standard").fragment(1)
    store.delete_fragment("i", "f", "standard", 1)
    assert frag.store is None and not (path / "i/f/views/standard/fragments/1").exists()
    store.delete_field_dir("i", "m")
    assert not (path / "i" / "m").exists()
    store.delete_index_dir("k")
    assert not (path / "k").exists()
    assert all(s.fragment.index == "i" and s.fragment.field != "m" for s in store._stores)
    store.close()


# -- keyed queries through both executors


def _plain(res):
    """A result in plain values, keys included, whichever package."""
    if isinstance(res, list):
        return [_plain(r) for r in res]
    if hasattr(res, "segments"):
        return ("row", [int(c) for c in res.columns()], res.keys)
    if hasattr(res, "group"):
        return ("group", [(g.field, g.row_id, g.row_key) for g in res.group], res.count)
    if hasattr(res, "rows"):
        return ("rows", res.rows, res.keys)
    if hasattr(res, "key"):
        return ("pair", res.id, res.key, res.count)
    if hasattr(res, "value"):
        return ("val", res.value, res.count)
    return res


def _keyed_pair():
    out = []
    for pkg in ("jax", "torch"):
        holder = JaxHolder() if pkg == "jax" else TorchHolder(device="cpu")
        FO = JaxFieldOptions if pkg == "jax" else TorchFieldOptions
        k = holder.create_index("k", keys=True)
        k.create_field("kf", FO(keys=True))
        k.create_field("kg", FO(keys=True))
        k.create_field("n")
        k.create_field("v", FO(field_type="int", min_=-50, max_=50))
        k.create_field("b", FO(field_type="bool"))
        u = holder.create_index("u")
        u.create_field("f")
        out.append((JaxExecutor if pkg == "jax" else TorchExecutor)(holder))
    return out


_KEYED_WRITES = (
    " ".join(f'Set("col{c}", kf="{"xyz"[c % 3]}")' for c in range(40))
    + " " + " ".join(f'Set("col{c}", kg="{"pq"[c % 2]}")' for c in range(0, 40, 3))
    + " " + " ".join(f'Set("col{c}", n={c % 4})' for c in range(0, 40, 5))
    + ' Set("col3", v=-7) Set("col4", v=12) Set("col5", v=30) Set("col6", b=true)'
    + ' Clear("col0", kf="x") Set("col0", kf="y")'
)

KEYED_QUERIES = [
    'Row(kf="y")',
    'Count(Row(kf="x"))',
    'Count(Intersect(Row(kf="x"), Row(kg="p"))) Count(Union(Row(kf="x"), Row(kf="z")))',
    'Count(Difference(Row(kf="z"), Row(kg="q"))) Count(Xor(Row(kf="y"), Row(kg="p")))',
    'TopN(kf, n=2)',
    'TopN(kf, Row(kg="q"), n=3)',
    'TopN(n, Row(kf="x"))',
    'Rows(kf)',
    'Rows(kf, previous="x")',
    'Rows(kf, column="col4")',
    'Rows(kf, limit=1)',
    'Rows(n, previous=1)',
    'GroupBy(Rows(kf), Rows(kg))',
    'GroupBy(Rows(kf), Rows(kg), previous=["y", "p"])',
    'GroupBy(Rows(kf), Rows(n), previous=["x", 1])',
    'GroupBy(Rows(kg), filter=Row(kf="z"))',
    'Sum(field=v) Sum(Row(kf="x"), field=v) Min(field=v) Max(field=v)',
    'Row(v > 0) Row(b=true) Count(Row(v >< [-10, 20]))',
    'Row(kf="unknown") Count(Row(kg="nope"))',
    'Set("new", kf="x") Row(kf="x") Clear("new", kf="x") ClearRow(kg="q") Rows(kg)',
]


def test_keyed_queries_match_jax():
    je, te = _keyed_pair()
    assert _plain(te.execute("k", _KEYED_WRITES)) == _plain(je.execute("k", _KEYED_WRITES))
    for q in KEYED_QUERIES:
        assert _plain(te.execute("k", q)) == _plain(je.execute("k", q)), q
    assert te.translator.to_dict() == je.translator.to_dict()


def test_keyed_batch_matches_jax():
    je, te = _keyed_pair()
    je.execute("k", _KEYED_WRITES)
    te.execute("k", _KEYED_WRITES)
    batch = [(q, None) for q in KEYED_QUERIES[:18]] + [('Count(Row(kf="x"))', [0])]
    got, want = te.execute_batch("k", batch), je.execute_batch("k", batch)
    assert [_plain(r) for r in got] == [_plain(r) for r in want]


KEY_ERRORS = [
    ("k", "Set(1, kf=\"x\")"),
    ("k", "Row(kf=1)"),
    ("u", 'Set("a", f=1)'),
    ("u", 'Row(f="x")'),
    ("u", 'Rows(f, column="a")'),
    ("k", 'GroupBy(Rows(kf), Rows(n), previous=["x", "y"])'),
    ("k", 'GroupBy(Rows(kf), previous="x")'),
    ("k", 'GroupBy(Rows(kf), Rows(kg), previous=["x"])'),
]


@pytest.mark.parametrize("index,query", KEY_ERRORS)
def test_key_errors_match_jax(index, query):
    je, te = _keyed_pair()
    with pytest.raises(Exception) as jerr:
        je.execute(index, query)
    with pytest.raises(Exception) as terr:
        te.execute(index, query)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)
