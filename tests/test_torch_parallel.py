"""The port's ``parallel`` package against ``pilosa_tpu.parallel``: the
counterpart of ``tests/test_parallel.py``.

JAX runs on the eight virtual CPU devices ``tests/conftest.py`` gives it;
the port on ``configure_serving(devices=[cpu] * 8)``, its counterpart.
One seeded field (6 shards, so the shard axis pads to 8) is written into
a JAX ``Field`` and a port ``Field`` alike, stacked by both packages'
``ShardedField.from_field`` over an 8-slice mesh, and every answer must be
equal: the layout, ``count_pair`` over the four ops, ``count_pairs``, the
per-shard partials, ``topn``, ``apply_updates`` and the BSI plane counts.
"""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import numpy as np
import pytest
import torch

import jax
from pilosa_tpu.core.field import Field as JaxField
from pilosa_tpu.parallel import ShardedField as JaxShardedField
from pilosa_tpu.parallel import default_mesh as jax_default_mesh
from pilosa_tpu.parallel import mesh_shape_for as jax_mesh_shape_for
from pilosa_tpu.parallel import sharded as jax_sharded
from pilosa_tpu_torch.core.field import Field
from pilosa_tpu_torch.parallel import ShardedField, default_mesh, mesh_shape_for
from pilosa_tpu_torch.parallel import mesh as mesh_mod
from pilosa_tpu_torch.parallel import sharded
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


@pytest.fixture(scope="module")
def eight():
    mesh_mod.configure_serving(None, devices=["cpu"] * 8)
    yield default_mesh(8)
    mesh_mod.configure_serving(None)


@pytest.fixture(scope="module")
def pair(eight):
    rng = np.random.default_rng(5)
    n = 20000
    rows = rng.integers(0, 10, size=n)
    cols = rng.integers(0, SHARD_WIDTH * 6, size=n)  # 6 shards -> pads to 8
    jf = JaxField("i", "f")
    jf.import_bits(rows, cols)
    tf = Field("i", "f", device="cpu")
    tf.import_bits(rows, cols)
    j = JaxShardedField.from_field(jf, jax_default_mesh(8))
    t = ShardedField.from_field(tf, eight)
    return j, t


def test_eight_devices_present(eight):
    assert len(jax.devices()) == 8
    assert eight.size == 8 and eight.axis_names == ("shards",)
    assert mesh_mod.serving_mesh() == eight


@pytest.mark.parametrize("n", [8, 2, 1])
def test_mesh_shape(n):
    assert mesh_shape_for(n) == jax_mesh_shape_for(n) == (n, 1)


def test_sharded_layout(pair):
    j, t = pair
    assert tuple(t.bits.shape) == tuple(j.bits.shape)
    assert t.bits.shape[0] % 8 == 0  # padded to the mesh
    assert t.row_ids == j.row_ids and t.shard_ids == j.shard_ids
    # one slice a device, contiguous shard ranges
    assert len(t.bits.slices) == len(j.bits.sharding.device_set) == 8
    assert t.bits.bounds == tuple((k, k + 1) for k in range(8))
    assert np.array_equal(t.bits.cpu().numpy().view(np.uint32), np.asarray(j.bits))


@pytest.mark.parametrize("op", ["intersect", "union", "difference", "xor"])
def test_count_pair_ops(pair, op):
    j, t = pair
    assert t.count_pair(3, 7, op=op) == j.count_pair(3, 7, op=op)


@pytest.mark.parametrize("op", ["intersect", "union", "difference", "xor"])
def test_count_pairs(pair, op):
    j, t = pair
    pairs = [(0, 1), (3, 7), (9, 9), (2, 8), (5, 0)]
    assert t.count_pairs(pairs, op=op) == j.count_pairs(pairs, op=op)


def test_per_shard_partials(pair):
    j, t = pair
    ras, rbs = [0, 3, 9], [1, 7, 2]
    want = np.asarray(jax_sharded.pair_counts_batched(
        j.bits, jax.numpy.asarray(ras), jax.numpy.asarray(rbs), op="union"))
    got = sharded.pair_counts_batched(t.bits, ras, rbs, op="union")
    assert np.array_equal(got.numpy(), want)  # [B, 8], the padded shards zero
    one = jax_sharded.pair_op_count(j.bits, jax.numpy.asarray(3), jax.numpy.asarray(7),
                                    op="xor")
    assert np.array_equal(sharded.pair_op_count(t.bits, 3, 7, op="xor").numpy(),
                          np.asarray(one))


@pytest.mark.parametrize("n", [1, 3, 10])
def test_topn(pair, n):
    j, t = pair
    assert t.topn(n) == j.topn(n)


def test_apply_updates(eight):
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 4, size=3000)
    cols = rng.integers(0, SHARD_WIDTH * 5, size=3000)
    jf = JaxField("i", "g")
    jf.import_bits(rows, cols)
    tf = Field("i", "g", device="cpu")
    tf.import_bits(rows, cols)
    j = JaxShardedField.from_field(jf, jax_default_mesh(8))
    t = ShardedField.from_field(tf, eight)
    S, R, W = j.bits.shape
    set_mask = rng.integers(0, 2**32, size=(S, R, W), dtype=np.uint32)
    set_mask &= rng.integers(0, 2**32, size=(S, R, W), dtype=np.uint32) & np.uint32(0x01010101)
    clear_mask = rng.integers(0, 2**32, size=(S, R, W), dtype=np.uint32) & np.uint32(0x10001000)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(j.mesh, P("shards", "rows", None))
    j.apply_updates(jax.device_put(set_mask, sh), jax.device_put(clear_mask, sh))
    t.apply_updates(sharded.shard(set_mask, eight), torch.from_numpy(clear_mask.view(np.int32)))
    assert np.array_equal(t.bits.cpu().numpy().view(np.uint32), np.asarray(j.bits))
    pairs = [(0, 1), (2, 3), (1, 1)]
    for op in ("intersect", "union"):
        assert t.count_pairs(pairs, op=op) == j.count_pairs(pairs, op=op)


def test_bsi_sum_planes(eight):
    from pilosa_tpu.core.field import FieldOptions as JaxOptions
    from pilosa_tpu_torch.core.field import FieldOptions

    rng = np.random.default_rng(13)
    cols = rng.choice(SHARD_WIDTH * 5, size=900, replace=False)
    vals = rng.integers(-300, 700, size=900)
    jf = JaxField("i", "v", JaxOptions(field_type="int", min_=-300, max_=700))
    jf.import_values(cols, vals)
    tf = Field("i", "v", FieldOptions(field_type="int", min_=-300, max_=700), device="cpu")
    tf.import_values(cols, vals)
    depth = jf.bit_depth
    assert tf.bit_depth == depth
    view = jf.bsi_view_name()
    j = JaxShardedField.from_field(jf, jax_default_mesh(8), view=view)
    t = ShardedField.from_field(tf, eight, view=view)
    assert j.row_ids == t.row_ids == list(range(2 + depth))
    exists, sign, planes = t.bits[:, 0], t.bits[:, 1], t.bits[:, 2:]
    filt = rng.integers(0, 2**32, size=(8, tf.n_words), dtype=np.uint32)
    jpos, jneg, jcount = jax_sharded.bsi_sum_planes(
        j.bits[:, 2:], j.bits[:, 0], j.bits[:, 1], jax.numpy.asarray(filt), depth=depth)
    pos, neg, count = sharded.bsi_sum_planes(
        planes, exists, sign, torch.from_numpy(filt.view(np.int32)), depth=depth)
    assert pos.tolist() == np.asarray(jpos).tolist()
    assert neg.tolist() == np.asarray(jneg).tolist()
    assert int(count) == int(jcount)
