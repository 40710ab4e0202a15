"""The control of the comparison: the reference answering from half of
the shards, scaled to the whole (an approximate answer where the
configurations promise exact ones), fails the comparison that decides
``correct``; the exact reference passes it. On the CPU at a small size;
``python -m portbench.control`` runs it at the cells' own size on the
card."""

import numpy as np
import pytest
import torch

from portbench import control, pack, run
from portbench.reference import Reference
from portbench.spec import Benchmark

CELLS = ["taxi.q1-q4", "ssb.q1", "taxi.drilldown"]


def small(cell, width=14, shards=4):
    return dict(cell.config, shard_width_exp=width, shards=shards, records=shards << width)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_comparison(workload):
    cell = Benchmark(run.ROOT).cell(workload)
    cfg = small(cell)
    dev = torch.device("cpu")
    assert control.control_wrong(cell, cfg, 2**32 + 1, 120, dev) > 0
    exact = cell.ref_module().cell_table(cfg, (r for _, r in run.raw_shards(cell, cfg, 5, dev)), dev)
    again = cell.ref_module().cell_table(cfg, (r for _, r in run.raw_shards(cell, cfg, 5, dev)), dev)
    a, b = Reference(exact), Reference(again)
    body = cell.traffic["templates"][0]["pql"].format(
        **{k: 1 for k in cell.traffic.get("draws", {})})
    assert a.answer(body) == b.answer(body)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["taxi.q1-q4", "ssb.q1"])
def test_card_packing_matches_the_cpu(card, workload):
    """The card's words of one shard equal the CPU's packing of the same
    records."""
    cell = Benchmark(run.ROOT).cell(workload)
    cfg = small(cell, width=20, shards=1)
    data = cell.data_module()
    _, raw = next(run.raw_shards(cell, cfg, 3, card))
    n = run.shard_records(cfg, 0)
    on_card = pack.shard_words(cfg, data.columns(cfg, raw), n, 1 << 20).cpu()
    cols = data.columns(cfg, {k: v.cpu() for k, v in raw.items()})
    on_cpu = pack.pack_words(pack.shard_bits(cfg, cols, n, 1 << 20))
    assert np.array_equal(on_card.numpy(), on_cpu.numpy())
