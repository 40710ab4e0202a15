"""The yardstick's byte arithmetic against the bounds of PERF.md's kernel
table (copied from chip_smoke.py: S = 160 shards, W = 32768 words, depth
20), and the device-interval arithmetic."""

import pytest

from portbench import roofline

S, W, DEPTH = 160, 32768, 20


def ms(nbytes):
    return roofline.least_seconds(nbytes) * 1e3


@pytest.mark.parametrize("nbytes, bound", [
    (roofline.bsi_sum_batch_bytes(S, DEPTH, W, 64, 64), 0.5384),
    (roofline.bsi_sum_batch_bytes(S, DEPTH, W, 8, 8), 0.1878),
    (roofline.cross_gram_bytes(S, W, 64, 64), 0.801305),
    (roofline.cross_gram_bytes(S, W, 256, 64), 2.003270),
    (roofline.cross_gram_bytes(S, W, 4, 64), 0.425691),
    (roofline.bsi_range_bytes(S, DEPTH, W, 12, 1, False), 0.144),
    (roofline.bsi_range_bytes(S, DEPTH, W, 12, 1, True), 0.138),
    (roofline.bsi_range_bytes(S, DEPTH, W, 12 * 12, 12, False), 0.213),
    (roofline.tree_count_bytes(S, W, 3, 1), 0.0188),
])
def test_bounds_of_the_kernel_table(nbytes, bound):
    digits = len(str(bound).split(".")[1])
    assert round(ms(nbytes), digits) == bound


def test_tree_rows_counted_once():
    # two leaves of one stack naming the same rows, a third leaf of another
    slots = [[0, 0, 3], [1, 0, 3], [-1, 2, 3]]
    assert roofline.tree_distinct_rows(["a", "b"], [0, 0, 1], slots) == 4
    # the same tensor passed as both stacks
    assert roofline.tree_distinct_rows(["a", "a"], [0, 0, 1], slots) == 4


def test_busy_union_and_gaps():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (9.5, 12.0)]
    assert roofline.busy_union(iv, 0.0, 10.0) == pytest.approx(3.5)
    assert roofline.idle_gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.5)]
