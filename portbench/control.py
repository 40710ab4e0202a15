"""The control of the comparison that decides ``correct``: the plain
reference put in the node's place with one guarantee broken, judged by
the same comparison a run makes.

The configurations state that every answer is exact. The control answers
every request from the records of every other shard, scaled to the whole
(an approximate answer where an exact one is due), for the requests a
window of the cell sends, at the cell's own size:

    python -m portbench.control --workload <cell> --seeds 1,2,3 --requests 900

Per seed it prints ``{"seed", "requests", "control_wrong"}``: the answers
of the control that the comparison finds wrong. Sound runs read 0 there
(the limit is 0), so the comparison fails the control where this reads
more.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def sampled_table(cell, cfg: dict, seed: int, dev):
    """The reference's table over the even shards, its records and sums
    scaled to all of them."""
    from portbench import run

    raws = (r for s, r in run.raw_shards(cell, cfg, seed, dev) if s % 2 == 0)
    table = cell.ref_module().cell_table(cfg, raws, dev)
    kept = sum(run.shard_records(cfg, s) for s in range(0, cfg["shards"], 2))
    scale = cfg["records"] / kept
    table.count = np.rint(table.count * scale).astype(np.int64)
    table.sums = {k: np.rint(v * scale).astype(np.int64) for k, v in table.sums.items()}
    return table


def control_wrong(cell, cfg: dict, seed: int, requests: int, dev) -> int:
    """Requests (as many as ``requests``, from the cell's clients' window
    plans) whose control answer the comparison finds wrong."""
    from portbench import run
    from portbench.reference import Reference
    from portbench.traffic import WINDOW, Plan

    exact = Reference(cell.ref_module().cell_table(
        cfg, (r for _, r in run.raw_shards(cell, cfg, seed, dev)), dev))
    control = Reference(sampled_table(cell, cfg, seed, dev))
    clients = int(cell.traffic["clients"])
    plans = [Plan(cell.traffic, seed, k, WINDOW) for k in range(clients)]
    bodies = [plans[i % clients].next()[1] for i in range(requests)]
    return sum(1 for b in bodies if control.answer(b) != exact.answer(b))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, required=True)
    args = p.parse_args(argv)
    from portbench.spec import Benchmark
    from portbench import run

    cell = Benchmark(run.ROOT).cell(args.workload)
    os.environ["PILOSA_TPU_SHARD_WIDTH"] = str(cell.config["shard_width_exp"])
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        wrong = control_wrong(cell, cell.config, seed, args.requests, dev)
        print(json.dumps({"workload": cell.name, "seed": seed, "requests": args.requests,
                          "control_wrong": wrong}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
