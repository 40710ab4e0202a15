"""A run of a cell on the CPU at a small size, for the tests: the whole
harness (data, node, client process, window, reference, result) with
the program's CPU paths, optionally with the timed path broken.

    python -m portbench.rehearse --workload <cell> --seed <n> --seconds <s>
        [--shards N] [--width E] [--fault none|alter|half] [--timeline FILE]

``--width`` is the shard width's exponent and ``--shards`` the shards
(the last one half full); ``alter`` adds one to the first count of each
query's first answer where the executor makes it, ``half`` answers the
second half of every flight with the first half's answers. Prints the
result line as a run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def fault_hooks(kind: str) -> None:
    from pilosa_tpu_torch.exec import executor as ex

    orig = ex.Executor.execute_batch

    def alter(result):
        if isinstance(result, int) and not isinstance(result, bool):
            return result + 1
        if hasattr(result, "count") and isinstance(getattr(result, "count"), int):
            result.count += 1
        elif isinstance(result, list) and result and hasattr(result[0], "count"):
            result[0].count += 1
        return result

    def execute_batch(self, index, queries):
        outs = orig(self, index, queries)
        if kind == "alter":
            for out in outs:
                if isinstance(out, list) and out:
                    out[0] = alter(out[0])
        elif kind == "half":
            keep = (len(outs) + 1) // 2
            outs = outs[:keep] + [outs[i % keep] for i in range(keep, len(outs))]
        return outs

    ex.Executor.execute_batch = execute_batch


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--fault", choices=("none", "alter", "half"), default="none")
    p.add_argument("--root", default=None, help="checkout holding BENCHMARK.json")
    p.add_argument("--timeline", default=None, help="as run.py's --timeline")
    args = p.parse_args(argv)
    os.environ["PILOSA_TPU_SHARD_WIDTH"] = str(args.width)
    from portbench import run
    from portbench.spec import Benchmark

    cell = Benchmark(args.root or run.ROOT).cell(args.workload)
    cfg = dict(cell.config, shard_width_exp=args.width, shards=args.shards,
               records=(2 * args.shards - 1) << (args.width - 1))
    if args.fault != "none":
        fault_hooks(args.fault)
    timeline = [] if args.timeline else None
    result, found, verdict, errors = run.run_cell(cell, args.seed, args.seconds, False,
                                                  device="cpu", cfg=cfg, timeline=timeline)
    if timeline is not None:
        with open(args.timeline, "w") as f:
            json.dump(timeline, f)
    result["forbidden"] = found
    result["errors"] = errors
    sys.stdout.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
