"""Two processes over ``torch.distributed`` (gloo) on the CPU: the port's
counterpart of ``tests/test_multihost.py``.

Each process runs ``python -m pilosa_tpu_torch.testing.multihost``: it
joins the job through ``parallel.mesh.init_multihost`` (a ``file://``
store under ``tmp_path``), serves the shards it owns (``shard % 2 ==
rank``) through the executor on a local mesh of two slices, sums the
partials across the processes and holds them to the data's truth, then
reads one stack laid over the global mesh of four slices through the
kernel wrappers, whose int64 totals are summed across the processes,
against the same truth (the JAX worker's checks, its chunked branch
included). Each process has 150 s, as JAX's workers have."""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run_pair(tmp_path, *extra):
    init = f"file://{tmp_path / 'pg'}"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.testing.multihost",
             "--rank", str(rank), "--init", init, "--device", "cpu", *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers hung: " + " | ".join(outs))
    return procs, outs


def test_two_process_distributed_executor(tmp_path):
    procs, outs = _run_pair(tmp_path)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc{i} failed:\n{outs[i]}"
    assert "proc0 OK" in outs[0]
    assert "proc1 OK" in outs[1]
    # the same totals on both ranks
    assert outs[0].split("proc0 OK")[1].strip() == outs[1].split("proc1 OK")[1].strip()


def test_two_process_uneven_rows_and_three_local_slices(tmp_path):
    """More rows than the grams read, and three slices a rank: each rank's
    block of 6 shards is padded to 6 over 3 slices, the global mesh of six
    slices holds 12 shards in process-major order."""
    procs, outs = _run_pair(tmp_path, "--shards", "12", "--rows", "9", "--words", "64",
                            "--local-devices", "3", "--seed", "7")
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc{i} failed:\n{outs[i]}"
    assert "proc0 OK" in outs[0] and "proc1 OK" in outs[1]
