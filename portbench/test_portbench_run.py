"""Whole runs on the CPU at a small size (``rehearse.py``): the harness
without its look for a card, data to node to client process to
reference. A sound run comes out correct; the timed path broken
underneath comes out not correct, once for each fault the cells can
have: an answer altered where the executor makes it, and half of each
flight answered with the other half's answers."""

import json
import subprocess
import sys

import pytest

from portbench import run

CELLS = ["taxi.q1-q4", "ssb.q1", "taxi.drilldown"]


def rehearse(workload: str, fault: str, seed: int, *extra: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", "portbench.rehearse", "--workload", workload, "--seed",
         str(seed), "--seconds", "2", "--shards", "2", "--width", "15", "--fault", fault,
         *extra],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = rehearse(workload, "none", 2**31 + 17)
    assert r["correct"], r
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["forbidden"] == [] and r["errors"] == []
    assert set(r["metrics"]) == {"queries_per_s", "p95_ms", "setup_s"}
    assert list(r)[-3:] == ["checks", "forbidden", "errors"]


@pytest.mark.parametrize("fault", ["alter", "half"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(workload, fault):
    r = rehearse(workload, fault, 2**31 + 18)
    assert not r["correct"], r
    assert r["checks"]["wrong_answers"]["value"] > 0


def test_timeline_holds_every_request(tmp_path):
    path = tmp_path / "timeline.json"
    r = rehearse("taxi.drilldown", "none", 2**31 + 19, "--timeline", str(path))
    timeline = json.loads(path.read_text())
    assert len(timeline) == r["attempted"]
    templates = {"q3_group_by_cab", "q4_group", "q4_group_by_cab"}
    for client, template, sent, answered, status in timeline:
        assert 0 <= client < 64 and template in templates and status == 200
        assert 0 <= sent <= answered
