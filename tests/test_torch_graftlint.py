"""The port is linted as the JAX package is: ``python -m tools.graftlint
pilosa_tpu_torch`` reports no open finding, every suppression in the port
carries its reason, and the CLI exits 0 over the port (the counterpart of
``tests/test_graftlint.py``'s clean-tree cases)."""

# the port's lock witness, installed before the port is imported so that its
# module-level locks are wrapped too (pilosa_tpu_torch/testing/lockwitness.py)
from pilosa_tpu_torch.testing import lockwitness as port_lockwitness

port_lockwitness.install()
# the module fixture that asserts no new inversion among the port's locks
from pilosa_tpu_torch.testing.lockwitness import no_new_inversion  # noqa: F401

import json
import os
import subprocess
import sys

import pytest

from tools.graftlint import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pilosa_tpu_torch")


@pytest.fixture(scope="module")
def findings():
    return engine.run([PORT])


def test_zero_unsuppressed_findings_in_the_port(findings):
    open_ = [f for f in findings if not f.suppressed]
    assert open_ == [], "\n".join(f.render() for f in open_)


def test_every_suppression_in_the_port_has_a_reason(findings):
    suppressed = [f for f in findings if f.suppressed]
    assert suppressed
    for f in suppressed:
        assert f.reason and f.reason.strip(), f.render()


def test_the_cli_reports_zero_over_the_port(tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "tools.graftlint", "pilosa_tpu_torch", "--json", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout + r.stderr
    assert json.loads(out.read_text())["open"] == 0
