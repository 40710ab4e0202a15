"""The check that nothing a run executes imports JAX or the JAX package,
names compared by their top-level part, whole."""

import json
import subprocess
import sys

from portbench import guard, run


def test_top_level_names_compared_whole():
    assert guard.forbidden({"pilosa_tpu_torch.exec.executor": 1, "jaxtyping": 1,
                            "flaxen": 1}) == []
    assert guard.forbidden({"jax.numpy": 1, "pilosa_tpu.ops": 1, "numpy": 1}) == [
        "jax", "pilosa_tpu"]
    assert guard.forbidden({"jaxlib": 1, "flax.linen": 1}) == ["flax", "jaxlib"]


def imports_of(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=run.ROOT, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def test_harness_and_port_import_no_jax():
    mods = imports_of(
        "from portbench import run, client, observe, control, rehearse\n"
        "from portbench.spec import Benchmark\n"
        "b = Benchmark(run.ROOT)\n"
        "for w in b.spec['workloads']:\n"
        "    c = b.cell(w['name']); c.data_module(); c.ref_module()\n"
        "    [b.reader(m['name']) for m in c.per_layer]\n"
        "import pilosa_tpu_torch.server.node, pilosa_tpu_torch.convert\n")
    assert guard.forbidden(mods) == []
    assert "pilosa_tpu_torch.server.node" in mods


def test_reference_imports_nothing_of_the_program():
    mods = imports_of(
        "from portbench import run, reference, pql, traffic\n"
        "from portbench.spec import Benchmark\n"
        "b = Benchmark(run.ROOT)\n"
        "for w in b.spec['workloads']:\n"
        "    c = b.cell(w['name']); c.ref_module(); c.data_module()\n")
    assert not [m for m in mods if m.split(".")[0] in ("pilosa_tpu_torch", "pilosa_tpu", "jax")]
