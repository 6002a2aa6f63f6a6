"""No module that the harness loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``gnn_ecommerce_tpu`` (compared whole: the port,
``gnn_ecommerce_tpu_torch``, is not the JAX package), and the reference
imports nothing of the program."""
import ast
import glob
import json
import os
import subprocess
import sys

from conftest import REPO

FOREIGN = {"jax", "jaxlib", "flax", "gnn_ecommerce_tpu"}
PORT = "gnn_ecommerce_tpu_torch"


def loaded_after(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter from the repository's root."""
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {REPO!r})\n{code}\n"
         "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        check=True, capture_output=True, text=True, cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    ).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = "\n".join([
        "import glob, os",
        "from benchmark import harness, inputs, measure, peaks, program, run",
        "from benchmark.tools import control, knee",
        "for p in sorted(glob.glob('benchmark/drivers/*.py') + glob.glob('benchmark/metrics/*.py')):",
        "    harness.load_module(p, 'x_' + os.path.basename(p).replace('.', '_'))",
    ])
    names = loaded_after(code)
    assert PORT in names
    assert not names & FOREIGN, names & FOREIGN


def test_reference_loads_nothing_of_the_program():
    names = loaded_after("import benchmark.reference.lightgcn, benchmark.reference.judge, "
                         "benchmark.reference.precision")
    assert PORT not in names and not names & FOREIGN


def test_reference_sources_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(REPO, "benchmark", "reference", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert not tops & (FOREIGN | {PORT}), (path, tops)


def test_foreign_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "gnn_ecommerce_tpu_torch_fake", object())
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "gnn_ecommerce_tpu.ops", object())
    assert harness.foreign_modules() == ["gnn_ecommerce_tpu"]


def test_run_without_a_card_prints_no_result(tmp_path):
    """On a host without a CUDA card the run exits non-zero and prints no
    result line; so it does in a directory holding only BENCHMARK.json and
    the benchmark's files (the program absent)."""
    import shutil

    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for root in (REPO, str(tmp_path)):
        if root != REPO:
            shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
            shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                            ignore=shutil.ignore_patterns("_cache", "__pycache__"))
        done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cosmetics-d90-l5.train",
                               "--seed", "1", "--seconds", "1", "--trace", "0"],
                              capture_output=True, text=True, cwd=root)
        assert done.returncode != 0 and done.stdout.strip() == "", (root, done.returncode, done.stdout)
