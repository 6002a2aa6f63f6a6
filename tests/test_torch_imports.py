"""The PyTorch port stands alone: every module of gnn_ecommerce_tpu_torch,
and chip_smoke.py, imports with JAX, the JAX package, pandas, PyYAML,
matplotlib and networkx made unimportable (the plots import the last two
only when they draw), and no source names JAX or the JAX package. Exact
checks: no tolerance applies."""
import os
import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "gnn_ecommerce_tpu_torch"


def _port_modules() -> list[str]:
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_module_imports_without_jax():
    modules = _port_modules() + ["chip_smoke"]
    assert "gnn_ecommerce_tpu_torch.ops.spmm_fast" in modules
    assert "gnn_ecommerce_tpu_torch.cli.train" in modules
    assert "gnn_ecommerce_tpu_torch.explain.plots" in modules
    for name in (
        "parallel", "parallel.mesh", "parallel.distributed", "parallel.edge_partition_fast",
        "parallel.sharded_eval", "parallel.sharded_train", "parallel.edge_partition",
        "ops.spmm_sharded", "data.eda", "data.profile", "cli.eda", "bench",
        "runs.full_corpus_r3", "runs.svd_full_r5", "runs.bprmf_full_r5", "runs.skyline_full_r3",
        "runs.movielens_bench", "runs.config3_subsample_r3", "runs.train_full_r5b", "runs.bars",
        "runs.real_data_rehearsal", "runs.heavy_k_sweep_r3", "runs.depth_dim_sweep_r3",
    ):
        assert f"gnn_ecommerce_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gnn_ecommerce_tpu'] = None\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['networkx'] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'gnn_ecommerce_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.startswith("ok")


def test_sources_name_no_jax():
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gnn_ecommerce_tpu)\b(?!_torch)", re.M)
    jax_module = re.compile(r"\bgnn_ecommerce_tpu\.")
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 15
    for path in sources:
        text = path.read_text()
        assert not jax_import.search(text), path
        assert not jax_module.search(text), path
