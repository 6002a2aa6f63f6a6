"""Two ``cli.train`` processes of the port train as one mesh on the CPU, the
counterpart of ``tests/test_multiprocess.py::test_two_process_cli_train``:
each is launched with torch's four variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), ``--mesh 2 --partition edge
--fast f32 --device cpu``. Both finish; rank 0 alone writes the prepared
artifact, the log and the checkpoints; a second launch with ``--resume``
trains one more epoch from LAST."""
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = [
    "--synthetic", "--synthetic-users", "200", "--synthetic-items", "50", "--synthetic-events",
    "4000", "--dim", "8", "--layers", "2", "--mesh", "2", "--partition", "edge", "--fast", "f32",
    "--heavy-users", "16", "--device", "cpu",
]
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(cwd, extra: list) -> list:
    """Both ranks' (return code, output), each rank killed at TIMEOUT_S."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
        env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gnn_ecommerce_tpu_torch.cli.train", *ARGS, *extra],
            cwd=str(cwd), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=TIMEOUT_S)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return outs


def test_two_process_cli_train_and_resume(tmp_path):
    outs = _launch(tmp_path, ["-e", "2"])
    for rank, (out, rc) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert f"distributed: {{'process_index': {rank}, 'process_count': 2" in out, out
        assert "done: best epoch" in out, out
    assert "prepared artifact" in outs[0][0] and "prepared artifact" not in outs[1][0]
    assert os.path.exists(tmp_path / "data" / "prepared" / "manifest.json")
    ckpt = tmp_path / "model-checkpoints"
    for name in ("LightGCN_best", "LightGCN_last"):
        assert os.path.exists(ckpt / name / "checkpoint.npz")

    outs = _launch(tmp_path, ["-e", "3", "--resume"])
    for rank, (out, rc) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed on resume:\n{out}"
    with open(ckpt / "train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [r["epoch"] for r in log if "epoch" in r] == [0, 1, 2]  # one writer
    assert len([r for r in log if "etl_s" in r]) == 2
    with open(ckpt / "LightGCN_last" / "meta.json") as f:
        assert json.load(f)["epoch"] == 2
