"""A cell, a configuration, a mix and a per-layer metric added as files and
entries, with no edit of a file that is there, make a runnable cell."""
import json
import os

import pytest

from conftest import run_tiny

METRIC = '''"""A throwaway metric: the steps the window attempted."""


def read(ctx):
    return float(ctx.window.attempted)
'''


def add_cell(root: str) -> str:
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    base = json.load(open(os.path.join(root, "benchmark", "configs", "lightgcn-cosmetics-d80-l4.json")))
    base.update(name="throwaway-d8-l3")
    base["model"].update(embedding_dim=8, num_layers=3)
    with open(os.path.join(root, "benchmark", "configs", "throwaway-d8-l3.json"), "w") as f:
        json.dump(base, f)
    mix = json.load(open(os.path.join(root, "benchmark", "mixes", "train.json")))
    mix.update(steps_per_call=2)
    with open(os.path.join(root, "benchmark", "mixes", "throwaway-train.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark", "metrics", "steps_attempted.throwaway.py"), "w") as f:
        f.write(METRIC)
    cell = "throwaway-d8-l3.train"
    bench["configs"].append({"name": "throwaway-d8-l3", "source": "https://example.org/throwaway",
                             "file": "benchmark/configs/throwaway-d8-l3.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": "throwaway-d8-l3", "traffic": "throwaway-train",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "steps_attempted.throwaway", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train.step (the whole BPR step)",
                               "moves": "train_step_ms", "workloads": [cell]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_from_files_alone(tiny_root, trace):
    cell = add_cell(tiny_root)
    r = run_tiny(tiny_root, cell, seed=2**31 + 5, seconds=0.5, trace=trace)
    assert r["correct"] and r["attempted"] > 0
    if trace:
        assert set(r["metrics"]) == {"steps_attempted.throwaway"}
        assert r["metrics"]["steps_attempted.throwaway"]["value"] == r["attempted"]
    else:
        assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
    assert list(r)[-1] == "checks"
