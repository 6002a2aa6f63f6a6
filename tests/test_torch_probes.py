"""The probe slice as a whole: each probe module's ``main`` on the CPU, at
the scripts' CPU shapes (or tiny ones), returns the script's keys, its
correctness sections pass and it launches no kernel; every kernel
configuration a probe times is checked first; a failed section raises out
of ``main`` and the command line; each section's launches are recorded."""
import json

import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu_torch.ops._kernels import ROW_GATHER
from gnn_ecommerce_tpu_torch.probes import (
    _timing,
    microbench_gather,
    microbench_gather2,
    pallas_gather_probe,
    proto_segreduce,
)

torch.set_num_threads(1)

RATE_KEYS = {"ms", "Mrows_s", "ns_per_row"}

# The keys each script records (scripts/*.py: rec, record and results[...]).
PROTO_KEYS = {"correct_small_relerr_f32"} | {
    f"{case}_{what}"
    for case in ("to_items_pl_bf16", "to_items_pl_f32", "to_users_pl_bf16", "to_users_pl_bf16_ch1024")
    for what in ("pad_ratio", "ms")
}
GATHER_PROBE_KEYS = {
    "xla_take_bf16_128", "xla_take_tile_rows", "pallas_dma_k4_c1024", "pallas_dma_k8_c1024",
    "pallas_dma_k8_c2048", "pallas_dma_k16_c1024",
}
MICRO_KEYS = {
    "gather_rand_big_f32d80", "gather_rand_big_bf16d80", "gather_sorted_big_f32d80",
    "gather_sorted_flagged_big_f32d80", "gather_rand_small_f32d80", "gather_rand_small_bf16d80",
    "gather_rand_big_f32d8", "gather_rand_big_f32d128", "gather_rand_big_f32d256", "to_items_like",
    "to_items_bf16gather", "segsum_sorted_items", "scatter_rand_small", "scatter_rand_big",
    "lane_gather_xla_small", "pallas_lane_gather_small", "onehot_expand_c128",
}
MICRO2_KEYS = {
    "to_items_like", "segsum_sorted_items", "segsum_sorted_users", "scatter_rand_small",
    "lane_gather_xla_small_bf16", "pallas_lane_gather_small", "onehot_expand_c128",
    "gather_rand_big_f32_out_bf16", "ell_gather_sum_w192",
}


def test_proto_segreduce_main():
    res = proto_segreduce.main(device="cpu", reps=1)
    assert res["device"] == "cpu" and not any(res["launches"].values())
    assert PROTO_KEYS <= res.keys()
    assert res["correct_small_relerr_f32"] < 1e-5
    assert all(res[k] >= 1.0 for k in PROTO_KEYS if k.endswith("pad_ratio"))
    assert all(res[k] > 0 for k in PROTO_KEYS if k.endswith("_ms"))


def test_pallas_gather_probe_main():
    res = pallas_gather_probe.main(device="cpu", reps=1)
    assert not any(res["launches"].values())
    assert (res["n_rows"], res["n_gather"], res["dim"]) == (4096, 8192, 128)  # the script's CPU shapes
    assert res["per_row_kernel_correct"] is True
    for key in GATHER_PROBE_KEYS | {"row_gather_bf16_128_k8_c1024"}:
        assert {"s", "ns_per_row", "GBps"} <= res[key].keys(), key
        assert res[key]["ms"] > 0
    assert res["pallas_dma_k4_c1024"]["first_call_s"] >= 0


@pytest.mark.parametrize("module,keys", [(microbench_gather, MICRO_KEYS), (microbench_gather2, MICRO2_KEYS)])
def test_microbench_main(module, keys):
    res = module.main(device="cpu", reps=1)
    assert not any(res["launches"].values())
    assert keys <= res.keys()
    for key in keys:
        assert RATE_KEYS <= res[key].keys() and res[key]["ms"] > 0, key
    assert res["pallas_lane_gather_small"]["exact"] is True


def test_cli_writes_json_and_exits_zero(tmp_path, capsys):
    out = tmp_path / "probe.json"
    rc = _timing.cli(pallas_gather_probe.main, pallas_gather_probe.__doc__,
                     ["--device", "cpu", "--reps", "1", "--out", str(out)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    assert GATHER_PROBE_KEYS <= printed.keys()


def _broken_lane_gather(tab, idx):
    raise RuntimeError("kernel failed")


def test_a_failed_section_raises_out_of_the_cli(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(microbench_gather2, "lane_gather_8x512", _broken_lane_gather)
    out = tmp_path / "probe.json"
    with pytest.raises(RuntimeError, match="kernel failed"):
        _timing.cli(microbench_gather2.main, microbench_gather2.__doc__,
                    ["--device", "cpu", "--reps", "1", "--out", str(out)])
    assert capsys.readouterr().out == "" and not out.exists()


def test_section_records_its_launches_and_raises(monkeypatch):
    monkeypatch.setitem(ROW_GATHER.launches, "float32", ROW_GATHER.launches["float32"])
    probe = _timing.Probe("cpu", reps=1)

    def launch_then_fail():
        ROW_GATHER.launches["float32"] += 2
        raise ValueError("bad rows")

    probe.section("quiet", lambda: None)
    with pytest.raises(ValueError, match="bad rows"):
        probe.section("loud", launch_then_fail)
    assert probe.results["launches"] == {"quiet": {}, "loud": {"row_gather.float32": 2}}


@pytest.mark.parametrize("k,chunk", [(4, 1024), (8, 1024), (8, 2048), (16, 1024)])
def test_gather_probe_checks_every_configuration_it_times(monkeypatch, k, chunk):
    real = pallas_gather_probe.row_gather

    def wrong_at_one_configuration(table, idx, *, k_inflight=8, chunk=1024):
        out = real(table, idx, k_inflight=k_inflight, chunk=chunk)
        if (k_inflight, chunk) == (k, chunk_wrong) and idx.numel() > 1024:
            out[-1] += 1  # one wrong row, which the script's 1,024-index check misses
        return out

    chunk_wrong = chunk
    monkeypatch.setattr(pallas_gather_probe, "row_gather", wrong_at_one_configuration)
    with pytest.raises(AssertionError, match=f"k_inflight={k} chunk={chunk} differs"):
        pallas_gather_probe.main(device="cpu", reps=1)


@pytest.mark.parametrize("case", ["to_items_pl_bf16", "to_items_pl_f32", "to_users_pl_bf16",
                                  "to_users_pl_bf16_ch1024"])
def test_proto_segreduce_checks_every_case_it_times(monkeypatch, case):
    real_plan, real = proto_segreduce.build_plan, proto_segreduce.tile_segreduce
    n_out = []

    def plan_recording_n_out(src, dst_sorted, w, n, OT, CH):
        n_out.append(n)
        return real_plan(src, dst_sorted, w, n, OT, CH)

    def wrong_in_one_case(msgs, seg, tile_map, first, n_tiles, ot):
        out = real(msgs, seg, tile_map, first, n_tiles, ot)
        ch = msgs.shape[0] // tile_map.numel()
        this = ("to_items" if n_out[-1] == proto_segreduce.SMALL["NI"] else "to_users") + "_pl_" + (
            "bf16" if msgs.dtype == torch.bfloat16 else "f32") + ("_ch1024" if ch == 1024 else "")
        if ot == 512 and this == case:
            out[0, 0] += 1.0  # one wrong output element
        return out

    monkeypatch.setattr(proto_segreduce, "build_plan", plan_recording_n_out)
    monkeypatch.setattr(proto_segreduce, "tile_segreduce", wrong_in_one_case)
    with pytest.raises(AssertionError, match=f"{case}: K2 differs from its plain version"):
        proto_segreduce.main(device="cpu", reps=1)


def test_microbench_gather2_takes_shared_sections_without_running_them():
    shared = microbench_gather.main(device="cpu", reps=1)
    res = microbench_gather2.main(device="cpu", reps=1, shared=shared)
    for key in microbench_gather2.SHARED:
        assert res[key] == {**shared[key], "same_as": f"microbench_gather.{key}"}
        assert key not in res["launches"]  # no section ran for it
    assert MICRO2_KEYS <= res.keys()
    assert shared["gather_sorted_flagged_big_f32d80"]["ms"] == shared["gather_sorted_big_f32d80"]["ms"]


def test_probes_raise_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        proto_segreduce.main()


def test_timer_and_rates():
    dev = torch.device("cpu")
    calls = []
    ms = _timing.time_ms(lambda: calls.append(1), dev, reps=3, warmup=2)
    assert len(calls) == 5 and ms >= 0
    r = _timing.rate(2.0, 4_000_000, 8_000_000)
    assert r == {"ms": 2.0, "Mrows_s": 2000.0, "ns_per_row": 0.5, "GBps": 4.0}
    assert "GBps" not in _timing.rate(1.0, 10)
    assert np.isclose(_timing.rate(0.5, 10)["Mrows_s"], 0.02)
