"""The comparison that decides ``correct`` fails what it has to fail.

At a size a test run holds, on the CPU (the look for a card skipped):

- a sound run of each cell is correct;
- the control, the reference computed one precision below the
  configuration's in the program's place, and the planted faults (half the
  batch; users drawn by purchase) fail the cell's limits (each driver's
  ``controls``, which ``tools/control.py`` prints), while the program's own
  sampler passes;
- a run with the timed path broken underneath comes out not correct: a
  training step that leaves its state unchanged, half of the batch left
  out with the mean taken over the rest, a sampler that favours active
  users (its triples all valid), an answer altered where it is
  produced, a refresh that leaves the cache unchanged.

``test_card_cells`` runs the same tiny cells on the card.
"""
import numpy as np
import pytest

from benchmark import harness

from conftest import run_tiny

CELLS = ["cosmetics-d90-l5.train", "cosmetics-d80-l4.train", "cosmetics-d90-l5.serve",
         "cosmetics-d90-l5.refresh"]


def failed_numbers(nums: dict, limits: dict) -> list:
    return [k for k, v in nums.items() if k in limits and not v <= limits[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = run_tiny(tiny_root, cell, seed=2**31 + 11, seconds=1.0)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 3])
def test_control_and_faults_fail(tiny_root, cell, seed):
    # 20 s of the serve mix's requests: at this size a few hundred answers can
    # all hold the same 20 items in TF32.
    c = harness.find_cell(tiny_root, cell, seed, 20.0, False, "cpu")
    out = c.driver.controls(c)
    expected = ({"program_sampler", "control_fp8", "half_batch", "users_by_purchase"} if "train" in cell
                else {"control_tf32"})
    assert set(out) == expected
    for kind, nums in out.items():
        if kind == "program_sampler":
            assert not failed_numbers(nums, c.mix["limits"]), nums
        else:
            assert failed_numbers(nums, c.mix["limits"]), (kind, nums, c.mix["limits"])


def adam_unchanged(monkeypatch):
    from gnn_ecommerce_tpu_torch.train import step

    monkeypatch.setattr(step.Adam, "update", lambda self, grads, state, params: None)


def half_batch(monkeypatch):
    from gnn_ecommerce_tpu_torch.train import step

    full = step.bpr_loss
    monkeypatch.setattr(step, "bpr_loss", lambda p, n: full(p[: len(p) // 2], n[: len(n) // 2]))


def users_by_degree(monkeypatch):
    import torch

    from gnn_ecommerce_tpu_torch.sampling import bpr
    from gnn_ecommerce_tpu_torch.train import step

    right = bpr.sample_batch

    def biased(generator, data, batch_size, replace=True):
        # Valid triples, the users the most active of four times as many.
        users, pos, neg = right(generator, data, 4 * batch_size, replace)
        deg = torch.zeros(data.n_users, dtype=torch.int64, device=users.device)
        deg[data.users] = data.pos_indptr[1:] - data.pos_indptr[:-1]
        keep = torch.argsort(deg[users], descending=True, stable=True)[:batch_size]
        return users[keep], pos[keep], neg[keep]

    monkeypatch.setattr(bpr, "sample_batch", biased)
    monkeypatch.setattr(step, "sample_batch", biased)


def answer_altered(monkeypatch):
    from gnn_ecommerce_tpu_torch.serve.service import RecommenderService

    right = RecommenderService.recommend

    def altered(self, user_ids, k=None):
        out = np.array(right(self, user_ids, k))
        out[:, 0] = (out[:, 0] + 1) % self.prepared.n_items
        return out

    monkeypatch.setattr(RecommenderService, "recommend", altered)


def refresh_unchanged(monkeypatch):
    from gnn_ecommerce_tpu_torch.serve.service import RecommenderService

    right = RecommenderService.refresh

    def stale(self, params, version=None):
        return 0.0 if self._versions else right(self, params, version)

    monkeypatch.setattr(RecommenderService, "refresh", stale)


@pytest.mark.parametrize("cell,fault", [
    ("cosmetics-d90-l5.train", adam_unchanged), ("cosmetics-d90-l5.train", half_batch),
    ("cosmetics-d90-l5.train", users_by_degree),
    ("cosmetics-d80-l4.train", adam_unchanged), ("cosmetics-d80-l4.train", half_batch),
    ("cosmetics-d90-l5.serve", answer_altered), ("cosmetics-d90-l5.refresh", refresh_unchanged),
])
def test_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run_tiny(tiny_root, cell, seed=2**31 + 17, seconds=0.5)
    assert not r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_cells(tiny_root, card, cell):
    r = run_tiny(tiny_root, cell, seed=2**31 + 23, seconds=1.0, trace=True, device=card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
