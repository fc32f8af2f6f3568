"""The frozen counts give the numbers the benchmark was defined with."""

import json
from pathlib import Path

import pytest

from benchmark.counts import model_flops as MF
from benchmark.counts import peaks, rollout_B, update_D
from benchmark.reference.update import pick_update_block

W, T, E, M = 8192, 32, 4, 4
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
POLICY = json.loads((CONFIGS / "tag_ppo.json").read_text())["policy"]


@pytest.mark.parametrize("config", ["tag_ppo", "tag_selfplay"])
def test_forward_flops(config):
    policy = json.loads((CONFIGS / f"{config}.json").read_text())["policy"]
    f = MF.widths(policy)
    assert f["actor_critic"] == \
        2 * (103 * 32 + 32 * 32 + 32 * 19 + 32 * 1) == 9920
    assert f["actor"] == 9856
    assert f["critic"] == 8704
    assert f["input_grads"] == 3328
    assert f["update_sample"] == 9920 + 9920 + 3328


def test_forward_flops_follow_the_widths():
    """A wider or deeper policy block counts its own products."""
    wide = dict(POLICY, hidden_size=64, num_hidden_layers=3)
    assert MF.widths(wide)["actor_critic"] == \
        2 * (103 * 64 + 2 * 64 * 64 + 64 * 19 + 64)


@pytest.mark.parametrize("frozen, gflop", [(False, 26.965), (True, 29.549)])
def test_iteration_flops(frozen, gflop):
    flops = MF.train_iteration(POLICY, W, T, E, frozen)
    assert flops / 1e9 == pytest.approx(gflop, abs=0.0005)
    f = MF.widths(POLICY)
    parts = (W * T * f["actor_critic"], W * f["critic"],
             E * W * T * f["update_sample"])
    assert [round(p / 1e9, 3) for p in parts] == [2.600, 0.071, 24.293]


def test_eval_flops():
    assert MF.eval_tick(POLICY, W) / 1e9 == pytest.approx(0.1615, abs=5e-5)


def test_kernel_D_bound():
    """26.48 GFLOP, bound by its operations (0.395 ms; PERF.md's table)."""
    ops = update_D.ops(W, T, E, M)
    nb = update_D.nbytes(W, T, E, pick_update_block(W, W * T // M))
    assert ops / 1e9 == pytest.approx(26.48, abs=0.005)
    assert peaks.bound_s(nb, ops) == pytest.approx(0.000395242, rel=1e-4)
    assert ops / peaks.FP32_FLOP_PER_S > nb / peaks.HBM_BYTES_PER_S


@pytest.mark.parametrize("frozen, gflop", [(False, 3.845), (True, 7.180)])
def test_kernel_B_bound(frozen, gflop):
    ops = rollout_B.ops(W, T, frozen)
    assert ops / 1e9 == pytest.approx(gflop, abs=0.001)
    if not frozen:
        # 0.057408 ms by its operations in PERF.md's table, which spread
        # the per-tick constant over the 64 counted worlds
        assert peaks.bound_s(rollout_B.nbytes(W, T, frozen), ops) == \
            pytest.approx(0.000057408, rel=3e-4)


def test_kernel_F_bound():
    """62.14 GFLOP a 5000-tick launch, bound by its operations (0.927 ms;
    PERF.md's table)."""
    from benchmark.counts import multistep_F
    ops = multistep_F.ops(W, 5000)
    assert ops / 1e9 == pytest.approx(62.14, abs=0.005)
    assert peaks.bound_s(multistep_F.nbytes(W), ops) == \
        pytest.approx(0.000927408, rel=1e-5)
