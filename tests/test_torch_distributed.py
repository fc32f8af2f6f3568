"""The port's multi-process bring-up (parallel/distributed.py, the JAX
package's parallel/distributed.py:22-70), the CLI's `--distributed
--data-parallel` on two gloo ranks, and `bench_scaling` at 1 and 2 ranks.

`init_distributed` is a no-op when a group exists, refuses an explicit
but incomplete configuration and a partial torchrun environment, and
with nothing given warns and continues as one process.  Two CLI ranks
(spawned, `file://` rendezvous in tmp_path; the CLI joins the group they
made) save only on rank 0, and the plain data-parallel checkpoint equals
the one-process `--data-parallel` run's bit for bit."""

import os

import pytest
import torch
import torch.distributed as dist

from madrona_basketball_tpu_torch import bench_scaling, cli
from madrona_basketball_tpu_torch.parallel.distributed import (
    backend_for, init_distributed)
from madrona_basketball_tpu_torch.utils import checkpoint as ckpt
from tests import torch_dist_workers as DW
from tests import torch_threads  # noqa: F401

ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@pytest.fixture
def no_env(monkeypatch):
    for k in ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()


def test_noop_when_already_initialized(no_env):
    with DW.single_group():
        assert init_distributed(device="cpu") == 1
        assert init_distributed("localhost:1", 2, 0, device="cpu") == 1
        assert dist.get_world_size() == 1
    assert not dist.is_initialized()


@pytest.mark.parametrize("given", [("localhost:29511", None, None),
                                   (None, 2, None), (None, None, 0),
                                   ("localhost:29511", 2, None)])
def test_explicit_but_incomplete_configuration_raises(no_env, given):
    with pytest.raises(ValueError, match="must be given together"):
        init_distributed(*given, device="cpu")
    assert not dist.is_initialized()


def test_partial_torchrun_environment_raises(no_env, monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed(device="cpu")
    assert not dist.is_initialized()


def test_nothing_given_warns_and_continues_single_process(no_env):
    with pytest.warns(UserWarning, match="continuing single-process"):
        assert init_distributed(device="cpu") == 1
    assert not dist.is_initialized()


def test_backends():
    assert backend_for("cuda") == "nccl" and backend_for("cuda:1") == "nccl"
    assert backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        backend_for("meta")


ARGV = ["--device", "cpu", "--num-rollout-steps", "4", "--num-iterations",
        "2", "--log-every-n-iterations", "1",
        "--save-model-every-n-iterations", "2", "--model-name", "m",
        "--data-parallel"]


@pytest.mark.parametrize("mode", ["plain", "dp_update"])
def test_cli_two_ranks_save_on_rank_zero(tmp_path, monkeypatch, no_env,
                                         mode):
    torch.set_num_threads(1)
    extra = ["--num-envs", "64"] if mode == "plain" else \
        ["--num-envs", "256", "--dp-update"]
    DW.spawn("cli", ["--distributed"] + ARGV + extra, tmp_path / "two")
    path = ckpt.checkpoint_path("m", 2)
    got = tmp_path / "two" / "rank0" / path
    assert got.exists()
    assert not (tmp_path / "two" / "rank1" / "checkpoints").exists()
    sd = torch.load(got, weights_only=True)
    assert all(torch.isfinite(v).all() for v in sd.values())
    back = ckpt.load_agent(str(got), "cpu")
    assert float(back.obs_rms.count) == 1.0 + 2 * 4 * int(extra[1])
    if mode == "dp_update":
        return
    # the one-process run of the same 64 worlds: the same checkpoint
    one = tmp_path / "one"
    one.mkdir()
    monkeypatch.chdir(one)
    state = cli.main(ARGV + extra)
    assert state.iteration == 2 and state.opt.count == 2 * 16
    want = torch.load(one / path, weights_only=True)
    assert set(want) == set(sd)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    assert not dist.is_initialized()


def test_bench_scaling_one_and_two_ranks():
    rows = bench_scaling.main(["--device", "cpu", "--max-gpus", "2",
                               "--worlds-per-gpu", "32",
                               "--num-rollout-steps", "4", "--sim-steps",
                               "4", "--iters-per-dispatch", "2"])
    assert [r["gpus"] for r in rows] == [1, 2]
    assert [r["worlds"] for r in rows] == [32, 64]
    assert rows[0]["sim_efficiency"] == rows[0]["train_efficiency"] == 1.0
    for r in rows:
        assert r["backend"] == "gloo"
        for k in ("sim_env_steps_per_s", "train_env_steps_per_s",
                  "train_iteration_ms", "sim_efficiency",
                  "train_efficiency"):
            assert r[k] > 0, k
    assert not dist.is_initialized() and "RANK" not in os.environ
