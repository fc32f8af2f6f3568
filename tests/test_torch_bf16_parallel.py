"""--bf16-traj across two gloo ranks on the CPU: the training CLI with
`--distributed --data-parallel --bf16-traj` spawned on two ranks of a
`file://` rendezvous (tests/torch_dist_workers.py), whose plain path
all-gathers each rank's bfloat16 trajectory over gloo, writes the
checkpoint of the one-process run of the same 64 worlds bit for bit, as
tests/test_torch_distributed.py holds the float32 path.  With
`--dp-update` each rank's kernel G reads its own bf16 blocks; its
stratified shuffle differs from one rank's, so that run is held to a
finite, loadable checkpoint."""

import pytest
import torch
import torch.distributed as dist

from madrona_basketball_tpu_torch import cli
from madrona_basketball_tpu_torch.utils import checkpoint as ckpt
from tests import torch_dist_workers as DW

ARGV = ["--device", "cpu", "--num-rollout-steps", "4", "--num-iterations",
        "2", "--log-every-n-iterations", "1",
        "--save-model-every-n-iterations", "2", "--model-name", "m",
        "--data-parallel", "--bf16-traj", "--bf16-policy"]
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


@pytest.mark.parametrize("mode", ["plain", "dp_update"])
def test_two_gloo_ranks_gather_the_bf16_trajectory(tmp_path, monkeypatch,
                                                   mode):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    torch.set_num_threads(1)
    extra = ["--num-envs", "64"] if mode == "plain" else \
        ["--num-envs", "256", "--dp-update"]
    DW.spawn("cli", ["--distributed"] + ARGV + extra, tmp_path / "two")
    path = ckpt.checkpoint_path("m", 2)
    sd = torch.load(tmp_path / "two" / "rank0" / path, weights_only=True)
    assert all(bool(torch.isfinite(v).all()) for v in sd.values())
    assert not (tmp_path / "two" / "rank1" / "checkpoints").exists()
    if mode == "dp_update":
        return
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
