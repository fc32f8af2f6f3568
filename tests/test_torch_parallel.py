"""The port's plain data-parallel iteration (`--data-parallel`,
`make_train_iteration(..., mesh=...)`) on the CPU over gloo.

Two ranks of 32 worlds against the one-process run of the same 64 worlds
(a world-size-1 group in this process): two chained iterations with a
frozen opponent, on injected noise and permutations, give the same
weights, Adam moments, normalizers, episode stats, metrics and (each
rank's columns of) rows bit for bit, and both ranks hold the same
learner bit for bit.  At one rank the plain iteration (with or without
--rollout-tiled) is the tiled flagship's bit for bit.
`shard_train_state` / `gather_train_state` round trip, and `world_base`
in `philox_noise` / the rollout wrapper gives the columns of the
whole-fleet draw.  The ranks are spawned processes with a `file://`
rendezvous in tmp_path (tests/torch_dist_workers.py)."""

import dataclasses

import pytest
import torch

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.models.agent import init_agent
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.parallel.mesh import DataMesh
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    make_train_iteration, shard_worlds)
from tests import torch_dist_workers as DW
from tests import torch_threads  # noqa: F401

SPEC = {"W": 64, "T": 4, "frozen": True, "iters": 2, "perm_shape": (4, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    ranks = DW.spawn("iterations", SPEC, tmp_path_factory.mktemp("plain"))
    with DW.single_group() as mesh:
        one = DW.run_iterations(mesh, SPEC)
    return ranks, one


def _equal(a, b, what):
    if isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def test_two_ranks_equal_the_one_process_run_bit_for_bit(runs):
    ranks, one = runs
    assert len(ranks) == 2
    for r in ranks:
        for key in ("params", "mu", "nu", "rms", "stats", "metrics", "count",
                    "counter"):
            _equal(r[key], one[key], key)
    # each rank's rows are its columns of the one-process rows
    for rank, r in enumerate(ranks):
        cols = slice(32 * rank, 32 * (rank + 1))
        for k, v in r["rows"].items():
            assert torch.equal(v, one["rows"][k][:, cols]), k
    # what the update consumed: the gathered trajectory in world order
    _equal(ranks[0]["first"]["traj"], one["first"]["traj"], "traj")


def test_every_rank_holds_the_same_learner(runs):
    ranks, _ = runs
    _equal(ranks[0]["params"], ranks[1]["params"], "params")
    _equal(ranks[0]["mu"], ranks[1]["mu"], "mu")
    _equal(ranks[0]["rms"], ranks[1]["rms"], "rms")
    assert all(torch.isfinite(p).all() for p in ranks[0]["params"])


def test_shard_train_state_round_trips(runs):
    ranks, one = runs
    assert all(r["round_trip"] for r in ranks)
    assert one["round_trip"]


@pytest.mark.parametrize("tiled", [False, True])
def test_one_rank_equals_the_tiled_flagship(tiled):
    """At one rank the plain data-parallel iteration (kernel E on the
    gathered trajectory), with or without --rollout-tiled, is the tiled
    flagship's iteration (kernel I, then E) bit for bit."""
    torch.set_num_threads(1)
    spec = {"W": 1024, "T": 2, "iters": 1, "perm_shape": (4, 4)}
    want = DW.run_iterations(None, dict(spec, tiled=True))
    with DW.single_group() as mesh:
        got = DW.run_iterations(mesh, dict(spec, tiled=tiled))
    for key in ("params", "mu", "nu", "rms", "stats", "rows", "metrics"):
        _equal(got[key], want[key], key)


def test_philox_world_base_gives_the_columns_of_the_whole_draw():
    whole = FR.philox_noise(11, 7, 3, 96, "cpu")
    for base in (0, 32, 64):
        part = FR.philox_noise(11, 7, 3, 32, "cpu", world_base=base)
        assert torch.equal(part, whole[:, base:base + 32])


def test_rollout_world_base_steps_a_shard_as_the_whole_fleet():
    cfg = SimConfig()
    gen = torch.Generator().manual_seed(4)
    sf, si = init_rows(cfg, 64, gen, "cpu")
    obs = torch.zeros((256, 64))
    mats = FR.pack_policy(init_agent(torch.Generator().manual_seed(2),
                                     "cpu"))
    kw = dict(n_steps=2, trainee_idx=1, seed=5, tick_base=3)
    whole = FR.fused_rollout(cfg, sf, si, obs, mats, **kw)
    h = slice(32, 64)
    part = FR.fused_rollout(cfg, sf[:, h].contiguous(), si[:, h].contiguous(),
                            obs[:, h].contiguous(), mats, world_base=32, **kw)
    for i in range(4):
        assert torch.equal(part[i], whole[i][..., h]), i
    with pytest.raises(ValueError, match="world_base"):
        FR.fused_rollout(cfg, sf, si, obs, mats, world_base=-1, **kw)


def test_shard_geometry_is_checked():
    mesh2 = DataMesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    hp = PPOParams(num_envs=32, num_rollout_steps=4)
    with pytest.raises(ValueError, match="warps of 32"):
        shard_worlds(hp, mesh2)
    with pytest.raises(ValueError, match="1024"):
        shard_worlds(PPOParams(num_envs=3072, num_rollout_steps=4), mesh2,
                     rollout_tiled=True)
    assert shard_worlds(PPOParams(num_envs=4096), mesh2,
                        rollout_tiled=True) == 2048
    with pytest.raises(ValueError, match="divide evenly"):
        DataMesh(None, 0, 3, torch.device("cpu")).worlds(64)
    assert mesh2.columns(64) == slice(0, 32)
    assert dataclasses.replace(mesh2, rank=1).columns(64) == slice(32, 64)
    with pytest.raises(ValueError, match="requires a mesh"):
        make_train_iteration(SimConfig(), hp, "cpu", dp_update=True)
