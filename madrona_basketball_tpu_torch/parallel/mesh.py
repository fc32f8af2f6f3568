"""The data axis over processes (port of
`madrona_basketball_tpu/parallel/mesh.py:25-103`).

The JAX package shards the world axis of one SPMD program over a device
mesh.  The port runs one process per GPU: a `DataMesh` names the process
group, this process's rank, the group's size and the rank's device.  Rank
r holds the contiguous worlds [r * W_l, (r + 1) * W_l) of W, W_l = W /
size: its columns of the row state sf, si and obs (and, under
`dp_update`, of the episode-stats carry).  The learner, both normalizers,
the Adam state and the meters stay whole on every rank.  Every rank
builds the same state from the same seed, so no broadcast is needed.

`all_gather` and `all_reduce_` are the two collectives the trainer uses
(ppo/train_fused.py); both go through the group's backend on the
caller's current stream, so a CUDA graph captures them under NCCL.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataMesh:
    group: Optional[object]  # a torch.distributed ProcessGroup (None: the
    #                          default group)
    rank: int
    size: int
    device: torch.device

    def worlds(self, num_envs: int) -> int:
        """W_l: the worlds of one rank."""
        if num_envs % self.size:
            raise ValueError(f"num_envs={num_envs} must divide evenly over "
                             f"{self.size} ranks")
        return num_envs // self.size

    def columns(self, num_envs: int) -> slice:
        """This rank's worlds [rank * W_l, (rank + 1) * W_l)."""
        w = self.worlds(num_envs)
        return slice(self.rank * w, (self.rank + 1) * w)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def make_mesh(device="cuda", group=None) -> DataMesh:
    """The data mesh of an initialized process group (`group`, default the
    world): this process's rank and the group's size.  A CUDA device
    without an index means the process's current GPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/distributed.py::init_distributed)")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return DataMesh(group=group, rank=dist.get_rank(group),
                    size=dist.get_world_size(group), device=dev)


def all_gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """(size, *x.shape): every rank's x, in rank order."""
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; older lacks that name
        warnings.filterwarnings("ignore", ".*all_gather_into_tensor",
                                FutureWarning)
        dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out.view((mesh.size,) + tuple(x.shape))


def all_gather_columns(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's columns (last axis) of x side by side, in world order:
    (..., W_l) -> (..., size * W_l)."""
    g = all_gather(x, mesh)                         # (size, ..., W_l)
    return g.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (-1,))


def all_reduce_(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """x summed over the ranks, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _stats_fields(dp_update: bool):
    return ("curr_rewards", "episode_lengths") if dp_update else ()


def shard_train_state(state, mesh: DataMesh, dp_update: bool = False):
    """The rank's share of a whole RolloutState / TrainState: its columns
    of sf, si and obs (and of the stats carry curr_rewards /
    episode_lengths under dp_update), as fresh contiguous tensors; the
    agents, normalizers, meters and Adam state as they are.  For the
    structured trainer's TrainState (ppo/train.py) the rank's worlds of
    every tensor of its env State (the JAX shard_train_state,
    parallel/mesh.py:49-75: the env sharded, the learner replicated)."""
    if not hasattr(state, "sf"):
        from ..state import tree_map
        cols = mesh.columns(state.env.reset_now.shape[0])
        return dataclasses.replace(state, env=tree_map(
            lambda t: t[cols].contiguous().clone(), state.env))
    cols = mesh.columns(state.sf.shape[1])
    stats = dataclasses.replace(state.stats, **{
        f: getattr(state.stats, f)[cols].clone()
        for f in _stats_fields(dp_update)})
    return dataclasses.replace(
        state, sf=state.sf[:, cols].clone(), si=state.si[:, cols].clone(),
        obs=state.obs[:, cols].clone(), stats=stats)


def gather_train_state(state, mesh: DataMesh, dp_update: bool = False):
    """Inverse of `shard_train_state` (a collective: every rank calls
    it): the whole state, the ranks' columns gathered in world order."""
    stats = dataclasses.replace(state.stats, **{
        f: all_gather_columns(getattr(state.stats, f), mesh)
        for f in _stats_fields(dp_update)})
    return dataclasses.replace(
        state, sf=all_gather_columns(state.sf, mesh),
        si=all_gather_columns(state.si, mesh),
        obs=all_gather_columns(state.obs, mesh), stats=stats)
