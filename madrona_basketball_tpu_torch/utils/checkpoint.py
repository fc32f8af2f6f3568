"""Agent checkpoints in the reference `.pth` layout (port of the `.pth`
half of `madrona_basketball_tpu/utils/checkpoint.py:25-82` and
`utils/torch_compat.py`).

A checkpoint is `torch.save` of the reference `Agent.state_dict()`
(scripts/ppo.py:337-350): the `ActorCritic` keys as they are
(`backbone.{3k}` Linear, `backbone.{3k+1}` LayerNorm, `actor`, `critic`)
plus both normalizers as float64 buffers `obs_norm.{mean,var,count}` and
`value_norm.{mean,var,count}`.  The JAX package's `load_agent` reads these
files, and its `torch_state_dict_from_agent_params` writes them.
"""

from __future__ import annotations

import os
import warnings

import torch

from .. import constants as C
from ..models.agent import ActorCritic, Agent
from ..models.normalize import RMSState

F32 = torch.float32
F64 = torch.float64
_NORMS = (("obs_norm", "obs_rms"), ("value_norm", "value_rms"))


def state_dict(agent: Agent) -> dict:
    """The reference-layout state_dict of an Agent, CPU tensors."""
    sd = {k: v.detach().to("cpu", copy=True)
          for k, v in agent.net.state_dict().items()}
    for prefix, attr in _NORMS:
        rms = getattr(agent, attr)
        for f in ("mean", "var", "count"):
            sd[f"{prefix}.{f}"] = getattr(rms, f).detach().to("cpu", F64)
    return sd


def save_agent(agent: Agent, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(state_dict(agent), path)
    return path


def _zero_obs_tail(mean: torch.Tensor, path: str) -> torch.Tensor:
    """The packed-obs update is exact only when the obs normalizer's tail
    mean (slots >= OBS_USED, structural zeros of the environment) is
    zero; a foreign checkpoint that breaks this is zeroed with a warning,
    as the JAX loader's `_check_obs_tail` does."""
    tail = mean[C.OBS_USED:]
    if tail.numel() and bool((tail != 0).any()):
        warnings.warn(
            f"{path}: obs_rms.mean[{C.OBS_USED}:] is nonzero (max |x| = "
            f"{float(tail.abs().max())}); these observation slots are "
            "structurally zero in this environment.  Zeroing the tail mean "
            "so the packed-obs update path stays exact.", stacklevel=3)
        mean = mean.clone()
        mean[C.OBS_USED:] = 0.0
    return mean


def load_agent(path: str, device="cuda") -> Agent:
    """Inverse of `save_agent`; raises if the file's architecture is not
    the port's ActorCritic."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = ActorCritic()
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items() if k in want}
    if got != want:
        raise ValueError(f"{path}: architecture does not match the port's "
                         f"ActorCritic: found {got}, expected {want}")
    net.load_state_dict({k: sd[k].to(F32) for k in want})

    def rms(prefix):
        mean, var, count = (sd[f"{prefix}.{f}"].to(F32)
                            for f in ("mean", "var", "count"))
        if prefix == "obs_norm":
            mean = _zero_obs_tail(mean, path)
        return RMSState(mean=mean.to(device), var=var.to(device),
                        count=count.reshape(()).to(device))

    return Agent(net=net.to(device), obs_rms=rms("obs_norm"),
                 value_rms=rms("value_norm"))


def checkpoint_path(model_name: str, iteration: int) -> str:
    return os.path.join("checkpoints", model_name,
                        f"{model_name}_{iteration}.pth")
