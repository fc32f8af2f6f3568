"""Agent checkpoints (port of
`madrona_basketball_tpu/utils/checkpoint.py:25-84` and
`utils/torch_compat.py`).

Agent files, by suffix:
  * `.pth` / `.pt`: `torch.save` of the reference `Agent.state_dict()`
    (scripts/ppo.py:337-350): the `ActorCritic` keys as they are
    (`backbone.{3k}` Linear, `backbone.{3k+1}` LayerNorm, `actor`,
    `critic`) plus both normalizers as float64 buffers
    `obs_norm.{mean,var,count}` and `value_norm.{mean,var,count}`.  The
    JAX package's `load_agent` reads these files, and its
    `torch_state_dict_from_agent_params` writes them.  `checkpoint_path`
    names this layout.
  * `.ckpt`: the JAX package's own agent file, `flax.serialization.
    to_bytes(AgentParams)`, written and read with the package's msgpack
    codec (utils/flax_msgpack.py) and mapped by utils/jax_params.py.
Both go through the same architecture check and obs-tail repair.

The counterpart of the JAX module's train-state resume (`:87-97`),
`save_train_state` / `restore_train_state`, lives beside `TrainState` in
ppo/train_fused.py.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .. import constants as C
from ..models.agent import ActorCritic, Agent
from ..models.normalize import RMSState, rms_init
from . import flax_msgpack
from .jax_params import agent_from_numpy, agent_to_numpy

F32 = torch.float32
F64 = torch.float64
_NORMS = (("obs_norm", "obs_rms"), ("value_norm", "value_rms"))
AGENT_SUFFIXES = (".pth", ".pt", ".ckpt")


def state_dict(agent: Agent) -> dict:
    """The reference-layout state_dict of an Agent, CPU tensors."""
    sd = {k: v.detach().to("cpu", copy=True)
          for k, v in agent.net.state_dict().items()}
    for prefix, attr in _NORMS:
        rms = getattr(agent, attr)
        for f in ("mean", "var", "count"):
            sd[f"{prefix}.{f}"] = getattr(rms, f).detach().to("cpu", F64)
    return sd


def _is_ckpt(path: str) -> bool:
    if not path.endswith(AGENT_SUFFIXES):
        raise ValueError(f"{path}: an agent file ends in one of "
                         f"{AGENT_SUFFIXES}")
    return path.endswith(".ckpt")


def save_agent(agent: Agent, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if _is_ckpt(path):
        with open(path, "wb") as f:
            f.write(flax_msgpack.packb(agent_to_numpy(agent)))
    else:
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


def _shapes(tree) -> dict:
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def _load_ckpt(path: str, device) -> Agent:
    with open(path, "rb") as f:
        tree = flax_msgpack.unpackb(f.read())
    want = _shapes(agent_to_numpy(Agent(
        net=ActorCritic(), obs_rms=rms_init(C.OBS_SIZE, "cpu"),
        value_rms=rms_init(1, "cpu"))))
    got = _shapes(tree)
    if got != want:
        raise ValueError(f"{path}: architecture does not match the port's "
                         f"ActorCritic: found {got}, expected {want}")
    return agent_from_numpy(tree, device)


def load_agent(path: str, device="cuda") -> Agent:
    """Inverse of `save_agent` (the format by the suffix); raises if the
    file's architecture is not the port's ActorCritic."""
    if _is_ckpt(path):
        agent = _load_ckpt(path, device)
        agent.obs_rms.mean = _zero_obs_tail(agent.obs_rms.mean, path)
        return agent
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
