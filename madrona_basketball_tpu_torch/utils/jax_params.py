"""Move JAX-package parameters, optimizer state and row state into the
port.

`agent_from_numpy(tree)` takes a JAX `AgentParams` converted with
`jax.tree.map(np.asarray, ap)` (so it needs no JAX import here), or its
flax state dict (nested dicts, as a `.ckpt` file holds it), and returns
the port's `Agent`; `agent_to_numpy(agent)` is its inverse, the state
dict in flax's key order.  Flax Dense kernels are (in, out); torch
Linear weights are (out, in), so kernels are transposed.
`adam_from_numpy(opt_state)` does the same for the trainer's optax chain
state.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..models.agent import ActorCritic, Agent, layers
from ..models.normalize import RMSState
from ..ops.fused_update import pack_weights
from ..ppo.train import AdamState

F32 = torch.float32


def _t(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _field(tree, name):
    """`tree.name`, or `tree[name]` for a state dict."""
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _rms_from(st, device) -> RMSState:
    return RMSState(mean=_t(_field(st, "mean"), device),
                    var=_t(_field(st, "var"), device),
                    count=_t(_field(st, "count"), device).reshape(()))


@torch.no_grad()
def _net_from_numpy(pp, device) -> ActorCritic:
    """A flax param dict (numpy leaves: Dense_k, LayerNorm_k, the two
    heads) -> an ActorCritic holding the same values."""
    n_layers = sum(1 for k in pp if k.startswith("LayerNorm_"))
    obs_dim = np.asarray(pp["Dense_0"]["kernel"]).shape[0]
    net = ActorCritic(obs_dim=obs_dim, num_layers=n_layers)
    for k, (lin, ln) in enumerate(zip(*layers(net))):
        lin.weight.copy_(_t(pp[f"Dense_{k}"]["kernel"], "cpu").T)
        lin.bias.copy_(_t(pp[f"Dense_{k}"]["bias"], "cpu"))
        ln.weight.copy_(_t(pp[f"LayerNorm_{k}"]["scale"], "cpu"))
        ln.bias.copy_(_t(pp[f"LayerNorm_{k}"]["bias"], "cpu"))
    for head, k in ((net.actor, n_layers), (net.critic, n_layers + 1)):
        head.weight.copy_(_t(pp[f"Dense_{k}"]["kernel"], "cpu").T)
        head.bias.copy_(_t(pp[f"Dense_{k}"]["bias"], "cpu"))
    return net.to(device)


def agent_from_numpy(tree, device="cuda") -> Agent:
    """JAX AgentParams or its state dict (numpy leaves) -> Agent."""
    return Agent(net=_net_from_numpy(_field(tree, "params")["params"],
                                     device),
                 obs_rms=_rms_from(_field(tree, "obs_rms"), device),
                 value_rms=_rms_from(_field(tree, "value_rms"), device))


def _np(x) -> np.ndarray:
    return x.detach().to("cpu", F32).numpy().copy()


def agent_to_numpy(agent: Agent) -> dict:
    """Agent -> the flax state dict of the JAX `AgentParams` holding the
    same values (float32 numpy leaves), its keys in the order the JAX
    package's `save_agent` writes them (the param dicts sorted, as
    `jax.device_get` leaves them)."""
    lin, ln = layers(agent.net)
    heads = [(agent.net.actor, None), (agent.net.critic, None)]
    pp = {}
    for k, (li, nm) in enumerate(list(zip(lin, ln)) + heads):
        pp[f"Dense_{k}"] = {"bias": _np(li.bias),
                            "kernel": _np(li.weight).T.copy()}
        if nm is not None:
            pp[f"LayerNorm_{k}"] = {"bias": _np(nm.bias),
                                    "scale": _np(nm.weight)}
    pp = dict(sorted(pp.items()))

    def rms(r):
        return {"mean": _np(r.mean), "var": _np(r.var),
                "count": _np(r.count).reshape(())}
    return {"params": {"params": pp}, "obs_rms": rms(agent.obs_rms),
            "value_rms": rms(agent.value_rms)}


def adam_from_numpy(opt_state, device="cuda") -> AdamState:
    """The JAX trainer's optax chain state, converted with
    `jax.tree.map(np.asarray, opt_state)`, i.e.
    `(clip_state, (ScaleByAdamState(count, mu, nu), scale_state))` ->
    the port's `AdamState`: each moment tree has the params' structure,
    so it packs as a network does (ops/fused_update.py::pack_weights,
    which drops the obs-tail rows of Dense_0: their gradient is
    structurally zero, so their moments never leave zero)."""
    adam = opt_state[1][0]
    return AdamState(
        count=int(np.asarray(adam.count)),
        mu=pack_weights(_net_from_numpy(adam.mu["params"], device)),
        nu=pack_weights(_net_from_numpy(adam.nu["params"], device)))


def rows_from_numpy(*arrays, device="cuda"):
    """numpy arrays (sf, si, obs, stats leaves, ...) -> torch tensors of
    the same dtype on `device`."""
    out = tuple(torch.tensor(np.array(a), device=device)
                for a in arrays)
    return out if len(out) > 1 else out[0]
