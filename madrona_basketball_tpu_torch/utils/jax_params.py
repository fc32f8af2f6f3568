"""Move JAX-package parameters and row state into the port.

`agent_from_numpy(tree)` takes a JAX `AgentParams` converted with
`jax.tree.map(np.asarray, ap)` (so it needs no JAX import here) and
returns the port's `Agent`.  Flax Dense kernels are (in, out); torch
Linear weights are (out, in), so kernels are transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.agent import ActorCritic, Agent
from ..models.normalize import RMSState

F32 = torch.float32


def _t(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _rms_from(st, device) -> RMSState:
    return RMSState(mean=_t(st.mean, device), var=_t(st.var, device),
                    count=_t(st.count, device).reshape(()))


@torch.no_grad()
def agent_from_numpy(tree, device="cuda") -> Agent:
    """JAX AgentParams (numpy leaves) -> Agent."""
    pp = tree.params["params"]
    n_layers = sum(1 for k in pp if k.startswith("LayerNorm_"))
    obs_dim = np.asarray(pp["Dense_0"]["kernel"]).shape[0]
    net = ActorCritic(obs_dim=obs_dim, num_layers=n_layers)
    linears = [m for m in net.backbone if isinstance(m, torch.nn.Linear)]
    norms = [m for m in net.backbone if isinstance(m, torch.nn.LayerNorm)]
    for k, (lin, ln) in enumerate(zip(linears, norms)):
        lin.weight.copy_(_t(pp[f"Dense_{k}"]["kernel"], "cpu").T)
        lin.bias.copy_(_t(pp[f"Dense_{k}"]["bias"], "cpu"))
        ln.weight.copy_(_t(pp[f"LayerNorm_{k}"]["scale"], "cpu"))
        ln.bias.copy_(_t(pp[f"LayerNorm_{k}"]["bias"], "cpu"))
    for head, k in ((net.actor, n_layers), (net.critic, n_layers + 1)):
        head.weight.copy_(_t(pp[f"Dense_{k}"]["kernel"], "cpu").T)
        head.bias.copy_(_t(pp[f"Dense_{k}"]["bias"], "cpu"))
    return Agent(net=net.to(device), obs_rms=_rms_from(tree.obs_rms, device),
                 value_rms=_rms_from(tree.value_rms, device))


def rows_from_numpy(*arrays, device="cuda"):
    """numpy arrays (sf, si, obs, stats leaves, ...) -> torch tensors of
    the same dtype on `device`."""
    out = tuple(torch.tensor(np.array(a), device=device)
                for a in arrays)
    return out if len(out) > 1 else out[0]
