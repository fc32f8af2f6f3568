"""The eval policies' forward and Gumbel-max sampling: plain torch + CUDA
kernel J (csrc/eval_policy.cu).

Kernel J computes what `models.agent.act` computes, for one agent or
for both agents of a tick in one launch: obs normalization (clamp +-5),
2 x (Linear 32 -> LayerNorm -> ReLU), the 19-logit actor head, then
each bucket's first maximum of the logits plus this tick's Gumbel noise
(made from uniforms, or given as Gumbel values; none for the argmax),
written as int32 actions into a (B, 6) tensor or view (the eval chunk's
action rows).  It reads the weights from the agent's live tensors, so a
CUDA-graph replay uses them as they stand.  No JAX counterpart: the JAX
package's eval policy is XLA-fused (madrona_basketball_tpu/infer.py:31-46).

`eval_policy` launches J on CUDA tensors and refuses any other device
(`infer.run_policies` is the one place that chooses: `act` on the CPU,
any agent there); J takes only the 128 -> 2 x 32 -> 19 agent, which
`check_agent` tests.  The plain version, `policy_plain`, is the tests'
reference: J's arithmetic in float32, feature-major, each Dense sum over
k in ascending order, then the bias; LayerNorm in torch's two-pass form
(the mean, then the mean of squared deviations).  It agrees with `act`
to float32 rounding, and with J to rounding too: on the card the
kernel's multiply-adds are fused.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from .. import _build
from .. import constants as C
from ..models.action import best
from ..models.agent import Agent, layers
from .fused_rollout import (H, LN_EPS, N_LOGITS, OBS, RMS_EPS, _matvec,
                            _seq_sum, gumbel_from_uniform)

F32 = torch.float32
I32 = torch.int32
N_ACT = len(C.ACTION_BUCKETS)  # 6
# the kernel's noise kinds (csrc/eval_policy.cu)
NOISE_NONE, NOISE_UNIFORM, NOISE_GUMBEL = 0, 1, 2
# an agent's weights in the kernel's order, with their shapes
WEIGHT_SHAPES = ((OBS,), (OBS,), (H, OBS), (H,), (H,), (H,), (H, H), (H,),
                 (H,), (H,), (N_LOGITS, H), (N_LOGITS,))

launches = 0  # kernel J launches (the wrapper counts, the caller resets)


class PolicyJob(NamedTuple):
    """One agent's share of a launch: its weights, its (B, 128) obs, this
    tick's noise ((B, 19) uniforms in [0, 1), or Gumbel values with
    `gumbel`; None for the argmax) and the (B, 6) int32 actions it
    writes (a tensor or a view)."""
    agent: Agent
    obs: torch.Tensor
    noise: Optional[torch.Tensor]
    gumbel: bool
    act: torch.Tensor

    @property
    def noise_kind(self) -> int:
        if self.noise is None:
            return NOISE_NONE
        return NOISE_GUMBEL if self.gumbel else NOISE_UNIFORM


def weights(ap: Agent) -> list:
    """The agent's live weight tensors in the kernel's order: the obs
    normalizer's mean and var, each backbone layer's Linear weight and
    bias and LayerNorm scale and bias, the actor head's weight and bias."""
    lin, ln = layers(ap.net)
    out = [ap.obs_rms.mean, ap.obs_rms.var]
    for li, nm in zip(lin, ln):
        out += [li.weight, li.bias, nm.weight, nm.bias]
    return out + [ap.net.actor.weight, ap.net.actor.bias]


# ---------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------

@torch.no_grad()
def policy_logits_plain(ap: Agent, obs: torch.Tensor) -> torch.Tensor:
    """(B, 128) raw obs -> (B, 19) logits, in kernel J's arithmetic."""
    mean, var = ap.obs_rms.mean, ap.obs_rms.var
    r = 1.0 / torch.sqrt(var + RMS_EPS)
    x = torch.clamp((obs.T - mean[:, None]) * r[:, None], -5.0, 5.0)
    for li, nm in zip(*layers(ap.net)):
        z = _matvec(li.weight, x) + li.bias[:, None]
        d = z - _seq_sum(z) / H
        rs = 1.0 / torch.sqrt(_seq_sum(d * d) / H + LN_EPS)
        x = torch.clamp(d * rs * nm.weight[:, None] + nm.bias[:, None],
                        min=0.0)
    head = ap.net.actor
    return (_matvec(head.weight, x) + head.bias[:, None]).T


@torch.no_grad()
def policy_plain(ap: Agent, obs: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 gumbel: bool = False) -> torch.Tensor:
    """(B, 6) int32 actions: each bucket's first maximum of the logits
    plus the Gumbel noise of `noise` (uniforms, or Gumbel values with
    `gumbel`), or of the logits alone without noise."""
    logits = policy_logits_plain(ap, obs)
    if noise is not None:
        logits = logits + (noise if gumbel else gumbel_from_uniform(noise))
    return best(logits)


# ---------------------------------------------------------------------
# Kernel J: the CUDA launch
# ---------------------------------------------------------------------

def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {shape} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the obs on {device}")


def check_agent(ap: Agent, name: str = "agent", device=None) -> None:
    """Refuse an agent kernel J cannot run: J takes the 128 -> 2 x 32 ->
    19 agent in float32, its weights contiguous and on `device` (by
    default the device of its first weight)."""
    ws = weights(ap)
    if len(ws) != len(WEIGHT_SHAPES):
        raise ValueError(f"{name}: the kernel takes 2 hidden layers, "
                         f"not {(len(ws) - 4) // 4}")
    device = ws[0].device if device is None else device
    for k, (t, shape) in enumerate(zip(ws, WEIGHT_SHAPES)):
        _check(f"{name} weight {k}", t, shape, F32, device)
        if not t.is_contiguous():
            raise ValueError(f"{name} weight {k} must be contiguous")


def _check_job(i: int, job: PolicyJob, B: int, device):
    _check(f"jobs[{i}].obs", job.obs, (B, OBS), F32, device)
    _check(f"jobs[{i}].act", job.act, (B, N_ACT), I32, device)
    if job.noise is not None:
        _check(f"jobs[{i}].noise", job.noise, (B, N_LOGITS), F32, device)
    check_agent(job.agent, f"jobs[{i}]", device)


def eval_policy(jobs: Sequence[PolicyJob]) -> None:
    """Each job's actions written into its `act`: kernel J, one launch
    for one or two jobs, on CUDA tensors.  The jobs share the world
    count, the device, the obs strides and the act strides (the kernel
    takes any strides)."""
    global launches
    if not 1 <= len(jobs) <= 2:
        raise ValueError(f"one launch takes 1 or 2 jobs, got {len(jobs)}")
    obs, act = jobs[0].obs, jobs[0].act
    B, dev = obs.shape[0], obs.device
    if B < 1:
        raise ValueError("no worlds")
    for i, job in enumerate(jobs):
        _check_job(i, job, B, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(j.obs.stride() != obs.stride() or j.act.stride() != act.stride()
           for j in jobs):
        raise ValueError("the jobs' obs, and their actions, must share "
                         "strides")
    if max(*obs.stride(), *act.stride()) >= 2 ** 31:
        raise ValueError("strides must fit in int32")
    lib = _build.load("eval_policy")
    noises = [None if j.noise is None else j.noise.contiguous()
              for j in jobs]
    # kept alive through the call: the kernel reads their pointers
    tensors = [t for j, nz in zip(jobs, noises)
               for t in (*weights(j.agent), j.obs, nz, j.act)]
    ptrs = (ctypes.c_void_p * len(tensors))(*map(_build.ptr, tensors))
    kinds = (ctypes.c_int * len(jobs))(*(j.noise_kind for j in jobs))
    err = lib.mbb_eval_policy(ptrs, kinds, len(jobs), B, obs.stride(0),
                              obs.stride(1), act.stride(0), act.stride(1),
                              _build.stream(dev))
    _build.check(err, "eval_policy")
    launches += 1
