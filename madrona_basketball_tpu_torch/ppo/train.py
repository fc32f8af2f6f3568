"""Episode statistics, optimizer and loss of the trainer (port of
`madrona_basketball_tpu.ppo.train`):

  * the reference's PPOStats + AverageMeter(window=100)
    (train.py:51-96, scripts/ppo_stats.py:8-50,153-172), and the fused
    path's windowed-meter scan with its CUDA kernel (csrc/meter_scan.cu);
  * `AdamState` / `init_adam` / `clip_adam_step`: optax's
    clip_by_global_norm + adam(eps=1e-8) (train.py:108-112) on the four
    kernel-orientation matrices of ops/fused_update.py;
  * `loss_fn`: the clipped PPO loss on packed obs (train.py:256-300),
    differentiable by autograd.  The tests hold the hand-derived backward
    of ops/fused_update.py against it; the training path never calls it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .. import constants as C
from ..models.agent import LN_EPS, layers
from ..models.normalize import EPS as RMS_EPS

F32 = torch.float32


@dataclasses.dataclass
class EpisodeStats:
    curr_rewards: torch.Tensor     # (N,)
    episode_lengths: torch.Tensor  # (N,)
    mean_reward: torch.Tensor      # ()
    reward_size: torch.Tensor      # ()
    mean_length: torch.Tensor      # ()
    length_size: torch.Tensor      # ()


def init_stats(num_envs: int, device="cuda") -> EpisodeStats:
    def z():
        return torch.zeros((), dtype=F32, device=device)
    return EpisodeStats(
        curr_rewards=torch.zeros((num_envs,), dtype=F32, device=device),
        episode_lengths=torch.zeros((num_envs,), dtype=F32, device=device),
        mean_reward=z(), reward_size=z(), mean_length=z(), length_size=z())


def _meter_update(mean, cur_size, values_sum, count, max_size=100.0):
    """AverageMeter.update with a masked batch
    (scripts/ppo_stats.py:160-167)."""
    has = count > 0
    new_mean = torch.where(has, values_sum / torch.clamp(count, min=1.0),
                           0.0)
    size = torch.clamp(count, max=max_size)
    old_size = torch.minimum(max_size - size, cur_size)
    total = old_size + size
    merged = torch.where(has, (mean * old_size + new_mean * size) /
                         torch.clamp(total, min=1.0), mean)
    return merged, torch.where(has, total, cur_size)


METERS = 4  # [reward mean, reward window, length mean, length window]


def meter_scan_plain(ticks, meters):
    """Plain version of the meter kernel: `ticks` (nb, T, 8) per-(block,
    tick) sums [done count, sum(curr * done), sum(lens * done), 0...] from
    kernel C, summed over blocks, then T updates of the reward and length
    meters `meters` (4,) -> (4,)."""
    per_t = ticks.sum(dim=0)
    r_mean, r_size, l_mean, l_size = meters.unbind()
    for t in range(per_t.shape[0]):
        r_mean, r_size = _meter_update(r_mean, r_size, per_t[t, 1],
                                       per_t[t, 0])
        l_mean, l_size = _meter_update(l_mean, l_size, per_t[t, 2],
                                       per_t[t, 0])
    return torch.stack([r_mean, r_size, l_mean, l_size])


launches = 0  # meter kernel launches (the wrapper counts, the caller resets)


def meter_scan(ticks, meters):
    """The windowed-meter scan of train_fused.py:602-615 (JAX package):
    csrc/meter_scan.cu on CUDA tensors, `meter_scan_plain` on CPU tensors.
    One block; a thread per tick sums the blocks' partials, then one
    thread runs the T-step recursion, so the scan stays on the device
    (no host copy, no T x 2 x ~12 launches of 0-d tensors)."""
    global launches
    nb, T, cols = ticks.shape
    if cols != 8 or meters.shape != (METERS,) or \
            ticks.dtype != F32 or meters.dtype != F32:
        raise ValueError("ticks must be (nb, T, 8) and meters (4,) float32")
    if ticks.device.type == "cpu":
        return meter_scan_plain(ticks, meters)
    if ticks.device.type != "cuda":
        raise ValueError(f"unsupported device {ticks.device}")
    from .. import _build
    _build.check_device(ticks.device, meters=meters)
    lib = _build.load("meter_scan")
    ticks, meters = ticks.contiguous(), meters.contiguous()
    out = torch.empty((METERS,), dtype=F32, device=ticks.device)
    err = lib.mbb_meter_scan(_build.ptr(ticks), _build.ptr(meters),
                             _build.ptr(out), nb, T,
                             _build.stream(ticks.device))
    _build.check(err, "meter_scan")
    launches += 1
    return out


def _stats_step(st: EpisodeStats, rew, done) -> EpisodeStats:
    curr = st.curr_rewards + rew
    lens = st.episode_lengths + 1.0
    count = done.sum()
    r_mean, r_size = _meter_update(st.mean_reward, st.reward_size,
                                   (curr * done).sum(), count)
    l_mean, l_size = _meter_update(st.mean_length, st.length_size,
                                   (lens * done).sum(), count)
    return EpisodeStats(curr_rewards=curr * (1.0 - done),
                        episode_lengths=lens * (1.0 - done),
                        mean_reward=r_mean, reward_size=r_size,
                        mean_length=l_mean, length_size=l_size)


# ---------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm(c), adam(lr, eps=1e-8))
# ---------------------------------------------------------------------

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    """Adam step count (a host int) and the first / second moments, each
    a tuple of the four kernel-orientation matrices
    (ops/fused_update.SHAPES), float32."""
    count: int
    mu: tuple
    nu: tuple


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(count=0,
                     mu=tuple(torch.zeros_like(p) for p in params),
                     nu=tuple(torch.zeros_like(p) for p in params))


@torch.no_grad()
def clip_adam_step(params, mu, nu, grads, t: int, *, lr: float,
                   max_norm: float):
    """One optimizer step at Adam step t (count after the step), optax's
    formulas exactly:
      u  = g if |g| < c else g / |g| * c     (|g| over all leaves)
      m' = (1 - b1) u + b1 m;   v' = (1 - b2) u^2 + b2 v
      p' = p - lr * (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps).
    Returns (params', mu', nu') as tuples."""
    gn = torch.sqrt(sum((g * g).sum() for g in grads))
    small = gn < max_norm
    tt = torch.tensor(float(t), dtype=F32)
    bc1 = (1.0 - torch.tensor(ADAM_B1, dtype=F32) ** tt).to(gn.device)
    bc2 = (1.0 - torch.tensor(ADAM_B2, dtype=F32) ** tt).to(gn.device)
    out_p, out_m, out_v = [], [], []
    for p, m, v, g in zip(params, mu, nu, grads):
        u = torch.where(small, g, (g / gn) * max_norm)
        m2 = (1.0 - ADAM_B1) * u + ADAM_B1 * m
        v2 = (1.0 - ADAM_B2) * (u * u) + ADAM_B2 * v
        out_p.append(p - lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) +
                                             ADAM_EPS)))
        out_m.append(m2)
        out_v.append(v2)
    return tuple(out_p), tuple(out_m), tuple(out_v)


# ---------------------------------------------------------------------
# The PPO loss (autograd oracle of the hand-derived backward)
# ---------------------------------------------------------------------

def _layer_norm_fast(z, scale, bias):
    """flax LayerNorm over the last axis with its fast variance
    max(E[z^2] - E[z]^2, 0)."""
    mu = z.mean(dim=-1, keepdim=True)
    var = torch.clamp((z * z).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    return (z - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def policy_stats(net, obs_rms, o, a, buckets=C.ACTION_BUCKETS):
    """(summed log-prob, summed entropy, value) of actions `a` (B, K) under
    the policy, on PACKED observations o (B, d): the features >= d are
    structural zeros, so normalizing the first d slots and applying the
    first layer's first d columns equals the full-width forward
    (train.py:256-280)."""
    d = o.shape[-1]
    x = torch.clamp((o - obs_rms.mean[:d]) *
                    torch.rsqrt(obs_rms.var[:d] + RMS_EPS), -5.0, 5.0)
    lin, ln = layers(net)
    h = x
    for k, (li, nm) in enumerate(zip(lin, ln)):
        w = li.weight[:, :d] if k == 0 else li.weight
        h = torch.relu(_layer_norm_fast(h @ w.T + li.bias, nm.weight,
                                        nm.bias))
    logits = net.actor(h)
    value = net.critic(h)[..., 0]
    lps, ents, off = [], [], 0
    for i, n in enumerate(buckets):
        logp = torch.log_softmax(logits[:, off:off + n], dim=-1)
        lps.append(torch.gather(logp, -1, a[:, i:i + 1].long())[:, 0])
        ents.append(-(logp.exp() * logp).sum(dim=-1))
        off += n
    return sum(lps), sum(ents), value


def loss_fn(hp, net, obs_rms, o, a, lp, v, adv, ret):
    """Clipped PPO surrogate + clipped value loss + entropy
    (train.py:282-300, scripts/ppo.py:192-210); returns the scalar loss."""
    lp_, ent, v_ = policy_stats(net, obs_rms, o, a)
    ratio = torch.exp(lp_ - lp)
    surr1 = -adv * ratio
    surr2 = -adv * torch.clamp(ratio, 1 - hp.clip_coef, 1 + hp.clip_coef)
    pg_loss = torch.maximum(surr1, surr2).mean()
    vf_loss = (v_ - ret) ** 2
    v_clip = v + torch.clamp(v_ - v, -hp.clip_coef, hp.clip_coef)
    if hp.clip_vloss:
        c_loss = 0.5 * torch.maximum(vf_loss, (v_clip - ret) ** 2).mean()
    else:
        c_loss = 0.5 * vf_loss.mean()
    return pg_loss + c_loss * hp.vf_coef - ent.mean() * hp.ent_coef
