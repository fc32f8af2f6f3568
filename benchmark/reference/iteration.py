"""One training iteration of the reference recipe in plain PyTorch.

The composition of the port's flagship iteration
(`madrona_basketball_tpu_torch/ppo/train_fused.py::_collect_body` and
`make_train_iteration`, one device, no data mesh, the untiled fused-GAE
path) over this folder's frozen plain versions: the reset pulse (one
tick with the reset flags set, the trainee's actions zeroed and the
frozen opponent's sampled), the T-tick rollout, the critic's next value,
GAE with the episode-stat carry and the windowed meters, the value /
return / advantage and obs-normalizer merges, then the update phase on
the epochs' block permutations.  Every draw is made here from the
state's (seed, counter), with the generators and formulas the program
documents: the pulse and the permutations from torch.Generators seeded
by `pulse_seed` / `perm_seed`, the rollout from Philox4x32-10 keyed by
the seed.  Nothing of the program is imported.

A state is a dict of tensors (`Snapshot` below): the trainee's and the
frozen agent's module weights (state_dict names) and normalizers, the
rows, the episode stats, Adam's packed moments and step count, the seed
and the iteration counter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from . import constants as C
from . import precision
from .gae import (SIDE_ADV, SIDE_VALUE, combine_block_moments, gae,
                  meter_scan)
from .layout import ACTION_ROWS, RESET_ROWS
from .rollout import (N_LOGITS, OBS, R_ACT, R_DONE, R_REW, R_VALUE, RMS_EPS,
                      ROLL_OBS, combine_obs_moments, gumbel_from_uniform,
                      obs_moment_partials, philox_noise, rollout)
from .sim import draw_noise_rows, step_rows_plain
from .update import D, pick_update_block, update_phase

F32 = torch.float32
I32 = torch.int32
LN_EPS = 1e-6
LINEARS = ("backbone.0", "backbone.3")
NORMS = ("backbone.1", "backbone.4")
STATS = ("curr_rewards", "episode_lengths", "mean_reward", "reward_size",
         "mean_length", "length_size")
METRICS = ("mean_reward", "mean_episode_length", "reward_window",
           "adv_abs_mean", "value_mean")


def pulse_seed(seed: int, counter: int) -> int:
    return (seed * 1_000_003 + counter) % (2 ** 63)


def perm_seed(seed: int, counter: int) -> int:
    return ((seed * 1_000_003 + counter) * 1_000_033 + 7) % (2 ** 63)


# ---- the agent: module weights by state_dict name, normalizers ----

def _linear(x, net, name):
    return Fn.linear(precision.operand(x), precision.operand(
        net[f"{name}.weight"]), net[f"{name}.bias"])


def _backbone(net, rms, obs):
    """The backbone's features of raw (B, 128) obs."""
    mean, var, _ = rms
    h = torch.clamp((obs - mean) * torch.rsqrt(var + RMS_EPS), -5.0, 5.0)
    for lin, ln in zip(LINEARS, NORMS):
        h = _linear(h, net, lin)
        h = Fn.layer_norm(h, (h.shape[-1],), net[f"{ln}.weight"],
                          net[f"{ln}.bias"], LN_EPS)
        h = torch.relu(h)
    return h


def _first_argmax(x):
    m = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == m, idx, x.shape[-1]).min(dim=-1).values


def greedy_actions(logits):
    """(B, 19) -> (B, 6) int32: each bucket's first argmax."""
    out, off = [], 0
    for n in C.ACTION_BUCKETS:
        out.append(_first_argmax(logits[:, off:off + n]))
        off += n
    return torch.stack(out, dim=1).to(I32)


def critic(net, rms, obs):
    return _linear(_backbone(net, rms, obs), net, "critic")[..., 0]


def pack_net(net, d: int | None = None):
    """Module weights -> (w1t, w2t, wht, bias), the kernels' packing; d
    cuts the first layer to its first d columns."""
    head_b = torch.cat([net["actor.bias"], net["critic.bias"]])
    head_b = Fn.pad(head_b, (0, 32 - head_b.shape[0]))
    bias = torch.stack([net["backbone.0.bias"], net["backbone.1.weight"],
                        net["backbone.1.bias"], net["backbone.3.bias"],
                        net["backbone.4.weight"], net["backbone.4.bias"],
                        head_b, torch.zeros_like(head_b)], dim=1)
    w1t = net["backbone.0.weight"]
    w1t = w1t if d is None else w1t[:, :d]
    wht = torch.cat([net["actor.weight"], net["critic.weight"]], dim=0)
    return tuple(x.contiguous().clone()
                 for x in (w1t, net["backbone.3.weight"], wht, bias))


def unpack_net(net, w1t, w2t, wht, bias) -> dict:
    """The module weights with the packed matrices written in; the first
    layer's columns >= d are carried over."""
    out = {k: v.clone() for k, v in net.items()}
    out["backbone.0.weight"][:, :w1t.shape[1]] = w1t
    out["backbone.3.weight"] = w2t.clone()
    out["actor.weight"] = wht[:N_LOGITS].clone()
    out["critic.weight"] = wht[N_LOGITS:N_LOGITS + 1].clone()
    for name, c in (("backbone.0.bias", 0), ("backbone.1.weight", 1),
                    ("backbone.1.bias", 2), ("backbone.3.bias", 3),
                    ("backbone.4.weight", 4), ("backbone.4.bias", 5)):
        out[name] = bias[:, c].clone()
    out["actor.bias"] = bias[:N_LOGITS, 6].clone()
    out["critic.bias"] = bias[N_LOGITS:N_LOGITS + 1, 6].clone()
    return out


def pack_policy(net, rms):
    mean, var, _ = rms
    nrm = torch.stack([mean, torch.rsqrt(var + RMS_EPS)], dim=1)
    return (nrm.contiguous(),) + pack_net(net)


# ---- normalizers: (mean, var, count), Chan merges ----

def rms_merge(st, mean, var, count):
    m0, v0, c0 = st
    count_ = count + c0
    delta = mean - m0
    m = v0 * c0 + var * count + delta ** 2 * c0 * count / count_
    return m0 + delta * count / count_, m / count_, count_


def rms_update_moments(st, mean, m2, n):
    """Merge batch moments of the first mean.shape[0] features; the rest
    are the structural-zero obs tail (a closed-form merge)."""
    m0, v0, c0 = st
    used = mean.shape[0]
    n = torch.as_tensor(n, dtype=F32, device=mean.device)
    var = m2 / torch.clamp(n - 1.0, min=1.0)
    hm, hv, hc = rms_merge((m0[:used], v0[:used], c0), mean, var, n)
    count_ = c0 + n
    pad_mean, pad_var = m0[used:], v0[used:]
    tail_mean = pad_mean * (c0 / count_)
    tail_var = (pad_var * c0 + pad_mean ** 2 * c0 * n / count_) / count_
    return torch.cat([hm, tail_mean]), torch.cat([hv, tail_var]), hc


# ---- the iteration, in its three stages ----

@torch.no_grad()
def collect(cfg, hp, s: dict) -> dict:
    """The reset pulse and the T-tick rollout from state `s`: the rows
    after them and the trajectory (T, 128, W)."""
    dev = s["sf"].device
    T, W = hp.num_rollout_steps, hp.num_envs
    ti, fi = hp.trainee_idx, 1 - hp.trainee_idx
    seed, counter = s["seed"], s["counter"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(pulse_seed(seed, counter))
    sf, si, obs = s["sf"], s["si"].clone(), s["obs"]
    for r in RESET_ROWS:
        si[r] = 1
    for r in ACTION_ROWS[ti]:
        si[r] = 0
    pulse = draw_noise_rows(W, gen, dev)
    if hp.use_frozen:
        f_u = torch.rand((N_LOGITS, W), generator=gen, device=dev)
        h = _backbone(s["frozen_net"], s["frozen_obs_rms"],
                      obs[fi * OBS:(fi + 1) * OBS].T)
        logits = _linear(h, s["frozen_net"], "actor")
        fa = greedy_actions(logits + gumbel_from_uniform(f_u).T)
        for j, r in enumerate(ACTION_ROWS[fi]):
            si[r] = fa[:, j]
    sf, si, obs = step_rows_plain(cfg, sf, si, pulse)
    for r in RESET_ROWS:
        si[r] = 0
    fmats = pack_policy(s["frozen_net"], s["frozen_obs_rms"]) \
        if hp.use_frozen else None
    sf, si, obs, traj, _ = rollout(
        cfg, sf, si, obs, pack_policy(s["net"], s["obs_rms"]), fmats,
        n_steps=T, trainee_idx=ti,
        noise=philox_noise(seed, counter * T, T, W, dev))
    return dict(sf=sf, si=si, obs=obs, traj=traj)


@torch.no_grad()
def advantages(hp, s: dict, traj, obs) -> dict:
    """GAE over a trajectory collected from state `s` whose last obs rows
    are `obs`, the episode stats and meters, the value / return /
    advantage and obs-normalizer merges: side (T, 8, W), ustats (1, 8),
    obs_rms, value_rms, stats and metrics."""
    dev = traj.device
    T, W = hp.num_rollout_steps, hp.num_envs
    ti = hp.trainee_idx
    net, rms = s["net"], s["obs_rms"]
    next_value = critic(net, rms, obs[ti * OBS:(ti + 1) * OBS].T)
    vm0, vv0, _ = s["value_rms"]
    vstats = torch.zeros((1, 8), dtype=F32, device=dev)
    vstats[0, 0] = vm0[0]
    vstats[0, 1] = torch.sqrt(vv0[0] + RMS_EPS)
    st = s["stats"]
    side, moments, carry, ticks = gae(
        traj, torch.stack([st["curr_rewards"], st["episode_lengths"]]),
        next_value[None, :], vstats, gamma=hp.gamma, lam=hp.gae_lambda,
        r_value=R_VALUE, r_rew=R_REW, r_done=R_DONE)
    m = meter_scan(ticks, torch.stack([st["mean_reward"], st["reward_size"],
                                       st["mean_length"],
                                       st["length_size"]]))
    stats = dict(zip(STATS, (carry[0], carry[1], m[0], m[1], m[2], m[3])))
    n_per = float(T * W // moments.shape[0])
    vm_b, vv_b, nN = combine_block_moments(moments[:, 0], moments[:, 1],
                                           n_per)
    am_b, av_b, _ = combine_block_moments(moments[:, 2], moments[:, 3],
                                          n_per)
    rm_b, rv_b, _ = combine_block_moments(moments[:, 4], moments[:, 5],
                                          n_per)
    value_rms = rms_merge(s["value_rms"], vm_b.reshape(1), vv_b.reshape(1),
                          nN)
    value_rms = rms_merge(value_rms, rm_b.reshape(1), rv_b.reshape(1), nN)
    ar = 1.0 / (torch.sqrt(av_b) + 1e-8)
    vr_post = torch.rsqrt(value_rms[1][0] + RMS_EPS)
    ustats = torch.zeros((1, 8), dtype=F32, device=dev)
    ustats[0, 0] = value_rms[0][0]
    ustats[0, 1] = vr_post
    ustats[0, 2] = am_b
    ustats[0, 3] = ar
    # the obs moments: per (tick, 32-world group) partials of the obs rows
    # the policy read, as kernel B folds them
    om = combine_obs_moments(torch.stack(
        [obs_moment_partials(traj[t, 0:ROLL_OBS]) for t in range(T)]))
    obs_rms = rms_update_moments(rms, om[:, 0], om[:, 1], om[0, 2])
    adv_n = (side[:, SIDE_ADV] - am_b) * ar
    values_n = torch.clamp((side[:, SIDE_VALUE] - value_rms[0][0]) * vr_post,
                           -5.0, 5.0)
    metrics = dict(zip(METRICS, (stats["mean_reward"], stats["mean_length"],
                                 stats["reward_size"], adv_n.abs().mean(),
                                 values_n.mean())))
    return dict(side=side, ustats=ustats, obs_rms=obs_rms,
                value_rms=value_rms, stats=stats, metrics=metrics)


@torch.no_grad()
def update(hp, s: dict, traj, side, ustats, obs_rms) -> dict:
    """The update phase from state `s`'s weights and Adam moments on a
    trajectory, its raw side rows, ustats and the merged obs normalizer:
    the module weights, mu, nu after it, and the first minibatch's
    gradient (packed)."""
    dev = traj.device
    T, W = hp.num_rollout_steps, hp.num_envs
    wb = hp.update_block or pick_update_block(W, hp.minibatch_size)
    perm_gen = torch.Generator(device=dev)
    perm_gen.manual_seed(perm_seed(s["seed"], s["counter"]))
    perms = torch.stack([torch.randperm(T * (W // wb), generator=perm_gen,
                                        device=dev)
                         for _ in range(hp.update_epochs)])
    mean, var, _ = obs_rms
    nrm = torch.stack([mean[:D], torch.rsqrt(var[:D] + RMS_EPS)])
    params, mu, nu, grad = update_phase(
        hp, perms.to(I32).reshape(-1), s["count"], traj, side, nrm, ustats,
        pack_net(s["net"], D), s["mu"], s["nu"], wb=wb)
    return dict(net=unpack_net(s["net"], *params), mu=mu, nu=nu, grad=grad)


def iteration(cfg, hp, s: dict) -> tuple:
    """One iteration from state `s` -> (the state after it, the stages'
    outputs: traj, side, ustats, obs_rms, value_rms, stats, metrics and
    the update's first gradient)."""
    c = collect(cfg, hp, s)
    a = advantages(hp, s, c["traj"], c["obs"])
    u = update(hp, s, c["traj"], a["side"], a["ustats"], a["obs_rms"])
    n_updates = hp.update_epochs * hp.num_minibatches
    state = dict(s, net=u["net"], obs_rms=a["obs_rms"],
                 value_rms=a["value_rms"], sf=c["sf"], si=c["si"],
                 obs=c["obs"], stats=a["stats"], mu=u["mu"], nu=u["nu"],
                 count=s["count"] + n_updates, counter=s["counter"] + 1)
    return state, dict(traj=c["traj"], grad=u["grad"], **a)
