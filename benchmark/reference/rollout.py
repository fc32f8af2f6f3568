"""The plain rollout of the reference: T ticks of policy, Gumbel-max
sampling, the sim tick and the trajectory rows, on Philox4x32-10 noise.

A frozen copy of the port's plain version
(`madrona_basketball_tpu_torch/ops/fused_rollout.py`: `policy_forward_rows`,
`sample_rows`, the Philox twin of kernel B's in-kernel generator, the
obs-moment partials and `_rollout_plain` without the probes and the bf16
branches).  The Dense products take their operands through
`precision.operand`, so the control can run them in TF32.
"""

from __future__ import annotations

import torch

from . import constants as C
from . import precision
from .layout import ACTION_ROWS, F_IDX, N_NOISE_ROWS, N_OBS_ROWS
from .sim import check_rows, step_rows_plain

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
A = C.NUM_AGENTS
N_LOGITS = sum(C.ACTION_BUCKETS)  # 19
OBS = C.OBS_SIZE                  # 128
H = 32                            # hidden width

# trajectory rows per (tick, world): 103 packed obs, 6 actions, logp,
# two zero pad rows, value, reward, done, zero pad to 128
ROLL_OBS = C.OBS_USED      # 103
R_ACT = ROLL_OBS           # 103
R_LOGP = R_ACT + 6         # 109
R_VALUE = -(-(R_LOGP + 1) // 8) * 8  # 112
R_REW = R_VALUE + 1        # 113
R_DONE = R_REW + 1         # 114
ROLL_ROWS = 128

# external-noise chunk per tick: rows 0..8 sim noise, 16..34 trainee
# uniforms, 35..53 frozen uniforms, padded to 56
EXT_TRAINEE_U = 16
EXT_FROZEN_U = EXT_TRAINEE_U + N_LOGITS
EXT_NOISE_CHUNK = ((EXT_FROZEN_U + N_LOGITS + 7) // 8) * 8  # 56

RMS_EPS = 1e-5
LN_EPS = 1e-6
MOM_GROUP = 32                         # worlds per obs-moment partial
N_DRAWS = N_NOISE_ROWS + 2 * N_LOGITS  # 47 uniforms per (world, tick)
N_DRAW_GROUPS = -(-N_DRAWS // 4)       # 12 Philox calls per (world, tick)


def _matvec(wt, x):
    """(M, K) @ (K, B) summed over k in ascending order, one multiply and
    one add per term (kernel B's per-thread order)."""
    wt, x = precision.operand(wt), precision.operand(x)
    acc = torch.zeros((wt.shape[0], x.shape[1]), dtype=F32, device=x.device)
    for k in range(wt.shape[1]):
        acc = acc + wt[:, k:k + 1] * x[k:k + 1]
    return acc


def _seq_sum(x):
    s = torch.zeros_like(x[0:1])
    for j in range(x.shape[0]):
        s = s + x[j:j + 1]
    return s


def _layer_norm(x, scale, b):
    """Feature axis 0; flax fast-variance form, eps 1e-6."""
    mu = _seq_sum(x) / x.shape[0]
    mu2 = _seq_sum(x * x) / x.shape[0]
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + b


def policy_forward_rows(obs_block, nrm, w1t, w2t, wht, bias):
    """(OBS, B) raw obs -> (logits (N_LOGITS, B), value (B,))."""
    x = torch.clamp((obs_block - nrm[:, 0:1]) * nrm[:, 1:2], -5.0, 5.0)
    h = _matvec(w1t, x) + bias[:, 0:1]
    h = torch.clamp(_layer_norm(h, bias[:, 1:2], bias[:, 2:3]), min=0.0)
    h = _matvec(w2t, h) + bias[:, 3:4]
    h = torch.clamp(_layer_norm(h, bias[:, 4:5], bias[:, 5:6]), min=0.0)
    out = _matvec(wht, h) + bias[0:N_LOGITS + 1, 6:7]
    return out[0:N_LOGITS], out[N_LOGITS]


def gumbel_from_uniform(u):
    return -torch.log(-torch.log(torch.clamp(u, min=1e-20)))


def sample_rows(logits, gumbel):
    """Gumbel-max per bucket over (N_LOGITS, B) rows -> (6 actions (B,)
    i32, summed log-prob (B,)); strict `>` keeps the first maximum."""
    noisy = logits + gumbel
    actions = []
    total_logp = None
    off = 0
    for n in C.ACTION_BUCKETS:
        best_noisy = noisy[off]
        sel_logit = logits[off]
        best_idx = torch.zeros_like(logits[off], dtype=I32)
        m = logits[off]
        for r in range(1, n):
            better = noisy[off + r] > best_noisy
            best_noisy = torch.where(better, noisy[off + r], best_noisy)
            best_idx = torch.where(better, r, best_idx)
            sel_logit = torch.where(better, logits[off + r], sel_logit)
            m = torch.maximum(m, logits[off + r])
        sumexp = torch.zeros_like(m)
        for r in range(n):
            sumexp = sumexp + torch.exp(logits[off + r] - m)
        lp = sel_logit - m - torch.log(sumexp)
        total_logp = lp if total_logp is None else total_logp + lp
        actions.append(best_idx.to(I32))
        off += n
    return actions, total_logp


# ---- Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of uint32 ----

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, b: torch.Tensor):
    p1 = m * (b & 0xFFFF)
    p2 = m * (b >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return ((p2 >> 16) + (s >> 32)) & MASK32, s & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    b = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return b.view(F32) - 1.0


def philox_uniforms(seed: int, tick: int, num_worlds: int, device):
    """(N_DRAWS, W) uniforms of one tick: counter (world, tick, group, 0),
    key (seed lo, seed hi); draw n is word n % 4 of group n // 4."""
    wv = torch.arange(num_worlds, dtype=I64, device=device)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    words = []
    for g in range(N_DRAW_GROUPS):
        words.extend(philox4x32(wv, torch.full_like(wv, tick & MASK32),
                                torch.full_like(wv, g), torch.zeros_like(wv),
                                k0, k1))
    return bits_to_unit(torch.stack(words[:N_DRAWS]))


def philox_sim_noise(seed: int, tick_base: int, n_steps: int,
                     worlds: torch.Tensor) -> torch.Tensor:
    """The sim's first N_NOISE_ROWS draws of ticks tick_base ..
    tick_base + n_steps - 1 for the given worlds only, as (n_steps,
    N_NOISE_ROWS, S): rows 0-7 = 2u - 1, row 8 = u.  The same counters as
    `philox_uniforms`, so a world's draws do not depend on which others
    are drawn."""
    n_groups = -(-N_NOISE_ROWS // 4)
    wv = worlds.to(I64)[None, :].expand(n_steps, -1)
    tv = (torch.arange(n_steps, dtype=I64, device=worlds.device)[:, None] +
          tick_base) & MASK32
    tv = tv.expand_as(wv)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    words = []
    for g in range(n_groups):
        words.extend(philox4x32(wv, tv, torch.full_like(wv, g),
                                torch.zeros_like(wv), k0, k1))
    u = bits_to_unit(torch.stack(words[:N_NOISE_ROWS], dim=1))
    return torch.cat([2.0 * u[:, :N_NOISE_ROWS - 1] - 1.0,
                      u[:, N_NOISE_ROWS - 1:]], dim=1)


def philox_noise(seed: int, tick_base: int, n_steps: int, num_worlds: int,
                 device) -> torch.Tensor:
    """The rollout's draws as a (T * EXT_NOISE_CHUNK, W) matrix: sim rows
    0-7 = 2u - 1, row 8 = u, then both policies' uniforms."""
    out = torch.zeros((n_steps, EXT_NOISE_CHUNK, num_worlds), dtype=F32,
                      device=device)
    for t in range(n_steps):
        u = philox_uniforms(seed, tick_base + t, num_worlds, device)
        out[t, 0:N_NOISE_ROWS - 1] = 2.0 * u[:N_NOISE_ROWS - 1] - 1.0
        out[t, N_NOISE_ROWS - 1] = u[N_NOISE_ROWS - 1]
        out[t, EXT_TRAINEE_U:EXT_TRAINEE_U + N_LOGITS] = \
            u[N_NOISE_ROWS:N_NOISE_ROWS + N_LOGITS]
        out[t, EXT_FROZEN_U:EXT_FROZEN_U + N_LOGITS] = \
            u[N_NOISE_ROWS + N_LOGITS:N_DRAWS]
    return out.reshape(n_steps * EXT_NOISE_CHUNK, num_worlds)


# ---- obs moments: per (tick, 32-world group) (mean, M2), Chan-merged ----

def obs_moment_partials(obs_used: torch.Tensor) -> torch.Tensor:
    F, W = obs_used.shape
    x = obs_used.reshape(F, W // MOM_GROUP, MOM_GROUP)
    m = x.sum(dim=2) * (1.0 / MOM_GROUP)
    m2 = ((x - m[:, :, None]) ** 2).sum(dim=2)
    return torch.stack([m, m2], dim=2).transpose(0, 1)


def combine_obs_moments(partials: torch.Tensor) -> torch.Tensor:
    """(T, G, ROLL_OBS, 2) partials -> (ROLL_OBS, 8) [mean, M2, n, 0...]."""
    T, G, F, _ = partials.shape
    means = partials[..., 0].reshape(T * G, F)
    m2s = partials[..., 1].reshape(T * G, F)
    gmean = means.mean(dim=0)
    m2 = m2s.sum(dim=0) + MOM_GROUP * ((means - gmean) ** 2).sum(dim=0)
    out = torch.zeros((F, 8), dtype=F32, device=partials.device)
    out[:, 0] = gmean
    out[:, 1] = m2
    out[:, 2] = float(T * G * MOM_GROUP)
    return out


@torch.no_grad()
def rollout(cfg, sf, si, obs0, mats, frozen_mats, *, n_steps: int,
            trainee_idx: int, noise: torch.Tensor):
    """(sf', si', obs', traj (T, 128, W), obs_moments (103, 8)) of T ticks
    on the external noise; frozen_mats None runs no opponent policy."""
    W = check_rows(sf, si)
    if obs0.shape != (N_OBS_ROWS, W) or W % MOM_GROUP:
        raise ValueError(f"obs0 must be ({N_OBS_ROWS}, {W}), W a multiple "
                         f"of {MOM_GROUP}")
    ti_lo = trainee_idx * OBS
    fi_lo = (1 - trainee_idx) * OBS
    rew_row = F_IDX[f"a{trainee_idx}.reward"]
    done_row = F_IDX[f"a{trainee_idx}.done"]
    traj = torch.zeros((n_steps, ROLL_ROWS, W), dtype=F32, device=sf.device)
    parts = []
    obs = obs0
    si = si.clone()
    for t in range(n_steps):
        chunk = noise[t * EXT_NOISE_CHUNK:(t + 1) * EXT_NOISE_CHUNK]
        obs_t = obs[ti_lo:ti_lo + OBS]
        logits, value = policy_forward_rows(obs_t, *mats)
        actions, logp = sample_rows(logits, gumbel_from_uniform(
            chunk[EXT_TRAINEE_U:EXT_TRAINEE_U + N_LOGITS]))
        for j in range(6):
            si[ACTION_ROWS[trainee_idx][j]] = actions[j]
        if frozen_mats is not None:
            f_logits, _ = policy_forward_rows(obs[fi_lo:fi_lo + OBS],
                                              *frozen_mats)
            f_actions, _ = sample_rows(f_logits, gumbel_from_uniform(
                chunk[EXT_FROZEN_U:EXT_FROZEN_U + N_LOGITS]))
            for j in range(6):
                si[ACTION_ROWS[1 - trainee_idx][j]] = f_actions[j]
        parts.append(obs_moment_partials(obs_t[0:ROLL_OBS]))
        traj[t, 0:ROLL_OBS] = obs_t[0:ROLL_OBS]
        for j in range(6):
            traj[t, R_ACT + j] = actions[j].to(F32)
        traj[t, R_LOGP] = logp
        traj[t, R_VALUE] = value
        sf, si, obs = step_rows_plain(cfg, sf, si, chunk[0:N_NOISE_ROWS])
        traj[t, R_REW] = sf[rew_row]
        traj[t, R_DONE] = sf[done_row]
    return sf, si, obs, traj, combine_obs_moments(torch.stack(parts))
