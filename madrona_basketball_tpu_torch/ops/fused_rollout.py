"""Policy-in-the-loop rollout: T PPO ticks, plain torch + CUDA kernel B.

Port of `madrona_basketball_tpu/ops/fused_rollout.py`.  Each tick:
normalize the trainee's pre-tick obs (clamp +-5), run the MLP
(128 -> 32 -> LN -> ReLU -> 32 -> LN -> ReLU -> 19 logits + value),
Gumbel-max sample every action bucket (strict `>`, so ties keep the first
index), write the actions into the i32 state (and the frozen opponent's,
when there is one), run the sim tick, and write the trajectory rows.

  * `rollout_plain` - the same loop in plain torch over `step_rows_plain`.
  * `fused_rollout` - kernel B (csrc/fused_rollout.cu), replacing the
    Pallas kernel `make_fused_rollout`
    (madrona_basketball_tpu/ops/fused_rollout.py:239, pallas_call :486).
    One thread per world keeps its world in registers/local memory for
    all T ticks and calls the same `step_world` device body as kernel A;
    the policy matrices (6,272 floats each) sit in shared memory.

Kernel B is bound by bytes too: it writes the (T, 128, W) trajectory
(16 KB per world at T = 32, 128 MB at 8192 worlds) plus the final state
and obs; the MLP is ~12 kflop per world-tick.

Noise comes two ways.  External: a (T * EXT_NOISE_CHUNK, W) matrix in the
`pack_rollout_noise` layout (tests and parity checks).  In-kernel: a
hand-written Philox4x32-10 with key = seed and counter
(world, tick_base + t, draw group, 0); `philox_noise` is the same
generator in plain torch.  The counter never mentions the launch length,
so one T-tick launch equals T one-tick launches with tick_base = t.

Obs-normalizer moments: every (tick, 32-world group) writes its
per-feature (mean, M2) of the 103 used obs slots; `combine_obs_moments`
merges those equal-count partials (Chan) into the (103, 8)
[mean, M2, n, 0...] block the JAX kernel's `chan_fold` produces.  The
merge order differs from the TPU's sequential fold, so agreement is
~1e-5 relative rather than exact.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import SimConfig
from ..models.agent import layers
from .fused_step import check_rows, step_rows_plain
from .layout import (ACTION_ROWS, F_IDX, N_NOISE_ROWS, N_OBS_ROWS)

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
A = C.NUM_AGENTS
N_LOGITS = sum(C.ACTION_BUCKETS)  # 19
OBS = C.OBS_SIZE                  # 128
H = 32                            # hidden width

# Trajectory rows per (tick, world): 103 packed obs, 6 actions, logp,
# two zero pad rows, value, reward, done, zero pad to 128.
ROLL_OBS = C.OBS_USED      # 103
R_ACT = ROLL_OBS           # 103
R_LOGP = R_ACT + 6         # 109
R_VALUE = -(-(R_LOGP + 1) // 8) * 8  # 112
R_REW = R_VALUE + 1        # 113
R_DONE = R_REW + 1         # 114
ROLL_ROWS = 128

# External-noise chunk per tick: rows 0..8 sim noise, 16..34 trainee
# uniforms, 35..53 frozen uniforms, padded to 56.
EXT_TRAINEE_U = 16
EXT_FROZEN_U = EXT_TRAINEE_U + N_LOGITS
EXT_NOISE_CHUNK = ((EXT_FROZEN_U + N_LOGITS + 7) // 8) * 8  # 56

RMS_EPS = 1e-5
LN_EPS = 1e-6
MOM_GROUP = 32                     # worlds per obs-moment partial (a warp)
N_DRAWS = N_NOISE_ROWS + 2 * N_LOGITS  # 47 uniforms per (world, tick)
N_DRAW_GROUPS = -(-N_DRAWS // 4)       # 12 Philox calls per (world, tick)
# Packed policy: nrm (128,2) | w1t (32,128) | w2t (32,32) | wht (20,32) |
# bias (32,8), row-major, in this order (csrc/fused_rollout.cu).
POLICY_SHAPES = ((OBS, 2), (H, OBS), (H, H), (N_LOGITS + 1, H), (H, 8))
POLICY_FLOATS = sum(r * c for r, c in POLICY_SHAPES)  # 6272


@torch.no_grad()
def pack_net(net) -> tuple:
    """ActorCritic -> (w1t (32,128), w2t (32,32), wht (20,32) actor rows +
    value row, bias (32,8) cols b1, ln1 scale, ln1 bias, b2, ln2 scale,
    ln2 bias, head bias (zero-padded), 0)."""
    lin, ln = layers(net)
    wht = torch.cat([net.actor.weight, net.critic.weight], dim=0)
    head_b = torch.cat([net.actor.bias, net.critic.bias])
    head_b = torch.nn.functional.pad(head_b, (0, H - head_b.shape[0]))
    bias = torch.stack([lin[0].bias, ln[0].weight, ln[0].bias, lin[1].bias,
                        ln[1].weight, ln[1].bias, head_b,
                        torch.zeros_like(head_b)], dim=1)
    return tuple(x.detach().to(F32).contiguous() for x in
                 (lin[0].weight, lin[1].weight, wht, bias))


@torch.no_grad()
def pack_policy(ap) -> tuple:
    """Agent -> (nrm, w1t, w2t, wht, bias) as in the JAX `pack_policy`:
    nrm (128,2) [mean, rsqrt(var + 1e-5)], then `pack_net`."""
    nrm = torch.stack([ap.obs_rms.mean,
                       torch.rsqrt(ap.obs_rms.var + RMS_EPS)], dim=1)
    return (nrm.detach().to(F32).contiguous(),) + pack_net(ap.net)


def flat_policy(mats) -> torch.Tensor:
    """The five packed matrices as one (POLICY_FLOATS,) buffer."""
    return torch.cat([m.reshape(-1) for m in mats]).contiguous()


def _matvec(wt, x):
    """(M, K) @ (K, B) summed over k in ascending order, one multiply and
    one add per term: the order of kernel B's per-thread matvec, so the
    two agree to the bit on the card."""
    acc = torch.zeros((wt.shape[0], x.shape[1]), dtype=F32, device=x.device)
    for k in range(wt.shape[1]):
        acc = acc + wt[:, k:k + 1] * x[k:k + 1]
    return acc


def _seq_sum(x):
    """Sum over axis 0 in ascending order (kernel B's order)."""
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
    """(OBS, B) raw obs -> (logits (N_LOGITS, B), value (B,)); the math
    of models.agent.forward, feature-major."""
    x = torch.clamp((obs_block - nrm[:, 0:1]) * nrm[:, 1:2], -5.0, 5.0)
    h = _matvec(w1t, x) + bias[:, 0:1]
    h = torch.clamp(_layer_norm(h, bias[:, 1:2], bias[:, 2:3]), min=0.0)
    h = _matvec(w2t, h) + bias[:, 3:4]
    h = torch.clamp(_layer_norm(h, bias[:, 4:5], bias[:, 5:6]), min=0.0)
    out = _matvec(wht, h) + bias[0:N_LOGITS + 1, 6:7]
    return out[0:N_LOGITS], out[N_LOGITS]


def gumbel_from_uniform(u):
    """u in [0, 1) -> standard Gumbel, guarding u == 0."""
    return -torch.log(-torch.log(torch.clamp(u, min=1e-20)))


def sample_rows(logits, gumbel):
    """Gumbel-max per bucket over (N_LOGITS, B) rows -> (6 actions (B,)
    i32, summed log-prob (B,)).  Strict `>` keeps the first maximum."""
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


def pack_rollout_noise(sim_chunks, trainee_u, frozen_u):
    """T (N_NOISE_ROWS, W) sim-noise matrices + (T, N_LOGITS, W) trainee
    and frozen uniforms -> (T * EXT_NOISE_CHUNK, W)."""
    T = len(sim_chunks)
    W = sim_chunks[0].shape[1]
    out = torch.zeros((T, EXT_NOISE_CHUNK, W), dtype=F32,
                      device=sim_chunks[0].device)
    for t in range(T):
        out[t, 0:N_NOISE_ROWS] = sim_chunks[t]
        out[t, EXT_TRAINEE_U:EXT_TRAINEE_U + N_LOGITS] = trainee_u[t]
        out[t, EXT_FROZEN_U:EXT_FROZEN_U + N_LOGITS] = frozen_u[t]
    return out.reshape(T * EXT_NOISE_CHUNK, W)


# =====================================================================
# Philox4x32-10 in plain torch (the in-kernel generator's twin)
# =====================================================================

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of m * b for b < 2**32, in int64 without
    overflow: b is split into 16-bit halves."""
    p1 = m * (b & 0xFFFF)
    p2 = m * (b >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return ((p2 >> 16) + (s >> 32)) & MASK32, s & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    uint32 values; returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 tensor) -> f32 in [0, 1): 23 mantissa bits under
    1.0's exponent, minus 1 (fused_step._bits_to_unit's mantissa trick)."""
    b = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return b.view(F32) - 1.0


def philox_uniforms(seed: int, tick: int, num_worlds: int,
                    device="cuda") -> torch.Tensor:
    """(N_DRAWS, W) uniforms of one tick: counter (world, tick, group, 0),
    key (seed lo, seed hi); draw n is word n % 4 of group n // 4."""
    wv = torch.arange(num_worlds, dtype=I64, device=device)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    words = []
    for g in range(N_DRAW_GROUPS):
        out = philox4x32(wv, torch.full_like(wv, tick & MASK32),
                         torch.full_like(wv, g), torch.zeros_like(wv),
                         k0, k1)
        words.extend(out)
    return bits_to_unit(torch.stack(words[:N_DRAWS]))


def philox_noise(seed: int, tick_base: int, n_steps: int, num_worlds: int,
                 device="cuda") -> torch.Tensor:
    """The in-kernel noise of a launch as an external-noise matrix
    (T * EXT_NOISE_CHUNK, W): sim rows 0-7 = 2u - 1, row 8 = u."""
    chunks, t_u, f_u = [], [], []
    for t in range(n_steps):
        u = philox_uniforms(seed, tick_base + t, num_worlds, device)
        chunks.append(torch.cat([2.0 * u[:N_NOISE_ROWS - 1] - 1.0,
                                 u[N_NOISE_ROWS - 1:N_NOISE_ROWS]]))
        t_u.append(u[N_NOISE_ROWS:N_NOISE_ROWS + N_LOGITS])
        f_u.append(u[N_NOISE_ROWS + N_LOGITS:N_DRAWS])
    return pack_rollout_noise(chunks, t_u, f_u)


# =====================================================================
# Obs moments
# =====================================================================

def obs_moment_partials(obs_used: torch.Tensor) -> torch.Tensor:
    """(ROLL_OBS, W) obs of one tick -> (W / MOM_GROUP, ROLL_OBS, 2)
    per-group (mean, M2), the partials kernel B writes per warp."""
    F, W = obs_used.shape
    x = obs_used.reshape(F, W // MOM_GROUP, MOM_GROUP)
    m = x.sum(dim=2) * (1.0 / MOM_GROUP)
    m2 = ((x - m[:, :, None]) ** 2).sum(dim=2)
    return torch.stack([m, m2], dim=2).transpose(0, 1)


def combine_obs_moments(partials: torch.Tensor) -> torch.Tensor:
    """(T, G, ROLL_OBS, 2) equal-count partials -> (ROLL_OBS, 8)
    [mean, M2, n, 0...]: Chan's combine, sum order fixed."""
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


# =====================================================================
# The rollout: plain version and kernel B
# =====================================================================

def _check_rollout_args(sf, si, obs0, n_steps, noise, mats, frozen_mats,
                        use_frozen):
    W = check_rows(sf, si)
    if obs0.shape != (N_OBS_ROWS, W) or obs0.dtype != F32:
        raise ValueError(f"obs0 must be ({N_OBS_ROWS}, {W}) float32")
    if W % MOM_GROUP:
        raise ValueError(f"num_worlds={W} must be a multiple of "
                         f"{MOM_GROUP}")
    if noise is not None and (noise.shape != (n_steps * EXT_NOISE_CHUNK, W)
                              or noise.dtype != F32):
        raise ValueError("external noise must be (T * EXT_NOISE_CHUNK, W) "
                         "float32")
    if use_frozen != (frozen_mats is not None):
        raise ValueError("frozen_mats must be given iff use_frozen")
    for ms in (mats, frozen_mats or mats):
        if tuple(tuple(m.shape) for m in ms) != POLICY_SHAPES or \
                any(m.dtype != F32 for m in ms):
            raise ValueError(f"mats must be pack_policy's float32 matrices "
                             f"of shapes {POLICY_SHAPES}")
    return W


@torch.no_grad()
def rollout_plain(cfg: SimConfig, sf, si, obs0, mats, frozen_mats=None, *,
                  n_steps: int, trainee_idx: int, noise: torch.Tensor):
    """The rollout in plain torch on external noise.  Returns
    (sf', si', obs', traj (T, 128, W), obs_moments (103, 8))."""
    use_frozen = frozen_mats is not None
    W = _check_rollout_args(sf, si, obs0, n_steps, noise, mats,
                            frozen_mats, use_frozen)
    ti_lo = trainee_idx * OBS
    fi_lo = (1 - trainee_idx) * OBS
    rew_row = F_IDX[f"a{trainee_idx}.reward"]
    done_row = F_IDX[f"a{trainee_idx}.done"]
    traj = torch.zeros((n_steps, ROLL_ROWS, W), dtype=F32, device=sf.device)
    partials = []
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
        if use_frozen:
            f_logits, _ = policy_forward_rows(obs[fi_lo:fi_lo + OBS],
                                              *frozen_mats)
            f_actions, _ = sample_rows(f_logits, gumbel_from_uniform(
                chunk[EXT_FROZEN_U:EXT_FROZEN_U + N_LOGITS]))
            for j in range(6):
                si[ACTION_ROWS[1 - trainee_idx][j]] = f_actions[j]
        partials.append(obs_moment_partials(obs_t[0:ROLL_OBS]))
        traj[t, 0:ROLL_OBS] = obs_t[0:ROLL_OBS]
        for j in range(6):
            traj[t, R_ACT + j] = actions[j].to(F32)
        traj[t, R_LOGP] = logp
        traj[t, R_VALUE] = value
        sf, si, obs = step_rows_plain(cfg, sf, si, chunk[0:N_NOISE_ROWS])
        traj[t, R_REW] = sf[rew_row]
        traj[t, R_DONE] = sf[done_row]
    return sf, si, obs, traj, combine_obs_moments(torch.stack(partials))


launches = 0  # kernel B launches (the wrapper counts, the caller resets)


def fused_rollout(cfg: SimConfig, sf, si, obs0, mats, frozen_mats=None, *,
                  n_steps: int, trainee_idx: int,
                  noise: torch.Tensor | None = None, seed: int = 0,
                  tick_base: int = 0):
    """Kernel B on CUDA tensors, the plain version on CPU tensors.

    noise=None draws in-kernel Philox noise from (seed, tick_base); a
    CPU caller gets the same numbers from `philox_noise`.  Returns
    (sf', si', obs', traj (T, 128, W), obs_moments (103, 8))."""
    global launches
    use_frozen = frozen_mats is not None
    W = _check_rollout_args(sf, si, obs0, n_steps, noise, mats,
                            frozen_mats, use_frozen)
    if sf.device.type == "cpu":
        if noise is None:
            noise = philox_noise(seed, tick_base, n_steps, W, sf.device)
        return rollout_plain(cfg, sf, si, obs0, mats, frozen_mats,
                             n_steps=n_steps, trainee_idx=trainee_idx,
                             noise=noise)
    if sf.device.type != "cuda":
        raise ValueError(f"unsupported device {sf.device}")
    from .. import _build
    from .fused_step import sim_params
    dev = sf.device
    _build.check_device(dev, si=si, obs0=obs0, noise=noise,
                        **{f"mats[{i}]": m for i, m in enumerate(mats)},
                        **{f"frozen_mats[{i}]": m
                           for i, m in enumerate(frozen_mats or ())})
    lib = _build.load("fused_rollout")
    sf2 = sf.contiguous().clone()
    si2 = si.contiguous().clone()
    obs = obs0.contiguous().clone()
    pol = flat_policy(mats)
    fpol = flat_policy(frozen_mats) if use_frozen else pol
    traj = torch.empty((n_steps, ROLL_ROWS, W), dtype=F32, device=dev)
    partials = torch.empty((n_steps, W // MOM_GROUP, ROLL_OBS, 2),
                           dtype=F32, device=dev)
    ext = None if noise is None else noise.contiguous()
    err = lib.mbb_fused_rollout(
        sim_params(cfg), _build.ptr(sf2), _build.ptr(si2), _build.ptr(obs),
        _build.ptr(pol), _build.ptr(fpol), _build.ptr(ext),
        _build.ptr(traj), _build.ptr(partials), W, n_steps, trainee_idx,
        1 if use_frozen else 0, seed & MASK32, (seed >> 32) & MASK32,
        tick_base, _build.stream(dev))
    _build.check(err, "fused_rollout")
    launches += 1
    return sf2, si2, obs, traj, combine_obs_moments(partials)
