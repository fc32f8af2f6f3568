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
    A CTA of 256 threads per tile of 64 worlds (csrc/rollout_common.cuh's
    `rollout_tile`, shared with kernel I): one thread per world runs the
    sim (the `step_world` device body of kernel A) with its world in
    registers for all T ticks, the policy is a (unit, world) tile product
    out of shared memory, and the obs tile stays in shared memory; each
    tick's obs are folded into per-32-world moment partials by warps.

Kernel B writes the (T, 128, W) trajectory (16 KB per world at T = 32,
128 MB at 8192 worlds) plus the final state and obs; the MLP is ~12
kflop per world-tick, which makes its bound the operations.

Noise comes two ways.  External: a (T * EXT_NOISE_CHUNK, W) matrix in the
`pack_rollout_noise` layout (tests and parity checks).  In-kernel: a
hand-written Philox4x32-10 with key = seed and counter
(world_base + world, tick_base + t, draw group, 0); `philox_noise` is
the same generator in plain torch.  The counter never mentions the launch
length, so one T-tick launch equals T one-tick launches with tick_base =
t; it holds the world's index in the whole fleet, so a launch on the
columns [world_base, world_base + W) of a fleet (a data-parallel rank's
shard) draws what a launch on the whole fleet draws for those worlds.

  * `fused_rollout_tiled` - kernel I (csrc/fused_rollout_tiled.cu),
    replacing the Pallas kernel `make_fused_rollout_tiled`
    (fused_rollout.py:502, pallas_call :664): kernel B's contract without
    the obs moments, for W % 1024 == 0: kernel B's tile body without the
    fold.  Its plain version is `rollout_tiled_plain`; on one seed and
    state kernels I and B write the same trajectory bit for bit.

The bf16 branches (the JAX kernel's `traj_dtype=bfloat16` and
`policy_bf16`, the trainer's --bf16-traj and --bf16-policy): with
`traj_dtype=torch.bfloat16` the trajectory is stored in bf16, each row
the float32 value rounded to nearest even (state, obs and the obs
moments stay float32, the moments folding the obs before rounding);
with `policy_bf16` the three Dense layers take bf16 operands (weights,
normalized obs, LayerNorm-ReLU outputs) and sum in float32.  On the card
either runs kernel B's bf16 instances (csrc/fused_rollout_bf16.cu, the
same tile body; the bf16 policy's products on the tensor cores, summed
in their order where the plain version sums over ascending k); the
plain versions round where the kernel rounds.

The timing probes (the JAX kernel's `probe`, fused_rollout.py:247,
:285-296; the attribution bench `bench_rollout_attr.py`): each removes
one cost term of kernel B and breaks the training semantics, so no
trainer path passes one.  "sim_only" runs neither policy and samples
nothing (the action, logp and value rows 0; the state's action rows
stay as `si` holds them); "policy_only" skips the sim tick (state and
obs stay, the actions the policy writes aside; reward and done 0);
"no_prng" draws constants in place of in-kernel Philox (sim noise 0.0,
both policies' uniforms 0.5: `no_prng_noise`), and with external noise
is the full kernel; "no_traj" writes no trajectory row and returns a
(1, 128, W) trajectory of zeros, everything else as the full kernel.
The obs fold runs in every probe.  Each probe takes the bf16 flags too,
as the JAX kernel does: a probe with bf16 storage stores the rows it
writes rounded, and with the bf16 policy runs it on bf16 operands
(sim_only runs no policy, so there the flag changes nothing).  On the
card the probes run on the float32 instance from their own source
(csrc/fused_rollout_probe.cu, counted in `probe_launches`), and with a
bf16 flag on the bf16 instances from two others, by storage type
(csrc/fused_rollout_probe_bf16.cu and csrc/fused_rollout_probe_pbf.cu,
counted in `probe_bf16_launches`).

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
BF16 = torch.bfloat16
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
def pack_net(net, of=None) -> tuple:
    """ActorCritic -> (w1t (32,128), w2t (32,32), wht (20,32) actor rows +
    value row, bias (32,8) cols b1, ln1 scale, ln1 bias, b2, ln2 scale,
    ln2 bias, head bias (zero-padded), 0).  `of(p)`, when given, maps
    each parameter to the tensor packed in its place (its gradient)."""
    lin, ln = layers(net)
    of = of or (lambda p: p)
    wht = torch.cat([of(net.actor.weight), of(net.critic.weight)], dim=0)
    head_b = torch.cat([of(net.actor.bias), of(net.critic.bias)])
    head_b = torch.nn.functional.pad(head_b, (0, H - head_b.shape[0]))
    bias = torch.stack([of(lin[0].bias), of(ln[0].weight), of(ln[0].bias),
                        of(lin[1].bias), of(ln[1].weight), of(ln[1].bias),
                        head_b, torch.zeros_like(head_b)], dim=1)
    return tuple(x.detach().to(F32).contiguous() for x in
                 (of(lin[0].weight), of(lin[1].weight), wht, bias))


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


def _round(x, mm_dtype):
    """x rounded to mm_dtype and back to float32 (mm_dtype F32: x)."""
    return x if mm_dtype == F32 else x.to(mm_dtype).to(F32)


def policy_forward_rows(obs_block, nrm, w1t, w2t, wht, bias, mm_dtype=F32):
    """(OBS, B) raw obs -> (logits (N_LOGITS, B), value (B,)); the math
    of models.agent.forward, feature-major.  mm_dtype=torch.bfloat16
    rounds each Dense layer's operands to bf16 (the JAX
    policy_forward_rows(mm_dtype=)): a product of two bf16 values is
    exact in float32, so the sums are float32 sums of exact products;
    biases, LayerNorm and ReLU stay float32."""
    x = torch.clamp((obs_block - nrm[:, 0:1]) * nrm[:, 1:2], -5.0, 5.0)
    h = _matvec(_round(w1t, mm_dtype), _round(x, mm_dtype)) + bias[:, 0:1]
    h = torch.clamp(_layer_norm(h, bias[:, 1:2], bias[:, 2:3]), min=0.0)
    h = _matvec(_round(w2t, mm_dtype), _round(h, mm_dtype)) + bias[:, 3:4]
    h = torch.clamp(_layer_norm(h, bias[:, 4:5], bias[:, 5:6]), min=0.0)
    out = _matvec(_round(wht, mm_dtype), _round(h, mm_dtype)) + \
        bias[0:N_LOGITS + 1, 6:7]
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
                    device="cuda", world_base: int = 0) -> torch.Tensor:
    """(N_DRAWS, W) uniforms of one tick: counter (world_base + world,
    tick, group, 0), key (seed lo, seed hi); draw n is word n % 4 of
    group n // 4."""
    wv = torch.arange(world_base, world_base + num_worlds, dtype=I64,
                      device=device)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    words = []
    for g in range(N_DRAW_GROUPS):
        out = philox4x32(wv, torch.full_like(wv, tick & MASK32),
                         torch.full_like(wv, g), torch.zeros_like(wv),
                         k0, k1)
        words.extend(out)
    return bits_to_unit(torch.stack(words[:N_DRAWS]))


def philox_noise(seed: int, tick_base: int, n_steps: int, num_worlds: int,
                 device="cuda", world_base: int = 0) -> torch.Tensor:
    """The in-kernel noise of a launch on worlds [world_base, world_base +
    W) as an external-noise matrix (T * EXT_NOISE_CHUNK, W): sim rows 0-7
    = 2u - 1, row 8 = u."""
    chunks, t_u, f_u = [], [], []
    for t in range(n_steps):
        u = philox_uniforms(seed, tick_base + t, num_worlds, device,
                            world_base)
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

def _check_traj_dtype(traj_dtype):
    if traj_dtype not in (F32, BF16):
        raise ValueError(f"traj_dtype must be torch.float32 or "
                         f"torch.bfloat16, not {traj_dtype}")


PROBES = ("sim_only", "policy_only", "no_prng", "no_traj")


def _check_probe(probe):
    if probe is not None and probe not in PROBES:
        raise ValueError(f"probe must be None or one of {PROBES}, not "
                         f"{probe!r}")


def no_prng_noise(n_steps: int, num_worlds: int, device="cuda"):
    """The draws of the no_prng probe as an external-noise matrix (T *
    EXT_NOISE_CHUNK, W): every sim-noise row 0.0, both policies'
    uniforms 0.5 (the JAX kernel's constants, fused_rollout.py:335-339)."""
    u = torch.full((n_steps, N_LOGITS, num_worlds), 0.5, dtype=F32,
                   device=device)
    sim = torch.zeros((N_NOISE_ROWS, num_worlds), dtype=F32, device=device)
    return pack_rollout_noise([sim] * n_steps, u, u)


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
                  n_steps: int, trainee_idx: int, noise: torch.Tensor,
                  traj_dtype=F32, policy_bf16: bool = False, probe=None):
    """The rollout in plain torch on external noise.  Returns
    (sf', si', obs', traj (T, 128, W) of traj_dtype, obs_moments
    (103, 8)); policy_bf16 takes bf16 policy operands, and probe one of
    PROBES runs that timing probe (no_prng: the full rollout, since the
    noise is external; no_traj: traj (1, 128, W) of zeros)."""
    return _rollout_plain(cfg, sf, si, obs0, mats, frozen_mats,
                          n_steps=n_steps, trainee_idx=trainee_idx,
                          noise=noise, moments=True, traj_dtype=traj_dtype,
                          policy_bf16=policy_bf16, probe=probe)


def _rollout_plain(cfg: SimConfig, sf, si, obs0, mats, frozen_mats, *,
                   n_steps: int, trainee_idx: int, noise: torch.Tensor,
                   moments: bool, traj_dtype=F32, policy_bf16: bool = False,
                   partials: bool = False, probe=None):
    use_frozen = frozen_mats is not None
    W = _check_rollout_args(sf, si, obs0, n_steps, noise, mats,
                            frozen_mats, use_frozen)
    _check_traj_dtype(traj_dtype)
    _check_probe(probe)
    mm = BF16 if policy_bf16 else F32
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
        if probe == "sim_only":
            # no policy, no sampling: the tick runs on the actions si holds
            zero = torch.zeros((W,), dtype=F32, device=sf.device)
            actions = [zero.to(I32)] * 6
            logp = value = zero
        else:
            logits, value = policy_forward_rows(obs_t, *mats, mm_dtype=mm)
            actions, logp = sample_rows(logits, gumbel_from_uniform(
                chunk[EXT_TRAINEE_U:EXT_TRAINEE_U + N_LOGITS]))
            for j in range(6):
                si[ACTION_ROWS[trainee_idx][j]] = actions[j]
            if use_frozen:
                f_logits, _ = policy_forward_rows(obs[fi_lo:fi_lo + OBS],
                                                  *frozen_mats, mm_dtype=mm)
                f_actions, _ = sample_rows(f_logits, gumbel_from_uniform(
                    chunk[EXT_FROZEN_U:EXT_FROZEN_U + N_LOGITS]))
                for j in range(6):
                    si[ACTION_ROWS[1 - trainee_idx][j]] = f_actions[j]
        if moments:
            parts.append(obs_moment_partials(obs_t[0:ROLL_OBS]))
        traj[t, 0:ROLL_OBS] = obs_t[0:ROLL_OBS]
        for j in range(6):
            traj[t, R_ACT + j] = actions[j].to(F32)
        traj[t, R_LOGP] = logp
        traj[t, R_VALUE] = value
        if probe == "policy_only":
            continue  # no tick: state and obs stay, reward and done 0
        sf, si, obs = step_rows_plain(cfg, sf, si, chunk[0:N_NOISE_ROWS])
        traj[t, R_REW] = sf[rew_row]
        traj[t, R_DONE] = sf[done_row]
    if probe == "no_traj":
        traj = torch.zeros((1, ROLL_ROWS, W), dtype=F32, device=sf.device)
    elif probe == "policy_only":
        sf, obs = sf.clone(), obs.clone()
    # bf16 storage: every row rounded once, as the kernel stores it (the
    # moments above fold the float32 obs)
    traj = traj.to(traj_dtype)
    if not moments:
        return sf, si, obs, traj
    out = (sf, si, obs, traj, combine_obs_moments(torch.stack(parts)))
    return (*out, torch.stack(parts)) if partials else out


def _check_world_base(world_base):
    if not isinstance(world_base, int) or not 0 <= world_base < 2 ** 31:
        raise ValueError(f"world_base must be an int in [0, 2**31), got "
                         f"{world_base!r}")


launches = 0  # kernel B launches (the wrapper counts, the caller resets)
# launches of kernel B's probe instances, by probe (the wrapper counts, the
# caller resets); no trainer path launches one
probe_launches = dict.fromkeys(PROBES, 0)
PROBE_CODES = {p: i + 1 for i, p in enumerate(PROBES)}  # csrc's PROBE_*
# launches of kernel B's bf16 instances, by branch (the wrapper counts, the
# caller resets): "traj" bf16 storage, "policy" bf16 policy operands; a
# launch with both flags counts in both
bf16_launches = {"traj": 0, "policy": 0}
# kernel B's probe x bf16 instances, "{probe}_{branch}" with branch "traj"
# (bf16 storage), "policy" (bf16 policy) or "both"; sim_only runs no
# policy, so with policy_bf16 it launches the sim_only instance of its
# storage type (probe_launches["sim_only"] or "sim_only_traj")
PROBE_BF16 = tuple(f"{p}_{b}" for p in PROBES
                   for b in ("traj", "policy", "both")
                   if p != "sim_only" or b == "traj")
# their launches (the wrapper counts, the caller resets); no trainer path
# launches one
probe_bf16_launches = dict.fromkeys(PROBE_BF16, 0)


def fused_rollout(cfg: SimConfig, sf, si, obs0, mats, frozen_mats=None, *,
                  n_steps: int, trainee_idx: int,
                  noise: torch.Tensor | None = None, seed: int = 0,
                  tick_base=0, world_base: int = 0,
                  moment_partials: bool = False, traj_dtype=F32,
                  policy_bf16: bool = False, probe=None):
    """Kernel B on CUDA tensors, the plain version on CPU tensors.

    noise=None draws in-kernel Philox noise from (seed, tick_base), the
    worlds numbered from world_base (a shard's first column in the whole
    fleet); a CPU caller gets the same numbers from `philox_noise`.
    tick_base is an int or a 0-d int32 tensor on the card, which the
    kernel reads there (a CUDA graph replays it with each replay's
    value).  Returns
    (sf', si', obs', traj (T, 128, W), obs_moments (103, 8)), and with
    moment_partials the per-(tick, 32-world group) (mean, M2) partials
    (T, W / 32, 103, 2) they were merged from.  traj_dtype=torch.bfloat16
    stores the trajectory in bf16 and policy_bf16 takes bf16 policy
    operands (kernel B's bf16 instances on the card).  probe, one of
    PROBES, runs that timing probe (kernel B's probe instances on the
    card, with a bf16 flag its probe x bf16 instances; the no_prng
    probe's CPU path draws `no_prng_noise`)."""
    global launches
    use_frozen = frozen_mats is not None
    W = _check_rollout_args(sf, si, obs0, n_steps, noise, mats,
                            frozen_mats, use_frozen)
    _check_world_base(world_base)
    _check_traj_dtype(traj_dtype)
    _check_probe(probe)
    t16 = traj_dtype == BF16
    pbf = policy_bf16 and probe != "sim_only"  # sim_only runs no policy
    if sf.device.type == "cpu":
        if noise is None and probe == "no_prng":
            noise = no_prng_noise(n_steps, W, sf.device)
        elif noise is None:
            noise = philox_noise(seed, int(tick_base), n_steps, W, sf.device,
                                 world_base)
        with torch.no_grad():
            return _rollout_plain(
                cfg, sf, si, obs0, mats, frozen_mats, n_steps=n_steps,
                trainee_idx=trainee_idx, noise=noise, moments=True,
                traj_dtype=traj_dtype, policy_bf16=policy_bf16,
                partials=moment_partials, probe=probe)
    if sf.device.type != "cuda":
        raise ValueError(f"unsupported device {sf.device}")
    from .. import _build
    from .fused_step import sim_params
    dev = sf.device
    _build.check_device(dev, si=si, obs0=obs0, noise=noise,
                        **{f"mats[{i}]": m for i, m in enumerate(mats)},
                        **{f"frozen_mats[{i}]": m
                           for i, m in enumerate(frozen_mats or ())})
    # the library and its entry's flags: the probe x bf16 instances build
    # in two sources, by storage type
    if probe:
        name, flags = ("fused_rollout_probe_bf16", (int(pbf),)) if t16 \
            else ("fused_rollout_probe_pbf", ()) if pbf \
            else ("fused_rollout_probe", ())
    else:
        name, flags = ("fused_rollout_bf16", (int(t16), int(pbf))) \
            if t16 or pbf else ("fused_rollout", ())
    lib = _build.load(name)
    sf2 = sf.contiguous().clone()
    si2 = si.contiguous().clone()
    obs = obs0.contiguous().clone()
    pol = flat_policy(mats)
    fpol = flat_policy(frozen_mats) if use_frozen else pol
    traj = torch.empty((1 if probe == "no_traj" else n_steps, ROLL_ROWS, W),
                       dtype=traj_dtype, device=dev)
    partials = torch.empty((n_steps, W // MOM_GROUP, ROLL_OBS, 2),
                           dtype=F32, device=dev)
    ext = None if noise is None else noise.contiguous()
    tb = None if noise is not None else _build.device_int(tick_base, dev)
    head = (sim_params(cfg), _build.ptr(sf2), _build.ptr(si2),
            _build.ptr(obs), _build.ptr(pol), _build.ptr(fpol),
            _build.ptr(ext), _build.ptr(traj), _build.ptr(partials), W,
            n_steps, trainee_idx, 1 if use_frozen else 0)
    tail = (seed & MASK32, (seed >> 32) & MASK32, _build.ptr(tb),
            world_base, _build.stream(dev))
    code = (PROBE_CODES[probe],) if probe else ()
    err = getattr(lib, f"mbb_{name}")(*head, *flags, *code, *tail)
    _build.check(err, name)
    if probe and (t16 or pbf):
        branch = "both" if t16 and pbf else "traj" if t16 else "policy"
        probe_bf16_launches[f"{probe}_{branch}"] += 1
    elif probe:
        probe_launches[probe] += 1
    elif t16 or pbf:
        bf16_launches["traj"] += int(t16)
        bf16_launches["policy"] += int(pbf)
    else:
        launches += 1
    out = (sf2, si2, obs, traj, combine_obs_moments(partials))
    return (*out, partials) if moment_partials else out


def rollout_occupancy(dev, name: str = "fused_rollout") -> dict:
    """Kernel B's resident CTAs per SM (from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads, warps per SM
    and dynamic shared memory, without and with the frozen policy: the
    float32 instance, or with name "fused_rollout_bf16" the bf16-policy
    instance (float32 storage)."""
    import ctypes
    from .. import _build
    if torch.device(dev).type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load(name)
    out = (ctypes.c_int * 6)()
    _build.check(getattr(lib, f"mbb_{name}_occupancy")(
        ctypes.addressof(out)), name)
    return {name: {"ctas_per_sm": out[i], "threads": out[i + 1],
                   "warps_per_sm": out[i] * out[i + 1] // 32,
                   "dynamic_smem_bytes": out[i + 2]}
            for name, i in (("trainee", 0), ("with_frozen", 3))}


# =====================================================================
# The tiled rollout: plain version and kernel I
# =====================================================================

TILED_WORLDS = 1024  # the JAX tiled kernel's world multiple (cols % 128)


def check_tiled_worlds(W: int):
    if W % TILED_WORLDS:
        raise ValueError("tiled rollout needs num_worlds % 1024 == 0 "
                         "(cols % 128 == 0)")


@torch.no_grad()
def rollout_tiled_plain(cfg: SimConfig, sf, si, obs0, mats,
                        frozen_mats=None, *, n_steps: int, trainee_idx: int,
                        noise: torch.Tensor):
    """Plain version of kernel I: `rollout_plain` without the obs moments.
    Returns (sf', si', obs', traj (T, 128, W))."""
    check_tiled_worlds(sf.shape[1])
    return _rollout_plain(cfg, sf, si, obs0, mats, frozen_mats,
                          n_steps=n_steps, trainee_idx=trainee_idx,
                          noise=noise, moments=False)


tiled_launches = 0  # kernel I launches (the wrapper counts, the caller resets)


def fused_rollout_tiled(cfg: SimConfig, sf, si, obs0, mats, frozen_mats=None,
                        *, n_steps: int, trainee_idx: int,
                        noise: torch.Tensor | None = None, seed: int = 0,
                        tick_base=0, world_base: int = 0):
    """Kernel I on CUDA tensors, the plain version on CPU tensors; W must
    be a multiple of 1024.

    noise=None draws kernel B's in-kernel Philox stream from (seed,
    tick_base, world_base); a CPU caller gets the same numbers from
    `philox_noise`.
    tick_base as kernel B takes it (an int or a 0-d int32 tensor on the
    card).
    Returns (sf', si', obs', traj (T, 128, W))."""
    global tiled_launches
    use_frozen = frozen_mats is not None
    W = _check_rollout_args(sf, si, obs0, n_steps, noise, mats,
                            frozen_mats, use_frozen)
    check_tiled_worlds(W)
    _check_world_base(world_base)
    if sf.device.type == "cpu":
        if noise is None:
            noise = philox_noise(seed, int(tick_base), n_steps, W, sf.device,
                                 world_base)
        return rollout_tiled_plain(cfg, sf, si, obs0, mats, frozen_mats,
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
    lib = _build.load("fused_rollout_tiled")
    sf2 = sf.contiguous().clone()
    si2 = si.contiguous().clone()
    obs = obs0.contiguous().clone()
    pol = flat_policy(mats)
    fpol = flat_policy(frozen_mats) if use_frozen else pol
    traj = torch.empty((n_steps, ROLL_ROWS, W), dtype=F32, device=dev)
    ext = None if noise is None else noise.contiguous()
    tb = None if noise is not None else _build.device_int(tick_base, dev)
    err = lib.mbb_fused_rollout_tiled(
        sim_params(cfg), _build.ptr(sf2), _build.ptr(si2), _build.ptr(obs),
        _build.ptr(pol), _build.ptr(fpol), _build.ptr(ext),
        _build.ptr(traj), W, n_steps, trainee_idx, 1 if use_frozen else 0,
        seed & MASK32, (seed >> 32) & MASK32, _build.ptr(tb), world_base,
        _build.stream(dev))
    _build.check(err, "fused_rollout_tiled")
    tiled_launches += 1
    return sf2, si2, obs, traj
