"""GAE + side array + episode-stat partials: plain torch + CUDA kernel C.

Port of `madrona_basketball_tpu/ops/fused_gae.py`.  One pass over the
trajectory's value/reward/done rows:

  * unnormalize the values with the pre-update value_rms (clamp +-5),
  * run the reverse GAE recursion with the t == T-1 quirk
    (fused_gae.py:118-121),
  * write the raw side array (T, SIDE_ROWS, W) = [value_un, adv, ret, 0..],
  * emit per world-block two-pass (mean, M2) of value_un / adv / ret,
  * run the episode-stat carry (current reward, length) forward and emit
    per (block, tick) [done count, sum(curr * done), sum(lens * done)].

`gae_plain` is the plain version; `fused_gae` is kernel C
(csrc/fused_gae.cu), replacing the Pallas kernel `make_fused_gae`
(madrona_basketball_tpu/ops/fused_gae.py:58, pallas_call :178).  Each
world block is a cluster of CTAs of 32 worlds: the input rows are staged
in shared memory, one thread per world runs each recursion from there,
and the block sums meet over distributed shared memory.  It is bound by
bytes: per world it reads 3 T + 3 floats and writes 8 T + 2 (~1.4 KB at
T = 32).

The port's world block (`pick_gae_block(W)`, at most GAE_BLOCK_CAP = 128)
is smaller than the TPU's 1024; it is chosen here and nowhere else, and a
caller of `combine_block_moments` takes n_per = T * W / nb from the
shape of `moments` (nb, 8).

The obs-normalizer moments of a trajectory whose rollout did not fold
them (the tiled rollout, kernel I) come from `obs_moments`: the
per-feature [mean, M2, n] of the 103 used obs rows over all (tick,
world) samples.  `obs_moments_plain` is the JAX kernel's sequential Chan
fold over (tick, world-block) tiles of OBS_MOMENT_TILE_CAP worlds in its
grid order; kernel E (csrc/obs_moments.cu), replacing the Pallas kernel
`make_obs_moments` (fused_gae.py:251, pallas_call :281), reduces the same
samples as a fixed tree (per-world two-pass, then pairwise and per-chunk
Chan merges), which rounds differently (~1e-6 relative).

Both take a trajectory of float32 or of bfloat16 (the JAX kernels'
traj_dtype, the trainer's --bf16-traj): a bf16 trajectory is upcast to
float32 as it is read, and everything after is the float32 arithmetic, so
each equals its float32 version on the upcast trajectory.  On the card
a bf16 trajectory runs the kernels' bf16 instances (`mbb_fused_gae_bf16`,
`mbb_obs_moments_bf16`), counted apart from the float32 ones.
"""

from __future__ import annotations

import torch

from .. import constants as C

F32 = torch.float32
BF16 = torch.bfloat16
OBS_USED = C.OBS_USED  # the packed obs slots (103)

VSTAT_COLS = 8       # vstats (1, 8): [value_mean, value_sigma, 0...]
SIDE_VALUE = 0
SIDE_ADV = 1
SIDE_RET = 2
SIDE_ROWS = 8
GAE_BLOCK_CAP = 128  # threads (worlds) per CUDA block


OBS_MOMENT_TILE_CAP = 1024  # the JAX fold's tile: its pick_gae_block(W)
OBS_MOMENT_CHUNK_CAP = 256  # kernel E: worlds per CTA (and per partial)


def pick_gae_block(W: int, cap: int = GAE_BLOCK_CAP) -> int:
    """Largest power-of-two worlds-per-block <= cap dividing W."""
    for cand in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if cand <= cap and W % cand == 0:
            return cand
    raise AssertionError("unreachable: 1 divides every W")


def chan_fold(acc, x):
    """Fold one (rows, n) tile's per-row (mean, M2) into a running
    (rows, 8) [mean, M2, n, 0...] accumulator (None starts one): the
    sequential Chan merge of the JAX `chan_fold` (fused_gae.py:219)."""
    rows, n_tile = x.shape
    m_b = x.sum(dim=1, keepdim=True) * (1.0 / n_tile)
    m2_b = ((x - m_b) * (x - m_b)).sum(dim=1, keepdim=True)
    out = torch.zeros((rows, 8), dtype=F32, device=x.device)
    if acc is None:
        out[:, 0:1], out[:, 1:2], out[:, 2] = m_b, m2_b, float(n_tile)
        return out
    m_run, m2_run, n_run = acc[:, 0:1], acc[:, 1:2], acc[:, 2:3]
    n_new = n_run + n_tile
    delta = m_b - m_run
    out[:, 0:1] = m_run + delta * (n_tile / n_new)
    out[:, 1:2] = m2_run + m2_b + delta * delta * (n_run * n_tile / n_new)
    out[:, 2:3] = n_new
    return out


def combine_block_moments(means, m2s, n_per: float):
    """Chan combine of equal-count per-block (mean, M2) pairs ->
    (mean, unbiased variance, count) of the full batch."""
    k = means.shape[0]
    n_total = n_per * k
    gmean = means.mean()
    m2 = m2s.sum() + n_per * ((means - gmean) ** 2).sum()
    var = m2 / max(n_total - 1.0, 1.0)
    return gmean, var, n_total


def _check(traj, carry, next_value_n, vstats, r_done):
    T, rows, W = traj.shape
    if traj.dtype not in (F32, BF16) or rows <= r_done:
        raise ValueError("traj must be (T, rows > r_done, W) float32 or "
                         "bfloat16")
    if carry.shape != (2, W) or next_value_n.shape != (1, W):
        raise ValueError("carry must be (2, W), next_value (1, W)")
    if vstats.shape != (1, VSTAT_COLS):
        raise ValueError(f"vstats must be (1, {VSTAT_COLS})")
    if any(x.dtype != F32 for x in (carry, next_value_n, vstats)):
        raise ValueError("carry, next_value and vstats must be float32")
    return T, W


@torch.no_grad()
def gae_plain(traj, carry, next_value_n, vstats, *, gamma: float,
              lam: float, r_value: int, r_rew: int, r_done: int):
    """Plain version of kernel C.  Returns (side (T, 8, W), moments
    (nb, 8) [v_mean, v_M2, a_mean, a_M2, r_mean, r_M2, 0, 0], carry'
    (2, W), ticks (nb, T, 8) [done count, sum(curr*d), sum(lens*d), 0..])."""
    T, W = _check(traj, carry, next_value_n, vstats, r_done)
    gb = pick_gae_block(W)
    nb = W // gb
    vmean, vsig = vstats[0, 0], vstats[0, 1]
    vals, rew, dn = (traj[:, r].to(F32) for r in (r_value, r_rew, r_done))
    v_un = vmean + vsig * torch.clamp(vals, -5.0, 5.0)
    next_un = vmean + vsig * torch.clamp(next_value_n, -5.0, 5.0)
    nd = 1.0 - dn
    nvs = torch.cat([v_un[1:], next_un], dim=0)
    nnt = torch.cat([nd[1:], nd[T - 1:T]], dim=0)
    deltas = rew + gamma * nvs * nnt - v_un
    adv = torch.empty_like(deltas)
    last = torch.zeros_like(deltas[0])
    for t in reversed(range(T)):
        last = deltas[t] + (gamma * lam) * nnt[t] * last
        adv[t] = last
    ret = adv + v_un

    side = torch.zeros((T, SIDE_ROWS, W), dtype=F32, device=traj.device)
    side[:, SIDE_VALUE], side[:, SIDE_ADV], side[:, SIDE_RET] = v_un, adv, ret

    moments = torch.zeros((nb, 8), dtype=F32, device=traj.device)
    n_per = float(T * gb)
    for c, x in enumerate((v_un, adv, ret)):
        # a row of T * gb values a block: each block's sums run in the
        # same order whatever the fleet's width (a data-parallel rank's
        # blocks are the whole fleet's), as the kernel's do
        xb = x.reshape(T, nb, gb).transpose(0, 1).reshape(nb, T * gb)
        m = xb.sum(dim=1) * (1.0 / n_per)
        moments[:, 2 * c] = m
        moments[:, 2 * c + 1] = ((xb - m[:, None]) ** 2).sum(dim=1)

    curr, lens = carry[0], carry[1]
    ticks = torch.zeros((nb, T, 8), dtype=F32, device=traj.device)
    for t in range(T):
        d = dn[t]
        curr = curr + rew[t]
        lens = lens + 1.0
        ticks[:, t, 0] = d.reshape(nb, gb).sum(dim=1)
        ticks[:, t, 1] = (curr * d).reshape(nb, gb).sum(dim=1)
        ticks[:, t, 2] = (lens * d).reshape(nb, gb).sum(dim=1)
        curr = curr * (1.0 - d)
        lens = lens * (1.0 - d)
    return side, moments, torch.stack([curr, lens]), ticks


launches = 0  # kernel C launches (the wrapper counts, the caller resets)
bf16_launches = 0  # of its bf16 instance (a bf16 trajectory)


def fused_gae(traj, carry, next_value_n, vstats, *, gamma: float,
              lam: float, r_value: int, r_rew: int, r_done: int):
    """Kernel C on CUDA tensors, `gae_plain` on CPU tensors; traj float32
    or bfloat16."""
    global launches, bf16_launches
    T, W = _check(traj, carry, next_value_n, vstats, r_done)
    if traj.device.type == "cpu":
        return gae_plain(traj, carry, next_value_n, vstats, gamma=gamma,
                         lam=lam, r_value=r_value, r_rew=r_rew,
                         r_done=r_done)
    if traj.device.type != "cuda":
        raise ValueError(f"unsupported device {traj.device}")
    gb = pick_gae_block(W)
    if gb % 32:
        raise ValueError("kernel C needs a world block that is a multiple "
                         "of 32 (a world count that is one)")
    from .. import _build
    dev = traj.device
    _build.check_device(dev, carry=carry, next_value=next_value_n,
                        vstats=vstats)
    lib = _build.load("fused_gae")
    nb = W // gb
    traj, carry, next_value_n, vstats = (
        x.contiguous() for x in (traj, carry, next_value_n, vstats))
    if traj.data_ptr() % 16:
        traj = traj.clone()  # the kernel reads 16- (bf16: 8-) byte vectors
    side = torch.empty((T, SIDE_ROWS, W), dtype=F32, device=dev)
    moments = torch.empty((nb, 8), dtype=F32, device=dev)
    carry2 = torch.empty((2, W), dtype=F32, device=dev)
    ticks = torch.empty((nb, T, 8), dtype=F32, device=dev)
    bf16 = traj.dtype == BF16
    entry = lib.mbb_fused_gae_bf16 if bf16 else lib.mbb_fused_gae
    err = entry(
        _build.ptr(traj), _build.ptr(carry), _build.ptr(next_value_n),
        _build.ptr(vstats), _build.ptr(side), _build.ptr(moments),
        _build.ptr(carry2), _build.ptr(ticks), T, traj.shape[1], W, gb,
        r_value, r_rew, r_done, float(gamma), float(gamma * lam),
        _build.stream(dev))
    _build.check(err, "fused_gae")
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return side, moments, carry2, ticks


GAE_TILE = 32  # worlds per CTA (csrc/gae_tile.cuh)


def gae_occupancy(dev, T: int, W: int) -> dict:
    """Kernel C's CTAs and warps per SM at T ticks: what an SM could hold
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor: ctas_per_sm,
    warps_per_sm), and what a launch over W worlds places on it
    (resident_*: min(that, ceil(grid / SMs)) CTAs), with threads and
    dynamic shared memory."""
    import ctypes
    from .. import _build
    if torch.device(dev).type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load("fused_gae")
    out = (ctypes.c_int * 3)()
    _build.check(lib.mbb_fused_gae_occupancy(T, ctypes.addressof(out)),
                 "fused_gae")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = -(-W // GAE_TILE)
    ctas = min(out[0], -(-grid // sms))
    return {"ctas_per_sm": out[0], "threads": out[1],
            "warps_per_sm": out[0] * out[1] // 32,
            "dynamic_smem_bytes": out[2], "grid_ctas": grid,
            "resident_ctas_per_sm": ctas,
            "resident_warps_per_sm": ctas * out[1] // 32}


# =====================================================================
# Obs-normalizer moments: plain fold and kernel E
# =====================================================================

def _check_obs(traj, used):
    if traj.dim() != 3 or traj.dtype not in (F32, BF16) or \
            traj.shape[1] < used:
        raise ValueError(f"traj must be (T, rows >= {used}, W) float32 or "
                         f"bfloat16")
    return traj.shape[0], traj.shape[2]


@torch.no_grad()
def obs_moments_plain(traj, used: int = OBS_USED):
    """(T, rows, W) trajectory -> (used, 8) [mean, M2, n, 0...] of rows
    0..used-1 over every (tick, world): the sequential Chan fold of the
    JAX `make_obs_moments`, tile i = t * n_wb + b of gb =
    pick_gae_block(W, OBS_MOMENT_TILE_CAP) worlds, in grid order."""
    T, W = _check_obs(traj, used)
    gb = pick_gae_block(W, OBS_MOMENT_TILE_CAP)
    acc = None
    for t in range(T):
        for b in range(W // gb):
            acc = chan_fold(acc, traj[t, 0:used, b * gb:(b + 1) * gb]
                            .to(F32))
    return acc


moment_launches = 0  # kernel E launches (wrapper counts, caller resets)
bf16_moment_launches = 0  # of its bf16 instance (a bf16 trajectory)


def obs_moments(traj, used: int = OBS_USED):
    """Kernel E on CUDA tensors, `obs_moments_plain` on CPU tensors; traj
    float32 or bfloat16."""
    global moment_launches, bf16_moment_launches
    T, W = _check_obs(traj, used)
    if traj.device.type == "cpu":
        return obs_moments_plain(traj, used)
    if traj.device.type != "cuda":
        raise ValueError(f"unsupported device {traj.device}")
    chunk = pick_gae_block(W, OBS_MOMENT_CHUNK_CAP)
    if chunk < 32:
        raise ValueError(f"kernel E needs a world count that is a multiple "
                         f"of 32, got {W}")
    from .. import _build
    lib = _build.load("obs_moments")
    dev = traj.device
    traj = traj.contiguous()
    bf16 = traj.dtype == BF16
    if bf16 and traj.data_ptr() % 16:
        traj = traj.clone()  # the bf16 instance reads 16-byte vectors
    partials = torch.empty((used, W // chunk, 2), dtype=F32, device=dev)
    out = torch.empty((used, 8), dtype=F32, device=dev)
    entry = lib.mbb_obs_moments_bf16 if bf16 else lib.mbb_obs_moments
    err = entry(_build.ptr(traj), _build.ptr(partials), _build.ptr(out), T,
                traj.shape[1], W, used, chunk, _build.stream(dev))
    _build.check(err, "obs_moments")
    if bf16:
        bf16_moment_launches += 1
    else:
        moment_launches += 1
    return out
