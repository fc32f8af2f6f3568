"""The PPO update phase: plain torch + CUDA kernels D, G and H.

Port of `madrona_basketball_tpu/ops/fused_update.py`.  The policy is a
2 x 32 MLP over the 103 packed obs slots, so the whole minibatch gradient
is a hand-derived forward + backward per sample:

  * normalize the packed obs (clamp +-5), Dense -> LayerNorm (flax fast
    variance, eps 1e-6) -> ReLU twice, a 20-row head (19 logits + value);
  * per-bucket softmax shifted by the global max over the 19 logits, the
    selected log-prob and the per-bucket entropy;
  * the clipped-surrogate, clipped-value and entropy cotangents, each
    scaled by 1 / minibatch size; ties route to the first operand
    (`take1 = surr1 >= surr2`, `takev = vf >= vfc`), as in the JAX kernel;
  * the backward through the head, both LayerNorms and both ReLUs.

The weights travel in the kernel orientation: w1t (32, 103), w2t (32, 32),
wht (20, 32) and bias (32, 8) with columns b1 | ln1 scale | ln1 bias | b2 |
ln2 scale | ln2 bias | head bias (rows 0..19) | 0.  Adam moments use the
same four shapes.

Three kernels share one device body (csrc/fused_update.cu):

  * D, `fused_update_phase` - every epoch x minibatch of the phase:
    gradient over the permuted (tick, world-block) blocks of the
    trajectory, then global-norm clip + Adam in place, with the raw side
    rows normalized from `ustats`.  Replaces `make_fused_update_phase`
    (madrona_basketball_tpu/ops/fused_update.py:457, pallas_call :636).
  * G, `fused_minibatch_grad_prefetch` - one minibatch's gradient over
    permuted blocks, side rows already normalized (:326, :413).
  * H, `fused_minibatch_grad` - one minibatch's gradient over a row-major
    (mb, F) feat matrix (:249, :287).

Each wrapper runs its plain version for CPU tensors, launches its kernel
for CUDA tensors and counts the launch; nothing falls back.  D issues all
of a phase's 2 x E x M device launches from one C call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as C
from ..models.agent import LN_EPS, layers
from ..models.normalize import EPS as RMS_EPS
from ..ppo.train import clip_adam_step
from .fused_gae import SIDE_ADV, SIDE_RET, SIDE_ROWS, SIDE_VALUE
from .fused_rollout import pack_net

F32 = torch.float32
I32 = torch.int32
BUCKETS = tuple(C.ACTION_BUCKETS)
N_LOGITS = sum(BUCKETS)           # 19
N_OUT = N_LOGITS + 1              # actor rows + value row
NB = len(BUCKETS)                 # 6
H = 32                            # hidden width
D = C.OBS_USED                    # 103 packed obs slots
N_BCOL = 8
R_ACT = D                         # trajectory rows: obs | 6 actions | logp
R_LOGP = D + NB
FEAT_COLS = D + NB + 4            # obs | actions | logp | v_n | adv | ret_n
SHAPES = ((H, D), (H, H), (N_OUT, H), (H, N_BCOL))
N_PARAMS = sum(r * c for r, c in SHAPES)  # 5216

# the buckets' first logit indices, and the bucket of each logit (the
# JAX kernel's segment matrix _SEG, as the loops over buckets that
# replace its products)
_BASE = np.cumsum((0,) + BUCKETS[:-1])
_BUCKET_OF = np.repeat(np.arange(NB), BUCKETS)


def _seg_sum(x):
    """(N_LOGITS, R) -> (NB, R): each bucket's sum over its logits, added
    in logit order as the kernel adds them (no segment-matrix product, and
    no reduction whose order differs from the kernel's: an ulp in a
    bucket sum can flip a sample's tie or ReLU and move the update)."""
    sums = []
    for o, n in zip(_BASE.tolist(), BUCKETS):
        acc = x[o]
        for j in range(o + 1, o + n):
            acc = acc + x[j]
        sums.append(acc)
    return torch.stack(sums)


def _seg_bcast(x):
    """(NB, R) -> (N_LOGITS, R): each bucket's row repeated over its
    logits."""
    return x[torch.as_tensor(_BUCKET_OF, device=x.device)]


def pack_norm(obs_rms, d: int = D):
    """RMSState -> the (2, d) [mean; rsqrt(var + eps)] matrix."""
    return torch.stack([obs_rms.mean[:d],
                        torch.rsqrt(obs_rms.var[:d] + RMS_EPS)]).to(F32)


def pack_weights(net, d: int = D):
    """ActorCritic (or a moment set of its shapes) -> (w1t (H, d),
    w2t (H, H), wht (N_OUT, H), bias (H, N_BCOL)): the rollout's packing
    (`fused_rollout.pack_net`) with the first layer cut to its first d
    columns (`nn.Linear.weight` is already (out, in)); fresh tensors."""
    w1t, w2t, wht, bias = pack_net(net)
    return tuple(x.clone(memory_format=torch.contiguous_format)
                 for x in (w1t[:, :d], w2t, wht, bias))


@torch.no_grad()
def unpack_weights(net, w1t, w2t, wht, bias):
    """Inverse of `pack_weights`, in place: the kernel-orientation
    matrices go back into the module.  Columns >= d of the first layer
    (the structurally-zero obs tail, whose gradient is exactly zero) are
    carried over unchanged, as the JAX `unpack_weights` does."""
    lin, ln = layers(net)
    d = w1t.shape[1]
    lin[0].weight[:, :d] = w1t
    lin[1].weight.copy_(w2t)
    net.actor.weight.copy_(wht[:N_LOGITS])
    net.critic.weight.copy_(wht[N_LOGITS:N_OUT])
    for dst, c in ((lin[0].bias, 0), (ln[0].weight, 1), (ln[0].bias, 2),
                   (lin[1].bias, 3), (ln[1].weight, 4), (ln[1].bias, 5)):
        dst.copy_(bias[:, c])
    net.actor.bias.copy_(bias[:N_LOGITS, 6])
    net.critic.bias.copy_(bias[N_LOGITS:N_OUT, 6])
    return net


def pick_update_block(W: int, mb_size: int, cap: int = 4096) -> int:
    """Largest power-of-two block width <= cap dividing both the world
    count and the minibatch size (1 always qualifies)."""
    g = math.gcd(W, mb_size)
    for cand in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if cand <= cap and g % cand == 0:
            return cand
    raise AssertionError("unreachable: 1 divides every gcd")


# =====================================================================
# Plain versions
# =====================================================================

def _ln_fwd(z, scale, bias):
    """Feature axis 0; flax fast-variance numerics."""
    mu = z.mean(dim=0, keepdim=True)
    mu2 = (z * z).mean(dim=0, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + LN_EPS)
    hhat = (z - mu) * rstd
    return hhat, rstd, hhat * scale + bias


def _ln_bwd(dy, hhat, rstd, scale):
    dhhat = dy * scale
    m1 = dhhat.mean(dim=0, keepdim=True)
    m2 = (dhhat * hhat).mean(dim=0, keepdim=True)
    dz = rstd * (dhhat - m1 - hhat * m2)
    return dz, (dy * hhat).sum(dim=1), dy.sum(dim=1)


@torch.no_grad()
def block_grads_plain(hp, inv_mb, obs, act, lp_old, v_old, adv, ret, nrm,
                      w1t, w2t, wht, bias):
    """Forward + hand-derived backward over one feature-major batch:
    obs (d, R), act (NB, R) as float indices, lp_old / v_old / adv / ret
    (R,).  Returns the gradients (dw1t, dw2t, dwht, dbias) summed over
    the R samples, each sample's terms scaled by `inv_mb`."""
    dev = obs.device
    base = torch.as_tensor(_BASE, dtype=F32, device=dev)[:, None]
    clip = hp.clip_coef

    def col(v):
        return v[:, None]

    xn = torch.clamp((obs - col(nrm[0])) * col(nrm[1]), -5.0, 5.0)
    z1 = w1t @ xn + col(bias[:, 0])
    h1, rstd1, y1 = _ln_fwd(z1, col(bias[:, 1]), col(bias[:, 2]))
    a1 = torch.clamp(y1, min=0.0)
    z2 = w2t @ a1 + col(bias[:, 3])
    h2, rstd2, y2 = _ln_fwd(z2, col(bias[:, 4]), col(bias[:, 5]))
    a2 = torch.clamp(y2, min=0.0)
    out = wht @ a2 + col(bias[0:N_OUT, 6])
    lg, value = out[0:N_LOGITS], out[N_LOGITS]

    M = lg.max(dim=0, keepdim=True).values
    E = torch.exp(lg - M)
    S = _seg_sum(E)                                   # (NB, R)
    p = E / _seg_bcast(S)
    logz_b = torch.log(S) + M
    lognorm = lg - _seg_bcast(logz_b)                 # log p
    target = _seg_bcast(base + act)
    rows = torch.arange(N_LOGITS, device=dev, dtype=F32)[:, None]
    oh = (rows == target).to(F32)
    logp_new = (oh * lognorm).sum(dim=0)
    HB = _seg_bcast(-_seg_sum(p * lognorm))

    ratio = torch.exp(logp_new - lp_old)
    surr1 = -adv * ratio
    surr2 = -adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    inb = (ratio >= 1.0 - clip) & (ratio <= 1.0 + clip)
    dratio = torch.where(surr1 >= surr2, -adv,
                         torch.where(inb, -adv, torch.zeros_like(adv)))
    dlogp = dratio * ratio * inv_mb
    if hp.clip_vloss:
        vf = (value - ret) ** 2
        dv = value - v_old
        dv_in = (dv >= -clip) & (dv <= clip)
        vclip = v_old + torch.clamp(dv, -clip, clip)
        vfc = (vclip - ret) ** 2
        dvalue = torch.where(vf >= vfc, value - ret,
                             torch.where(dv_in, vclip - ret,
                                         torch.zeros_like(ret)))
        dvalue = dvalue * (hp.vf_coef * inv_mb)
    else:
        dvalue = (value - ret) * (hp.vf_coef * inv_mb)
    dlg = dlogp[None, :] * (oh - p) + \
        (hp.ent_coef * inv_mb) * p * (lognorm + HB)
    dout = torch.cat([dlg, dvalue[None, :]], dim=0)

    da2 = wht.T @ dout
    dwh = dout @ a2.T
    dbh = dout.sum(dim=1)
    dz2, dg2, dbe2 = _ln_bwd(da2 * (y2 > 0.0), h2, rstd2, col(bias[:, 4]))
    dw2 = dz2 @ a1.T
    da1 = w2t.T @ dz2
    dz1, dg1, dbe1 = _ln_bwd(da1 * (y1 > 0.0), h1, rstd1, col(bias[:, 1]))
    dw1 = dz1 @ xn.T
    zero = torch.zeros((H,), dtype=F32, device=dev)
    dbias = torch.stack([dz1.sum(dim=1), dg1, dbe1, dz2.sum(dim=1), dg2, dbe2,
                         torch.nn.functional.pad(dbh, (0, H - N_OUT)), zero],
                        dim=1)
    return dw1, dw2, dwh, dbias


def minibatch_grad_plain(hp, feat, nrm, w1t, w2t, wht, bias):
    """Plain version of kernel H: one minibatch's gradient over a
    row-major (mb, F >= FEAT_COLS) feat matrix whose columns are
    obs 0:103 | actions | logp | value_n | advantage | return_n."""
    ft = feat.T
    return block_grads_plain(hp, 1.0 / feat.shape[0], ft[0:D],
                             ft[D:D + NB], ft[D + NB], ft[D + NB + 1],
                             ft[D + NB + 2], ft[D + NB + 3], nrm, w1t, w2t,
                             wht, bias)


def gather_blocks(idx, traj, side, wb: int):
    """The blocks `idx` of a (T, rows, W) trajectory and its side array,
    concatenated along the samples: block b is tick b // (W / wb),
    worlds (b % (W / wb)) * wb onward.  Returns (traj rows 0..R_LOGP,
    side rows) as ((R_LOGP + 1, n), (SIDE_ROWS, n))."""
    wblk = traj.shape[2] // wb
    t = (idx // wblk).long()
    w0 = (idx % wblk).long() * wb
    cols = w0[:, None] + torch.arange(wb, device=idx.device)[None, :]
    tb = traj[t[:, None], 0:R_LOGP + 1, cols]        # (n_blk, wb, rows)
    sb = side[t[:, None], :, cols]
    return (tb.reshape(-1, R_LOGP + 1).T, sb.reshape(-1, sb.shape[-1]).T)


def normalize_side(side, ustats):
    """Raw side rows [value_un, adv, ret] -> [value_n, adv_n, ret_n] from
    ustats (1, 8) = [v_mean', v_rstd', adv_mean, adv_rscale, 0...]
    (the normalization of the JAX phase kernel, fused_update.py:551-557)."""
    vm, vr, am, ar = ustats[0, 0], ustats[0, 1], ustats[0, 2], ustats[0, 3]
    out = torch.zeros_like(side)
    out[:, SIDE_VALUE] = torch.clamp((side[:, SIDE_VALUE] - vm) * vr,
                                     -5.0, 5.0)
    out[:, SIDE_ADV] = (side[:, SIDE_ADV] - am) * ar
    out[:, SIDE_RET] = torch.clamp((side[:, SIDE_RET] - vm) * vr, -5.0, 5.0)
    return out


def minibatch_grad_prefetch_plain(hp, idx, traj, side, nrm, w1t, w2t, wht,
                                  bias, *, wb: int):
    """Plain version of kernel G: one minibatch's gradient over the
    (tick, world-block) blocks `idx`, side rows already normalized."""
    if idx.shape[0] * wb != hp.minibatch_size:
        raise ValueError(f"{idx.shape[0]} blocks of {wb} samples != "
                         f"minibatch_size {hp.minibatch_size}")
    tb, sb = gather_blocks(idx, traj, side, wb)
    return block_grads_plain(hp, 1.0 / hp.minibatch_size, tb[0:D],
                             tb[R_ACT:R_ACT + NB], tb[R_LOGP],
                             sb[SIDE_VALUE], sb[SIDE_ADV], sb[SIDE_RET], nrm,
                             w1t, w2t, wht, bias)


def _phase_geometry(hp, idx, traj, side, wb):
    T, rows, W = traj.shape
    if W % wb or hp.minibatch_size % wb:
        raise ValueError(f"update block {wb} must divide num_envs {W} and "
                         f"minibatch_size {hp.minibatch_size}")
    if hp.num_minibatches * hp.minibatch_size != T * W:
        raise ValueError(
            f"num_minibatches={hp.num_minibatches} must divide the rollout "
            f"batch ({T}*{W}={T * W} samples) exactly for the update phase")
    n_mb = hp.update_epochs * hp.num_minibatches
    bpm = hp.minibatch_size // wb
    if idx.shape != (n_mb * bpm,) or idx.dtype != I32:
        raise ValueError(f"idx must be ({n_mb * bpm},) int32")
    if traj.dtype != F32 or rows <= R_LOGP:
        raise ValueError("traj must be (T, rows > R_LOGP, W) float32")
    if side.shape != (T, SIDE_ROWS, W) or side.dtype != F32:
        raise ValueError(f"side must be ({T}, {SIDE_ROWS}, {W}) float32")
    return n_mb, bpm


def _check_mats(*mat_sets):
    for ms in mat_sets:
        if tuple(tuple(m.shape) for m in ms) != SHAPES or \
                any(m.dtype != F32 for m in ms):
            raise ValueError(f"weights and moments must be float32 of "
                             f"shapes {SHAPES}")


@torch.no_grad()
def update_phase_plain(hp, idx, count: int, traj, side, nrm, ustats,
                       params, mu, nu, *, wb: int):
    """Plain version of kernel D: E x M minibatches, each the gradient of
    its `wb`-wide blocks of `idx` then `clip_adam_step` with step
    count + k + 1.  `ustats` None means the side rows are already
    normalized.  Returns (params', mu', nu') as tuples of 4 tensors."""
    n_mb, bpm = _phase_geometry(hp, idx, traj, side, wb)
    _check_mats(params, mu, nu)
    side_n = side if ustats is None else normalize_side(side, ustats)
    params, mu, nu = tuple(params), tuple(mu), tuple(nu)
    for k in range(n_mb):
        g = minibatch_grad_prefetch_plain(hp, idx[k * bpm:(k + 1) * bpm],
                                          traj, side_n, nrm, *params, wb=wb)
        params, mu, nu = clip_adam_step(params, mu, nu, g, count + k + 1,
                                        lr=hp.learning_rate,
                                        max_norm=hp.max_grad_norm)
    return params, mu, nu


# =====================================================================
# Kernel wrappers
# =====================================================================

launches = {"fused_update_phase": 0, "fused_minibatch_grad_prefetch": 0,
            "fused_minibatch_grad": 0}  # wrapper calls that launched
device_launches = 0  # D's device launches (D1 + D2 per minibatch)


def _flat(mats):
    return torch.cat([m.reshape(-1) for m in mats]).contiguous()


def _split(flat):
    out, o = [], 0
    for r, c in SHAPES:
        out.append(flat[o:o + r * c].reshape(r, c))
        o += r * c
    return tuple(out)


def _loss_args(hp):
    return (float(hp.clip_coef), float(hp.vf_coef), float(hp.ent_coef),
            1 if hp.clip_vloss else 0)


def _lib(t, **others):
    """The kernel library, after checking that every tensor lies on the
    CUDA device of `t`."""
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    from .. import _build
    _build.check_device(t.device, **others)
    return _build, _build.load("fused_update")


GRAD_CTAS = 128  # CTAs of one gradient launch: rows of the partial sums


def _partials(dev):
    return torch.empty((GRAD_CTAS, N_PARAMS), dtype=F32, device=dev)


def fused_minibatch_grad(hp, feat, nrm, w1t, w2t, wht, bias):
    """Kernel H on CUDA tensors, `minibatch_grad_plain` on CPU tensors."""
    mb, F = feat.shape
    if feat.dtype != F32 or F < FEAT_COLS:
        raise ValueError(f"feat must be (mb, F >= {FEAT_COLS}) float32")
    _check_mats((w1t, w2t, wht, bias))
    if feat.device.type == "cpu":
        return minibatch_grad_plain(hp, feat, nrm, w1t, w2t, wht, bias)
    _b, lib = _lib(feat, nrm=nrm, w1t=w1t, w2t=w2t, wht=wht, bias=bias)
    dev = feat.device
    feat, nrm = feat.contiguous(), nrm.contiguous()
    params = _flat((w1t, w2t, wht, bias))
    grads = torch.empty((N_PARAMS,), dtype=F32, device=dev)
    err = lib.mbb_fused_minibatch_grad(
        _b.ptr(feat), _b.ptr(nrm), _b.ptr(params), _b.ptr(grads),
        _b.ptr(_partials(dev)), GRAD_CTAS, mb, F, *_loss_args(hp),
        _b.stream(dev))
    _b.check(err, "fused_update")
    launches["fused_minibatch_grad"] += 1
    return _split(grads)


def fused_minibatch_grad_prefetch(hp, idx, traj, side, nrm, w1t, w2t, wht,
                                  bias, *, wb: int):
    """Kernel G on CUDA tensors, `minibatch_grad_prefetch_plain` on CPU
    tensors."""
    if idx.dtype != I32 or idx.shape[0] * wb != hp.minibatch_size:
        raise ValueError(f"idx must be ({hp.minibatch_size // wb},) int32")
    _check_mats((w1t, w2t, wht, bias))
    if traj.device.type == "cpu":
        return minibatch_grad_prefetch_plain(hp, idx, traj, side, nrm, w1t,
                                             w2t, wht, bias, wb=wb)
    _b, lib = _lib(traj, idx=idx, side=side, nrm=nrm, w1t=w1t, w2t=w2t,
                   wht=wht, bias=bias)
    _, rows, W = traj.shape
    dev = traj.device
    idx, traj, side, nrm = (x.contiguous() for x in (idx, traj, side, nrm))
    params = _flat((w1t, w2t, wht, bias))
    grads = torch.empty((N_PARAMS,), dtype=F32, device=dev)
    err = lib.mbb_fused_minibatch_grad_prefetch(
        _b.ptr(idx), _b.ptr(traj), _b.ptr(side), _b.ptr(nrm),
        _b.ptr(params), _b.ptr(grads), _b.ptr(_partials(dev)), GRAD_CTAS,
        rows, W, wb, hp.minibatch_size // wb, *_loss_args(hp),
        _b.stream(dev))
    _b.check(err, "fused_update")
    launches["fused_minibatch_grad_prefetch"] += 1
    return _split(grads)


def fused_update_phase(hp, idx, count: int, traj, side, nrm, ustats, params,
                       mu, nu, *, wb: int):
    """Kernel D on CUDA tensors, `update_phase_plain` on CPU tensors.

    idx (E * T * W / wb,) int32: each epoch's permutation of the blocks,
    epochs in order; count: Adam steps taken so far; ustats (1, 8) for
    raw side rows or None for normalized ones; params / mu / nu: 4
    kernel-orientation tensors each.  Returns new (params', mu', nu');
    the inputs are not modified.  One C call issues the phase's
    2 x E x M device launches."""
    global device_launches
    if traj.device.type == "cpu":
        return update_phase_plain(hp, idx, count, traj, side, nrm, ustats,
                                  params, mu, nu, wb=wb)
    n_mb, bpm = _phase_geometry(hp, idx, traj, side, wb)
    _check_mats(params, mu, nu)
    if ustats is not None and (ustats.shape != (1, 8) or
                               ustats.dtype != F32):
        raise ValueError("ustats must be (1, 8) float32")
    _b, lib = _lib(traj, idx=idx, side=side, nrm=nrm, ustats=ustats,
                   **{f"params[{i}]": m for i, m in enumerate(params)},
                   **{f"mu[{i}]": m for i, m in enumerate(mu)},
                   **{f"nu[{i}]": m for i, m in enumerate(nu)})
    _, rows, W = traj.shape
    dev = traj.device
    idx, traj, side, nrm = (x.contiguous() for x in (idx, traj, side, nrm))
    us = None if ustats is None else ustats.contiguous()
    p, m, v = _flat(params), _flat(mu), _flat(nu)
    err = lib.mbb_fused_update_phase(
        _b.ptr(idx), int(count), _b.ptr(traj), _b.ptr(side), _b.ptr(nrm),
        _b.ptr(us), _b.ptr(p), _b.ptr(m), _b.ptr(v), _b.ptr(_partials(dev)),
        GRAD_CTAS, rows, W, wb, bpm, n_mb, *_loss_args(hp),
        float(hp.learning_rate), float(hp.max_grad_norm), _b.stream(dev))
    _b.check(err, "fused_update")
    launches["fused_update_phase"] += 1
    device_launches += 2 * n_mb
    return _split(p), _split(m), _split(v)
