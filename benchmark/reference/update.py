"""The plain update of the reference: every epoch x minibatch of the PPO
loss's forward and hand-derived backward, then the global-norm clip and
Adam (optax's formulas).

A frozen copy of the port's plain version of kernel D
(`madrona_basketball_tpu_torch/ops/fused_update.py`: `block_grads_plain`
without its kink report, `gather_blocks`, `normalize_side`,
`_update_phase`; `ppo/train.py::clip_adam_step`).  Its Dense products go
through `precision.mm`.  Weights are the packed kernel-orientation
matrices (w1t (32, 103), w2t (32, 32), wht (20, 32), bias (32, 8)).
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from . import precision
from .gae import SIDE_ADV, SIDE_RET, SIDE_VALUE

F32 = torch.float32
I32 = torch.int32
BUCKETS = tuple(C.ACTION_BUCKETS)
N_LOGITS = sum(BUCKETS)           # 19
N_OUT = N_LOGITS + 1              # actor rows + value row
NB = len(BUCKETS)                 # 6
H = 32
D = C.OBS_USED                    # 103
R_ACT = D
R_LOGP = D + NB
LN_EPS = 1e-6
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

_BASE = np.cumsum((0,) + BUCKETS[:-1])
_BUCKET_OF = np.repeat(np.arange(NB), BUCKETS)


def pick_update_block(W: int, mb_size: int, cap: int = 4096) -> int:
    g = np.gcd(W, mb_size)
    for cand in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if cand <= cap and g % cand == 0:
            return cand
    raise AssertionError("unreachable: 1 divides every gcd")


def _seg_sum(x):
    sums = []
    for o, n in zip(_BASE.tolist(), BUCKETS):
        acc = x[o]
        for j in range(o + 1, o + n):
            acc = acc + x[j]
        sums.append(acc)
    return torch.stack(sums)


def _seg_bcast(x):
    return x[torch.as_tensor(_BUCKET_OF, device=x.device)]


def _unit_sum(x):
    n = x.shape[0] // 4
    runs = []
    for r in range(4):
        acc = x[r * n]
        for u in range(r * n + 1, (r + 1) * n):
            acc = acc + x[u]
        runs.append(acc)
    return (runs[0] + runs[1] + runs[2] + runs[3])[None]


def _ln_fwd(z, scale, bias):
    inv = 1.0 / z.shape[0]
    mu = _unit_sum(z) * inv
    mu2 = _unit_sum(z * z) * inv
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
def block_grads(hp, inv_mb, obs, act, lp_old, v_old, adv, ret, nrm,
                w1t, w2t, wht, bias):
    """The loss's gradients (dw1t, dw2t, dwht, dbias) summed over the R
    feature-major samples, each sample's terms scaled by inv_mb."""
    dev = obs.device
    base = torch.as_tensor(_BASE, dtype=F32, device=dev)[:, None]
    clip = hp.clip_coef

    def col(v):
        return v[:, None]

    xn = torch.clamp((obs - col(nrm[0])) * col(nrm[1]), -5.0, 5.0)
    z1 = precision.mm(w1t, xn) + col(bias[:, 0])
    h1, rstd1, y1 = _ln_fwd(z1, col(bias[:, 1]), col(bias[:, 2]))
    a1 = torch.clamp(y1, min=0.0)
    z2 = precision.mm(w2t, a1) + col(bias[:, 3])
    h2, rstd2, y2 = _ln_fwd(z2, col(bias[:, 4]), col(bias[:, 5]))
    a2 = torch.clamp(y2, min=0.0)
    out = precision.mm(wht, a2) + col(bias[0:N_OUT, 6])
    lg, value = out[0:N_LOGITS], out[N_LOGITS]

    M = lg.max(dim=0, keepdim=True).values
    E = torch.exp(lg - M)
    S = _seg_sum(E)
    p = E / _seg_bcast(S)
    logz_b = torch.log(S) + M
    lognorm = lg - _seg_bcast(logz_b)
    target = _seg_bcast(base + act)
    rows = torch.arange(N_LOGITS, device=dev, dtype=F32)[:, None]
    oh = (rows == target).to(F32)
    logp_new = (oh * lognorm).sum(dim=0)
    HB = _seg_bcast(-_seg_sum(p * lognorm))

    ratio = torch.exp(logp_new - lp_old)
    surr1 = -adv * ratio
    surr2 = -adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    inb = (ratio >= 1.0 - clip) & (ratio <= 1.0 + clip)
    take1 = surr1 >= surr2
    dratio = torch.where(take1, -adv,
                         torch.where(inb, -adv, torch.zeros_like(adv)))
    dlogp = dratio * ratio * inv_mb
    if hp.clip_vloss:
        vf = (value - ret) ** 2
        dv = value - v_old
        dv_in = (dv >= -clip) & (dv <= clip)
        vclip = v_old + torch.clamp(dv, -clip, clip)
        vfc = (vclip - ret) ** 2
        takev = vf >= vfc
        dvalue = torch.where(takev, value - ret,
                             torch.where(dv_in, vclip - ret,
                                         torch.zeros_like(ret)))
        dvalue = dvalue * (hp.vf_coef * inv_mb)
    else:
        dvalue = (value - ret) * (hp.vf_coef * inv_mb)
    dlg = dlogp[None, :] * (oh - p) + \
        (hp.ent_coef * inv_mb) * p * (lognorm + HB)
    dout = torch.cat([dlg, dvalue[None, :]], dim=0)

    da2 = precision.mm(wht.T, dout)
    dwh = precision.mm(dout, a2.T)
    dbh = dout.sum(dim=1)
    dz2, dg2, dbe2 = _ln_bwd(da2 * (y2 > 0.0), h2, rstd2, col(bias[:, 4]))
    dw2 = precision.mm(dz2, a1.T)
    da1 = precision.mm(w2t.T, dz2)
    dz1, dg1, dbe1 = _ln_bwd(da1 * (y1 > 0.0), h1, rstd1, col(bias[:, 1]))
    dw1 = precision.mm(dz1, xn.T)
    zero = torch.zeros((H,), dtype=F32, device=dev)
    dbias = torch.stack([dz1.sum(dim=1), dg1, dbe1, dz2.sum(dim=1), dg2, dbe2,
                         torch.nn.functional.pad(dbh, (0, H - N_OUT)), zero],
                        dim=1)
    return dw1, dw2, dwh, dbias


def gather_blocks(idx, traj, side, wb: int):
    """The (tick, world-block) blocks `idx` as (traj rows 0..R_LOGP,
    side rows), samples along axis 1."""
    wblk = traj.shape[2] // wb
    t = (idx // wblk).long()
    w0 = (idx % wblk).long() * wb
    cols = w0[:, None] + torch.arange(wb, device=idx.device)[None, :]
    tb = traj[t[:, None], 0:R_LOGP + 1, cols]
    sb = side[t[:, None], :, cols]
    return (tb.reshape(-1, R_LOGP + 1).T.to(F32),
            sb.reshape(-1, sb.shape[-1]).T)


def normalize_side(side, ustats):
    vm, vr, am, ar = ustats[0, 0], ustats[0, 1], ustats[0, 2], ustats[0, 3]
    out = torch.zeros_like(side)
    out[:, SIDE_VALUE] = torch.clamp((side[:, SIDE_VALUE] - vm) * vr,
                                     -5.0, 5.0)
    out[:, SIDE_ADV] = (side[:, SIDE_ADV] - am) * ar
    out[:, SIDE_RET] = torch.clamp((side[:, SIDE_RET] - vm) * vr, -5.0, 5.0)
    return out


@torch.no_grad()
def clip_adam_step(params, mu, nu, grads, t: int, *, lr: float,
                   max_norm: float):
    """optax clip_by_global_norm(max_norm) then adam(lr, eps=1e-8) at
    step count t (after the step)."""
    gn = torch.sqrt(sum((g * g).sum() for g in grads))
    small = gn < max_norm
    tt = torch.tensor(float(t), dtype=F32)
    bc1 = (1.0 - torch.full_like(tt, ADAM_B1) ** tt).to(gn.device)
    bc2 = (1.0 - torch.full_like(tt, ADAM_B2) ** tt).to(gn.device)
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


@torch.no_grad()
def update_phase(hp, idx, count: int, traj, side, nrm, ustats, params, mu,
                 nu, *, wb: int):
    """E x M minibatches of the blocks `idx` (int32, whole minibatches in
    order): each one's gradient, then the clip and Adam at step count +
    k + 1.  Returns (params', mu', nu', the first minibatch's gradient)."""
    bpm = hp.minibatch_size // wb
    side_n = normalize_side(side, ustats)
    inv_mb = 1.0 / hp.minibatch_size
    first = None
    for k in range(idx.numel() // bpm):
        tb, sb = gather_blocks(idx[k * bpm:(k + 1) * bpm], traj, side_n, wb)
        g = block_grads(hp, inv_mb, tb[0:D], tb[R_ACT:R_ACT + NB],
                        tb[R_LOGP], sb[SIDE_VALUE], sb[SIDE_ADV],
                        sb[SIDE_RET], nrm, *params)
        first = g if first is None else first
        params, mu, nu = clip_adam_step(params, mu, nu, g, count + k + 1,
                                        lr=hp.learning_rate,
                                        max_norm=hp.max_grad_norm)
    return params, mu, nu, first
