"""The plain GAE, value / return / advantage block moments, episode-stat
carry and windowed meters of the reference.

A frozen copy of the port's plain versions
(`madrona_basketball_tpu_torch/ops/fused_gae.py::gae_plain`,
`combine_block_moments`, `pick_gae_block`;
`madrona_basketball_tpu_torch/ppo/train.py::meter_scan_plain`).
"""

from __future__ import annotations

import torch

F32 = torch.float32
SIDE_VALUE, SIDE_ADV, SIDE_RET = 0, 1, 2
SIDE_ROWS = 8
GAE_BLOCK_CAP = 128


def pick_gae_block(W: int, cap: int = GAE_BLOCK_CAP) -> int:
    for cand in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if cand <= cap and W % cand == 0:
            return cand
    raise AssertionError("unreachable: 1 divides every W")


def combine_block_moments(means, m2s, n_per: float):
    """Equal-count per-block (mean, M2) -> (mean, unbiased var, count)."""
    k = means.shape[0]
    n_total = n_per * k
    gmean = means.mean()
    m2 = m2s.sum() + n_per * ((means - gmean) ** 2).sum()
    var = m2 / max(n_total - 1.0, 1.0)
    return gmean, var, n_total


@torch.no_grad()
def gae(traj, carry, next_value_n, vstats, *, gamma: float, lam: float,
        r_value: int, r_rew: int, r_done: int):
    """(side (T, 8, W), moments (nb, 8), carry' (2, W), ticks (nb, T, 8))
    of a float32 trajectory."""
    T, _, W = traj.shape
    gb = pick_gae_block(W)
    nb = W // gb
    vmean, vsig = vstats[0, 0], vstats[0, 1]
    vals, rew, dn = (traj[:, r] for r in (r_value, r_rew, r_done))
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


def _meter_update(mean, cur_size, values_sum, count, max_size=100.0):
    has = count > 0
    new_mean = torch.where(has, values_sum / torch.clamp(count, min=1.0),
                           0.0)
    size = torch.clamp(count, max=max_size)
    old_size = torch.minimum(max_size - size, cur_size)
    total = old_size + size
    merged = torch.where(has, (mean * old_size + new_mean * size) /
                         torch.clamp(total, min=1.0), mean)
    return merged, torch.where(has, total, cur_size)


def meter_scan(ticks, meters):
    """ticks (nb, T, 8) -> the reward and length meters (4,) after T
    updates of meters (4,) [reward mean, window, length mean, window]."""
    per_t = ticks.sum(dim=0)
    r_mean, r_size, l_mean, l_size = meters.unbind()
    for t in range(per_t.shape[0]):
        r_mean, r_size = _meter_update(r_mean, r_size, per_t[t, 1],
                                       per_t[t, 0])
        l_mean, l_size = _meter_update(l_mean, l_size, per_t[t, 2],
                                       per_t[t, 0])
    return torch.stack([r_mean, r_size, l_mean, l_size])
