"""Generalized Advantage Estimation, plain reverse loop (port of
`madrona_basketball_tpu.ops.gae.compute_gae`, gae.py:15-39).

It keeps the reference's boundary quirk (scripts/ppo.py:156-161): at
t = T-1 the non-terminal mask is not_dones[T-1] (not not_dones[T]),
paired with the bootstrap value.  The independent reference for
kernel C (ops/fused_gae.py).
"""

from __future__ import annotations

import torch


def compute_gae(rewards, values, not_dones, next_value, gamma: float,
                gae_lambda: float):
    """All inputs (T, N) except next_value (N,), values unnormalized;
    returns (advantages, returns)."""
    next_values = torch.cat([values[1:], next_value[None]], dim=0)
    nnt = torch.cat([not_dones[1:], not_dones[-1:]], dim=0)
    deltas = rewards + gamma * next_values * nnt - values
    advs = torch.empty_like(deltas)
    last = torch.zeros_like(next_value)
    for t in reversed(range(rewards.shape[0])):
        last = deltas[t] + gamma * gae_lambda * nnt[t] * last
        advs[t] = last
    return advs, advs + values
