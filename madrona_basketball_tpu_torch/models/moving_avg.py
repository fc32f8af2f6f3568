"""EMA mean / variance normalizer (port of
`madrona_basketball_tpu.models.moving_avg`, moving_avg.py:19-65).

Functional port of the reference's `EMANormalizer` (scripts/moving_avg.py:
7-106), defined there and importable but unused by the training path and
kept for capability parity: bias-corrected exponential moving estimates
of the mean and sigma, in float32.
"""

from __future__ import annotations

import dataclasses

import torch

F32 = torch.float32


@dataclasses.dataclass
class EMAState:
    mu: torch.Tensor               # ()
    inv_sigma: torch.Tensor        # ()
    sigma: torch.Tensor            # ()
    mu_biased: torch.Tensor        # ()
    sigma_sq_biased: torch.Tensor  # ()
    n: torch.Tensor                # () update count, float32
    decay: torch.Tensor            # ()
    eps: float = 1e-5


def ema_init(decay: float, eps: float = 1e-5, device="cuda") -> EMAState:
    def z():
        return torch.zeros((), dtype=F32, device=device)
    return EMAState(mu=z(), inv_sigma=z(), sigma=z(), mu_biased=z(),
                    sigma_sq_biased=z(), n=z(),
                    decay=torch.tensor(decay, dtype=F32, device=device),
                    eps=eps)


def ema_update(st: EMAState, x: torch.Tensor) -> EMAState:
    """One training-mode forward's statistics update
    (scripts/moving_avg.py:63-96)."""
    x = x.to(F32)
    n = st.n + 1.0
    one_minus_decay = 1.0 - st.decay
    bias_correction = -torch.expm1(n * torch.log(st.decay))

    mu_biased = st.mu_biased * st.decay + x.mean() * one_minus_decay
    new_mu = mu_biased / bias_correction

    prev_mu = torch.where(n == 1.0, new_mu, st.mu)
    sigma_sq_new = ((x - prev_mu) * (x - new_mu)).mean()
    sigma_sq_biased = (st.sigma_sq_biased * st.decay +
                       sigma_sq_new * one_minus_decay)
    sigma_sq = sigma_sq_biased / bias_correction

    inv_sigma = torch.rsqrt(torch.clamp(sigma_sq, min=st.eps))
    return dataclasses.replace(st, mu=new_mu, inv_sigma=inv_sigma,
                               sigma=1.0 / inv_sigma, mu_biased=mu_biased,
                               sigma_sq_biased=sigma_sq_biased, n=n)


def ema_normalize(st: EMAState, x: torch.Tensor) -> torch.Tensor:
    return (-st.mu * st.inv_sigma + x * st.inv_sigma).to(x.dtype)


def ema_unnormalize(st: EMAState, x: torch.Tensor) -> torch.Tensor:
    return (st.mu + x.to(F32) * st.sigma).to(x.dtype)
