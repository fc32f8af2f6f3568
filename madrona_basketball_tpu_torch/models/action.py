"""Multi-bucket discrete action distributions (port of
`madrona_basketball_tpu.models.action`, action.py:27-81).

Logits (B, 19) split into buckets [2, 8, 3, 2, 2, 2].  Sampling is
Gumbel-max with one Gumbel tensor over the whole logit row; the Gumbel
noise is passed in (tests inject it, the rollout kernel draws it), and
ties resolve to the first maximal index like `jnp.argmax`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import constants as C

I32 = torch.int32


def _slices(buckets: Sequence[int]):
    off = 0
    for n in buckets:
        yield off, n
        off += n


def _first_argmax(x):
    """argmax over the last axis, first index on ties."""
    m = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == m, idx, x.shape[-1]).min(dim=-1).values


def _select(logp, act):
    return torch.gather(logp, -1, act[:, None].long())[:, 0]


def sample(gumbel: torch.Tensor, logits: torch.Tensor,
           buckets: Sequence[int] = C.ACTION_BUCKETS):
    """(actions (B, K) i32, log_probs (B, K)) from an injected Gumbel
    tensor of the logits' shape."""
    noisy = logits + gumbel
    actions, lps = [], []
    for off, n in _slices(buckets):
        act = _first_argmax(noisy[:, off:off + n])
        logp = torch.log_softmax(logits[:, off:off + n], dim=-1)
        lps.append(_select(logp, act))
        actions.append(act)
    return torch.stack(actions, dim=1).to(I32), torch.stack(lps, dim=1)


def best(logits: torch.Tensor, buckets: Sequence[int] = C.ACTION_BUCKETS):
    return torch.stack([_first_argmax(logits[:, off:off + n])
                        for off, n in _slices(buckets)], dim=1).to(I32)


def action_stats(logits: torch.Tensor, actions: torch.Tensor,
                 buckets: Sequence[int] = C.ACTION_BUCKETS):
    """(log_probs (B, K), entropies (B, K)) of `actions` (action.py:70-81,
    scripts/action.py:35-42); differentiable in the logits."""
    lps, ents = [], []
    for i, (off, n) in enumerate(_slices(buckets)):
        logp = torch.log_softmax(logits[:, off:off + n], dim=-1)
        lps.append(_select(logp, actions[:, i]))
        ents.append(-(logp.exp() * logp).sum(dim=-1))
    return torch.stack(lps, dim=1), torch.stack(ents, dim=1)


def log_probs(logits: torch.Tensor, actions: torch.Tensor,
              buckets: Sequence[int] = C.ACTION_BUCKETS):
    lps = []
    for i, (off, n) in enumerate(_slices(buckets)):
        logp = torch.log_softmax(logits[:, off:off + n], dim=-1)
        lps.append(_select(logp, actions[:, i]))
    return torch.stack(lps, dim=1)
