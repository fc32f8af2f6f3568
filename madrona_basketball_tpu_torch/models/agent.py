"""Actor-critic policy (port of `madrona_basketball_tpu.models.agent`,
agent.py:9-117).

2 x (Linear 32 -> LayerNorm eps 1e-6 -> ReLU), a 19-logit actor head and
a scalar critic head.  Init keeps the reference's quirk:
variance_scaling(2/3, fan_in, normal) for the backbone (kaiming_normal_
called with sqrt(2) as its negative slope, scripts/agent.py:98) and
orthogonal(0.01) heads with zero biases.  The normalizers ride beside
the module in `Agent`, as `AgentParams` does in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from .. import constants as C
from . import action as action_dist
from .normalize import RMSState, rms_init, rms_normalize, rms_unnormalize

F32 = torch.float32
LN_EPS = 1e-6  # flax nn.LayerNorm default


class ActorCritic(nn.Module):
    def __init__(self, obs_dim: int = C.OBS_SIZE, num_channels: int = 32,
                 num_layers: int = 2,
                 action_dim: int = sum(C.ACTION_BUCKETS)):
        super().__init__()
        layers = []
        d = obs_dim
        for _ in range(num_layers):
            layers += [nn.Linear(d, num_channels),
                       nn.LayerNorm(num_channels, eps=LN_EPS), nn.ReLU()]
            d = num_channels
        self.backbone = nn.Sequential(*layers)
        self.actor = nn.Linear(d, action_dim)
        self.critic = nn.Linear(d, 1)

    @torch.no_grad()
    def reset_parameters_like_reference(self, gen: torch.Generator):
        for m in self.backbone:
            if isinstance(m, nn.Linear):
                # variance_scaling(2/3, "fan_in", "normal"): N(0, 2/3/fan_in)
                w = torch.empty_like(m.weight, device="cpu")
                nn.init.normal_(w, 0.0, math.sqrt(2.0 / 3.0 / m.in_features),
                                generator=gen)
                m.weight.copy_(w)
                m.bias.zero_()
        for head in (self.actor, self.critic):
            w = torch.empty_like(head.weight, device="cpu")
            nn.init.orthogonal_(w, gain=0.01, generator=gen)
            head.weight.copy_(w)
            head.bias.zero_()

    def forward(self, x):
        h = self.backbone(x)
        return self.actor(h), self.critic(h)[..., 0]


def layers(net: ActorCritic):
    """The backbone's Linear and LayerNorm modules, each list in order."""
    return ([m for m in net.backbone if isinstance(m, nn.Linear)],
            [m for m in net.backbone if isinstance(m, nn.LayerNorm)])


@dataclasses.dataclass
class Agent:
    """Network weights + both normalizer states (what the reference
    checkpoints, scripts/ppo.py:343)."""
    net: ActorCritic
    obs_rms: RMSState
    value_rms: RMSState


def init_agent(gen: torch.Generator, device="cuda",
               obs_dim: int = C.OBS_SIZE) -> Agent:
    net = ActorCritic(obs_dim=obs_dim)
    net.reset_parameters_like_reference(gen)
    return Agent(net=net.to(device), obs_rms=rms_init(obs_dim, device),
                 value_rms=rms_init(1, device))


@torch.no_grad()
def forward(ap: Agent, obs, gumbel=None,
            buckets: Sequence[int] = C.ACTION_BUCKETS):
    """(actions, summed log-probs, value) - scripts/agent.py:140-154.
    With `gumbel` given it samples (Gumbel-max); without, it takes the
    per-bucket argmax."""
    x = rms_normalize(ap.obs_rms, obs, clamp=5.0)
    logits, value = ap.net(x)
    if gumbel is not None:
        actions, lps = action_dist.sample(gumbel, logits, buckets)
    else:
        actions = action_dist.best(logits, buckets)
        lps = action_dist.log_probs(logits, actions, buckets)
    return actions, lps.sum(dim=-1), value


@torch.no_grad()
def evaluate(ap: Agent, obs):
    """Critic-only forward (scripts/agent.py:168-170)."""
    x = rms_normalize(ap.obs_rms, obs, clamp=5.0)
    return ap.net(x)[1]


def unnorm_value(ap: Agent, values):
    return rms_unnormalize(ap.value_rms, values[..., None],
                           clamp=5.0)[..., 0]
