"""Agent controllers: RL policy / human keyboard / hard-coded rules (port
of `madrona_basketball_tpu.controllers`, controllers.py:1-89;
scripts/controllers.py:5-93).

A controller maps one observation vector (128,) to a 6-int action; the
manager hands world 0's selected agent to the keyboard while human
control is on, for interactive training and evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.agent import Agent, forward
from .ops.fused_rollout import N_LOGITS, gumbel_from_uniform

F32 = torch.float32


class Controller:
    """Base class for all methods of controlling an agent."""

    def get_action(self, obs, viewer_instance=None):
        raise NotImplementedError


class RLController(Controller):
    """Runs the policy (`models/agent.py::forward`, Gumbel-max sampling)
    on a single observation.  Each call draws one (1, 19) uniform from a
    `torch.Generator` seeded `seed` on the agent's device, or, with the
    `gumbel` seam, takes the next (1, 19) Gumbel draw (an iterator, or a
    callable returning one)."""

    def __init__(self, agent: Agent, seed: int = 0, gumbel=None):
        self.agent = agent
        dev = next(agent.net.parameters()).device
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.gumbel = gumbel

    @torch.no_grad()
    def get_action(self, obs, viewer_instance=None):
        dev = self.gen.device
        obs = torch.tensor(np.asarray(obs), dtype=F32,
                           device=dev).reshape(1, -1)
        if self.gumbel is not None:
            g = self.gumbel() if callable(self.gumbel) else next(self.gumbel)
            g = torch.tensor(np.asarray(g), dtype=F32,
                             device=dev).reshape(1, N_LOGITS)
        else:
            g = gumbel_from_uniform(torch.rand((1, N_LOGITS),
                                               generator=self.gen,
                                               dtype=F32, device=dev))
        actions, _, _ = forward(self.agent, obs, g)
        return actions[0].cpu().numpy()


class HumanController(Controller):
    """Keyboard input through the viewer (scripts/controllers.py:65-81)."""

    def get_action(self, obs, viewer_instance=None):
        if viewer_instance is not None:
            return np.asarray(viewer_instance.get_human_action(),
                              dtype=np.int32)
        return np.zeros(6, np.int32)


class RulesController(Controller):
    """Hard-coded policy: shoot when holding the ball, else try to grab.

    The reference reads obs[30] as hasBall (scripts/controllers.py:89),
    but index 30 is the self-orientation quaternion's w component; the
    true hasBall slot is the last element of the 38-float self block,
    which starts at index 23: 23 + 37 = 60 (obs[59] is pointsWorth,
    always >= 2).  This port uses the corrected slot, as the JAX package
    does; tests/test_torch_controllers.py pins it against the live env.
    """

    HAS_BALL_IDX = 60

    def get_action(self, obs, viewer_instance=None):
        obs = np.asarray(obs)
        if obs[self.HAS_BALL_IDX] > 0.5:
            return np.array([0, 0, 0, 0, 0, 1], np.int32)  # shoot
        return np.array([0, 0, 0, 1, 0, 0], np.int32)      # grab


class SimpleControllerManager:
    """Human-override toggle around the RL controller
    (scripts/controllers.py:18-45)."""

    def __init__(self, agent: Agent, seed: int = 0):
        self.rl_controller = RLController(agent, seed)
        self.human_controller = HumanController()
        self.human_control_active = False

    def set_human_control(self, active: bool):
        self.human_control_active = active
        print(f"Human control {'enabled' if active else 'disabled'}")

    def is_human_control_active(self) -> bool:
        return self.human_control_active

    def get_action(self, obs, viewer_instance=None):
        if self.human_control_active and viewer_instance is not None:
            return self.human_controller.get_action(obs, viewer_instance)
        return self.rl_controller.get_action(obs, viewer_instance)
