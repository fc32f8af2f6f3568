"""Vectorized environment facade (port of `madrona_basketball_tpu.env`,
env.py:57-208; the reference's `EnvWrapper`, scripts/env.py:16-252).

`BasketballEnv` drives the rows engine (engine_fused.FusedEngine, kernel
A on the card) with the reference's step / reset contract.  Observations,
rewards and dones stay torch tensors on the engine's device.  The PPO
trainer does not go through this class (it runs ppo/train_fused.py); the
env serves interactive use, evaluation and benchmarking.

Every stepping call takes `noise=None`: a (9, W) matrix there replaces the
engine's draw, so tests can drive the env on the JAX package's noise.
An attached viewer (viewer/app.py::ViewerClass, or any object with its
`tick` / `training_paused` / `set_controller_manager` /
`set_training_paused` surface) ticks after every step once the first
reset is done, and its pause flag freezes the sim in
`step_with_world_actions` (JAX env.py:150-208).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import constants as C
from .config import SimConfig
from .engine_fused import FusedEngine
from .export import export_tensors
from .ops.layout import ACTION_ROWS, F_IDX, RESET_ROWS

I32 = torch.int32


class BasketballEnv:
    """Gym-style vectorized env over `num_worlds` lockstep worlds."""

    def __init__(self, num_worlds: int, cfg: SimConfig = SimConfig(),
                 seed: int = 0, frozen_policy: Optional[Callable] = None,
                 trainee_agent_idx: int = 0, viewer=None, device="cuda"):
        self.cfg = cfg
        self.num_worlds = num_worlds
        self.agent_idx = trainee_agent_idx
        self.engine = FusedEngine(cfg, num_worlds, seed=seed, device=device)
        # Optional frozen-opponent policy for self-play:
        # obs (W, 128) -> actions (W, 6)  (scripts/env.py:105-143).
        self.frozen_policy = frozen_policy
        self.viewer = viewer
        self.action_buckets = list(C.ACTION_BUCKETS)
        self.first_reset_done = False
        self.controller_manager = None
        self.training_paused = False

    # ---- introspection (scripts/env.py:113-123) ----
    def get_action_space_size(self) -> int:
        return len(self.action_buckets)

    def get_input_dim(self) -> int:
        return C.OBS_SIZE

    def get_action_buckets(self):
        return self.action_buckets

    def set_agent_idx(self, agent_idx: int):
        self.agent_idx = agent_idx

    # ---- observation / action access ----
    @property
    def observations(self) -> torch.Tensor:
        """(W, A, 128) float32."""
        return self.engine.obs.reshape(
            C.NUM_AGENTS, C.OBS_SIZE, self.num_worlds).permute(2, 0, 1)

    def get_obs(self) -> torch.Tensor:
        return self.engine.trainee_obs(self.agent_idx)

    def get_blank_actions(self) -> torch.Tensor:
        return torch.zeros((self.num_worlds, len(self.action_buckets)),
                           dtype=I32, device=self.engine.device)

    def tensors(self, bitcast_compat: bool = False) -> dict:
        """The reference's tensor export API (src/mgr.cpp:315-445)."""
        return export_tensors(self.engine.state(),
                              bitcast_compat=bitcast_compat)

    # ---- step / reset (scripts/env.py:125-185) ----
    def _write(self, agent: int, actions, si=None):
        si = self.engine.si.clone() if si is None else si
        actions = torch.as_tensor(actions).to(device=si.device, dtype=I32)
        for j, r in enumerate(ACTION_ROWS[agent]):
            si[r] = actions[..., j]
        return si

    def _frozen_actions(self):
        frozen_idx = 1 - self.agent_idx
        return frozen_idx, self.frozen_policy(
            self.engine.trainee_obs(frozen_idx))

    def _outputs(self):
        e, i = self.engine, self.agent_idx
        return (e.trainee_obs(i), e.sf[F_IDX[f"a{i}.reward"]],
                e.sf[F_IDX[f"a{i}.done"]])

    def step(self, trainee_actions, noise: torch.Tensor | None = None):
        """Write the trainee's (W, 6) actions (and, with a frozen policy,
        the opponent's), step every world; returns the trainee's
        (obs (W, 128), reward (W,), done (W,))."""
        si = self._write(self.agent_idx, trainee_actions)
        if self.frozen_policy is not None:
            frozen_idx, fa = self._frozen_actions()
            si = self._write(frozen_idx, fa, si)
        self.engine.si = si
        self.engine.step(noise)
        self._tick_viewer()
        return self._outputs()

    def _tick_viewer(self):
        if self.viewer is not None and self.first_reset_done:
            self.viewer.tick()

    def _set_reset_flags(self, value: int):
        si = self.engine.si.clone()
        for r in RESET_ROWS:
            si[r] = value
        self.engine.si = si

    def reset(self, noise: torch.Tensor | None = None):
        """Pulse the Reset flag for one step (scripts/env.py:178-185).

        Like the reference, this marks done = 1 / cur_step = 0 for the
        learner but does NOT reposition entities; repositioning happens
        only through the in-sim WorldClock reset path (SURVEY section 3.3).
        """
        self._set_reset_flags(1)
        out = self.step(self.get_blank_actions(), noise)
        self._set_reset_flags(0)
        self.first_reset_done = True
        return out

    def trigger_reset(self, world_idx: int):
        """Set the advisory Reset flag of one world (Manager::triggerReset,
        src/mgr.cpp:297-311): the next tick marks done = 1 / cur_step = 0
        for that world's agents."""
        si = self.engine.si.clone()
        for r in RESET_ROWS:
            si[r, world_idx] = 1
        self.engine.si = si

    # ---- interactive-control plumbing (scripts/env.py:186-207) ----
    def set_controller_manager(self, controller_manager):
        """Attach a SimpleControllerManager for interactive training or
        evaluation; forwarded to the viewer, whose H key toggles it."""
        self.controller_manager = controller_manager
        if self.viewer is not None:
            self.viewer.set_controller_manager(controller_manager)

    def toggle_human_control(self):
        if self.controller_manager is not None:
            self.controller_manager.set_human_control(
                not self.controller_manager.is_human_control_active())

    def is_training_paused(self) -> bool:
        return self.training_paused

    def set_training_paused(self, paused: bool):
        self.training_paused = paused
        if self.viewer is not None:
            self.viewer.set_training_paused(paused)

    def step_with_world_actions(self, actions, human_action_world_0=None,
                                human_agent_idx=None,
                                noise: torch.Tensor | None = None):
        """Step with trainee actions, world 0's selected agent optionally
        overridden by a human action (scripts/env.py:213-251).

        Order follows the reference: the trainee (and frozen) actions are
        written for all worlds first, then world 0 is overridden, so the
        human action survives.  While the viewer reports paused, world 0's
        action of that agent is zeroed (the agent freezes visually) and
        the sim does not advance, so `noise` goes unused; the viewer still
        ticks, for its interaction."""
        si = self._write(self.agent_idx, actions)
        if self.frozen_policy is not None:
            frozen_idx, fa = self._frozen_actions()
            si = self._write(frozen_idx, fa, si)
        idx = self.agent_idx if human_agent_idx is None else human_agent_idx
        if human_action_world_0 is not None:
            human = torch.as_tensor(human_action_world_0).to(
                device=si.device, dtype=I32)
            for j, r in enumerate(ACTION_ROWS[idx]):
                si[r, 0] = human[j]
        self.training_paused = bool(
            self.viewer is not None and
            getattr(self.viewer, "training_paused", False))
        if self.training_paused:
            for r in ACTION_ROWS[idx]:
                si[r, 0] = 0
        self.engine.si = si
        if not self.training_paused:
            self.engine.step(noise)
        self._tick_viewer()
        return self._outputs()

