"""The rows engine: the whole fleet stepped by kernels A and F (port of
`madrona_basketball_tpu.engine_fused`, engine_fused.py:31-149).

`draw_noise_rows` gives one tick's sim noise in the kernels' 9-row layout:
rows 0-5 shot deviations U(-1,1), 3 per agent; rows 6-7 offense spawn x/y
deviation U(-1,1); row 8 defender spawn angle U(0,1).  The draws come from
the caller's `torch.Generator`, not from JAX's key splits: only the
distribution is shared with the JAX package (SURVEY section 2.3).

`FusedEngine` holds the fleet as SoA rows (sf, si, obs) on its device:
`step` is one kernel-A launch, `step_many(n)` one kernel-F launch.  On CPU
tensors the wrappers run their plain versions, so the JAX `backend="xla"`
branch has no counterpart here.
"""

from __future__ import annotations

import torch

from . import constants as C
from .config import SimConfig
from .engine import init_rows
from .ops.fused_step import fused_multistep, fused_step
from .ops.layout import ACTION_ROWS, N_NOISE_ROWS, N_OBS_ROWS, unpack
from .state import State


def draw_noise_rows(num_worlds: int, gen: torch.Generator,
                    device="cuda") -> torch.Tensor:
    """(N_NOISE_ROWS, W) float32: rows 0-7 U(-1,1), row 8 U(0,1)."""
    u = torch.rand((N_NOISE_ROWS, num_worlds), generator=gen,
                   dtype=torch.float32, device=device)
    return torch.cat([2.0 * u[:N_NOISE_ROWS - 1] - 1.0,
                      u[N_NOISE_ROWS - 1:]])


class FusedEngine:
    """Holds (sf, si, obs) and a torch.Generator on `device`, and steps the
    whole fleet per call."""

    def __init__(self, cfg: SimConfig, num_worlds: int, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.num_worlds = num_worlds
        self.seed = seed
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.sf, self.si = init_rows(cfg, num_worlds, self.gen, self.device)
        self.obs = torch.zeros((N_OBS_ROWS, num_worlds), dtype=torch.float32,
                               device=self.device)
        self._multistep_calls = 0

    def step(self, noise: torch.Tensor | None = None):
        """One tick (kernel A).  `noise` (9, W) replaces the generator's
        draw (tests inject the JAX package's draws)."""
        if noise is None:
            noise = draw_noise_rows(self.num_worlds, self.gen, self.device)
        self.sf, self.si, self.obs = fused_step(self.cfg, self.sf, self.si,
                                                noise)

    def step_many(self, n_steps: int, noise: torch.Tensor | None = None):
        """Advance every world `n_steps` ticks in ONE kernel-F launch, obs
        of the last tick only.  Actions persist in the state, so
        hardCodeDefense keeps driving unwritten agents each tick, as in
        repeated `step()` calls.  The Philox key is (call counter, engine
        seed), so every call and every engine seed draw their own stream;
        `noise` ((n * 16, W), pack_multistep_noise) replaces it."""
        if n_steps <= 0:
            return
        if noise is None:
            seed = (self.seed << 32) | self._multistep_calls
            self._multistep_calls += 1
            out = fused_multistep(self.cfg, self.sf, self.si, n_steps,
                                  seed=seed)
        else:
            out = fused_multistep(self.cfg, self.sf, self.si, n_steps,
                                  noise=noise)
        self.sf, self.si, self.obs = out

    def set_actions(self, actions: torch.Tensor):
        """Write a (W, A, 6) action tensor into the row state."""
        actions = actions.to(device=self.device, dtype=torch.int32)
        si = self.si.clone()
        for i in range(C.NUM_AGENTS):
            for j, r in enumerate(ACTION_ROWS[i]):
                si[r] = actions[:, i, j]
        self.si = si

    def trainee_obs(self, agent_idx: int) -> torch.Tensor:
        """(W, 128) observation of one agent."""
        lo = agent_idx * C.OBS_SIZE
        return self.obs[lo:lo + C.OBS_SIZE].T

    def state(self) -> State:
        """The structured view (for the export)."""
        return unpack(self.cfg, self.sf, self.si, obs=self.obs)
