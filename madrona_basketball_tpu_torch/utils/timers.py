"""Wall-clock iteration timer (port of `madrona_basketball_tpu/utils/
timers.py`, PPOTimer of scripts/ppo_stats.py:53-150).

The port issues its iteration from the host phase by phase, so for a
CUDA device `start` and `end` first wait for the card
(`torch.cuda.synchronize`): a host clock without it would time the
issue, not the work.  The CLI times the whole iteration only ("iter"),
as the JAX CLI does.
"""

from __future__ import annotations

from collections import defaultdict
from time import perf_counter

import torch


class PPOTimer:
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.global_step = 0
        self._starts = {}
        self.reset()

    def reset(self):
        self.t = defaultdict(float)
        self.iter_step = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, phase: str):
        self._sync()
        self._starts[phase] = perf_counter()

    def end(self, phase: str):
        self._sync()
        start = self._starts.pop(phase, None)
        if start is None:
            raise RuntimeError(f"{phase} start not set")
        self.t[phase] += perf_counter() - start

    def add_steps(self, steps: int):
        self.iter_step += steps
        self.global_step += steps

    def fps(self, phase: str) -> int:
        el = self.t[phase]
        return int(self.iter_step / el) if el > 0 else 0

    def print(self):
        print(f"Took {self.t['iter']:.2f} seconds. "
              f"FPS: {self.fps('iter')}. Global {self.global_step:_}")
