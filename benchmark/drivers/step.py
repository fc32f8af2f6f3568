"""The stepping driver: the whole fleet stepped with no policy, as the
port's stepping bench runs `scripts/run.py`'s workload (its engine (c)),
timed over a window, and its first launch held against the plain
reference.

Set-up builds kernel F's library and makes the fleet's rows from the
seed on the device (`engine.init_rows`, a generator seeded by the seed).
Each launch is one call of `ops/fused_step.py::fused_multistep`:
`ticks_per_launch` ticks, observations every tick or held, agent
`blank_agent`'s actions zeroed before every tick, the in-kernel Philox
keyed by the seed and the launch's number as `FusedEngine.step_many` keys
its calls.  The first `check_launches` launches run in set-up with a
snapshot of the rows before and after each; the window continues from
there.

The window issues launch after launch, each consuming the last one's
rows, with at most `IN_FLIGHT` launches queued on the device, until
`seconds` have passed; then it waits for the device.  After the window
the reference follows the checked launches for every world, each from the
program's own rows before it.
"""

from __future__ import annotations

import collections
import time

import torch

from benchmark.drivers.train import DIVERGED, _row_err
from benchmark.reference import multistep as RM
from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.ops import fused_step as FS

LIBRARIES = ("fused_multistep",)
CONTROL = "bfloat16"   # the sim's state is float32
IN_FLIGHT = 2
MASK32 = 0xFFFFFFFF


class Run:
    """One run of a stepping cell: `window(seconds)`, then `trace_window()`
    (traced runs) and `check()`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = dev = torch.device(device)
        self.traffic = traffic
        if dev.type == "cuda":
            _build.build(LIBRARIES)
        self.cfg = SimConfig(**config["sim"])
        self.num_envs = config["ppo"]["num_envs"]
        self.K = traffic["ticks_per_launch"]
        self.seed, self.launches = seed, 0
        self._reference = None    # the float32 reference, once made
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.sf, self.si = init_rows(self.cfg, self.num_envs, gen, dev)
        self.snaps = [self._snapshot()]
        self.keys = []
        for _ in range(traffic["check_launches"]):
            self.keys.append(self._key())
            self._launch()
            self.snaps.append(self._snapshot())
        self._sync()

    def _key(self) -> int:
        return ((self.seed & MASK32) << 32) | (self.launches & MASK32)

    def _launch(self):
        self.sf, self.si, self.obs = FS.fused_multistep(
            self.cfg, self.sf, self.si, self.K, seed=self._key(),
            obs_every_tick=self.traffic["obs_every_tick"],
            blank_agent=self.traffic["blank_agent"])
        self.launches += 1

    def _snapshot(self) -> dict:
        obs = getattr(self, "obs", None)
        return dict(sf=self.sf.clone(), si=self.si.clone(),
                    obs=None if obs is None else obs.clone())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _loop(self, until, mark=None):
        """Launches until `until(n)` says stop, at most IN_FLIGHT queued;
        returns their number once the device has finished them."""
        cuda = self.device.type == "cuda"
        queued, n = collections.deque(), 0
        while not until(n):
            if mark is None:
                self._launch()
            else:
                with mark("launch"):
                    self._launch()
            n += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                queued.append(ev)
                if len(queued) > IN_FLIGHT:
                    queued.popleft().synchronize()
        self._sync()
        return n

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = self._loop(lambda n: time.perf_counter() - t0 >= seconds)
        window_s = time.perf_counter() - t0
        ticks = n * self.K
        return {"step_env_steps_per_s": ticks * self.num_envs / window_s,
                "iterations": n, "ticks": ticks, "window_s": window_s}

    def trace_window(self) -> dict:
        """`profile_launches` whole launches under torch.profiler, after
        the window."""
        from torch.profiler import ProfilerActivity, profile, record_function
        n = self.traffic["profile_launches"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            self._loop(lambda i: i >= n, record_function)
            window_s = time.perf_counter() - t0
        return {"prof": prof, "window_s": window_s, "iterations": n,
                "ticks": n * self.K}

    def free(self):
        self.sf = self.si = self.obs = None

    def produced(self) -> list:
        return self.snaps[1:]

    def check(self, produced=None) -> dict:
        """worlds_off_pct: the share of worlds whose int rows differ from
        the reference's after a checked launch, or whose float rows or
        observations differ by more than DIVERGED of their row's scale,
        the worst over the checked launches."""
        produced = self.produced() if produced is None else produced
        if self._reference is None:
            self._reference = self.reference_steps("float32")
        worst = 0.0
        for prog, ref in zip(produced, self._reference):
            off = (prog["si"] != ref["si"]).any(dim=0)
            for k in ("sf", "obs"):
                off |= _row_err(prog[k], ref[k], 0).amax(dim=0) > DIVERGED
            worst = max(worst, 100.0 * float(off.sum()) / off.numel())
        return {"worlds_off_pct": worst}

    def reference_steps(self, mode: str) -> list:
        """The reference in `mode` ("float32", or "bfloat16": the float
        rows rounded to bfloat16 after every tick) from each snapshot
        before a checked launch, for every world."""
        state_dtype = {"float32": None, "bfloat16": torch.bfloat16}[mode]
        worlds = torch.arange(self.num_envs, device=self.device)
        out = []
        for before, key in zip(self.snaps, self.keys):
            sf, si, obs = RM.multistep(
                self.cfg, before["sf"], before["si"], worlds, seed=key,
                n_steps=self.K, blank_agent=self.traffic["blank_agent"],
                state_dtype=state_dtype)
            out.append(dict(sf=sf, si=si, obs=obs))
        return out
