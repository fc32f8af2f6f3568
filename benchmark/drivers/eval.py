"""The evaluation driver: checkpoint evaluation against a frozen opponent
as `infer.py`'s chunked loop runs it, timed over a window, and its first
chunks held against the plain reference.

Set-up builds kernel A's library, makes the trainee and the frozen agent
from the seed on the device (heads as the configuration's
`assumed.checkpoint_heads` says), writes
both as checkpoints under TMPDIR and loads them with `load_agent` (as a
user's are), makes the env
(`BasketballEnv`, reset), both policies (`make_policy_fn` on generators
seeded as `infer` / `multi_gen_infer` seed them) and the eval chunk of
`chunk_ticks` ticks (`make_eval_chunk`: a CUDA graph on the card), with
no log and no early stop.  Its first `check_steps` chunks run with a
snapshot before and after each; the window continues from there.

The window repeats `_infer_chunked`'s loop body: `chunk.run(K)` and the
`int(chunk.t_used)` fetch, until `seconds` have passed.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch

from benchmark.drivers.train import DIVERGED, _row_err, make_agents
from benchmark.reference import precision
from benchmark.reference.eval import eval_chunk
from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.infer import (generator, make_eval_chunk,
                                                make_policy_fn)
from madrona_basketball_tpu_torch.utils.checkpoint import (load_agent,
                                                           save_agent)

LIBRARIES = ("fused_step",)
CONTROL = "tf32"   # the policy's products are float32, TF32 off


def _agent(a) -> tuple:
    net = {k: v.detach().clone() for k, v in a.net.state_dict().items()}
    r = a.obs_rms
    return net, (r.mean.clone(), r.var.clone(), r.count.clone())


class Run:
    """One run of an eval cell: `window(seconds)`, then `trace_window()`
    (traced runs) and `check()`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        dev = torch.device(device)
        self.traffic = traffic
        if dev.type == "cuda":
            _build.build(LIBRARIES)
        self.cfg = SimConfig(**config["sim"])
        ppo = config["ppo"]
        self.num_envs, self.ti = ppo["num_envs"], ppo["trainee_idx"]
        self.K = traffic["chunk_ticks"]
        self.ckpt_dir = tempfile.mkdtemp(prefix="bench_eval_")
        agents = []
        made = make_agents(seed, dev, 2, config["policy"],
                           config["assumed"]["checkpoint_heads"])
        for name, a in zip(("trainee", "frozen"), made):
            path = save_agent(a, os.path.join(self.ckpt_dir, f"{name}.pth"))
            agents.append(load_agent(path, dev))
        trainee, frozen = agents
        self.agents = {"trainee": _agent(trainee), "frozen": _agent(frozen)}
        frozen_fn = make_policy_fn(frozen, generator(seed + 1, dev))
        env = BasketballEnv(self.num_envs, self.cfg, seed=seed,
                            frozen_policy=frozen_fn,
                            trainee_agent_idx=self.ti, device=dev)
        policy = make_policy_fn(trainee, generator(seed, dev))
        env.reset()
        self.chunk = make_eval_chunk(env, policy, frozen_fn, self.K,
                                     num_episodes=0, log=False)
        self.gens = (policy.gen, frozen_fn.gen, env.engine.gen)
        self.snaps = [self._snapshot()]
        for _ in range(traffic["check_steps"]):
            self._run_chunk()
            self.snaps.append(self._snapshot())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _snapshot(self) -> dict:
        c = self.chunk
        return dict(sf=c.sf.clone(), si=c.si.clone(), obs=c.obs.clone(),
                    counts=c.counts.clone(), **self.agents,
                    gens=tuple(g.get_state() for g in self.gens))

    def _run_chunk(self) -> int:
        self.chunk.run(self.K)
        return int(self.chunk.t_used)  # the loop's one fetch a chunk

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        ticks = 0
        while time.perf_counter() - t0 < seconds:
            ticks += self._run_chunk()
        window_s = time.perf_counter() - t0
        return {"eval_env_steps_per_s": ticks * self.num_envs / window_s,
                "iterations": ticks // self.K, "ticks": ticks,
                "window_s": window_s}

    def trace_window(self) -> dict:
        """Whole chunks of at least `profile_ticks` ticks, after the window:
        first timed by CUDA events with no profiler (`trace.event_span`:
        each replay between two events, the t_used fetch after it), then
        under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark import trace
        n = -(-self.traffic["profile_ticks"] // self.K)
        events = trace.event_span(lambda: self.chunk.run(self.K),
                                  lambda: int(self.chunk.t_used), n)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                with record_function("chunk_dispatch"):
                    self.chunk.run(self.K)
                with record_function("t_used_fetch"):
                    int(self.chunk.t_used)
            window_s = time.perf_counter() - t0
        return {"prof": prof, "window_s": window_s, "iterations": n,
                "ticks": n * self.K, **events}

    def free(self):
        shutil.rmtree(self.ckpt_dir, ignore_errors=True)
        self.chunk = None

    def produced(self) -> list:
        return self.snaps[1:]

    def check(self, produced=None) -> dict:
        """worlds_off_pct: the share of worlds whose int rows or episode
        count differ from the reference's, or whose float rows differ by
        more than DIVERGED of their row's scale, the worst over the
        checked chunks."""
        produced = self.produced() if produced is None else produced
        worst = 0.0
        for before, prog in zip(self.snaps, produced):
            ref = eval_chunk(self.cfg, before, self.K, self.ti)
            off = (prog["si"] != ref["si"]).any(dim=0) | \
                (prog["counts"] != ref["counts"])
            for k in ("sf", "obs"):
                off |= _row_err(prog[k], ref[k], 0).amax(dim=0) > DIVERGED
            worst = max(worst, 100.0 * float(off.sum()) / off.numel())
        return {"worlds_off_pct": worst}

    def reference_steps(self, mode: str) -> list:
        precision.set_mode(mode)
        try:
            return [eval_chunk(self.cfg, s, self.K, self.ti)
                    for s in self.snaps[:-1]]
        finally:
            precision.set_mode("float32")
