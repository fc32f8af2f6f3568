"""Policy evaluation and trajectory logging (port of
`madrona_basketball_tpu/infer.py:31-349`).

`infer` rolls a checkpoint (stochastic or argmax) across N worlds until
each completes `num_episodes`, logging the trajectory to a compressed npz
in the reference's key schema (scripts/infer.py:116-129), which the JAX
package's viewer plays unchanged; `multi_gen_infer` evaluates every
checkpoint of a model on a fixed seed (scripts/infer.py:154-186).

Two loops, equal bit for bit:
  * per step (`chunk_size=1`): policy (kernel J on the card, one launch
    an agent), env step (kernel A on the card), the log row fetched to
    the host, every tick;
  * the eval chunk (`chunk_size=K > 1`; 0 = 32, the default): K ticks on
    static buffers (`EvalChunk`), on the card captured once as a CUDA
    graph and replayed, with the stop tested on the device before every
    tick, both policies one launch of kernel J a tick, and the host
    fetching counts and logs once a chunk.
Both draw, each tick, the trainee's Gumbel noise, the frozen policy's,
then the env noise, each from its own generator: the trainee's seeded
`seed`, the frozen policy's `seed + 1` (as `main` builds it), the
engine's the env's seed.

CLI: python -m madrona_basketball_tpu_torch.infer [...] (the JAX CLI's
flags and defaults, plus `--device`); `--viewer` evaluates per step with
the embedded viewer (viewer/app.py) and the human override;
`--trace-out PATH` traces the evaluation (utils/profiling.py: the chunk
loop's host spans, each chunk's device stamps) and writes one Chrome
trace at its end.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import constants as C
from .config import SimConfig
from .controllers import SimpleControllerManager
from .engine_fused import draw_noise_rows
from .env import BasketballEnv
from .models.agent import Agent, act
from .ops import eval_policy as EP
from .ops.fused_rollout import N_LOGITS, gumbel_from_uniform
from .ops.fused_step import fused_step
from .ops.layout import ACTION_NAMES, ACTION_ROWS, F_IDX, I_IDX
from .utils.checkpoint import AGENT_SUFFIXES, load_agent
from .utils.profiling import TRACER, annotate, capture, trace

F32 = torch.float32
I32 = torch.int32
EVAL_CHUNK = 32  # ticks a dispatch when chunk_size == 0 (infer.py:152)


def _draw(seam):
    """The next injected draw: `seam()` for a callable, else next(seam)."""
    return seam() if callable(seam) else next(seam)


class Policy:
    """obs (B, 128) -> actions (B, 6) int32 under one agent: a Gumbel-max
    sample, or the per-bucket argmax when not stochastic.  The Gumbel
    noise is one (B, 19) uniform draw a call from `gen`
    (`gumbel_from_uniform`), or, with the `gumbel` seam, the next of its
    (B, 19) Gumbel draws (an iterator, or a callable returning one).
    On CUDA tensors kernel J (ops/eval_policy.py) runs the forward and
    the sampling; on CPU tensors `models.agent.act`.  Kernel J takes only
    the 128 -> 2 x 32 -> 19 agent, so an agent off the CPU must be that
    one: any other (a checkpoint of another depth or obs width) is
    refused here, and evaluates on the CPU."""

    def __init__(self, agent: Agent, gen: Optional[torch.Generator],
                 stochastic: bool = True, gumbel=None):
        if agent.obs_rms.mean.device.type != "cpu":
            EP.check_agent(agent)
        self.agent, self.gen = agent, gen
        self.stochastic, self.gumbel = stochastic, gumbel

    def job(self, obs: torch.Tensor, out) -> EP.PolicyJob:
        """This call's draw with `obs` and the (B, 6) int32 actions `out`
        it is to write: kernel J's share of one agent."""
        noise = None
        if self.stochastic:
            if self.gumbel is not None:
                noise = torch.as_tensor(_draw(self.gumbel), dtype=F32,
                                        device=obs.device)
            else:
                noise = torch.rand((obs.shape[0], N_LOGITS),
                                   generator=self.gen, dtype=F32,
                                   device=obs.device)
        return EP.PolicyJob(self.agent, obs, noise, self.gumbel is not None,
                            out)

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        out = torch.empty((obs.shape[0], len(ACTION_NAMES)), dtype=I32,
                          device=obs.device)
        run_policies([self.job(obs, out)])
        return out


def run_policies(jobs) -> None:
    """Each `EP.PolicyJob`'s actions written into its `act`: on CPU
    tensors `act` on the noise's Gumbel values, a job at a time; on any
    other device kernel J, one launch for the jobs (ops/eval_policy.py,
    which refuses a device other than CUDA)."""
    if jobs[0].obs.device.type != "cpu":
        EP.eval_policy(jobs)
        return
    for j in jobs:
        g = j.noise if j.gumbel or j.noise is None else \
            gumbel_from_uniform(j.noise)
        j.act.copy_(act(j.agent, j.obs, g))


def make_policy_fn(ap: Agent, gen: Optional[torch.Generator],
                   stochastic: bool = True, gumbel=None) -> Policy:
    """A stateful callable obs -> actions, drawing from `gen` (the JAX
    `make_policy_fn`, infer.py:31-46, with a generator for its key)."""
    return Policy(ap, gen, stochastic, gumbel)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


# ---------------------------------------------------------------------
# One tick's log row
# ---------------------------------------------------------------------

_AGENTS = range(C.NUM_AGENTS)
# npz key: (table, rows stacked in the last axis, per-world shape) - the
# export's tensors (export.py) that the reference's log keeps
LOG_ROWS = {
    "agent_pos": ("f", [f"a{i}.pos_{c}" for i in _AGENTS for c in "xyz"],
                  (C.NUM_AGENTS, 3)),
    "ball_pos": ("f", ["bpos_x", "bpos_y", "bpos_z"], (1, 3)),
    "ball_vel": ("f", ["bvel_x", "bvel_y", "bvel_z"], (1, 3)),
    "orientation": ("f", [f"a{i}.quat_{c}" for i in _AGENTS
                          for c in "wxyz"], (C.NUM_AGENTS, 4)),
    "ball_physics": ("i", ["binflight", "blt_agent", "blt_team",
                           "bsb_agent", "bsb_team", "bspv", "bsgi"],
                     (1, 7)),
    "agent_possession": ("i", [f"a{i}.{n}" for i in _AGENTS for n in
                               ("has_ball", "held_ball", "points_worth")],
                         (C.NUM_AGENTS, 3)),
    "game_state": ("f", ["ginb", "glive", "period", "tip", "t0hoop",
                         "t0score", "t1hoop", "t1score", "gclock", "sclock",
                         "sbaskets", "oob", "iclock", "is1v1"], (14,)),
    "rewards": ("f", [f"a{i}.reward" for i in _AGENTS], (C.NUM_AGENTS,)),
    "actions": ("i", [f"a{i}.{n}" for i in _AGENTS for n in ACTION_NAMES],
                (C.NUM_AGENTS, 6)),
}


def log_row(sf: torch.Tensor, si: torch.Tensor, trainee_idx: int) -> dict:
    """One tick's npz row from the rows (the reference's key schema,
    scripts/infer.py:116-129): the export's tensors, game_state's int
    fields cast to float as the export casts them, and the trainee's
    done.  Stacks of row views: nothing is read on the host."""
    W = sf.shape[1]
    out = {}
    for key, (table, names, shape) in LOG_ROWS.items():
        rows = [sf[F_IDX[n]] if n in F_IDX else si[I_IDX[n]] for n in names]
        if table == "f":
            rows = [r.to(F32) for r in rows]
        out[key] = torch.stack(rows, dim=-1).reshape((W,) + shape)
    out["done"] = sf[F_IDX[f"a{trainee_idx}.done"]]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (on the CPU `.cpu()` would share the buffer)."""
    return t.to("cpu", copy=True).numpy()


def _save_log(log_path, static_log, logs, num_episodes):
    if log_path and logs and logs["done"]:
        episode_log = {k: np.concatenate(v) for k, v in logs.items()}
        static_log["num_episodes"] = num_episodes
        np.savez_compressed(log_path, **static_log, **episode_log)
        print(f"Finished logging. Trajectory saved to {log_path}")


# ---------------------------------------------------------------------
# The eval chunk
# ---------------------------------------------------------------------

def _agent_obs(obs: torch.Tensor, agent: int) -> torch.Tensor:
    lo = agent * C.OBS_SIZE
    return obs[lo:lo + C.OBS_SIZE].T


# the chunk writes an agent's six actions as one slice of rows
_ACTION_LO = [rows[0] for rows in ACTION_ROWS]
if any(rows != list(range(lo, lo + len(ACTION_NAMES)))
       for rows, lo in zip(ACTION_ROWS, _ACTION_LO)):
    raise ImportError("an agent's action rows must be consecutive")


class EvalChunk:
    """K eval ticks on tensors that keep their addresses: what a CUDA
    graph captures (the JAX package's `_make_eval_chunk`,
    infer.py:49-122).

    Holds the rows `sf`, `si`, `obs`, the episode counts (W,) int32,
    `t_used` and `budget` (0-d int32) and, with `log`, the log buffers
    (K, W, ...).  `step()` runs K ticks.  Before tick k it computes on
    the device go = (k < budget) & any(counts < num_episodes) (the second
    term dropped when num_episodes == 0); the tick's rows, counts and log
    slot k are kept only where go holds (slots of stopped ticks are
    zero), and `t_used` counts the go ticks: no tick after the stop
    reaches the state or the log.  Each tick draws the trainee's Gumbel
    noise, the frozen policy's, then the env noise from `engine.gen`,
    and writes the actions into a scratch copy of `si`: on the card both
    policies' forward and sampling are one launch of kernel J, writing
    into its action rows.  Nothing in `step()` reads a value on the host.
    `capture()` (on the card) records one `step()` as a CUDA graph, after
    a warm-up tick on a side stream with every generator's state restored
    after it, and counts its kernel nodes (`kernel_nodes`: the tracer's
    stamps left out, None where they cannot be counted) and kernel J's
    launches in it (`policy_launches`, K); `run(budget)` replays it (or,
    uncaptured, calls `step()`); `advance(budget)` is the eval loop's
    body, the run and its `t_used` fetch.  With the tracer on, `step()`
    stamps "start", "policies" after each tick's policy work, and "end"
    (utils/profiling.py)."""

    def __init__(self, cfg: SimConfig, engine, policy: Policy,
                 frozen: Optional[Policy], trainee_idx: int, K: int,
                 num_episodes: int, log: bool):
        self.cfg, self.policy, self.frozen = cfg, policy, frozen
        self.ti, self.K, self.num_episodes = trainee_idx, K, num_episodes
        self.gen = engine.gen
        dev = engine.device
        self.sf, self.si = engine.sf.clone(), engine.si.clone()
        self.obs = engine.obs.clone()
        self.si_in = torch.empty_like(self.si)
        self.counts = torch.zeros((engine.num_worlds,), dtype=I32,
                                  device=dev)
        self.t_used = torch.zeros((), dtype=I32, device=dev)
        self.budget = torch.full((), K, dtype=I32, device=dev)
        self.logs = {k: torch.zeros((K,) + tuple(v.shape), dtype=v.dtype,
                                    device=dev)
                     for k, v in log_row(self.sf, self.si,
                                         trainee_idx).items()} \
            if log else None
        self._zero = {t: torch.zeros((), dtype=t, device=dev)
                      for t in (F32, I32)}
        self.graph = None
        self.kernel_nodes = self.policy_launches = None

    @property
    def generators(self) -> list:
        pols = [p for p in (self.policy, self.frozen)
                if p is not None and p.stochastic]
        if any(p.gumbel is not None for p in pols):
            raise ValueError("the eval chunk draws from generators; "
                             "injected Gumbel draws need chunk_size=1")
        return [p.gen for p in pols] + [self.gen]

    def _actions(self, agent: int) -> torch.Tensor:
        """The agent's (W, 6) action rows of `si_in`, a view."""
        lo = _ACTION_LO[agent]
        return self.si_in[lo:lo + len(ACTION_NAMES)].T

    @torch.no_grad()
    def tick(self, k: int, mark=None):
        go = self.budget > k
        if self.num_episodes > 0:
            go = go & (self.counts < self.num_episodes).any()
        self.si_in.copy_(self.si)
        pols = [(self.ti, self.policy)]
        if self.frozen is not None:
            pols.append((1 - self.ti, self.frozen))
        run_policies([p.job(_agent_obs(self.obs, a), self._actions(a))
                      for a, p in pols])
        if mark:
            mark("policies")
        noise = draw_noise_rows(self.sf.shape[1], self.gen, self.sf.device)
        sf, si, obs = fused_step(self.cfg, self.sf, self.si_in, noise)
        for dst, src in ((self.sf, sf), (self.si, si), (self.obs, obs)):
            torch.where(go, src, dst, out=dst)
        done = sf[F_IDX[f"a{self.ti}.done"]]
        self.counts.add_(done.to(I32) * go)
        self.t_used.add_(go.to(I32))
        if self.logs is not None:
            for key, v in log_row(sf, si, self.ti).items():
                torch.where(go, v, self._zero[v.dtype],
                            out=self.logs[key][k])

    def step(self):
        mark = TRACER.mark if TRACER.on else None
        if mark:
            mark("start")
        self.t_used.zero_()
        for k in range(self.K):
            self.tick(k, mark)
        if mark:
            mark("end")

    def capture(self):
        if not torch.cuda.is_available():
            raise RuntimeError("capturing the eval chunk needs a CUDA card")
        dev = self.sf.device
        gens = self.generators
        saved = [g.get_state() for g in gens]
        with annotate("capture"):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                # budget 0: every tick is masked, so the buffers keep their
                # values; only the generators advance, and are restored
                self.budget.fill_(0)
                self.tick(0)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            for g, s in zip(gens, saved):
                g.set_state(s)
            launched = EP.launches
            self.graph, self.kernel_nodes = capture(self.step, gens,
                                                    "eval_chunk")
            self.policy_launches = EP.launches - launched

    def run(self, budget: int):
        """Up to `budget` (<= K) ticks: the graph's replay once captured,
        else `step()`."""
        self.budget.fill_(budget)
        if self.graph is not None:
            self.graph.replay()
        else:
            self.step()

    def advance(self, budget: int, index: int = -1) -> int:
        """The eval loop's body: `run(budget)`, then the loop's one host
        read a chunk, the ticks used (host spans chunk_dispatch and
        t_used_fetch, indexed by the chunk `index`)."""
        with annotate("chunk_dispatch", index):
            self.run(budget)
        with annotate("t_used_fetch", index):
            return int(self.t_used)


def make_eval_chunk(env: BasketballEnv, policy: Policy,
                    frozen: Optional[Policy], K: int, num_episodes: int,
                    log: bool) -> EvalChunk:
    """The env's eval chunk of K ticks, captured when the env's rows lie on
    the card."""
    chunk = EvalChunk(env.cfg, env.engine, policy, frozen, env.agent_idx, K,
                      num_episodes, log)
    if env.engine.device.type == "cuda":
        chunk.capture()
    return chunk


# ---------------------------------------------------------------------
# infer
# ---------------------------------------------------------------------

def infer(env: BasketballEnv, policy_params: Agent,
          log_path: str = "logs/trajectories.npz", num_episodes: int = 5,
          max_steps: int = 10000, stochastic: bool = True, seed: int = 0,
          trainee_idx: int = 1, frozen_params: Optional[Agent] = None,
          chunk_size: int = 0, *, noise=None, gumbel=None) -> np.ndarray:
    """Evaluate `policy_params` from the env's reset until every world has
    completed `num_episodes` (0: never stop early) or `max_steps` ticks
    ran; returns the per-world episode counts (int64), and writes the
    trajectory to `log_path` (none when empty).

    chunk_size 1 is the per-step loop, K > 1 the eval chunk of K ticks,
    0 the chunk of 32.  Per step, the opponent is `env.frozen_policy`;
    the chunk needs `frozen_params` whenever the env has one (as the JAX
    package's does, infer.py:210-215), and continues the env's frozen
    `Policy`'s generator when it is one.  `noise` (an iterator or
    callable of (9, W) env-noise matrices, one per tick, the reset's
    first) and `gumbel` (the trainee policy's seam) inject draws on the
    per-step path.

    A controller manager is attached (scripts/infer.py:45-48, JAX
    infer.py:133-138), so that a live viewer's H key hands world 0's
    selected agent to the keyboard: with a viewer attached the loop runs
    per step (chunk_size 0 means 1 there, and a chunk is never used) and
    overrides that agent's action while human control is on."""
    env.set_agent_idx(trainee_idx)
    dev = env.engine.device
    policy = make_policy_fn(policy_params, generator(seed, dev), stochastic,
                            gumbel)
    manager = SimpleControllerManager(policy_params, seed=seed)
    env.set_controller_manager(manager)
    static_log = {}
    if log_path:
        Path(log_path).parent.mkdir(parents=True, exist_ok=True)
        static_log["hoop_pos"] = _host(env.tensors()["hoop_pos"])
    obs, _, _ = env.reset(None if noise is None else _draw(noise))
    counts = np.zeros(env.num_worlds, dtype=np.int64)
    logs = {k: [] for k in (*LOG_ROWS, "done")} if log_path else None

    if chunk_size == 0:
        chunk_size = 1 if env.viewer is not None else EVAL_CHUNK
    if chunk_size > 1 and env.viewer is None:
        if noise is not None or gumbel is not None:
            raise ValueError("injected draws need the per-step loop "
                             "(chunk_size=1)")
        _infer_chunked(env, policy, frozen_params, logs, num_episodes,
                       max_steps, seed, chunk_size, counts)
    else:
        step = 0
        while step < max_steps:
            actions = policy(obs)
            n = None if noise is None else _draw(noise)
            if env.viewer is not None and manager.is_human_control_active():
                # scripts/infer.py:91-109: world 0's selected agent
                obs, _, done = env.step_with_world_actions(
                    actions, env.viewer.get_human_action(),
                    env.viewer.get_selected_agent_index(), noise=n)
            else:
                obs, _, done = env.step(actions, n)
            if log_path:
                row = log_row(env.engine.sf, env.engine.si, trainee_idx)
                for k, v in row.items():
                    logs[k].append(_host(v)[None])
            if num_episodes > 0:
                counts += done.cpu().numpy().astype(np.int64)
                if np.all(counts >= num_episodes):
                    print(f"All environments have completed "
                          f"{num_episodes} episodes.")
                    break
            step += 1
    _save_log(log_path, static_log, logs, num_episodes)
    print("Inference Complete")
    return counts


def _infer_chunked(env, policy, frozen_params, logs, num_episodes,
                   max_steps, seed, K, counts):
    frozen = None
    if frozen_params is not None or env.frozen_policy is not None:
        if frozen_params is None:
            raise ValueError("chunked eval with a frozen opponent needs "
                             "frozen_params (an Agent), not a host "
                             "callable; pass chunk_size=1 to keep the "
                             "per-step path")
        env_frozen = env.frozen_policy
        gen = env_frozen.gen if isinstance(env_frozen, Policy) else \
            generator(seed + 1, env.engine.device)
        frozen = make_policy_fn(frozen_params, gen, True)
    chunk = make_eval_chunk(env, policy, frozen, K, num_episodes,
                            logs is not None)
    step = n = 0
    while step < max_steps:
        # the exact tail: the last chunk runs max_steps % K ticks
        t_used = chunk.advance(min(K, max_steps - step), n)
        n += 1
        if logs is not None:
            for k, buf in chunk.logs.items():
                logs[k].append(_host(buf[:t_used]))
        step += t_used
        if num_episodes > 0:
            counts[:] = chunk.counts.cpu().numpy()
            if np.all(counts >= num_episodes):
                print(f"All environments have completed "
                      f"{num_episodes} episodes.")
                break
    e = env.engine
    e.sf, e.si, e.obs = chunk.sf.clone(), chunk.si.clone(), chunk.obs.clone()


def multi_gen_infer(model_name: str, num_envs: int = 10,
                    frozen_checkpoint: Optional[str] = None,
                    trainee_idx: int = 1, num_episodes: int = 5,
                    max_steps: int = 10000, stochastic: bool = True,
                    test_seed: int = 0, checkpoint_dir: str = "checkpoints",
                    cfg: Optional[SimConfig] = None, device="cuda"):
    """Evaluate every `{model}_*` checkpoint (`.pth`, `.pt` or `.ckpt`) on
    a fixed seed, each log written to `logs/mgi/{model}_/{name}.npz`
    (the JAX viewer's `--watch-model` playlist, infer.py:262-294)."""
    cfg = cfg or SimConfig()
    search_dir = os.path.join(checkpoint_dir, model_name)
    if not os.path.isdir(search_dir):
        search_dir = checkpoint_dir
    ckpts = sorted(f for f in os.listdir(search_dir)
                   if f.startswith(f"{model_name}_") and
                   f.endswith(AGENT_SUFFIXES))
    print(f"Found {len(ckpts)} checkpoints to test: {ckpts}")
    for name in ckpts:
        path = os.path.join(search_dir, name)
        log_path = (f"logs/mgi/{model_name}_/"
                    f"{os.path.splitext(name)[0]}.npz")
        print(f"Testing checkpoint: {path} -> {log_path}")
        frozen_fn, frozen_params = None, None
        if frozen_checkpoint:
            frozen_params = load_agent(frozen_checkpoint, device)
            frozen_fn = make_policy_fn(frozen_params,
                                       generator(test_seed + 1, device))
        env = BasketballEnv(num_envs, cfg, seed=test_seed,
                            frozen_policy=frozen_fn,
                            trainee_agent_idx=trainee_idx, device=device)
        infer(env, load_agent(path, device), log_path, num_episodes,
              max_steps, stochastic, seed=test_seed, trainee_idx=trainee_idx,
              frozen_params=frozen_params)


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate checkpoints "
                                            "(PyTorch + CUDA)")
    p.add_argument("--model-name", type=str, default=None)
    p.add_argument("--trainee-idx", type=int, default=1)
    p.add_argument("--trainee-checkpoint", type=str, default=None)
    p.add_argument("--frozen-checkpoint", type=str, default=None)
    p.add_argument("--log-path", type=str,
                   default="logs/inference_trajectories.npz")
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--num-episodes", type=int, default=5)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--num-envs", type=int, default=10)
    p.add_argument("--test-seed", type=int, default=0)
    p.add_argument("--viewer", action="store_true", default=False,
                   help="embedded live viewer during eval (per step); "
                        "press H to take over world 0's selected agent")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (kernel A) or cpu (its plain version)")
    p.add_argument("--trace-out", type=str, default=None,
                   help="trace the evaluation and write a Chrome trace to "
                        "PATH at its end")
    args = p.parse_args(argv)
    with trace(args.trace_out, args.device):
        _main(p, args)


def _main(p, args):
    dev = args.device
    if args.model_name is not None:
        multi_gen_infer(args.model_name, args.num_envs,
                        args.frozen_checkpoint, args.trainee_idx,
                        args.num_episodes, args.max_steps,
                        not args.deterministic, args.test_seed, device=dev)
        return
    if args.trainee_checkpoint is None:
        p.error("--trainee-checkpoint (or --model-name) is required")
    frozen_fn, frozen_params = None, None
    if args.frozen_checkpoint:
        frozen_params = load_agent(args.frozen_checkpoint, dev)
        frozen_fn = make_policy_fn(frozen_params,
                                   generator(args.test_seed + 1, dev))
    viewer = None
    if args.viewer:
        from .viewer.app import ViewerClass
        viewer = ViewerClass()
    env = BasketballEnv(args.num_envs, SimConfig(), seed=args.test_seed,
                        frozen_policy=frozen_fn,
                        trainee_agent_idx=args.trainee_idx, viewer=viewer,
                        device=dev)
    if viewer is not None:
        viewer.env = env
    infer(env, load_agent(args.trainee_checkpoint, dev), args.log_path,
          args.num_episodes, args.max_steps, not args.deterministic,
          seed=args.test_seed, trainee_idx=args.trainee_idx,
          frozen_params=frozen_params)


if __name__ == "__main__":
    main()
