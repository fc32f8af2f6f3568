"""The training driver: the user's PPO loop over the port's chunked
iteration, timed over a window, and its first steps held against the
plain reference.

Set-up builds the cell's kernel libraries (all in parallel), makes both
agents' weights from the seed on the device, makes the train state
(`init_train_state`), the iteration (`make_train_iteration`) and the
chunk of `auto_chunk(log_every, save_every)` iterations
(`make_train_chunk`), and captures the chunk's CUDA graph by running one
warm chunk on a copy of the state.  The same state object then takes its
first `check_steps` iterations through the captured graph, each replay
reseeded as the chunk reseeds it, beside the same iteration run eagerly
from a copy (a replay keeps its trajectory to itself; the eager step
gives it, and has to equal the replay exactly), with a snapshot of the
state before and after each; the window continues from there.

The window repeats the loop body of the port's CLI and league
(`cli.py::_train`, `selfplay.py::train_generation`): a chunk dispatch,
the per-chunk metric unstack, the `float()` readback of every metric at
the log cadence and `save_agent` (under TMPDIR) at the save cadence,
counting its own iterations from 0, until `seconds` have passed; then it
waits for the device.

After the window the reference follows the first steps, each from the
program's own snapshot before it, stage by stage, and `compare` reads
the numbers that decide `correct`.
"""

from __future__ import annotations

import copy
import math
import os
import shutil
import statistics
import tempfile
import time
from contextlib import nullcontext

import torch

from benchmark.reference import iteration as R
from benchmark.reference import precision
from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch import constants as C
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.models.agent import (LN_EPS, ActorCritic,
                                                       Agent)
from madrona_basketball_tpu_torch.models.normalize import rms_init
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train import (auto_chunk,
                                                    make_train_chunk,
                                                    unstack_metrics)
from madrona_basketball_tpu_torch.ppo.train_fused import (
    METRICS, init_train_state, make_train_iteration)
from madrona_basketball_tpu_torch.utils.checkpoint import save_agent

# the libraries the flagship iteration launches: A (the reset pulse),
# B, C, the meter scan, D
LIBRARIES = ("fused_step", "fused_rollout", "fused_gae", "meter_scan",
             "fused_update")
CONTROL = "tf32"   # the policy's products are float32, TF32 off


def policy_net(policy: dict) -> ActorCritic:
    """The ActorCritic that the configuration's `policy` block states.
    Set-up stops where the block states what the port does not build: its
    kernels serve one width, obs layout, action heads, LayerNorm and
    precision, those of `ActorCritic()`.  (Its `tf32` sets torch's TF32
    flags for the run: `run.py::set_precision`.)"""
    net = ActorCritic(obs_dim=policy["obs_size"],
                      num_channels=policy["hidden_size"],
                      num_layers=policy["num_hidden_layers"],
                      action_dim=sum(policy["action_buckets"]))
    port = ActorCritic()
    built = {"obs_used": C.OBS_USED,
             "action_buckets": list(C.ACTION_BUCKETS),
             "layer_norm_eps": LN_EPS, "dtype": "float32"}
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    if shapes != {k: tuple(v.shape) for k, v in port.state_dict().items()}:
        raise SystemExit(f"the configuration's policy block {policy} "
                         f"states widths the port's kernels do not serve")
    for k, v in built.items():
        if policy[k] != v:
            raise SystemExit(f"the configuration's policy.{k} is "
                             f"{policy[k]!r}; the port builds {v!r}")
    return net


def make_agents(seed: int, device, n: int, policy: dict, heads: str):
    """n agents of the configuration's policy whose weights come from one
    normal draw of a generator on `device` seeded by `seed`: the
    backbone's Linear weights N(0, 2/3 / fan_in) (the reference recipe's
    variance scaling), LayerNorm scales 1, every bias 0, fresh
    normalizers; the heads N(0, (0.01 / sqrt(fan_in))^2) (heads "recipe":
    the scale of its orthogonal(0.01) init) or with the backbone's
    scaling (heads "trained": logits of a policy that has learned to
    prefer its actions).  The configuration's `assumed` block says which
    heads a cell's agents have."""
    if heads not in ("recipe", "trained"):
        raise SystemExit(f"heads must be 'recipe' or 'trained', not "
                         f"{heads!r}")
    template = policy_net(policy)
    shapes = {k: v.shape for k, v in template.state_dict().items()}
    weights = [k for k, s in shapes.items() if len(s) == 2]
    sizes = [math.prod(shapes[k]) for k in weights]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draw = torch.randn((n, sum(sizes)), generator=gen, device=device)
    agents = []
    for i in range(n):
        net = copy.deepcopy(template).to(device)
        sd = {}
        for k, part in zip(weights, draw[i].split(sizes)):
            fan_in = shapes[k][1]
            std = math.sqrt(2.0 / 3.0 / fan_in) \
                if k.startswith("backbone") or heads == "trained" \
                else 0.01 / math.sqrt(fan_in)
            sd[k] = part.reshape(shapes[k]) * std
        for k, s in shapes.items():
            if k not in sd:     # biases 0, LayerNorm scales 1
                is_scale = k.endswith("weight")
                sd[k] = torch.full(s, 1.0 if is_scale else 0.0,
                                   device=device)
        net.load_state_dict(sd)
        obs_size = policy["obs_size"]
        agents.append(Agent(net=net, obs_rms=rms_init(obs_size, device),
                            value_rms=rms_init(1, device)))
    return agents


def _host(x):
    return x.detach().to("cpu", copy=True)


def snapshot(state) -> dict:
    """A reference state (reference/iteration.py) copied to the host from
    a TrainState."""
    def rms(r):
        return (_host(r.mean), _host(r.var), _host(r.count))

    def net(a):
        return {k: _host(v) for k, v in a.net.state_dict().items()}
    st = state.stats
    return dict(
        net=net(state.agent), obs_rms=rms(state.agent.obs_rms),
        value_rms=rms(state.agent.value_rms), frozen_net=net(state.frozen),
        frozen_obs_rms=rms(state.frozen.obs_rms),
        frozen_value_rms=rms(state.frozen.value_rms),
        sf=_host(state.sf), si=_host(state.si), obs=_host(state.obs),
        stats={k: _host(getattr(st, k)) for k in R.STATS},
        mu=tuple(_host(m) for m in state.opt.mu),
        nu=tuple(_host(v) for v in state.opt.nu),
        count=int(state.opt.count), seed=int(state.seed),
        counter=int(state.counter))


def stage_outputs(out: dict) -> dict:
    """The eager iteration's `out` as the reference's stages give theirs,
    on the host."""
    def rms(r):
        return (_host(r.mean), _host(r.var), _host(r.count))
    return dict(traj=_host(out["traj"]), side=_host(out["side"]),
                ustats=_host(out["ustats"]), obs_rms=rms(out["obs_rms"]),
                value_rms=rms(out["value_rms"]),
                stats={k: _host(getattr(out["stats"], k)) for k in R.STATS},
                metrics={k: _host(out["metrics"][k]) for k in R.METRICS})


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def max_exact_diff(a, b) -> float:
    """The largest |a - b| over two snapshots' tensors (inf where a shape,
    a dtype or a host value differs)."""
    if isinstance(a, dict):
        return max([max_exact_diff(a[k], b[k]) for k in a] + [0.0])
    if isinstance(a, tuple):
        return max([max_exact_diff(x, y) for x, y in zip(a, b)] + [0.0])
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return math.inf
        d = (a.double() - b.double()).abs()
        return float(d.max()) if d.numel() else 0.0
    return 0.0 if a == b else math.inf


class Run:
    """One run of a training cell: `window(seconds)`, then `trace_window()`
    (traced runs) and `check()`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = dev = torch.device(device)
        self.traffic = traffic
        if dev.type == "cuda":
            _build.build(LIBRARIES)
        self.cfg = SimConfig(**config["sim"])
        self.hp = hp = PPOParams(**config["ppo"])
        self.log_every = config["log_every"]
        self.save_every = config["save_every"]
        trainee, frozen = make_agents(seed, dev, 2, config["policy"],
                                      config["assumed"]["init_heads"])
        state = init_train_state(self.cfg, hp, seed, dev, agent=trainee,
                                 frozen=frozen)
        self.train_iteration = make_train_iteration(self.cfg, hp, dev)
        self.chunk_n = auto_chunk(self.log_every, self.save_every)
        self.chunk = make_train_chunk(self.train_iteration, self.chunk_n)
        # the warm chunk: every kernel's first launch and the capture
        self.chunk(copy.deepcopy(state))
        # the checked steps: each through the chunk's graph, and the same
        # step eagerly from a copy, whose stage outputs the reference reads
        self.snaps, self.outs, self.graph_vs_eager = [snapshot(state)], [], 0.0
        for _ in range(traffic["check_steps"]):
            eager, out = self.train_iteration(copy.deepcopy(state))
            state, metrics = self._advance(state)
            self.snaps.append(snapshot(state))
            self.outs.append(stage_outputs(out))
            self.graph_vs_eager = max(
                self.graph_vs_eager,
                max_exact_diff(self.snaps[-1], snapshot(eager)),
                max_exact_diff({k: _host(v) for k, v in metrics.items()},
                               self.outs[-1]["metrics"]))
        self.state = state
        self.ckpt_dir = tempfile.mkdtemp(prefix="bench_ckpt_")
        self.iteration = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _advance(self, state):
        """One iteration through the chunk's own captured graph (on the CPU,
        where a chunk loops the eager iteration: that iteration)."""
        cap = self.chunk.captured
        if not cap:
            state, out = self.train_iteration(state)
            return state, {k: v.clone() for k, v in out["metrics"].items()}
        static, graph = cap["static"], cap["graph"]
        static.load(state)
        static.reseed(state.seed, state.counter)
        graph.replay()
        metrics = {k: static.metrics[j].clone()
                   for j, k in enumerate(METRICS)}
        return static.result(state, 1), metrics

    def _dispatch(self):
        self.state, self._stacked = self.chunk(self.state)

    def _chunk_body(self, mark):
        """The loop body of the CLI and the league for one chunk."""
        with mark("chunk_dispatch"):
            self._dispatch()
        self._after_dispatch(mark)

    def _after_dispatch(self, mark):
        """The loop body after a chunk's dispatch: the unstack, the log
        readback and the save at their cadences."""
        with mark("unstack_metrics"):
            rows = unstack_metrics(self._stacked, self.chunk_n)
        for metrics in rows:
            self.iteration += 1
            if self.iteration % self.log_every == 0:
                with mark("log_readback"):
                    self.logged = {k: float(v) for k, v in metrics.items()}
            if self.iteration % self.save_every == 0:
                with mark("save_agent"):
                    save_agent(self.state.agent, os.path.join(
                        self.ckpt_dir, f"agent_{self.iteration}.pth"))

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        start = self.iteration
        while time.perf_counter() - t0 < seconds:
            self._chunk_body(lambda name: nullcontext())
        _sync(self.state)
        window_s = time.perf_counter() - t0
        done = self.iteration - start
        env_steps = done * self.hp.num_envs * self.hp.num_rollout_steps
        return {"train_env_steps_per_s": env_steps / window_s,
                "iterations": done, "window_s": window_s}

    def trace_window(self) -> dict:
        """Whole chunks of at least `profile_iterations` iterations, after
        the window: first timed by CUDA events with no profiler
        (`trace.event_span`: each dispatch between two events, the rest of
        the loop body after it), then under torch.profiler: the device's
        operations and the host's phases (record_function ranges)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark import trace
        n = -(-self.traffic["profile_iterations"] // self.chunk_n)
        events = {}
        if self.device.type == "cuda":
            events = trace.event_span(
                self._dispatch,
                lambda: self._after_dispatch(lambda name: nullcontext()), n)
            _sync(self.state)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                self._chunk_body(record_function)
            _sync(self.state)
            window_s = time.perf_counter() - t0
        return {"prof": prof, "window_s": window_s,
                "iterations": n * self.chunk_n, **events}

    def free(self):
        """Drop the program's state (the snapshots stay)."""
        shutil.rmtree(self.ckpt_dir, ignore_errors=True)
        self.state = self.chunk = self.train_iteration = None

    def produced(self) -> list:
        """What the timed path produced at each checked step: (the state
        after it, the eager step's stage outputs)."""
        return list(zip(self.snaps[1:], self.outs))

    def check(self, produced=None) -> dict:
        """The numbers that decide `correct`, each the worst over the
        steps: the reference's stages from each snapshot before a step
        against what `produced` (by default the timed path's, with
        graph_vs_eager) holds after it."""
        own = produced is None
        produced = self.produced() if own else produced
        dev = self.device
        steps = []
        for before, (prog, out) in zip(self.snaps, produced):
            steps.append(compare(self.cfg, self.hp, to_device(before, dev),
                                 to_device(prog, dev), to_device(out, dev)))
        numbers = {"graph_vs_eager": self.graph_vs_eager if own else 0.0}
        numbers.update({k: max(s[k] for s in steps) for k in steps[0]})
        return numbers

    def reference_steps(self, mode: str) -> list:
        """The reference in `mode` from each snapshot before a step, as
        `produced` holds them: the control's stand-in for the program."""
        precision.set_mode(mode)
        dev = self.device
        try:
            return [R.iteration(self.cfg, self.hp, to_device(s, dev))
                    for s in self.snaps[:-1]]
        finally:
            precision.set_mode("float32")


def _sync(state):
    if state.sf.device.type == "cuda":
        torch.cuda.synchronize(state.sf.device)


# ---- the comparison ----

DIVERGED = 1e-3  # a world whose float rows differ by more has diverged


def leaves(w1t, w2t, wht, bias) -> list:
    """The packed matrices split into the module's 12 leaves."""
    n = R.N_LOGITS
    return ([w1t, w2t, wht[:n], wht[n:n + 1]] +
            [bias[:, c] for c in range(6)] + [bias[:n, 6], bias[n:n + 1, 6]])


def _leaf_norms(mats) -> list:
    return [float(torch.linalg.vector_norm(x.double())) for x in
            leaves(*mats)]


def _gap(prog_norms, ref_norms, keep) -> float:
    """Worst leaf of |program's norm - reference's| over the larger of the
    reference's norm and the median leaf's."""
    med = statistics.median(ref_norms[i] for i in keep)
    return max(abs(prog_norms[i] - ref_norms[i]) / max(ref_norms[i], med)
               for i in keep)


def _row_err(p, r, row_dim: int):
    """|p - r| over the largest |r| of its row (the row axis `row_dim`),
    elementwise, in float64; inf where p is not finite."""
    p, r = p.double(), r.double()
    dims = [d for d in range(r.dim()) if d != row_dim]
    scale = r.abs().amax(dim=dims, keepdim=True) if dims else r.abs()
    err = (p - r).abs() / scale.clamp(min=1e-30)
    return torch.where(torch.isfinite(p), err, torch.full_like(err, math.inf))


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


# the trajectory rows a sample fills: obs, actions, logp, value, reward,
# done (the pad rows stay 0)
TRAJ_ROWS = list(range(R.R_VALUE - 3)) + [R.R_VALUE, R.R_REW, R.R_DONE]


def compare(cfg, hp, before: dict, prog: dict, out: dict) -> dict:
    """One step's numbers, stage by stage: the reference's rollout from
    the state before the step against the program's trajectory and rows
    (a world whose int rows or actions differ, or whose float rows differ
    by more than DIVERGED of their row's scale, has diverged: counted in
    worlds_off_pct and left out of traj_err); its GAE, meters and
    normalizer merges on the program's trajectory against the program's
    (gae_err); its update on the program's trajectory, side rows and
    normalizer from the same weights against the program's weights and
    Adam moments, leaf by leaf (update_gap, moment_gap)."""
    c = R.collect(cfg, hp, before)
    traj = out["traj"]
    acts = slice(R.R_ACT, R.R_ACT + 6)
    off = (prog["si"] != c["si"]).any(dim=0) | \
        (traj[:, acts] != c["traj"][:, acts]).any(dim=1).any(dim=0)
    per_world = [
        _row_err(traj[:, TRAJ_ROWS], c["traj"][:, TRAJ_ROWS], 1).amax(
            dim=(0, 1)),
        _row_err(prog["sf"], c["sf"], 0).amax(dim=0),
        _row_err(prog["obs"], c["obs"], 0).amax(dim=0)]
    err = torch.stack(per_world).amax(dim=0)
    off |= err > DIVERGED
    a = R.advantages(hp, before, traj, prog["obs"])
    gae = [_row_err(out["side"][:, 0:3], a["side"][:, 0:3], 1),
           _row_err(out["ustats"][0, :4], a["ustats"][0, :4], 0)]
    for k in ("obs_rms", "value_rms"):
        gae += [_row_err(x, y, -1) for x, y in zip(out[k], a[k])]
    gae += [_row_err(out["stats"][k], a["stats"][k], -1) for k in R.STATS]
    gae += [_row_err(out["metrics"][k], a["metrics"][k], -1)
            for k in R.METRICS]
    u = R.update(hp, before, traj, out["side"], out["ustats"], out["obs_rms"])
    # leaves whose reference gradient is under a thousandth of the median
    # leaf's are left out (Adam moves them by round-off alone)
    g = _leaf_norms(u["grad"])
    keep = [i for i, x in enumerate(g) if x >= 1e-3 * statistics.median(g)]
    p0 = R.pack_net(before["net"], R.D)
    delta = [[x - y for x, y in zip(R.pack_net(n, R.D), p0)]
             for n in (prog["net"], u["net"])]
    finite = all(bool(torch.isfinite(x).all()) for x in delta[0])
    norms = {"delta": (_leaf_norms(delta[0]), _leaf_norms(delta[1]))}
    for k in ("mu", "nu"):
        norms[k] = (_leaf_norms(prog[k]), _leaf_norms(u[k]))
    return dict(
        worlds_off_pct=100.0 * float(off.sum()) / off.numel(),
        traj_err=_max(err[~off]),
        gae_err=max(_max(x) for x in gae),
        update_gap=_gap(*norms["delta"], keep) if finite else math.inf,
        moment_gap=max(_gap(*norms[k], keep) for k in ("mu", "nu"))
        if finite else math.inf)
