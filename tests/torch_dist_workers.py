"""Multi-process helpers of the port's data-parallel tests: gloo on the
CPU, ranks started by `torch.multiprocessing.spawn`, a `file://`
rendezvous in the test's tmp_path (no TCP port).  Imports no JAX, so a
spawned rank starts in a few seconds.

`run_iterations(mesh, spec)` is the body both sides run: the ranks of a
spawned group, and the one-process reference in the test's own process
(`single_group()`, a world-size-1 gloo group, or no mesh at all).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.parallel.mesh import (gather_train_state,
                                                        make_mesh,
                                                        shard_train_state)
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    CollectNoise, init_train_state, make_train_iteration)


# Seconds a rank waits in a gloo rendezvous or collective, and a spawned
# group's whole run: a cold job takes up to ~20 s on a loaded CPU.
GLOO_TIMEOUT = 60
DEADLINE = 120


def hparams(spec: dict) -> PPOParams:
    return PPOParams(num_envs=spec["W"], num_rollout_steps=spec["T"],
                     num_minibatches=spec.get("M", 4),
                     update_epochs=spec.get("E", 4),
                     use_frozen=spec.get("frozen", False))


def noise_of(spec: dict, it: int) -> CollectNoise:
    """The whole fleet's draws of iteration `it`, from a numpy seed."""
    W, T = spec["W"], spec["T"]
    rng = np.random.RandomState(1000 * spec.get("noise_seed", 5) + it)
    pulse = np.concatenate([rng.uniform(-1, 1, (8, W)),
                            rng.uniform(0, 1, (1, W))]).astype(np.float32)
    noise = rng.uniform(0, 1, (T * FR.EXT_NOISE_CHUNK, W))
    row = np.arange(T * FR.EXT_NOISE_CHUNK) % FR.EXT_NOISE_CHUNK
    noise = np.where((row < 8)[:, None], 2 * noise - 1, noise)
    frozen_u = rng.uniform(0, 1, (FR.N_LOGITS, W)).astype(np.float32)
    return CollectNoise(pulse=torch.tensor(pulse),
                        rollout=torch.tensor(noise.astype(np.float32)),
                        pulse_frozen_u=torch.tensor(frozen_u))


def perms_of(shape, it: int, seed: int = 9) -> torch.Tensor:
    rng = np.random.RandomState(1000 * seed + it)
    rows = [rng.permutation(shape[-1])
            for _ in range(int(np.prod(shape[:-1])))]
    return torch.tensor(np.stack(rows).reshape(shape).astype(np.int32))


def _cpu(x):
    return x.detach().to("cpu", copy=True)


def run_iterations(mesh, spec: dict) -> dict:
    """`spec["iters"]` iterations of `make_train_iteration` (mesh or
    None, spec["dp"], spec["tiled"]) from `init_train_state(seed)`, on
    injected noise and permutations (spec["perm_shape"], else drawn);
    returns CPU copies of what the tests compare, the first
    iteration's update inputs (under dp) and the shard round trip."""
    cfg, hp = SimConfig(), hparams(spec)
    dp = spec.get("dp", False)
    whole = init_train_state(cfg, hp, spec.get("seed", 3), "cpu")
    state = whole if mesh is None else shard_train_state(whole, mesh, dp)
    out = {}
    if mesh is not None:
        back = gather_train_state(state, mesh, dp)
        out["round_trip"] = all(
            torch.equal(getattr(back, k), getattr(whole, k))
            for k in ("sf", "si", "obs")) and all(
            torch.equal(getattr(back.stats, f.name),
                        getattr(whole.stats, f.name))
            for f in dataclasses.fields(whole.stats))
    it_fn = make_train_iteration(cfg, hp, "cpu", mesh=mesh, dp_update=dp,
                                 rollout_tiled=spec.get("tiled", False))
    metrics = []
    for it in range(spec["iters"]):
        pre = (tuple(_cpu(p) for p in FU.pack_weights(state.agent.net)),
               tuple(_cpu(m) for m in state.opt.mu),
               tuple(_cpu(v) for v in state.opt.nu), state.opt.count,
               _cpu(state.agent.obs_rms.mean), _cpu(state.agent.obs_rms.var),
               _cpu(state.agent.obs_rms.count))
        perms = perms_of(spec["perm_shape"], it) \
            if "perm_shape" in spec else None
        state, o = it_fn(state, noise_of(spec, it), perms=perms)
        metrics.append({k: _cpu(v) for k, v in o["metrics"].items()})
        if it == 0:
            out["first"] = {"pre": pre, "perms": perms,
                            **{k: _cpu(o[k]) for k in ("traj", "side",
                                                       "ustats")},
                            "obs_rms": {f: _cpu(getattr(o["obs_rms"], f))
                                        for f in ("mean", "var", "count")}}
    out.update(
        params=[_cpu(p) for p in FU.pack_weights(state.agent.net)],
        mu=[_cpu(m) for m in state.opt.mu],
        nu=[_cpu(v) for v in state.opt.nu],
        rms={f"{a}.{f}": _cpu(getattr(getattr(state.agent, a), f))
             for a in ("obs_rms", "value_rms")
             for f in ("mean", "var", "count")},
        stats={f.name: _cpu(getattr(state.stats, f.name))
               for f in dataclasses.fields(state.stats)},
        rows={k: _cpu(getattr(state, k)) for k in ("sf", "si", "obs")},
        metrics=metrics, count=state.opt.count, counter=state.counter)
    return out


@contextlib.contextmanager
def single_group():
    """A world-size-1 gloo group in this process, destroyed on exit."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _iterations_job(rank, spec, out_dir):
    torch.save(run_iterations(make_mesh("cpu"), spec),
               os.path.join(out_dir, f"rank{rank}.pt"))


def _cli_job(rank, argv, out_dir):
    from madrona_basketball_tpu_torch import cli
    cwd = os.path.join(out_dir, f"rank{rank}")
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    cli.main(argv)


def run_paths(mesh, spec: dict) -> dict:
    """`spec["iters"]` iterations of the per-tick rows path
    (spec["path"] "per_tick") or the structured trainer ("structured")
    under `mesh` (or none), on injected noise and permutations; CPU copies
    of the learner, the stats, the metrics and the fleet (the structured
    state packed into rows)."""
    from madrona_basketball_tpu_torch.ops import layout
    from madrona_basketball_tpu_torch.ppo import train as TT
    cfg, hp = SimConfig(), hparams(spec)
    if spec["path"] == "structured":
        init, make = TT.init_train_state, TT.make_train_iteration
        kw = {}
    else:
        init, make = init_train_state, make_train_iteration
        kw = {"rollout_kernel": False}
    state = init(cfg, hp, spec.get("seed", 3), "cpu")
    if mesh is not None:
        state = shard_train_state(state, mesh)
    it_fn = make(cfg, hp, "cpu", mesh=mesh, **kw)
    metrics = []
    for it in range(spec["iters"]):
        state, o = it_fn(state, noise_of(spec, it),
                         perms=perms_of(it_fn.perm_shape, it))
        metrics.append({k: _cpu(v) for k, v in o["metrics"].items()})
    fleet = layout.pack(state.env) if hasattr(state, "env") else \
        (state.sf, state.si)
    return dict(
        params=[_cpu(p) for p in FU.pack_weights(state.agent.net)],
        mu=[_cpu(m) for m in state.opt.mu],
        nu=[_cpu(v) for v in state.opt.nu],
        rms={f"{a}.{f}": _cpu(getattr(getattr(state.agent, a), f))
             for a in ("obs_rms", "value_rms")
             for f in ("mean", "var", "count")},
        stats={f.name: _cpu(getattr(state.stats, f.name))
               for f in dataclasses.fields(state.stats)},
        rows=[_cpu(x) for x in fleet], metrics=metrics,
        count=state.opt.count, counter=state.counter)


def _paths_job(rank, spec, out_dir):
    torch.save(run_paths(make_mesh("cpu"), spec),
               os.path.join(out_dir, f"rank{rank}.pt"))


JOBS = {"iterations": _iterations_job, "cli": _cli_job,
        "paths": _paths_job}


def _entry(rank, world, rdv, job, arg, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT))
    try:
        JOBS[job](rank, arg, out_dir)
    finally:
        dist.destroy_process_group()


def spawn(job: str, arg, out_dir, world: int = 2) -> list:
    """Run JOBS[job](rank, arg, out_dir) on `world` gloo ranks; returns
    the ranks' saved results (rank{r}.pt), where the job saved any.
    Ranks that have not all ended DEADLINE s after the spawn are killed
    and the test fails."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    rdv = os.path.join(out_dir, f"rdv-{job}")
    ctx = mp.spawn(_entry, args=(world, rdv, job, arg, out_dir),
                   nprocs=world, join=False)
    end = time.monotonic() + DEADLINE
    while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
        if time.monotonic() >= end:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            raise TimeoutError(f"{job}: {world} ranks still running after "
                               f"{DEADLINE} s")
    paths = [os.path.join(out_dir, f"rank{r}.pt") for r in range(world)]
    return [torch.load(p, weights_only=False) for p in paths
            if os.path.exists(p)]
