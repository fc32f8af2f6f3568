"""Weak-scaling sweep over data-parallel ranks (the port's counterpart of
the root `bench_scaling.py`).

    python -m madrona_basketball_tpu_torch.bench_scaling
        [--worlds-per-gpu 4096] [--max-gpus N] [--num-rollout-steps 32]
        [--sim-steps 500] [--iters-per-dispatch 20] [--bf16-traj]
        [--bf16-policy] [--device cpu]

For n = 1 .. N GPUs (N: every visible GPU) at a FIXED number of worlds a
GPU, one process a GPU (n = 1 in this process, n > 1 spawned ranks of a
NCCL group), it times

  * stepping: each rank's `FusedEngine.step_many(sim_steps)` (kernel F)
    on its own worlds, best of 3 rounds, the slowest rank's time;
  * training: the plain data-parallel iteration (`make_train_iteration(
    ..., mesh=...)`, with the training CLI's bf16 flags when given) at
    n x worlds a GPU, chunks of
    `--iters-per-dispatch` iterations (on the card one iteration
    captured as a CUDA graph), best of 3 chunks, the slowest rank's
    time;

and prints one JSON line a step: env-steps/s of both and the efficiency
against n = 1 (rate_n / (n x rate_1)), with the card's name and power
limit.  `--device cpu` runs the plain versions on gloo ranks (small
sizes; `--max-gpus` then sets the rank count): the mechanics only, its
numbers are CPU times, not device metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from .config import SimConfig
from .engine_fused import FusedEngine
from .parallel.distributed import backend_for, init_single_process
from .parallel.mesh import make_mesh, shard_train_state
from .ppo.hparams import PPOParams
from .ppo.train import make_train_chunk
from .ppo.train_fused import init_train_state, make_train_iteration

TRIES = 3


def _slowest(seconds: float, dev) -> float:
    """The largest of the ranks' times."""
    t = torch.tensor([seconds], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _best(fn, dev) -> float:
    """Fastest of TRIES calls of fn() (after one untimed call), each
    bracketed by barriers and synchronized: seconds, the slowest rank."""
    fn()
    best = float("inf")
    for _ in range(TRIES):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, _slowest(time.perf_counter() - t0, dev))
    return best


def measure(args) -> dict:
    """One rank's part of the step at the group's size; rank 0's dict."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    mesh = make_mesh(args.device)
    dev, n = mesh.device, mesh.size
    cfg = SimConfig()
    wpg, T = args.worlds_per_gpu, args.num_rollout_steps
    eng = FusedEngine(cfg, wpg, seed=mesh.rank, device=dev)
    sim_s = _best(lambda: eng.step_many(args.sim_steps), dev)
    hp = PPOParams(num_envs=n * wpg, num_rollout_steps=T)
    state = shard_train_state(init_train_state(cfg, hp, 1, dev), mesh)
    it = make_train_iteration(cfg, hp, dev, mesh=mesh,
                              bf16_traj=args.bf16_traj,
                              bf16_policy=args.bf16_policy)
    chunk = make_train_chunk(it, args.iters_per_dispatch)
    holder = [state]

    def train():
        holder[0], _ = chunk(holder[0])
    it_s = _best(train, dev) / args.iters_per_dispatch
    return {"gpus": n, "worlds_per_gpu": wpg, "worlds": n * wpg,
            "ticks": T, "sim_steps": args.sim_steps,
            "sim_env_steps_per_s": n * wpg * args.sim_steps / sim_s,
            "iters_per_dispatch": args.iters_per_dispatch,
            "train_iteration_ms": it_s * 1e3,
            "train_env_steps_per_s": n * wpg * T / it_s,
            "bf16_traj": args.bf16_traj, "bf16_policy": args.bf16_policy,
            "backend": mesh.backend}


def _worker(rank: int, n: int, rdv: str, args, queue):
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend_for(dev), init_method=f"file://{rdv}",
                            rank=rank, world_size=n)
    try:
        row = measure(args)
        if rank == 0:
            queue.put(row)
    finally:
        dist.destroy_process_group()


def run(args, n: int) -> dict:
    """The step at n ranks: in this process for n = 1, else n spawned."""
    if n == 1:
        init_single_process(args.device)
        try:
            return measure(args)
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(n, os.path.join(tmp, "rdv"), args, queue),
                 nprocs=n)
    return queue.get()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds-per-gpu", type=int, default=4096)
    ap.add_argument("--max-gpus", type=int, default=0,
                   help="largest n (0: every visible GPU; with --device "
                        "cpu, 1)")
    ap.add_argument("--num-rollout-steps", type=int,
                    default=PPOParams.num_rollout_steps)
    ap.add_argument("--sim-steps", type=int, default=500)
    ap.add_argument("--iters-per-dispatch", type=int, default=20)
    ap.add_argument("--bf16-traj", action="store_true")
    ap.add_argument("--bf16-policy", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_scaling: no CUDA card (pass --device cpu "
                             "for the plain versions)")
        from .bench import card_name_and_power_limit
        name, power = card_name_and_power_limit()
        torch.backends.cuda.matmul.allow_tf32 = False
        visible = torch.cuda.device_count()
        if args.max_gpus > visible:
            raise SystemExit(f"bench_scaling: --max-gpus {args.max_gpus} > "
                             f"{visible} visible GPUs")
        top = args.max_gpus or visible
    else:
        name, power = str(dev), None
        top = args.max_gpus or 1
    rows = []
    for n in range(1, top + 1):
        row = run(args, n)
        base = rows[0] if rows else row
        row.update(
            sim_efficiency=row["sim_env_steps_per_s"] /
            (n * base["sim_env_steps_per_s"]),
            train_efficiency=row["train_env_steps_per_s"] /
            (n * base["train_env_steps_per_s"]),
            device=name, power_limit=power)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
