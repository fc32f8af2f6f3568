"""Training-iteration benchmark: ms per iteration and train env-steps/s
(the port's counterpart of the root `bench_train.py`).

    python -m madrona_basketball_tpu_torch.bench_train [W] [--no-frozen]
        [--tiled] [--bf16-traj] [--bf16-policy] [--iters-per-dispatch N]
        [--num-rollout-steps T] [--device cpu]

Times the flagship training iteration (rollout kernel B, or kernel I and
E with `--tiled`, then GAE and the 4 x 4 minibatch update) at W worlds
(default 8192) with the frozen opponent on (the JAX script's default),
from `init_train_state(seed=1)` (`--bf16-traj`, `--bf16-policy`: the
training CLI's bf16 branches), two ways:
  * eager: one host dispatch an iteration, best of 3 rounds of 20
    chained iterations, after one untimed iteration;
  * chunked: N (50) iterations a dispatch (`ppo/train.py::
    make_train_chunk`, one iteration captured as a CUDA graph and
    replayed), best of 3 chained chunks, after one untimed chunk (the
    capture).
Each round ends in `torch.cuda.synchronize`.  Stdout gets one JSON line:
ms an iteration and train env-steps/s (W x T / iteration time) of both,
with the card's name and power limit.  `--device cpu` runs the plain
versions (with a small W, T and N); its numbers are CPU times, not device
metrics.
"""

from __future__ import annotations

import argparse
import json

import torch

from .bench import card_name_and_power_limit
from .config import SimConfig
from .ppo.hparams import PPOParams
from .ppo.train import make_train_chunk
from .ppo.train_fused import init_train_state, make_train_iteration
from .utils.benching import bench_ms

REPS, TRIES = 20, 3   # the root bench_train.py's: best of 3 x 20 chained


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("worlds", nargs="?", type=int, default=8192)
    ap.add_argument("--no-frozen", action="store_true")
    ap.add_argument("--tiled", action="store_true")
    ap.add_argument("--bf16-traj", action="store_true")
    ap.add_argument("--bf16-policy", action="store_true")
    ap.add_argument("--iters-per-dispatch", type=int, default=50)
    ap.add_argument("--num-rollout-steps", type=int,
                    default=PPOParams.num_rollout_steps)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_train: no CUDA card (pass --device cpu "
                             "for the plain versions)")
        name, power = card_name_and_power_limit()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        name, power = str(dev), None
    if args.iters_per_dispatch < 1:
        raise SystemExit("bench_train: --iters-per-dispatch must be >= 1")
    W, T, n = args.worlds, args.num_rollout_steps, args.iters_per_dispatch
    cfg = SimConfig()
    hp = PPOParams(num_envs=W, num_rollout_steps=T,
                   use_frozen=not args.no_frozen)
    it = make_train_iteration(cfg, hp, dev, rollout_tiled=args.tiled,
                              bf16_traj=args.bf16_traj,
                              bf16_policy=args.bf16_policy)
    holder = [init_train_state(cfg, hp, seed=1, device=dev)]

    def eager():
        holder[0], _ = it(holder[0])
    eager_ms = bench_ms(eager, reps=REPS, tries=TRIES, device=dev)
    chunk = make_train_chunk(it, n)

    def chunked():
        holder[0], _ = chunk(holder[0])
    chunk_ms = bench_ms(chunked, reps=1, tries=TRIES, device=dev) / n
    line = {"metric": f"train_iteration_ms_{W}", "worlds": W, "ticks": T,
            "frozen": hp.use_frozen, "tiled": args.tiled,
            "bf16_traj": args.bf16_traj, "bf16_policy": args.bf16_policy,
            "eager_ms": eager_ms,
            "eager_train_env_steps_per_s": W * T / (eager_ms / 1e3),
            "eager_method": f"best_of_{TRIES}x{REPS}_chained",
            "iters_per_dispatch": n, "chunked_ms": chunk_ms,
            "chunked_train_env_steps_per_s": W * T / (chunk_ms / 1e3),
            "chunked_method": f"best_of_{TRIES}_chained_chunks",
            "iterations_run": holder[0].iteration,
            "device": name, "power_limit": power}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
