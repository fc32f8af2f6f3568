"""Convergence run of the flagship trainer (the port's counterpart of the
root `run_convergence.py`): a learning curve over many iterations,
chunked 100 iterations a dispatch as the JAX script does.

    python -m madrona_basketball_tpu_torch.run_convergence [W] [iters]
        [seed] [update_block] [--tiled] [--frozen]
        [--no-fused-gae] [--no-fused-grads] [--shuffle-block G]
        [--no-rollout-kernel] [--structured] [--bf16-traj]
        [--bf16-policy] [--num-rollout-steps T] [--device cpu]

Defaults: 8192 worlds, 1500 iterations (a multiple of the 100-iteration
chunk), seed 1, the default update block
(0), the canonical learning task (trainee 1 against the in-sim defense,
no frozen opponent; `--frozen` adds a frozen random policy as the JAX
script's flag does).  `--tiled` runs the `--rollout-tiled` iteration
(kernels I and E); `--no-fused-gae`, `--no-fused-grads` (with
`--shuffle-block`), `--no-rollout-kernel`, `--structured`, `--bf16-traj`
and `--bf16-policy` the training CLI's alternate paths of the same names
(with the JAX trainer's refusals).  Prints the reward
and episode length after every chunk
(`utils/benching.py::run_chunked_train`), then one JSON line: the curve,
whether the params are finite, the sustained train env-steps/s (the
first chunk's capture included) and the card's name and power limit.
`--device cpu` runs the plain versions at a small size; its numbers are
CPU times, not device metrics.
"""

from __future__ import annotations

import argparse
import json

import torch

from .bench import card_name_and_power_limit
from .config import SimConfig
from .ppo import train as TT
from .ppo.hparams import PPOParams
from .ppo.train import make_train_chunk
from .ppo.train_fused import init_train_state, make_train_iteration
from .utils.benching import run_chunked_train

CHUNK = 100   # iterations a dispatch, the root run_convergence.py's


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("worlds", nargs="?", type=int, default=8192)
    ap.add_argument("iters", nargs="?", type=int, default=1500)
    ap.add_argument("seed", nargs="?", type=int, default=1)
    ap.add_argument("update_block", nargs="?", type=int, default=0)
    ap.add_argument("--tiled", action="store_true")
    ap.add_argument("--frozen", action="store_true")
    ap.add_argument("--no-fused-gae", action="store_true")
    ap.add_argument("--no-fused-grads", action="store_true")
    ap.add_argument("--no-rollout-kernel", action="store_true")
    ap.add_argument("--structured", action="store_true")
    ap.add_argument("--bf16-traj", action="store_true")
    ap.add_argument("--bf16-policy", action="store_true")
    ap.add_argument("--shuffle-block", type=int,
                    default=PPOParams.shuffle_block)
    ap.add_argument("--num-rollout-steps", type=int,
                    default=PPOParams.num_rollout_steps)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("run_convergence: no CUDA card (pass --device "
                             "cpu for the plain versions)")
        name, power = card_name_and_power_limit()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        name, power = str(dev), None
    W, T = args.worlds, args.num_rollout_steps
    cfg = SimConfig()
    hp = PPOParams(num_envs=W, num_rollout_steps=T, use_frozen=args.frozen,
                   update_block=args.update_block,
                   shuffle_block=args.shuffle_block)
    paths = [f for f in ("tiled", "no_fused_gae", "no_fused_grads",
                         "no_rollout_kernel", "structured", "bf16_traj",
                         "bf16_policy")
             if getattr(args, f)]
    if args.structured:
        it = TT.make_train_iteration(cfg, hp, dev)
        state = TT.init_train_state(cfg, hp, args.seed, dev)
    else:
        it = make_train_iteration(
            cfg, hp, dev, rollout_tiled=args.tiled,
            rollout_kernel=not args.no_rollout_kernel,
            fused_grads=not args.no_fused_grads,
            fused_gae=False if args.no_fused_gae else None,
            bf16_traj=args.bf16_traj, bf16_policy=args.bf16_policy)
        state = init_train_state(cfg, hp, seed=args.seed, device=dev)
    label = (f"conv seed={args.seed} ub={args.update_block or 'auto'}"
             f"{''.join(' ' + f for f in paths)}"
             f"{' frozen' if args.frozen else ''}")
    state, summary = run_chunked_train(
        state, make_train_chunk(it, CHUNK), args.iters, label, W, T,
        ch=CHUNK)
    line = {"metric": "convergence", "worlds": W, "ticks": T,
            "iterations": args.iters, "seed": args.seed,
            "update_block": args.update_block, "tiled": args.tiled,
            "paths": paths, "shuffle_block": args.shuffle_block,
            "frozen": args.frozen, "iters_per_dispatch": CHUNK,
            **summary, "device": name, "power_limit": power}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
