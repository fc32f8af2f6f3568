"""PPO training CLI of the port —
`python -m madrona_basketball_tpu_torch.cli [...]`.

Port of `madrona_basketball_tpu/cli.py:28-149,281-500` for the flagship
trainer (rollout kernel + fused gradients + fused GAE): the same flags and
defaults, plus `--device` (default "cuda"; "cpu" runs the plain torch
versions of the kernels, for small runs).  Each iteration is
`ppo/train_fused.py::make_train_iteration`; the log line and the
checkpoint cadence are the JAX CLI's.  Checkpoints are reference-layout
`.pth` files under `checkpoints/{model}/{model}_{iteration}.pth`, which
the JAX CLI's `--trainee-checkpoint` also reads.

Flags of trainer paths the port does not have yet exit with the ROADMAP
item that ports them, instead of being ignored.
"""

from __future__ import annotations

import argparse
import time

from .config import SimConfig
from .ppo.hparams import PPOParams
from .ppo.train_fused import init_train_state, make_train_iteration
from .utils.checkpoint import checkpoint_path, load_agent, save_agent
from .utils.timers import PPOTimer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PPO trainer (PyTorch + CUDA)")
    p.add_argument("--seed", type=int, default=321)
    p.add_argument("--model-name", type=str, default="Model")
    p.add_argument("--trainee-idx", type=int, default=1)
    p.add_argument("--trainee-checkpoint", type=str, default=None)
    p.add_argument("--frozen-checkpoint", type=str, default=None)
    p.add_argument("--num-iterations", type=int, default=100_000)
    p.add_argument("--num-envs", type=int, default=8192)
    p.add_argument("--num-rollout-steps", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.998)
    p.add_argument("--gae-lambda", type=float, default=0.95)
    p.add_argument("--num-minibatches", type=int, default=4)
    p.add_argument("--update-epochs", type=int, default=4)
    p.add_argument("--clip-coef", type=float, default=0.2)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--vf-coef", type=float, default=1.0)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--log-every-n-iterations", type=int, default=100)
    p.add_argument("--save-model-every-n-iterations", type=int, default=100)
    p.add_argument("--no-tag-mode", action="store_true", default=False)
    p.add_argument("--full-game", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    # flags of paths not ported yet: accepted so that JAX command lines
    # parse, refused below unless left at their defaults
    p.add_argument("--shuffle-block", type=int,
                   default=PPOParams.shuffle_block,
                   help="the unfused update's shuffle granularity")
    p.add_argument("--viewer", action="store_true", default=False)
    p.add_argument("--tensorboard", action="store_true", default=False)
    p.add_argument("--backend", choices=("fused", "structured", "xla-rows"),
                   default="fused")
    p.add_argument("--interactive", action="store_true", default=False)
    p.add_argument("--rollout-kernel", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--fused-grads", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--fused-gae", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--data-parallel", action="store_true", default=False)
    p.add_argument("--dp-update", action="store_true", default=False)
    p.add_argument("--distributed", action="store_true", default=False)
    p.add_argument("--rollout-tiled", action="store_true", default=False)
    p.add_argument("--bf16-traj", action="store_true", default=False)
    p.add_argument("--bf16-policy", action="store_true", default=False)
    p.add_argument("--rollout-block", type=int, default=0)
    p.add_argument("--iters-per-dispatch", type=int, default=0,
                   help="0 or 1: one iteration per host dispatch (CUDA-"
                        "graph chunking is not ported yet)")
    return p


_ALT = "ROADMAP.md queue 1, item 16 (alternate trainer paths)"
# flag, test of a non-default value, the ROADMAP item that ports its path
UNPORTED = (
    ("--backend structured / xla-rows", lambda a: a.backend != "fused",
     _ALT),
    ("--no-rollout-kernel", lambda a: a.rollout_kernel is False, _ALT),
    ("--no-fused-grads", lambda a: not a.fused_grads, _ALT),
    ("--no-fused-gae", lambda a: a.fused_gae is False, _ALT),
    ("--rollout-block", lambda a: a.rollout_block != 0, _ALT),
    ("--shuffle-block", lambda a: a.shuffle_block != PPOParams.shuffle_block,
     _ALT),
    ("--bf16-traj", lambda a: a.bf16_traj, _ALT),
    ("--bf16-policy", lambda a: a.bf16_policy, _ALT),
    ("--rollout-tiled", lambda a: a.rollout_tiled,
     "ROADMAP.md queue 2, item 9 (kernel I)"),
    ("--data-parallel", lambda a: a.data_parallel,
     "ROADMAP.md queue 1, item 12 (multi-GPU)"),
    ("--dp-update", lambda a: a.dp_update,
     "ROADMAP.md queue 1, item 12 (multi-GPU)"),
    ("--distributed", lambda a: a.distributed,
     "ROADMAP.md queue 1, item 12 (multi-GPU)"),
    ("--interactive", lambda a: a.interactive,
     "ROADMAP.md queue 1, item 13 (interactive trainer, viewer)"),
    ("--viewer", lambda a: a.viewer,
     "ROADMAP.md queue 1, item 13 (interactive trainer, viewer)"),
    ("--tensorboard", lambda a: a.tensorboard,
     "ROADMAP.md queue 1, item 8 (TensorBoard logging)"),
    ("--iters-per-dispatch > 1", lambda a: a.iters_per_dispatch not in (0, 1),
     "ROADMAP.md queue 1, item 8 (chunked dispatch as CUDA graphs)"),
)


def check_ported(args):
    for flag, given, item in UNPORTED:
        if given(args):
            raise SystemExit(f"{flag}: this trainer path is not ported to "
                             f"the PyTorch package yet ({item})")


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    model_name = args.model_name or \
        f"MadronaBasketball__{args.seed}__{int(time.time())}"
    cfg = SimConfig(one_on_one=not args.full_game,
                    tag_mode=not args.no_tag_mode and not args.full_game)
    hp = PPOParams(
        num_envs=args.num_envs,
        num_rollout_steps=args.num_rollout_steps,
        learning_rate=args.learning_rate,
        gamma=args.gamma, gae_lambda=args.gae_lambda,
        num_minibatches=args.num_minibatches,
        update_epochs=args.update_epochs,
        clip_coef=args.clip_coef, ent_coef=args.ent_coef,
        vf_coef=args.vf_coef, max_grad_norm=args.max_grad_norm,
        trainee_idx=args.trainee_idx,
        use_frozen=args.frozen_checkpoint is not None)
    dev = args.device
    agent = load_agent(args.trainee_checkpoint, dev) \
        if args.trainee_checkpoint else None
    frozen = load_agent(args.frozen_checkpoint, dev) \
        if args.frozen_checkpoint else None

    print("🎯 TRAINING CONFIGURATION:")
    print(f"   Trainee Agent Index: {hp.trainee_idx}")
    print(f"   Frozen Checkpoint: {args.frozen_checkpoint}")
    print(f"   Model: {model_name}  Envs: {hp.num_envs}  "
          f"Iters: {args.num_iterations}")
    print(f"   Device: {dev}")

    state = init_train_state(cfg, hp, args.seed, dev, agent=agent,
                             frozen=frozen)
    train_iteration = make_train_iteration(cfg, hp, dev)
    timer = PPOTimer(dev)
    timer.start("iter")
    for iteration in range(1, args.num_iterations + 1):
        timer.add_steps(hp.num_envs * hp.num_rollout_steps)
        state, out = train_iteration(state)
        if iteration % args.log_every_n_iterations == 0:
            timer.end("iter")
            m = {k: float(v) for k, v in out["metrics"].items()}
            print(f"\nUpdate: {iteration}", end=" ")
            timer.print()
            print(f"Mean reward: {m['mean_reward']:.2f}. "
                  f"Mean episode length: {m['mean_episode_length']:.2f}")
            timer.reset()
            timer.start("iter")
        if iteration % args.save_model_every_n_iterations == 0:
            save_agent(state.agent, checkpoint_path(model_name, iteration))
            print(f"Model {model_name} saved at iteration {iteration}")
    return state


if __name__ == "__main__":
    main()
