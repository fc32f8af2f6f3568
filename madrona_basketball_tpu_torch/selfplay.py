"""In-process self-play league (port of
`madrona_basketball_tpu/selfplay.py:33-160`).

Two agents take turns: each phase of a generation trains one (the
trainee) against the other, frozen, for `iter_per_agent` iterations of
the flagship trainer (ppo/train_fused.py, the frozen policy's forward
inside kernel B), chunked as the CLI chunks.  The checkpoint naming is
the JAX league's (`{name}_gen_{g}` trained for `iter_per_agent`
iterations, saved every `iter_per_agent // 10` as
`checkpoints/{name}_gen_{g}/{name}_gen_{g}_{iteration}.pth`), so
`infer.multi_gen_infer` evaluates a generation's checkpoints.  The
retired-opponent pool is kept at the reference's probability 0
(scripts/self_play.py:95-98,123-127,151-155).

Seeds: the JAX league splits one key (selfplay.py:87-92,133); here every
draw has an integer seed `league_seed(seed, generation, phase)`, with
generation -1 for the two initial agents (phase = the agent's index).

CLI: python -m madrona_basketball_tpu_torch.selfplay [...] (the JAX CLI's
flags, plus `--device` and `--trace-out PATH`: the league traced,
utils/profiling.py, one Chrome trace written at its end).
"""

from __future__ import annotations

import argparse
import copy
import random
from typing import Optional

import torch

from .config import SimConfig
from .models.agent import Agent, init_agent
from .ppo.hparams import PPOParams
from .ppo.train import TrainLoop, auto_chunk
from .ppo.train_fused import init_train_state, make_train_iteration
from .utils.checkpoint import checkpoint_path, load_agent, save_agent
from .utils.profiling import trace


def league_seed(seed: int, generation: int, phase: int) -> int:
    """The seed of one phase's training session, and with generation -1
    of initial agent `phase`; distinct for every (generation, phase)."""
    return ((seed * 1_000_003 + generation + 1) * 2 + phase) % (2 ** 63)


def train_generation(cfg: SimConfig, hp: PPOParams, seed: int,
                     trainee: Agent, frozen: Agent, num_iterations: int,
                     model_name: str, save_every: int, log_every: int = 100,
                     device="cuda") -> Agent:
    """One training session, the trainee against the frozen opponent
    (scripts/ppo.py's recipe at self-play scale): `num_iterations` of the
    flagship iteration from `init_train_state(seed)`, whole chunks of
    `auto_chunk(log_every, save_every)` then one at a time; returns the
    trained agent (a copy: `trainee` is left as it was)."""
    state = init_train_state(cfg, hp, seed, device,
                             agent=copy.deepcopy(trainee), frozen=frozen)
    it = make_train_iteration(cfg, hp, device)
    chunk_n = max(1, min(auto_chunk(log_every, save_every), num_iterations))

    def log(m, iteration):
        print(f"  [{model_name}] iter {iteration}: "
              f"mean_reward={m['mean_reward']:.3f} "
              f"mean_len={m['mean_episode_length']:.1f}")

    def save(state, iteration):
        save_agent(state.agent, checkpoint_path(model_name, iteration))

    loop = TrainLoop(it, chunk_n, log_every, save_every, log=log, save=save)
    return loop.run(state, num_iterations).agent


def run_league(num_training_cycles: int = 5, iter_per_agent: int = 5000,
               num_envs: int = 8192, first_trainee_idx: int = 1,
               model_name_0: str = "model_0", model_name_1: str = "model_1",
               seed: int = 0, cfg: Optional[SimConfig] = None,
               checkpoint_0: Optional[str] = None,
               checkpoint_1: Optional[str] = None, device="cuda") -> dict:
    cfg = cfg or SimConfig()
    agents = {}
    # Initial policies for both roles (scripts/self_play.py:70-92).
    for i, ckpt in ((0, checkpoint_0), (1, checkpoint_1)):
        if ckpt:
            agents[i] = load_agent(ckpt, device)
        else:
            agents[i] = init_agent(
                torch.Generator().manual_seed(league_seed(seed, -1, i)),
                device)
            save_agent(agents[i], f"checkpoints/model_{i}_initial.pth")

    names = {0: model_name_0, 1: model_name_1}
    save_every = max(1, iter_per_agent // 10)

    # Retired-model pool (scripts/self_play.py:95-98): kept for parity;
    # the reference sets the replay probability to 0.
    model_pool: list[Agent] = []
    max_models_in_pool = 3
    probability_old_opponent = 0

    for generation in range(num_training_cycles):
        for phase, trainee_idx in enumerate(
                (first_trainee_idx, 1 - first_trainee_idx)):
            frozen_idx = 1 - trainee_idx
            model_name = f"{names[trainee_idx]}_gen_{generation}"
            print(f"\n🔄 GENERATION {generation} phase {phase}: "
                  f"training agent {trainee_idx} ({model_name}) vs frozen "
                  f"agent {frozen_idx}")
            model_pool.append(agents[trainee_idx])
            if len(model_pool) > 2 * max_models_in_pool:
                del model_pool[0:2]

            hp = PPOParams(num_envs=num_envs, trainee_idx=trainee_idx,
                           use_frozen=True)
            frozen = agents[frozen_idx]
            if random.randint(1, 100) <= probability_old_opponent \
                    and model_pool:
                frozen = random.choice(model_pool)
                print("  (facing a retired opponent this session)")
            agents[trainee_idx] = train_generation(
                cfg, hp, league_seed(seed, generation, phase),
                agents[trainee_idx], frozen, iter_per_agent, model_name,
                save_every, device=device)
        print(f"\n✅ Cycle {generation}/{num_training_cycles - 1} complete.")
    return agents


def main(argv=None):
    p = argparse.ArgumentParser(description="Self-play league "
                                            "(PyTorch + CUDA)")
    p.add_argument("--num-training-cycles", type=int, default=5)
    p.add_argument("--iter-per-agent", type=int, default=5000)
    p.add_argument("--num-envs", type=int, default=8192)
    p.add_argument("--first-trainee-idx", type=int, default=1)
    p.add_argument("--model-name-0", type=str, default="model_0")
    p.add_argument("--model-name-1", type=str, default="model_1")
    p.add_argument("--checkpoint-0", type=str, default=None)
    p.add_argument("--checkpoint-1", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--trace-out", type=str, default=None,
                   help="trace the league and write a Chrome trace to "
                        "PATH at its end")
    args = p.parse_args(argv)
    with trace(args.trace_out, args.device):
        run_league(args.num_training_cycles, args.iter_per_agent,
                   args.num_envs, args.first_trainee_idx, args.model_name_0,
                   args.model_name_1, args.seed,
                   checkpoint_0=args.checkpoint_0,
                   checkpoint_1=args.checkpoint_1, device=args.device)


if __name__ == "__main__":
    main()
