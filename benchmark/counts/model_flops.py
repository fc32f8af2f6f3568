"""Model FLOPs of the policy's matrix products, the numerator of `mfu.*`.

Only the ActorCritic's Dense products count (2 FLOP a multiply-add), at
the widths the configuration's `policy` block states and these inputs
need: the used obs slots (`obs_used`) -> `hidden_size` x
`num_hidden_layers`, an actor head of sum(`action_buckets`) logits and a
critic head of 1.  LayerNorm, sampling, the optimizer and the simulator
are left out; nothing recomputed is counted.  For the recipe's 103 ->
32 -> 32 with 19 logits: an actor-critic forward is 9 920 FLOP a sample.
"""

from __future__ import annotations


def widths(policy: dict) -> dict:
    """FLOPs a sample of each forward, and of the update's extra work."""
    o, h = policy["obs_used"], policy["hidden_size"]
    n, layers = sum(policy["action_buckets"]), policy["num_hidden_layers"]
    backbone = 2 * (o * h + (layers - 1) * h * h)
    actor_critic = backbone + 2 * h * n + 2 * h
    # the input gradients of every layer but the first
    input_grads = 2 * ((layers - 1) * h * h + h * (n + 1))
    return {"backbone": backbone, "actor": backbone + 2 * h * n,
            "critic": backbone + 2 * h, "actor_critic": actor_critic,
            "input_grads": input_grads,
            # the forward, every weight's gradient, the input gradients
            "update_sample": 2 * actor_critic + input_grads}


def train_iteration(policy: dict, num_envs: int, num_rollout_steps: int,
                    update_epochs: int, use_frozen: bool) -> int:
    """One PPO iteration: an actor-critic forward a world-tick (and one
    actor forward of the frozen opponent), one backbone + critic forward
    a world for the next value, and `update_epochs` passes of the update
    over every sample."""
    f = widths(policy)
    samples = num_envs * num_rollout_steps
    rollout = samples * (f["actor_critic"] + (f["actor"] if use_frozen
                                              else 0))
    return (rollout + num_envs * f["critic"] +
            update_epochs * samples * f["update_sample"])


def eval_tick(policy: dict, num_envs: int) -> int:
    """One evaluation tick: both agents' actor forwards in every world."""
    return 2 * widths(policy)["actor"] * num_envs
