"""Episode statistics, optimizer and loss of the trainer (port of
`madrona_basketball_tpu.ppo.train`):

  * the reference's PPOStats + AverageMeter(window=100)
    (train.py:51-96, scripts/ppo_stats.py:8-50,153-172), and the fused
    path's windowed-meter scan with its CUDA kernel (csrc/meter_scan.cu);
  * `AdamState` / `init_adam` / `clip_adam_step`: optax's
    clip_by_global_norm + adam(eps=1e-8) (train.py:108-112) on the four
    kernel-orientation matrices of ops/fused_update.py;
  * `loss_fn`: the clipped PPO loss (train.py:256-300) on full or packed
    obs (models/agent.py::get_stats), differentiable by autograd: the
    tests hold the hand-derived backward of ops/fused_update.py against
    it, and the autodiff update takes its gradient;
  * `make_minibatch_update` / `make_update_fns` (train.py:115-330): the
    epochs x shuffled-minibatches skeleton over a feat matrix and the
    post-rollout phase (GAE and the normalizers, the autodiff update) of
    the per-tick, `--no-fused-grads` and structured paths;
  * the structured trainer (train.py:98-105,333-463): `TrainState`,
    `init_train_state`, `make_train_iteration` over engine.py /
    systems.py, and `_world0_log`;
  * `make_train_chunk` / `unstack_metrics` / `auto_chunk`
    (train.py:466-502): n iterations a dispatch, on the card one
    iteration captured as a CUDA graph and replayed n times;
  * `TrainLoop`: the training loop's body (dispatch, unstack, log
    readback, save), shared by the CLI and the league, each part a host
    span of the tracer (utils/profiling.py).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Sequence

import torch

from ..models.agent import Agent, get_stats, unnorm_value
from ..utils.profiling import annotate, capture

F32 = torch.float32


@dataclasses.dataclass
class EpisodeStats:
    curr_rewards: torch.Tensor     # (N,)
    episode_lengths: torch.Tensor  # (N,)
    mean_reward: torch.Tensor      # ()
    reward_size: torch.Tensor      # ()
    mean_length: torch.Tensor      # ()
    length_size: torch.Tensor      # ()


def init_stats(num_envs: int, device="cuda") -> EpisodeStats:
    def z():
        return torch.zeros((), dtype=F32, device=device)
    return EpisodeStats(
        curr_rewards=torch.zeros((num_envs,), dtype=F32, device=device),
        episode_lengths=torch.zeros((num_envs,), dtype=F32, device=device),
        mean_reward=z(), reward_size=z(), mean_length=z(), length_size=z())


def _meter_update(mean, cur_size, values_sum, count, max_size=100.0):
    """AverageMeter.update with a masked batch
    (scripts/ppo_stats.py:160-167)."""
    has = count > 0
    new_mean = torch.where(has, values_sum / torch.clamp(count, min=1.0),
                           0.0)
    size = torch.clamp(count, max=max_size)
    old_size = torch.minimum(max_size - size, cur_size)
    total = old_size + size
    merged = torch.where(has, (mean * old_size + new_mean * size) /
                         torch.clamp(total, min=1.0), mean)
    return merged, torch.where(has, total, cur_size)


METERS = 4  # [reward mean, reward window, length mean, length window]


def meter_scan_plain(ticks, meters):
    """Plain version of the meter kernel: `ticks` (nb, T, 8) per-(block,
    tick) sums [done count, sum(curr * done), sum(lens * done), 0...] from
    kernel C, summed over blocks, then T updates of the reward and length
    meters `meters` (4,) -> (4,)."""
    per_t = ticks.sum(dim=0)
    r_mean, r_size, l_mean, l_size = meters.unbind()
    for t in range(per_t.shape[0]):
        r_mean, r_size = _meter_update(r_mean, r_size, per_t[t, 1],
                                       per_t[t, 0])
        l_mean, l_size = _meter_update(l_mean, l_size, per_t[t, 2],
                                       per_t[t, 0])
    return torch.stack([r_mean, r_size, l_mean, l_size])


launches = 0  # meter kernel launches (the wrapper counts, the caller resets)


def meter_scan(ticks, meters):
    """The windowed-meter scan of train_fused.py:602-615 (JAX package):
    csrc/meter_scan.cu on CUDA tensors, `meter_scan_plain` on CPU tensors.
    One block; a thread per tick sums the blocks' partials, then one
    thread runs the T-step recursion, so the scan stays on the device
    (no host copy, no T x 2 x ~12 launches of 0-d tensors)."""
    global launches
    nb, T, cols = ticks.shape
    if cols != 8 or meters.shape != (METERS,) or \
            ticks.dtype != F32 or meters.dtype != F32:
        raise ValueError("ticks must be (nb, T, 8) and meters (4,) float32")
    if ticks.device.type == "cpu":
        return meter_scan_plain(ticks, meters)
    if ticks.device.type != "cuda":
        raise ValueError(f"unsupported device {ticks.device}")
    from .. import _build
    _build.check_device(ticks.device, meters=meters)
    lib = _build.load("meter_scan")
    ticks, meters = ticks.contiguous(), meters.contiguous()
    out = torch.empty((METERS,), dtype=F32, device=ticks.device)
    err = lib.mbb_meter_scan(_build.ptr(ticks), _build.ptr(meters),
                             _build.ptr(out), nb, T,
                             _build.stream(ticks.device))
    _build.check(err, "meter_scan")
    launches += 1
    return out


def _stats_step(st: EpisodeStats, rew, done) -> EpisodeStats:
    curr = st.curr_rewards + rew
    lens = st.episode_lengths + 1.0
    count = done.sum()
    r_mean, r_size = _meter_update(st.mean_reward, st.reward_size,
                                   (curr * done).sum(), count)
    l_mean, l_size = _meter_update(st.mean_length, st.length_size,
                                   (lens * done).sum(), count)
    return EpisodeStats(curr_rewards=curr * (1.0 - done),
                        episode_lengths=lens * (1.0 - done),
                        mean_reward=r_mean, reward_size=r_size,
                        mean_length=l_mean, length_size=l_size)


# ---------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm(c), adam(lr, eps=1e-8))
# ---------------------------------------------------------------------

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    """Adam step count and the first / second moments, each a tuple of
    the four kernel-orientation matrices (ops/fused_update.SHAPES),
    float32.  `count` is a host int; kernel D reads it from device memory,
    where the eager iteration writes it each call and a captured
    iteration (ppo/train_fused.py::StaticIteration) keeps its own device
    counter."""
    count: int
    mu: tuple
    nu: tuple


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(count=0,
                     mu=tuple(torch.zeros_like(p) for p in params),
                     nu=tuple(torch.zeros_like(p) for p in params))


@torch.no_grad()
def clip_adam_step(params, mu, nu, grads, t, *, lr: float,
                   max_norm: float):
    """One optimizer step at Adam step t (count after the step), optax's
    formulas exactly:
      u  = g if |g| < c else g / |g| * c     (|g| over all leaves)
      m' = (1 - b1) u + b1 m;   v' = (1 - b2) u^2 + b2 v
      p' = p - lr * (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps).
    t is an int (the bias corrections on the CPU) or a 0-d int tensor
    (on its own device: a CUDA graph replays the step with each replay's
    count, and no value crosses to the host).  Returns (params', mu',
    nu') as tuples."""
    gn = torch.sqrt(sum((g * g).sum() for g in grads))
    small = gn < max_norm
    tt = t.to(dtype=F32) if isinstance(t, torch.Tensor) else \
        torch.tensor(float(t), dtype=F32)
    bc1 = (1.0 - torch.full_like(tt, ADAM_B1) ** tt).to(gn.device)
    bc2 = (1.0 - torch.full_like(tt, ADAM_B2) ** tt).to(gn.device)
    out_p, out_m, out_v = [], [], []
    for p, m, v, g in zip(params, mu, nu, grads):
        u = torch.where(small, g, (g / gn) * max_norm)
        m2 = (1.0 - ADAM_B1) * u + ADAM_B1 * m
        v2 = (1.0 - ADAM_B2) * (u * u) + ADAM_B2 * v
        out_p.append(p - lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) +
                                             ADAM_EPS)))
        out_m.append(m2)
        out_v.append(v2)
    return tuple(out_p), tuple(out_m), tuple(out_v)


# ---------------------------------------------------------------------
# The PPO loss (autograd oracle of the hand-derived backward)
# ---------------------------------------------------------------------

def loss_fn(hp, net, obs_rms, o, a, lp, v, adv, ret):
    """Clipped PPO surrogate + clipped value loss + entropy
    (train.py:282-300, scripts/ppo.py:192-210); returns the scalar loss."""
    lp_, ent, v_ = get_stats(net, obs_rms, o, a)
    ratio = torch.exp(lp_ - lp)
    surr1 = -adv * ratio
    surr2 = -adv * torch.clamp(ratio, 1 - hp.clip_coef, 1 + hp.clip_coef)
    pg_loss = torch.maximum(surr1, surr2).mean()
    vf_loss = (v_ - ret) ** 2
    v_clip = v + torch.clamp(v_ - v, -hp.clip_coef, hp.clip_coef)
    if hp.clip_vloss:
        c_loss = 0.5 * torch.maximum(vf_loss, (v_clip - ret) ** 2).mean()
    else:
        c_loss = 0.5 * vf_loss.mean()
    return pg_loss + c_loss * hp.vf_coef - ent.mean() * hp.ent_coef


# ---------------------------------------------------------------------
# The autodiff update (train.py:115-330): epochs x shuffled minibatches
# of autograd of `loss_fn`, then `clip_adam_step`
# ---------------------------------------------------------------------

def shuffle_block(hp) -> int:
    """The epoch shuffle's super-row G (PPOParams.shuffle_block), with the
    JAX package's warnings and fallback to sample-exact shuffling
    (train.py:133-146)."""
    G = hp.shuffle_block
    if G < 1:
        warnings.warn(f"shuffle_block={G} is invalid (must be >= 1); "
                      "using sample-exact shuffling", stacklevel=3)
        G = 1
    if G > 1 and hp.minibatch_size % G:
        warnings.warn(
            f"shuffle_block={G} does not divide minibatch_size="
            f"{hp.minibatch_size}; falling back to sample-exact shuffling",
            stacklevel=3)
        G = 1
    return G


def make_minibatch_update(hp):
    """The epochs x shuffled-minibatches skeleton (train.py:115-215).

    Everything a minibatch needs rides in one (total, F) float32 feat
    matrix whose first D + K + 4 columns are obs | actions | log_prob |
    value_n | advantage | return_n.  An epoch permutes its rows in
    super-rows of G = `shuffle_block(hp)` consecutive samples and deals
    them into the minibatches in order.

    Returns `update(grad_step, params, mu, nu, count, buf, advantages,
    values_n, returns_n, perms)` -> (params', mu', nu'), with
    `update.run_epochs(grad_step, params, mu, nu, count, feat, D, K,
    perms)` over a prebuilt feat matrix, `update.draw_perms(gen, device)`
    and `update.perm_shape`.  grad_step(params, mu, nu, o, a, lp, v, adv,
    ret, t) applies one minibatch step at Adam step t (count + k + 1 for
    the k-th minibatch; count an int or a 0-d int32 tensor)."""
    G = shuffle_block(hp)
    E, M, mb = hp.update_epochs, hp.num_minibatches, hp.minibatch_size
    rows = hp.rollout_batch_size // G

    def draw_perms(gen: torch.Generator, device) -> torch.Tensor:
        """(E, rows) int64: each epoch's permutation of the super-rows, the
        argsort of uint32-range draws as the JAX package makes them (one
        independent uniform permutation per epoch)."""
        bits = torch.randint(0, 2 ** 32, (E, rows), generator=gen,
                             dtype=torch.int64, device=device)
        return torch.argsort(bits, dim=1, stable=True)

    def run_epochs(grad_step, params, mu, nu, count, feat, D: int, K: int,
                   perms):
        if tuple(perms.shape) != (E, rows):
            raise ValueError(f"perms must be ({E}, {rows})")
        F = feat.shape[-1]
        featG = feat.reshape(rows, G, F)
        k = 0
        for e in range(E):
            feat_e = featG[perms[e].long()].reshape(M, mb, F)
            for m in range(M):
                fe = feat_e[m]
                k += 1
                params, mu, nu = grad_step(
                    params, mu, nu, fe[:, :D], fe[:, D:D + K].long(),
                    fe[:, D + K], fe[:, D + K + 1], fe[:, D + K + 2],
                    fe[:, D + K + 3], count + k)
        return params, mu, nu

    def update(grad_step, params, mu, nu, count, buf, advantages, values_n,
               returns_n, perms):
        total = hp.rollout_batch_size
        obs = buf["obs"].reshape(total, -1)
        K = buf["actions"].shape[-1]
        feat = torch.cat([
            obs, buf["actions"].reshape(total, K).to(F32),
            buf["log_probs"].reshape(total, 1),
            values_n.reshape(total, 1), advantages.reshape(total, 1),
            returns_n.reshape(total, 1)], dim=-1)
        return run_epochs(grad_step, params, mu, nu, count, feat,
                          obs.shape[-1], K, perms)

    update.run_epochs = run_epochs
    update.draw_perms = draw_perms
    update.perm_shape = (E, rows)
    return update


def normalize_advantages(hp, agent, values, rewards, not_dones, next_value):
    """GAE on the critic's un-normalized values, the value normalizer's
    two merges, then the advantages standardized and the values and
    returns re-normalized in place (train.py:241-265, scripts/ppo.py:
    144-177).  Returns (value_rms', adv_n, values_n, returns_n); `values`
    (T, N) and `next_value` (N,) as the critic gives them."""
    from ..models.normalize import rms_normalize, rms_update
    from ..ops.gae import compute_gae
    values = unnorm_value(agent, values)
    advantages, returns = compute_gae(rewards, values, not_dones,
                                      unnorm_value(agent, next_value),
                                      hp.gamma, hp.gae_lambda)
    value_rms = rms_update(agent.value_rms, values.reshape(-1, 1))
    value_rms = rms_update(value_rms, returns.reshape(-1, 1))
    adv_n = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
    values_n = rms_normalize(value_rms, values.reshape(-1, 1),
                             clamp=5.0).reshape(values.shape)
    returns_n = rms_normalize(value_rms, returns.reshape(-1, 1),
                              clamp=5.0).reshape(returns.shape)
    return value_rms, adv_n, values_n, returns_n


def make_update_fns(hp):
    """The post-rollout phase of the per-tick and structured trainers
    (train.py:218-330): `(compute_advantages, update_policy)`.

      compute_advantages(agent, buf) -> (agent', advantages, values_n,
        returns_n): `normalize_advantages` plus the obs normalizer's merge
        of buf["obs"]; agent' shares agent's module;
      update_policy(agent, opt, buf, advantages, values_n, returns_n,
        perms, count=None) -> (agent, opt'): the epochs x minibatches of
        the autodiff update (`make_minibatch_update`), the new weights
        written into agent's module in place.  count (default opt.count)
        is the Adam step count the phase starts from, an int or a 0-d
        int32 tensor on the card; opt'.count = opt.count + E * M;
      update_policy.with_feat(agent, opt, feat, D, K, perms, count=None):
        the same over a prebuilt feat matrix.

    buf: obs (T, N, D), actions (T, N, K), values / log_probs / not_dones /
    rewards (T, N), next_value (N,).  The gradient is autograd of
    `loss_fn` taken through the module and packed in kernel D's
    orientation (`fused_update.pack_weights`), so the Adam state is the
    one every trainer path shares; the first layer's columns >= 103 (the
    structural-zero obs tail) have a zero gradient and are carried over
    unchanged."""
    from ..models.normalize import rms_update
    from ..ops import fused_update as FU
    mb_update = make_minibatch_update(hp)
    n_updates = hp.update_epochs * hp.num_minibatches

    def compute_advantages(agent, buf):
        value_rms, adv_n, values_n, returns_n = normalize_advantages(
            hp, agent, buf["values"], buf["rewards"], buf["not_dones"],
            buf["next_value"])
        obs = buf["obs"]
        obs_rms = rms_update(agent.obs_rms, obs.reshape(-1, obs.shape[-1]))
        return (Agent(net=agent.net, obs_rms=obs_rms, value_rms=value_rms),
                adv_n, values_n, returns_n)

    def grad_step_for(agent):
        net, obs_rms = agent.net, agent.obs_rms
        plist = list(net.parameters())

        def grad_step(params, mu, nu, o, a, lp, v, adv, ret, t):
            FU.unpack_weights(net, *params)
            with torch.enable_grad():
                loss = loss_fn(hp, net, obs_rms, o, a, lp, v, adv, ret)
                g = dict(zip(map(id, plist), torch.autograd.grad(loss,
                                                                 plist)))
            grads = FU.pack_weights(net, of=lambda p: g[id(p)])
            return clip_adam_step(params, mu, nu, grads, t,
                                  lr=hp.learning_rate,
                                  max_norm=hp.max_grad_norm)

        return grad_step

    def _count(opt, count, like):
        """The phase's starting Adam count; on the card a 0-d int32 device
        tensor (written by a fill), so the bias corrections never copy a
        host value."""
        count = opt.count if count is None else count
        if like.device.type == "cuda" and not isinstance(count, torch.Tensor):
            from .. import _build
            count = _build.device_int(count, like.device)
        return count

    def _finish(agent, opt, params, mu, nu):
        FU.unpack_weights(agent.net, *params)
        return agent, AdamState(count=opt.count + n_updates, mu=mu, nu=nu)

    @torch.no_grad()
    def update_policy(agent, opt: AdamState, buf, advantages, values_n,
                      returns_n, perms, count=None):
        out = mb_update(grad_step_for(agent), FU.pack_weights(agent.net),
                        opt.mu, opt.nu, _count(opt, count, advantages), buf,
                        advantages, values_n, returns_n, perms)
        return _finish(agent, opt, *out)

    @torch.no_grad()
    def update_policy_feat(agent, opt: AdamState, feat, D: int, K: int,
                           perms, count=None):
        out = mb_update.run_epochs(
            grad_step_for(agent), FU.pack_weights(agent.net), opt.mu, opt.nu,
            _count(opt, count, feat), feat, D, K, perms)
        return _finish(agent, opt, *out)

    update_policy.with_feat = update_policy_feat
    update_policy.draw_perms = mb_update.draw_perms
    update_policy.perm_shape = mb_update.perm_shape
    return compute_advantages, update_policy


# ---------------------------------------------------------------------
# The structured trainer (train.py:60-105,333-463)
# ---------------------------------------------------------------------

class StructuredWorlds:
    """The fleet of the structured trainer's TrainState for the per-tick
    rollout (ppo/train_fused.py::_per_tick_body): env = the engine's
    `state.State`, one tick = engine.step_core (systems.py), functional,
    so every write makes a new State."""

    @staticmethod
    def get(state):
        return state.env

    @staticmethod
    def fields(env) -> dict:
        return dict(env=env)

    @staticmethod
    def owned(env):
        return env

    @staticmethod
    def obs(env, i):
        return env.agents.obs[:, i]

    @staticmethod
    def set_reset(env, value: int):
        return dataclasses.replace(env, agents=dataclasses.replace(
            env.agents, reset=torch.full_like(env.agents.reset, value)))

    @staticmethod
    def set_actions(env, i, actions):
        action = env.agents.action.clone()
        action[:, i] = actions
        return dataclasses.replace(env, agents=dataclasses.replace(
            env.agents, action=action))

    @staticmethod
    def step(cfg, env, noise):
        from .. import engine
        from ..systems import StepNoise
        return engine.step_core(cfg, env, StepNoise.from_rows(noise))

    @staticmethod
    def reward_done(env, i):
        return env.agents.reward[:, i], env.agents.done[:, i]

    @staticmethod
    def world0(env, done):
        return _world0_log(env, done)


@dataclasses.dataclass
class TrainState:
    """The structured trainer's state (train.py:98-105): both agents, the
    fleet as an engine `state.State`, the episode stats, the run's seed and
    iteration counter (the generators' reseed), Adam, the iteration."""
    agent: Agent
    frozen: Agent
    env: object          # state.State, (W, ...) tensors
    stats: EpisodeStats
    seed: int
    counter: int         # iterations collected so far
    opt: AdamState
    iteration: int = 0


def init_train_state(cfg, hp, seed: int, device="cuda", agent=None,
                     frozen=None) -> TrainState:
    """`hp.num_envs` fresh structured worlds and new agents from `seed`
    (train.py:413-425), drawn as the rows trainer's `init_train_state`
    draws them: `layout.pack(state.env)` equals its rows."""
    from .. import engine
    from ..models import agent as agent_lib
    from ..ops import fused_update as FU
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not "
                           "available")
    gen_cpu = torch.Generator().manual_seed(seed)
    if agent is None:
        agent = agent_lib.init_agent(gen_cpu, dev)
    if frozen is None:
        frozen = agent_lib.init_agent(gen_cpu, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    env = engine.init_batch(cfg, gen, hp.num_envs, dev)
    return TrainState(agent=agent, frozen=frozen, env=env,
                      stats=init_stats(hp.num_envs, dev), seed=seed,
                      counter=0, opt=init_adam(FU.pack_weights(agent.net)))


def make_train_iteration(cfg, hp, device="cuda", mesh=None):
    """The structured trainer's `train_iteration(state, noise=None,
    perms=None, mark=None) -> (state', out)` (train.py:428-440): the
    per-tick rollout of ppo/train_fused.py over the structured engine
    (the reset pulse, then T ticks of policy, actions and
    engine.step_core), the episode stats, `compute_advantages` and the
    autodiff update, with the rows per-tick path's noise, permutations,
    static form (`train_iteration.static`, for make_train_chunk's CUDA
    graph) and data mesh."""
    from .train_fused import make_train_iteration as rows_iteration
    return rows_iteration(cfg, hp, device, mesh=mesh, rollout_kernel=False,
                          backend="xla", worlds=StructuredWorlds)


def _world0_log(env, done) -> dict:
    """World 0's telemetry of one tick in the reference's npz schema
    (train.py:443-463, scripts/ppo.py:93-105); each leaf keeps a leading
    world axis of 1."""
    from ..export import game_state_tensor
    a, b = env.agents, env.ball
    return {
        "agent_pos": a.pos[0:1],
        "ball_pos": b.pos[0:1][:, None, :],
        "ball_vel": b.vel[0:1][:, None, :],
        "orientation": a.orient[0:1],
        "ball_physics": torch.stack(
            [b.in_flight, b.last_touched_agent, b.last_touched_team,
             b.shot_by_agent, b.shot_by_team, b.shot_point_value,
             b.shot_going_in], dim=-1)[0:1][:, None, :],
        "agent_possession": torch.stack(
            [a.has_ball, a.held_ball_id, a.points_worth], dim=-1)[0:1],
        "game_state": game_state_tensor(env)[0:1],
        "rewards": a.reward[0:1],
        "actions": a.action[0:1],
        "done": done[0:1],
    }


# ---------------------------------------------------------------------
# Chunked dispatch: n iterations per host dispatch
# ---------------------------------------------------------------------

def make_train_chunk(train_iteration, n_iters: int):
    """n_iters whole training iterations per call (the JAX package's
    `make_train_chunk`, train.py:466-483).

    chunk(state) -> (state', metrics): each metric gains a leading
    (n_iters,) axis, in iteration order; state' equals n_iters calls of
    `train_iteration` (the weights updated in state's module in place,
    as those calls update them).  On a CPU state it is a loop over
    `train_iteration`.  On a CUDA state the first call captures one
    iteration (`train_iteration.static`'s `step()`) in a CUDA graph,
    after a warm-up step on a throwaway copy of the state on a side
    stream (each kernel's first use, its shared-memory attributes); every
    call then copies the state into the static buffers and replays the
    graph n_iters times, reseeding the pulse and permutation generators
    (registered with the graph) before each replay, with no host
    synchronization.  The graph's kernels count one launch each, at
    capture (and one in the warm-up); replays count none.  A failed
    capture or replay raises; nothing falls back to the eager path.
    Under a data mesh (`train_iteration.mesh`) the graph holds the
    iteration's collectives too, which needs NCCL: a CUDA chunk over
    another backend (gloo copies through the host) raises.
    The state's seed is baked into the capture (kernel B's Philox key).
    `chunk.captured` holds, once captured, "static" (the
    StaticIteration, whose device counters the replays advance), "graph",
    and the graph's "kernel_nodes" (the tracer's stamps left out; None
    where they cannot be counted)."""
    if n_iters < 1:
        raise ValueError(f"n_iters={n_iters} must be >= 1")
    captured = {}

    def chunk(state):
        from .train_fused import state_device
        dev = state_device(state)
        if dev.type == "cpu":
            rows = []
            for _ in range(n_iters):
                state, out = train_iteration(state)
                rows.append(out["metrics"])
            return state, _stack(rows)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        mesh = getattr(train_iteration, "mesh", None)
        if mesh is not None and mesh.backend != "nccl":
            raise ValueError(f"a CUDA chunk under a data mesh captures its "
                             f"collectives, which needs NCCL, not "
                             f"{mesh.backend}")
        if not captured:
            captured.update(_capture(train_iteration, state))
        static, graph = captured["static"], captured["graph"]
        from .train_fused import METRICS
        static.load(state)
        rows = torch.empty((n_iters, len(METRICS)), dtype=F32, device=dev)
        w0 = None if static.world0 is None else {
            k: torch.empty((n_iters,) + tuple(v.shape), dtype=v.dtype,
                           device=dev) for k, v in static.world0.items()}
        for i in range(n_iters):
            static.reseed(state.seed, state.counter + i)
            graph.replay()
            rows[i].copy_(static.metrics)
            for k, v in (w0 or {}).items():
                v[i].copy_(static.world0[k])
        metrics = {k: rows[:, j] for j, k in enumerate(METRICS)}
        if w0 is not None:
            metrics["world0"] = w0
        return static.result(state, n_iters), metrics

    chunk.captured = captured
    return chunk


def _capture(train_iteration, state) -> dict:
    """The static form of `train_iteration` loaded with `state`, and one
    of its steps captured as a CUDA graph."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA chunk needs a CUDA card")
    from .train_fused import state_device
    dev = state_device(state)
    with annotate("capture"):
        static = train_iteration.static(state)
        warm = train_iteration.static(state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm.reseed(state.seed, state.counter)
            warm.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        del warm
        graph, kernels = capture(static.step, static.generators,
                                 "train_iteration")
    return {"static": static, "graph": graph, "kernel_nodes": kernels}


def _stack(rows: list) -> dict:
    """Per-iteration metric dicts (values tensors or dicts of them) ->
    one dict whose tensors gain a leading (n,) axis."""
    return {k: _stack([m[k] for m in rows]) if isinstance(v, dict)
            else torch.stack([m[k] for m in rows])
            for k, v in rows[0].items()}


def unstack_metrics(stacked, n: int) -> list:
    """Inverse of make_train_chunk's metric stacking: a dict whose values
    (tensors, or dicts of them such as the world-0 rows) carry a leading
    (n,) axis -> a list of n per-iteration dicts, in order."""
    def at(d, j):
        return {k: at(v, j) if isinstance(v, dict) else v[j]
                for k, v in d.items()}
    return [at(stacked, j) for j in range(n)]


class TrainLoop:
    """The training loop of the CLI and the league, one dispatch at a time.

    `step(state, iteration, left=None) -> (state, iteration)` dispatches a
    chunk of `chunk_n` iterations (`make_train_chunk`, or `chunk`) when
    `left` (the iterations still to run; None: any) holds one, else one
    eager `train_iteration`, and unstacks its metrics.  Then, for each
    iteration in order, it pops the metrics' "world0" rows and calls
    `row(iteration, world0)`; at `log_every` it reads every metric back
    with float() and calls `log(values, iteration)`; at `save_every` it
    calls `save(state, iteration)` (state: after the whole dispatch).  A
    hook left None is not called and its readback not made.  The
    dispatch, unstack, readback and save are the tracer's host spans
    chunk_dispatch, unstack_metrics, log_readback and save_agent, indexed
    by the iteration.  `run(state, n)` steps n iterations from 0."""

    def __init__(self, train_iteration, chunk_n: int, log_every: int,
                 save_every: int, *, row=None, log=None, save=None,
                 chunk=None):
        self.train_iteration, self.chunk_n = train_iteration, chunk_n
        self.log_every, self.save_every = log_every, save_every
        self.row, self.log, self.save = row, log, save
        if chunk is None and chunk_n > 1:
            chunk = make_train_chunk(train_iteration, chunk_n)
        self.chunk = chunk

    def step(self, state, iteration: int, left=None):
        whole = self.chunk is not None and (left is None or
                                            left >= self.chunk_n)
        with annotate("chunk_dispatch", iteration):
            if whole:
                state, stacked = self.chunk(state)
            else:
                state, out = self.train_iteration(state)
        with annotate("unstack_metrics", iteration):
            rows = unstack_metrics(stacked, self.chunk_n) if whole \
                else [out["metrics"]]
        for metrics in rows:
            iteration += 1
            world0 = metrics.pop("world0", None)
            if self.row is not None:
                self.row(iteration, world0)
            if self.log is not None and iteration % self.log_every == 0:
                with annotate("log_readback", iteration):
                    values = {k: float(v) for k, v in metrics.items()}
                self.log(values, iteration)
            if self.save is not None and iteration % self.save_every == 0:
                with annotate("save_agent", iteration):
                    self.save(state, iteration)
        return state, iteration

    def run(self, state, num_iterations: int):
        iteration = 0
        while iteration < num_iterations:
            state, iteration = self.step(state, iteration,
                                         num_iterations - iteration)
        return state


def auto_chunk(log_every: int, save_every: int, cap: int = 50) -> int:
    """Largest iterations-per-dispatch that keeps log/save boundaries on
    chunk edges (a common divisor of both cadences, capped)."""
    g = math.gcd(max(1, log_every), max(1, save_every))
    best = 1
    for d in range(1, min(g, cap) + 1):
        if g % d == 0:
            best = d
    return best
