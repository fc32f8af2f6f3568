"""The structured trainer of the port (ppo/train.py::init_train_state,
make_train_iteration over engine.py / systems.py) vs the JAX package's
`ppo/train.make_train_iteration` composed from its pieces
(train.py:343-440) on the same injected draws: the reset pulse and the
ticks as `engine.step_core` under `vmap` with injected `StepNoise`, the
policy's Gumbel-max on injected uniforms, `_stats_step`, `evaluate`,
`_world0_log`, then `make_update_fns`' compute_advantages and
update_policy on the update key whose permutations the port is given.
Two iterations with the frozen opponent and world-0 recording.

Then the data mesh (`--data-parallel`, plain): 2 gloo ranks of 16 worlds
against one process of 32, for the structured trainer and the per-tick
rows path, on injected draws and permutations (tests/
torch_dist_workers.py::run_paths).

Tolerances: the fleet's integer fields and the sampled actions exact,
float fields 1e-5 absolute / 1e-6 relative; params, Adam mu and nu 1e-5
absolute; normalizers, stats and metrics 1e-4 relative / 1e-5
absolute; the world-0 rows 1e-6 relative / 1e-5 absolute.  Two ranks
against one: 1e-6 absolute everywhere, integers exact (the policy's
matmuls see 16 rows instead of 32, which float32 GEMMs may round
differently)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import engine as JE
from madrona_basketball_tpu import systems as JS
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import (_stats_step, _world0_log,
                                              init_stats, make_optimizer,
                                              make_update_fns)

from madrona_basketball_tpu_torch import constants as C
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ops import layout as L
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo import train_fused as TF
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.utils.jax_params import (adam_from_numpy,
                                                           agent_from_numpy)
from tests import torch_dist_workers as DW
from tests.test_torch_train_alt import _draws, _jax_perms, _metrics, _policy

W, T, TI = 32, 4, 1
CH = JFR.EXT_NOISE_CHUNK


@functools.lru_cache(maxsize=None)
def _jstep():
    jcfg = JSimConfig()
    return jax.jit(jax.vmap(lambda s, n: JE.step_core(jcfg, s, n)))


def _jnoise(rows):
    rows = np.asarray(rows)
    return JS.StepNoise(shot_u=jnp.asarray(rows[:6].T.reshape(W, 2, 3)),
                        reset_u=jnp.asarray(rows[6:].T))


def _act(env, i, acts):
    a = env.agents
    return env.replace(agents=a.replace(
        action=a.action.at[:, i].set(acts.astype(jnp.int32))))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **kw)


def test_structured_iteration_matches_jax():
    kw = dict(num_envs=W, num_rollout_steps=T, trainee_idx=TI,
              num_minibatches=2, update_epochs=2, use_frozen=True,
              record_world0=True)
    jhp, hp = JPPOParams(**kw), PPOParams(**kw)
    cfg = SimConfig()
    net, agent = jagent.init_agent(jax.random.PRNGKey(3))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(4))
    env = JE.init_batch(JSimConfig(), jax.random.PRNGKey(5), W)
    sf, si = (torch.tensor(np.asarray(x)) for x in JL.pack(env))
    t_agent = agent_from_numpy(jax.tree.map(np.asarray, agent), "cpu")
    state = TT.TrainState(
        agent=t_agent,
        frozen=agent_from_numpy(jax.tree.map(np.asarray, frozen), "cpu"),
        env=L.unpack(cfg, sf, si, torch.zeros((2 * C.OBS_SIZE, W))),
        stats=TT.init_stats(W, "cpu"), seed=0, counter=0,
        opt=TT.init_adam(FU.pack_weights(t_agent.net)))
    compute_advantages, update_policy = make_update_fns(jhp, net)
    opt = make_optimizer(jhp).init(agent.params)
    stats = init_stats(W)
    train_iteration = TT.make_train_iteration(cfg, hp, "cpu")
    rng = np.random.RandomState(61)
    for it in range(2):
        pulse, noise, frozen_u = _draws(rng)
        # ---- JAX: train.py:369-411 with the draws injected
        a = env.agents
        env = env.replace(agents=a.replace(reset=jnp.ones_like(a.reset)))
        env = _act(env, TI, jnp.zeros((W, 6), jnp.int32))
        env = _act(env, 1 - TI, _policy(net, frozen, env.agents.obs[:, 1 - TI],
                                        frozen_u)[0])
        env = _jstep()(env, _jnoise(pulse))
        env = env.replace(agents=env.agents.replace(
            reset=jnp.zeros_like(env.agents.reset)))
        rows, w0 = [], []
        for t in range(T):
            c = noise[t * CH:(t + 1) * CH]
            obs_t = env.agents.obs[:, TI]
            acts, lp, value = _policy(
                net, agent, obs_t,
                c[JFR.EXT_TRAINEE_U:JFR.EXT_TRAINEE_U + JFR.N_LOGITS])
            fa = _policy(net, frozen, env.agents.obs[:, 1 - TI],
                         c[JFR.EXT_FROZEN_U:JFR.EXT_FROZEN_U +
                           JFR.N_LOGITS])[0]
            env = _act(_act(env, TI, acts), 1 - TI, fa)
            env = _jstep()(env, _jnoise(c[:9]))
            rew, done = env.agents.reward[:, TI], env.agents.done[:, TI]
            stats = _stats_step(stats, rew, done)
            rows.append((obs_t, acts, value, lp, 1.0 - done, rew))
            w0.append(_world0_log(env, done))
        buf = dict(zip(("obs", "actions", "values", "log_probs",
                        "not_dones", "rewards"),
                       (jnp.stack(x) for x in zip(*rows))))
        buf["next_value"] = jagent.evaluate(net, agent,
                                            env.agents.obs[:, TI])
        key = jax.random.PRNGKey(90 + it)
        agent, adv, vn, rn = compute_advantages(agent, buf)
        agent, opt = update_policy(agent, opt, buf, adv, vn, rn, key)

        # ---- the port
        state, got = train_iteration(
            state, TF.CollectNoise(pulse=torch.tensor(pulse),
                                   rollout=torch.tensor(noise),
                                   pulse_frozen_u=torch.tensor(frozen_u)),
            perms=torch.tensor(_jax_perms(key, jhp)))
        gsf, gsi = L.pack(state.env)
        wsf, wsi = JL.pack(env)
        np.testing.assert_array_equal(gsi.numpy(), np.asarray(wsi))
        _close(gsf, wsf, atol=1e-5, rtol=1e-6)
        _close(state.env.agents.obs, env.agents.obs, atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(got["buf"]["actions"].numpy(),
                                      np.asarray(buf["actions"]))
        for f in ("curr_rewards", "episode_lengths", "mean_reward",
                  "reward_size", "mean_length", "length_size"):
            _close(getattr(state.stats, f), getattr(stats, f), rtol=1e-5,
                   atol=1e-4)
        for k in TF.METRICS:
            _close(got["metrics"][k], _metrics(stats, adv, vn)[k],
                   rtol=1e-4, atol=1e-5)
        for k in ("obs_rms", "value_rms"):
            for f in ("mean", "var", "count"):
                _close(getattr(getattr(state.agent, k), f),
                       getattr(getattr(agent, k), f), rtol=1e-4, atol=1e-5)
        for g, w in zip(FU.pack_weights(state.agent.net),
                        JFU.pack_weights(agent.params, C.OBS_USED)):
            _close(g, w, rtol=0, atol=1e-5)
        adam = adam_from_numpy(jax.tree.map(np.asarray, opt), "cpu")
        for g, w in zip(state.opt.mu + state.opt.nu, adam.mu + adam.nu):
            _close(g, w, rtol=0, atol=1e-5)
        assert state.opt.count == adam.count
        for k in w0[0]:
            want = np.stack([np.asarray(w[k]) for w in w0])
            g = got["metrics"]["world0"][k].numpy()
            assert g.shape == want.shape and g.dtype == want.dtype, k
            np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-5,
                                       err_msg=k)
    assert state.iteration == state.counter == 2


def test_structured_chunk_and_static_form_equal_eager():
    """make_train_chunk of the structured iteration (a CPU chunk loops
    it) and its static-buffer form (what a CUDA graph captures) give the
    eager iterations bit for bit."""
    cfg = SimConfig()
    hp = PPOParams(num_envs=W, num_rollout_steps=T, num_minibatches=2,
                   update_epochs=2)
    it = TT.make_train_iteration(cfg, hp, "cpu")
    a = TT.init_train_state(cfg, hp, 7, "cpu")
    b = TT.init_train_state(cfg, hp, 7, "cpu")
    c = TT.init_train_state(cfg, hp, 7, "cpu")
    rows = []
    for _ in range(2):
        a, out = it(a)
        rows.append(out["metrics"])
    b, stacked = TT.make_train_chunk(it, 2)(b)
    static = it.static(c)
    for i in range(2):
        static.reseed(c.seed, c.counter + i)
        static.step()
        for j, k in enumerate(TF.METRICS):
            assert torch.equal(static.metrics[j], rows[i][k]), k
    c = static.result(c, 2)
    for j, m in enumerate(TT.unstack_metrics(stacked, 2)):
        for k in TF.METRICS:
            assert torch.equal(m[k], rows[j][k]), k
    for s in (b, c):
        for x, y in zip(TF.state_tensors(a), TF.state_tensors(s)):
            assert torch.equal(x, y)
        assert s.opt.count == a.opt.count and s.iteration == a.iteration


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    torch.set_num_threads(1)
    out = {}
    for path in ("structured", "per_tick"):
        spec = {"W": 32, "T": 4, "M": 2, "E": 2, "frozen": True, "iters": 2,
                "path": path}
        ranks = DW.spawn("paths", spec, tmp_path_factory.mktemp(path))
        with DW.single_group() as mesh:
            one = DW.run_paths(mesh, spec)
        out[path] = (ranks, one, DW.run_paths(None, spec))
    return out


def _near(a, b, what):
    if isinstance(a, dict):
        for k in a:
            _near(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _near(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=what)
        else:
            assert torch.equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("path", ["structured", "per_tick"])
def test_two_gloo_ranks_match_one(dist_runs, path):
    ranks, one, bare = dist_runs[path]
    assert len(ranks) == 2
    for r, res in enumerate(ranks):
        cols = slice(r * 16, (r + 1) * 16)
        for k in ("params", "mu", "nu", "rms", "stats", "metrics", "count",
                  "counter"):
            _near(res[k], one[k], f"rank {r} {k}")
        _near([x[:, cols] for x in one["rows"]], res["rows"],
              f"rank {r} rows")
    # a world-size-1 group is the run without a mesh
    _near(one, bare, "one rank vs no mesh")
    assert dataclasses.is_dataclass(TT.TrainState)
