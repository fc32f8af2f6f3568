"""The alternate rows paths of the port's trainer
(ppo/train_fused.py::make_train_iteration with rollout_kernel=False,
fused_gae=False, fused_grads=False) vs the JAX
`make_train_iteration_fused(backend="xla", ...)` composed by hand from
its pieces, as tests/test_torch_train.py composes the flagship, on the
same injected noise and permutations:

  * per tick (train_fused.py:190-257,752-776): `fused_step_xla` reset
    pulse and ticks, the policy's Gumbel-max on injected uniforms,
    `_stats_step`, `evaluate`, then `make_update_fns`' compute_advantages
    and update_policy with the update key whose permutations the port is
    given; two iterations with the frozen opponent and world-0 recording;
  * the rollout kernel (interpret mode, external noise) followed by the
    unfused GAE segment (train_fused.py:563-570,679-693), then
    `make_fused_update_phase(raw_side=False)` (`--no-fused-gae`) or the
    feat matrix and `update_policy_feat` (`--no-fused-grads`).

Also the JAX trainer's validity errors with their exact messages, and
`world0_rows` against `_world0_rows` on the same rows.

Tolerances: rows, trajectory and stats as tests/test_torch_train.py holds
them (sampled actions, dones and integer rows exact; float rows 1e-5
absolute); params, Adam mu and nu 1e-5 absolute (the whole-phase tier
of tests/test_torch_update_fns.py); normalizers and metrics 1e-4
relative / 1e-5 absolute; the Adam count exact; the world-0 rows exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import constants as C
from madrona_basketball_tpu import engine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.models import action as jaction
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.models.normalize import (rms_normalize,
                                                     rms_update,
                                                     rms_update_padded,
                                                     rms_update_padded_tdw)
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ops.fused_step import fused_step_xla
from madrona_basketball_tpu.ops.gae import compute_gae
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import (_stats_step, init_stats,
                                              make_optimizer, make_update_fns)
from madrona_basketball_tpu.ppo.train_fused import (_world0_rows,
                                                    make_train_iteration_fused)

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo import train_fused as TF
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.utils.jax_params import (adam_from_numpy,
                                                           agent_from_numpy,
                                                           rows_from_numpy)

W, T, TI, WB = 32, 4, 1, 8
OBS = C.OBS_SIZE
D = C.OBS_USED
CH = JFR.EXT_NOISE_CHUNK
REW = JL.F_IDX[f"a{TI}.reward"]
DONE = JL.F_IDX[f"a{TI}.done"]


def _hps(**kw):
    kw = {**dict(num_envs=W, num_rollout_steps=T, trainee_idx=TI,
                 num_minibatches=2, update_epochs=2, update_block=WB), **kw}
    return JPPOParams(**kw), PPOParams(**kw)


@functools.lru_cache(maxsize=None)
def _step():
    return jax.jit(functools.partial(fused_step_xla, JSimConfig()))


@functools.lru_cache(maxsize=None)
def _rollout(use_frozen):
    return jax.jit(JFR.make_fused_rollout(
        JSimConfig(), W, T, trainee_idx=TI, use_frozen=use_frozen, block=128,
        interpret=True, external_noise=True))


def _draws(rng):
    pulse = np.concatenate([rng.uniform(-1, 1, (8, W)),
                            rng.uniform(0, 1, (1, W))]).astype(np.float32)
    noise = rng.uniform(0, 1, (T * CH, W))
    row = np.arange(T * CH) % CH
    noise = np.where((row < 8)[:, None], 2 * noise - 1, noise)
    frozen_u = rng.uniform(0, 1, (JFR.N_LOGITS, W)).astype(np.float32)
    return pulse, noise.astype(np.float32), frozen_u


def _policy(net, ap, obs, u):
    """agent.forward (agent.py:79-90) with the Gumbel draws of
    action.sample taken from the uniforms u (N_LOGITS, B)."""
    logits, value = net.apply(ap.params, rms_normalize(ap.obs_rms, obs,
                                                       clamp=5.0))
    acts = jaction.best(logits + JFR.gumbel_from_uniform(u).T,
                        C.ACTION_BUCKETS)
    return acts, jaction.log_probs(logits, acts,
                                   C.ACTION_BUCKETS).sum(-1), value


def _write(si, agent_idx, acts):
    for j, n in enumerate(JL.AGENT_I32[:6]):
        si = si.at[JL.I_IDX[f"a{agent_idx}.{n}"]].set(acts[:, j])
    return si


def _pulse(jhp, net, frozen, sf, si, obs, pulse, frozen_u):
    """reset_pulse (train_fused.py:217-223)."""
    for r in (JL.I_IDX["a0.reset"], JL.I_IDX["a1.reset"]):
        si = si.at[r].set(1)
    si = _write(si, TI, jnp.zeros((W, 6), jnp.int32))
    if jhp.use_frozen:
        fi_lo = (1 - TI) * OBS
        si = _write(si, 1 - TI, _policy(net, frozen, obs[fi_lo:fi_lo + OBS].T,
                                        frozen_u)[0])
    sf, si, obs = _step()(sf, si, pulse)
    for r in (JL.I_IDX["a0.reset"], JL.I_IDX["a1.reset"]):
        si = si.at[r].set(0)
    return sf, si, obs


def _setup(jhp, hp, seed):
    net, agent = jagent.init_agent(jax.random.PRNGKey(seed))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(seed + 1))
    sf, si = JL.pack(engine.init_batch(JSimConfig(),
                                       jax.random.PRNGKey(seed + 2), W))
    obs = jnp.zeros((JL.N_OBS_ROWS, W), jnp.float32)
    t_agent = agent_from_numpy(jax.tree.map(np.asarray, agent), "cpu")
    state = TF.TrainState(
        agent=t_agent,
        frozen=agent_from_numpy(jax.tree.map(np.asarray, frozen), "cpu"),
        sf=rows_from_numpy(np.asarray(sf), device="cpu"),
        si=rows_from_numpy(np.asarray(si), device="cpu"),
        obs=torch.zeros((JL.N_OBS_ROWS, W)),
        stats=TT.init_stats(W, "cpu"), seed=0, counter=0,
        opt=TT.init_adam(FU.pack_weights(t_agent.net)), iteration=0)
    jax_state = dict(agent=agent, frozen=frozen, sf=sf, si=si, obs=obs,
                     stats=init_stats(W),
                     opt=make_optimizer(jhp).init(agent.params))
    return net, jax_state, state


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **kw)


def _check(state, got, js, metrics):
    np.testing.assert_array_equal(state.si.numpy(), np.asarray(js["si"]))
    _close(state.sf, js["sf"], atol=1e-5, rtol=1e-6)
    _close(state.obs, js["obs"], atol=1e-5, rtol=1e-6)
    for f in ("curr_rewards", "episode_lengths", "mean_reward",
              "reward_size", "mean_length", "length_size"):
        _close(getattr(state.stats, f), getattr(js["stats"], f), rtol=1e-5,
               atol=1e-4)
    agent = js["agent"]
    for k in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            _close(getattr(getattr(state.agent, k), f),
                   getattr(getattr(agent, k), f), rtol=1e-4, atol=1e-5)
    for k in TF.METRICS:
        _close(got["metrics"][k], metrics[k], rtol=1e-4, atol=1e-5)
    for g, w in zip(FU.pack_weights(state.agent.net),
                    JFU.pack_weights(agent.params, D)):
        _close(g, w, rtol=0, atol=1e-5)
    adam = adam_from_numpy(jax.tree.map(np.asarray, js["opt"]), "cpu")
    for g, w in zip(state.opt.mu + state.opt.nu, adam.mu + adam.nu):
        _close(g, w, rtol=0, atol=1e-5)
    assert state.opt.count == adam.count


def _jax_perms(key, jhp):
    rows = jhp.rollout_batch_size // jhp.shuffle_block
    return np.asarray(jnp.argsort(jax.random.bits(
        key, (jhp.update_epochs, rows), jnp.uint32), axis=1))


def _metrics(stats, adv_n, values_n):
    return {"mean_reward": stats.mean_reward,
            "mean_episode_length": stats.mean_length,
            "reward_window": stats.reward_size,
            "adv_abs_mean": jnp.abs(adv_n).mean(),
            "value_mean": values_n.mean()}


def test_per_tick_iteration_matches_jax():
    """`--no-rollout-kernel` with the frozen opponent and record_world0."""
    jhp, hp = _hps(use_frozen=True, record_world0=True)
    net, js, state = _setup(jhp, hp, 11)
    compute_advantages, update_policy = make_update_fns(jhp, net)
    train_iteration = TF.make_train_iteration(SimConfig(), hp, "cpu",
                                              rollout_kernel=False)
    rng = np.random.RandomState(31)
    ti_lo, fi_lo = TI * OBS, (1 - TI) * OBS
    for it in range(2):
        pulse, noise, frozen_u = _draws(rng)
        agent, frozen = js["agent"], js["frozen"]
        sf, si, obs = _pulse(jhp, net, frozen, js["sf"], js["si"], js["obs"],
                             pulse, frozen_u)
        stats = js["stats"]
        rows, w0 = [], []
        for t in range(T):
            c = noise[t * CH:(t + 1) * CH]
            obs_t = obs[ti_lo:ti_lo + OBS].T
            acts, lp, value = _policy(
                net, agent, obs_t,
                c[JFR.EXT_TRAINEE_U:JFR.EXT_TRAINEE_U + JFR.N_LOGITS])
            si = _write(si, TI, acts)
            si = _write(si, 1 - TI, _policy(
                net, frozen, obs[fi_lo:fi_lo + OBS].T,
                c[JFR.EXT_FROZEN_U:JFR.EXT_FROZEN_U + JFR.N_LOGITS])[0])
            sf, si, obs = _step()(sf, si, c[:9])
            done = sf[DONE]
            stats = _stats_step(stats, sf[REW], done)
            rows.append((obs_t, acts, value, lp, 1.0 - done, sf[REW]))
            w0.append(_world0_rows(sf, si, done))
        buf = dict(zip(("obs", "actions", "values", "log_probs",
                        "not_dones", "rewards"),
                       (jnp.stack(x) for x in zip(*rows))))
        buf["next_value"] = jagent.evaluate(net, agent,
                                            obs[ti_lo:ti_lo + OBS].T)
        key = jax.random.PRNGKey(70 + it)
        agent, adv, vn, rn = compute_advantages(agent, buf)
        agent, opt = update_policy(agent, js["opt"], buf, adv, vn, rn, key)
        js.update(agent=agent, opt=opt, sf=sf, si=si, obs=obs, stats=stats)

        state, got = train_iteration(
            state, TF.CollectNoise(pulse=torch.tensor(pulse),
                                   rollout=torch.tensor(noise),
                                   pulse_frozen_u=torch.tensor(frozen_u)),
            perms=torch.tensor(_jax_perms(key, jhp)))
        gbuf = got["buf"]
        np.testing.assert_array_equal(gbuf["actions"].numpy(),
                                      np.asarray(buf["actions"]))
        np.testing.assert_array_equal(gbuf["not_dones"].numpy(),
                                      np.asarray(buf["not_dones"]))
        for k in ("obs", "values", "log_probs", "rewards", "next_value"):
            _close(gbuf[k], buf[k], rtol=1e-5, atol=1e-5)
        _check(state, got, js, _metrics(stats, adv, vn))
        want_w0 = {k: np.stack([np.asarray(w[k]) for w in w0]) for k in w0[0]}
        assert set(got["metrics"]["world0"]) == set(want_w0)
        for k, v in want_w0.items():
            g = got["metrics"]["world0"][k].numpy()
            assert g.shape == v.shape, k
            np.testing.assert_allclose(g, v, rtol=1e-6, atol=1e-5,
                                       err_msg=k)
        assert state.iteration == state.counter == it + 1


def _unfused_jax(jhp, net, js, pulse, noise, frozen_u):
    """The rollout kernel, then train_fused.py:563-570,679-693."""
    agent = js["agent"]
    sf, si, obs = _pulse(jhp, net, js["frozen"], js["sf"], js["si"],
                         js["obs"], pulse, frozen_u)
    mats = JFR.pack_policy(agent)
    sf, si, obs, traj = _rollout(False)(jnp.asarray(noise), sf, si, obs,
                                        *mats)
    ti_lo = TI * OBS
    next_value = jagent.evaluate(net, agent, obs[ti_lo:ti_lo + OBS].T)
    values, rewards = traj[:, JFR.R_VALUE], traj[:, JFR.R_REW]
    done = traj[:, JFR.R_DONE]
    stats = js["stats"]
    for t in range(T):
        stats = _stats_step(stats, rewards[t], done[t])
    values_un = jagent.unnorm_value(agent, values)
    advantages, returns = compute_gae(
        rewards, values_un, 1.0 - done, jagent.unnorm_value(agent, next_value),
        jhp.gamma, jhp.gae_lambda)
    value_rms = rms_update(agent.value_rms, values_un.reshape(-1, 1))
    value_rms = rms_update(value_rms, returns.reshape(-1, 1))
    adv_n = (advantages - advantages.mean()) / (advantages.std(ddof=1) +
                                                1e-8)
    values_n = rms_normalize(value_rms, values_un.reshape(-1, 1),
                             clamp=5.0).reshape(values.shape)
    returns_n = rms_normalize(value_rms, returns.reshape(-1, 1),
                              clamp=5.0).reshape(returns.shape)
    js.update(sf=sf, si=si, obs=obs, stats=stats)
    return traj, value_rms, adv_n, values_n, returns_n


def test_no_fused_gae_iteration_matches_jax():
    """`--no-fused-gae`: kernel D's phase on the normalized side rows
    (make_fused_update_phase(raw_side=False), train_fused.py:704-713)."""
    jhp, hp = _hps()
    net, js, state = _setup(jhp, hp, 21)
    ufp = jax.jit(JFU.make_fused_update_phase(jhp, D, T, W, WB,
                                              interpret=True,
                                              raw_side=False))
    train_iteration = TF.make_train_iteration(SimConfig(), hp, "cpu",
                                              fused_gae=False)
    assert train_iteration.perm_shape == (2, T * W // WB)
    rng = np.random.RandomState(41)
    pulse, noise, frozen_u = _draws(rng)
    perms = np.stack([rng.permutation(T * W // WB)
                      for _ in range(2)]).astype(np.int32)
    traj, value_rms, adv_n, values_n, returns_n = _unfused_jax(
        jhp, net, js, pulse, noise, frozen_u)
    side = jnp.concatenate([jnp.stack([values_n, adv_n, returns_n], axis=1),
                            jnp.zeros((T, JFU.SIDE_ROWS - 3, W))], axis=1)
    agent = js["agent"]
    agent = agent.replace(
        obs_rms=rms_update_padded_tdw(agent.obs_rms, traj[:, :D]),
        value_rms=value_rms)
    adam = js["opt"][1][0]
    out = ufp(jnp.asarray(perms.reshape(-1)), adam.count, traj, side,
              JFU.pack_norm(agent.obs_rms, D),
              *JFU.pack_weights(agent.params, D),
              *JFU.pack_weights(adam.mu, D), *JFU.pack_weights(adam.nu, D))
    agent = agent.replace(params=JFU.unpack_weights(agent.params, *out[0:4],
                                                    D))
    adam = adam._replace(count=adam.count + 4,
                         mu=JFU.unpack_weights(adam.mu, *out[4:8], D),
                         nu=JFU.unpack_weights(adam.nu, *out[8:12], D))
    js.update(agent=agent, opt=(js["opt"][0], (adam, js["opt"][1][1])))

    state, got = train_iteration(
        state, TF.CollectNoise(pulse=torch.tensor(pulse),
                               rollout=torch.tensor(noise)),
        perms=torch.tensor(perms))
    assert got["ustats"] is None
    acts = slice(JFR.R_ACT, JFR.R_ACT + 6)
    np.testing.assert_array_equal(got["traj"][:, acts].numpy(),
                                  np.asarray(traj[:, acts]))
    _close(got["side"], side, rtol=1e-5, atol=1e-4)
    _check(state, got, js, _metrics(js["stats"], adv_n, values_n))


@pytest.mark.parametrize("G", [8, 1])
def test_no_fused_grads_iteration_matches_jax(G):
    """`--no-fused-grads` (train_fused.py:714-733): the side quantities in
    the trajectory's spare rows, the feat matrix, `rms_update_padded`,
    then `update_policy_feat` shuffled in G-sample super-rows."""
    jhp, hp = _hps(shuffle_block=G)
    net, js, state = _setup(jhp, hp, 31)
    _, update_policy = make_update_fns(jhp, net)
    train_iteration = TF.make_train_iteration(SimConfig(), hp, "cpu",
                                              fused_grads=False)
    rng = np.random.RandomState(51)
    pulse, noise, frozen_u = _draws(rng)
    traj, value_rms, adv_n, values_n, returns_n = _unfused_jax(
        jhp, net, js, pulse, noise, frozen_u)
    traj = traj.at[:, JFR.R_LOGP + 1, :].set(values_n)
    traj = traj.at[:, JFR.R_LOGP + 2, :].set(adv_n)
    traj = traj.at[:, JFR.R_LOGP + 3, :].set(returns_n)
    feat = jnp.swapaxes(traj, 1, 2).reshape(T * W, JFR.ROLL_ROWS)
    agent = js["agent"].replace(
        obs_rms=rms_update_padded(js["agent"].obs_rms, feat[:, :D]),
        value_rms=value_rms)
    key = jax.random.PRNGKey(81)
    agent, opt = update_policy.with_feat(agent, js["opt"], feat, D, 6, key)
    js.update(agent=agent, opt=opt)

    state, got = train_iteration(
        state, TF.CollectNoise(pulse=torch.tensor(pulse),
                               rollout=torch.tensor(noise)),
        perms=torch.tensor(_jax_perms(key, jhp)))
    _close(got["feat"], feat, rtol=1e-5, atol=1e-4)
    _check(state, got, js, _metrics(js["stats"], adv_n, values_n))


@pytest.mark.parametrize("kw, hp_kw", [
    (dict(rollout_kernel=True), dict(record_world0=True)),
    (dict(rollout_kernel=True, backend="xla"), {}),
    (dict(rollout_kernel=False, fused_gae=True), {}),
    (dict(rollout_kernel=True, fused_grads=False, fused_gae=True), {}),
    (dict(rollout_kernel=False, fused_gae=False, rollout_tiled=True), {}),
    (dict(rollout_kernel=True, fused_gae=False, dp_update=True), {})])
def test_invalid_paths_raise_the_jax_messages(kw, hp_kw):
    jhp, hp = _hps(**hp_kw)
    net, _ = jagent.init_agent(jax.random.PRNGKey(0))
    jkw = dict(kw)
    jkw.setdefault("fused_gae", False)
    with pytest.raises(ValueError) as want:
        make_train_iteration_fused(JSimConfig(), jhp, net,
                                   **{"backend": "pallas", **jkw})
    with pytest.raises(ValueError) as got:
        TF.make_train_iteration(SimConfig(), hp, "cpu", **kw)
    assert str(got.value) == str(want.value)


def test_world0_rows_match_jax():
    rng = np.random.RandomState(3)
    sf = rng.normal(size=(JL.N_F32_ROWS, W)).astype(np.float32)
    si = rng.randint(-1, 9, (JL.N_I32_ROWS, W)).astype(np.int32)
    done = rng.uniform(size=(W,)).astype(np.float32)
    want = _world0_rows(jnp.asarray(sf), jnp.asarray(si), jnp.asarray(done))
    got = TF.world0_rows(torch.tensor(sf), torch.tensor(si),
                         torch.tensor(done))
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(v).dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


def test_per_tick_chunk_equals_eager_iterations():
    """make_train_chunk over the per-tick path (a CPU chunk loops the
    iteration) and the world-0 rows stacked per iteration."""
    _, hp = _hps(record_world0=True)
    cfg = SimConfig()
    it = TF.make_train_iteration(cfg, hp, "cpu", rollout_kernel=False)
    a = TF.init_train_state(cfg, hp, 5, "cpu")
    b = TF.init_train_state(cfg, hp, 5, "cpu")
    rows = []
    for _ in range(2):
        a, out = it(a)
        rows.append(out["metrics"])
    b, stacked = TT.make_train_chunk(it, 2)(b)
    for j, m in enumerate(TT.unstack_metrics(stacked, 2)):
        for k in TF.METRICS:
            assert torch.equal(m[k], rows[j][k]), k
        for k, v in m["world0"].items():
            assert torch.equal(v, rows[j]["world0"][k]), k
    for x, y in zip(TF.state_tensors(a), TF.state_tensors(b)):
        assert torch.equal(x, y)
