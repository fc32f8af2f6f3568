"""`BasketballEnv` vs the JAX env, on the CPU, driven on the JAX package's
own noise: reset / step / trigger_reset / step_with_world_actions, with
and without a frozen policy, from the same initial state
(`init_rows(reset_u=...)` with the JAX spawn draws), the noise drawn by
`engine_fused.make_noise_fn` on the JAX env's keys and injected through
the port's `noise=` seam.  Tolerance: tests/test_fused.py::_compare_states,
atol 3e-4 (the JAX env runs the structured engine, which differs from the
rows by float reassociation).  The rows engine and the export are in
tests/test_torch_engine.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.engine_fused import make_noise_fn
from madrona_basketball_tpu.env import BasketballEnv as JEnv
from madrona_basketball_tpu.ops import layout as JL

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.env import BasketballEnv
from tests.test_fused import _compare_states
from tests.test_torch_engine import _BUCKETS, W, _actions, _init_from_jax


def _frozen_pair():
    """One deterministic opponent policy for both sides: actions from the
    ball-grabbed obs slot (an exact 0/1) and the world index."""
    def pattern(grabbed, xp):
        w = xp.arange(grabbed.shape[0])
        return [(grabbed.astype(np.int32) if xp is jnp else
                 grabbed.to(torch.int32)) + w + j for j in range(6)]

    def jax_policy(obs):
        cols = pattern(obs[:, 13], jnp)
        return jnp.stack([c % b for c, b in zip(cols, _BUCKETS)], axis=1)

    def torch_policy(obs):
        cols = pattern(obs[:, 13], torch)
        return torch.stack([c % b for c, b in zip(cols, _BUCKETS)], dim=1)
    return jax_policy, torch_policy


def _compare_env(jenv, env, out_j, out_t, t):
    view = JL.unpack(JSimConfig(), jnp.asarray(env.engine.sf.numpy()),
                     jnp.asarray(env.engine.si.numpy()), jenv.state.key,
                     obs=jnp.asarray(env.engine.obs.numpy()))
    _compare_states(jenv.state, view, t)
    for name, a, b in zip(("obs", "reward", "done"), out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=3e-4,
                                   rtol=1e-3, err_msg=f"{t}: {name}")


@pytest.mark.parametrize("frozen", [False, True])
def test_env_matches_jax_env(frozen):
    trainee = 1 if frozen else 0
    jp, tp = _frozen_pair() if frozen else (None, None)
    jenv = JEnv(W, JSimConfig(), seed=3, frozen_policy=jp,
                trainee_agent_idx=trainee)
    env = BasketballEnv(W, SimConfig(), seed=3, frozen_policy=tp,
                        trainee_agent_idx=trainee, device="cpu")
    _init_from_jax(env.engine, 3)
    noise_fn = make_noise_fn(JSimConfig())
    rng = np.random.RandomState(1)

    def noise():
        return torch.tensor(np.asarray(noise_fn(jenv.state.key)[1]))

    n = noise()
    out = env.reset(noise=n), jenv.reset()
    _compare_env(jenv, env, out[1], out[0], "reset")
    assert bool((out[0][2] == 1.0).all())
    assert not env.engine.si[JL.I_IDX["a0.reset"]].any()
    for t in range(3):
        if t == 1:
            jenv.trigger_reset(5)
            env.trigger_reset(5)
        acts = _actions(rng, (W,))
        n = noise()
        out_j = jenv.step(jnp.asarray(acts))
        out_t = env.step(torch.tensor(acts), noise=n)
        _compare_env(jenv, env, out_j, out_t, f"step {t}")
    acts, human = _actions(rng, (W,)), [1, 3, 2, 1, 0, 1]
    n = noise()
    out_j = jenv.step_with_world_actions(jnp.asarray(acts), human, 1 - trainee)
    out_t = env.step_with_world_actions(torch.tensor(acts), human,
                                        1 - trainee, noise=n)
    _compare_env(jenv, env, out_j, out_t, "world actions")
    assert not env.is_training_paused()


def test_env_surface():
    env = BasketballEnv(W, SimConfig(), seed=0, device="cpu")
    assert env.get_action_space_size() == 6 and env.get_input_dim() == 128
    assert env.get_action_buckets() == list(_BUCKETS)
    assert env.observations.shape == (W, 2, 128)
    assert env.get_blank_actions().shape == (W, 6)
    env.set_agent_idx(1)
    obs, rew, done = env.step(env.get_blank_actions())
    assert torch.equal(obs, env.get_obs()) and rew.shape == done.shape == (W,)
    assert torch.equal(env.observations[:, 1], obs)
    assert len(env.tensors()) == 19
    env.set_training_paused(True)
    assert env.is_training_paused()
    # a viewer is kept and gets the manager and the pause flag
    class Viewer:
        controller_manager, training_paused = None, False

        def set_controller_manager(self, mgr):
            self.controller_manager = mgr

        def set_training_paused(self, paused):
            self.training_paused = paused
    viewer, mgr = Viewer(), object()
    env = BasketballEnv(W, SimConfig(), viewer=viewer, device="cpu")
    assert env.viewer is viewer
    env.set_controller_manager(mgr)
    assert env.controller_manager is mgr and viewer.controller_manager is mgr
    env.set_training_paused(True)
    assert viewer.training_paused and env.is_training_paused()
