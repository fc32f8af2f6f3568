"""Kernel I's plain version: `fused_rollout_tiled` on CPU tensors (which
runs `rollout_tiled_plain`) vs the JAX tiled rollout kernel
`make_fused_rollout_tiled(interpret=True, external_noise=True)` at 1024
worlds x 2 ticks, with and without the frozen policy, on identical
injected noise (the inputs of tests/test_rollout_kernel.py:198-243).
Tiers as tests/test_torch_rollout.py: actions, dones and integer state
exact, obs / reward / state 1e-5, logp and value 1e-4.  The tiled
rollout is kernel B's contract without the obs moments, so on the CPU it
equals `rollout_plain`'s first four outputs exactly; a world count that
is not a multiple of 1024 raises, as the JAX kernel asserts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import engine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.ops import fused_rollout as JFR
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ops.fused_step import fused_step_xla

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy
from tests import torch_threads  # noqa: F401

W, T, TI = 1024, 2, 1
NL = TFR.N_LOGITS


def _setup(seed=44):
    cfg = JSimConfig()
    _, agent = jagent.init_agent(jax.random.PRNGKey(11))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(12))
    sf, si = JL.pack(engine.init_batch(cfg, jax.random.PRNGKey(5), W))
    rng = np.random.RandomState(seed)

    def sim_noise():
        return np.concatenate([rng.uniform(-1, 1, (8, W)),
                               rng.uniform(0, 1, (1, W))]).astype(np.float32)

    sf, si, obs0 = fused_step_xla(cfg, sf, si, jnp.asarray(sim_noise()))
    chunks = [sim_noise() for _ in range(T)]
    t_u = rng.uniform(0, 1, (T, NL, W)).astype(np.float32)
    f_u = rng.uniform(0, 1, (T, NL, W)).astype(np.float32)
    noise = np.asarray(JFR.pack_rollout_noise(
        [jnp.asarray(c) for c in chunks], jnp.asarray(t_u),
        jnp.asarray(f_u)))
    return cfg, agent, frozen, (sf, si, obs0), noise


@pytest.mark.parametrize("use_frozen", [False, True])
def test_rollout_tiled_matches_pallas_interpret(use_frozen):
    jcfg, agent, frozen, (sf, si, obs0), noise = _setup()
    rollout = JFR.make_fused_rollout_tiled(jcfg, W, T, trainee_idx=TI,
                                           use_frozen=use_frozen,
                                           block=1024, interpret=True,
                                           external_noise=True)
    mats = JFR.pack_policy(agent) + (JFR.pack_policy(frozen) if use_frozen
                                     else ())
    want = [np.asarray(x) for x in rollout(jnp.asarray(noise), sf, si, obs0,
                                           *mats)]

    ta = agent_from_numpy(jax.tree.map(np.asarray, agent), "cpu")
    tf = agent_from_numpy(jax.tree.map(np.asarray, frozen), "cpu")
    args = (SimConfig(), torch.tensor(np.asarray(sf)),
            torch.tensor(np.asarray(si)), torch.tensor(np.asarray(obs0)),
            TFR.pack_policy(ta), TFR.pack_policy(tf) if use_frozen else None)
    got = TFR.fused_rollout_tiled(*args, n_steps=T, trainee_idx=TI,
                                  noise=torch.tensor(noise))
    assert len(got) == 4
    flat = TFR.rollout_plain(*args, n_steps=T, trainee_idx=TI,
                             noise=torch.tensor(noise))
    for a, b in zip(got, flat[:4]):
        assert torch.equal(a, b)

    sf_k, si_k, obs_k, traj_k = want
    sf_t, si_t, obs_t, traj_t = (x.numpy() for x in got)
    acts = slice(TFR.R_ACT, TFR.R_ACT + 6)
    np.testing.assert_array_equal(traj_t[:, acts], traj_k[:, acts])
    np.testing.assert_allclose(traj_t[:, :TFR.ROLL_OBS],
                               traj_k[:, :TFR.ROLL_OBS], atol=1e-5)
    for r in (TFR.R_LOGP, TFR.R_VALUE):
        np.testing.assert_allclose(traj_t[:, r], traj_k[:, r], atol=1e-4)
    np.testing.assert_allclose(traj_t[:, TFR.R_REW], traj_k[:, TFR.R_REW],
                               atol=1e-5)
    np.testing.assert_array_equal(traj_t[:, TFR.R_DONE],
                                  traj_k[:, TFR.R_DONE])
    pad = [TFR.R_LOGP + 1, TFR.R_LOGP + 2] + list(range(TFR.R_DONE + 1, 128))
    assert not np.any(traj_t[:, pad]) and not np.any(traj_k[:, pad])
    np.testing.assert_array_equal(si_t, si_k)
    np.testing.assert_allclose(sf_t, sf_k, atol=1e-5)
    np.testing.assert_allclose(obs_t, obs_k, atol=1e-5)


def test_rollout_tiled_needs_1024_worlds():
    from madrona_basketball_tpu_torch.engine import init_rows
    from madrona_basketball_tpu_torch.models.agent import init_agent
    w = 512
    g = torch.Generator().manual_seed(0)
    sf, si = init_rows(SimConfig(), w, g, "cpu")
    mats = TFR.pack_policy(init_agent(g, "cpu"))
    obs = torch.zeros((256, w))
    noise = TFR.philox_noise(0, 0, 1, w, "cpu")
    for fn in (TFR.fused_rollout_tiled, TFR.rollout_tiled_plain):
        with pytest.raises(ValueError, match="1024"):
            fn(SimConfig(), sf, si, obs, mats, n_steps=1, trainee_idx=TI,
               noise=noise)
