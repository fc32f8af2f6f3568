"""The port's per-step `infer` against the JAX package's (`chunk_size=1`)
on the CPU: 4 worlds of `SimConfig(time_per_period=1.0)` (every episode
ends by tick ~62), one episode, at most 70 ticks, deterministic, then
stochastic with a frozen opponent.  Both start from the same rows (the
port's `init_rows` on the JAX spawn draws, as tests/test_torch_engine.py
does), the env noise is the JAX env's (`engine_fused.make_noise_fn` on
its keys, injected through `infer(noise=...)`) and the Gumbel draws
replay the JAX `make_policy_fn`'s key splits, the trainee's from key
`seed` and the frozen policy's from `seed + 1`.  Actions, every integer
array and the episode counts must be exact; floats within atol 3e-4 /
rtol 1e-3 (the JAX env steps the structured engine, which differs from
the rows by float reassociation, tests/test_torch_engine_env.py); keys,
shapes and dtypes equal.  A divergence reports its first tick and
world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.engine_fused import make_noise_fn
from madrona_basketball_tpu.env import BasketballEnv as JEnv
from madrona_basketball_tpu.infer import infer as jinfer
from madrona_basketball_tpu.infer import make_policy_fn as jpolicy
from madrona_basketball_tpu.models.agent import init_agent as jinit
from madrona_basketball_tpu.ops import layout as JL

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.infer import infer, make_policy_fn
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy
from tests.test_torch_init import _jax_reset_u
from tests.test_torch_infer_chunk import _one_thread  # noqa: F401

W, ENV_SEED, TEST_SEED, MAX_STEPS = 4, 3, 0, 70
JCFG = JSimConfig(time_per_period=1.0)
CFG = SimConfig(time_per_period=1.0)


def _gumbels(seed):
    """The draws of the JAX make_policy_fn seeded `seed`, call by call."""
    draw = jax.jit(lambda k: jax.random.gumbel(k, (W, 19), jnp.float32))
    key = jax.random.PRNGKey(seed)
    while True:
        key, k = jax.random.split(key)
        yield torch.tensor(np.asarray(draw(k)))


def _noise(keys, n):
    """The JAX env's sim noise of its next n ticks (one key split per
    world and tick, whatever the actions)."""
    draw = jax.jit(make_noise_fn(JCFG))
    out = []
    for _ in range(n):
        keys, nz = draw(keys)
        out.append(torch.tensor(np.asarray(nz)))
    return out


def _first_divergence(a, b, exact):
    """(tick, world) of the first entry out of tolerance, else None."""
    if exact:
        bad = a != b
    else:
        bad = ~np.isclose(b, a, atol=3e-4, rtol=1e-3)
    bad = bad.reshape(bad.shape[0], bad.shape[1], -1).any(-1) \
        if bad.ndim > 1 else bad
    idx = np.argwhere(bad)
    return tuple(int(i) for i in idx[0]) if len(idx) else None


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["deterministic", "stochastic_frozen"])
def test_infer_matches_jax_infer(stochastic, tmp_path):
    net, jap = jinit(jax.random.PRNGKey(2))
    ap = agent_from_numpy(jax.tree.map(np.asarray, jap), "cpu")
    jfrozen_fn = frozen_fn = frozen = None
    if stochastic:
        _, jfp = jinit(jax.random.PRNGKey(5))
        frozen = agent_from_numpy(jax.tree.map(np.asarray, jfp), "cpu")
        jfrozen_fn = jpolicy(net, jfp, jax.random.PRNGKey(TEST_SEED + 1))
        frozen_fn = make_policy_fn(frozen, None,
                                   gumbel=_gumbels(TEST_SEED + 1))
    jenv = JEnv(W, JCFG, seed=ENV_SEED, frozen_policy=jfrozen_fn,
                trainee_agent_idx=1)
    env = BasketballEnv(W, CFG, seed=ENV_SEED, frozen_policy=frozen_fn,
                        trainee_agent_idx=1, device="cpu")
    ru = _jax_reset_u(JCFG, jax.random.PRNGKey(ENV_SEED), W)
    env.engine.sf, env.engine.si = init_rows(
        CFG, W, None, "cpu", reset_u=torch.tensor(ru.T.copy()))
    sf_j, si_j = (np.asarray(x) for x in JL.pack(jenv.state))
    np.testing.assert_array_equal(env.engine.si.numpy(), si_j)
    np.testing.assert_allclose(env.engine.sf.numpy(), sf_j, atol=2e-6,
                               rtol=0)
    noise = _noise(jenv.state.key, MAX_STEPS + 1)

    kw = dict(num_episodes=1, max_steps=MAX_STEPS, stochastic=stochastic,
              seed=TEST_SEED, trainee_idx=1, chunk_size=1)
    jpath, path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcounts = jinfer(jenv, net, jap, log_path=jpath,
                     frozen_params=jfp if stochastic else None, **kw)
    counts = infer(env, ap, log_path=path, frozen_params=frozen,
                   noise=iter(noise),
                   gumbel=_gumbels(TEST_SEED) if stochastic else None, **kw)

    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    assert (counts == 1).all()
    want, got = dict(np.load(jpath)), dict(np.load(path))
    assert sorted(got) == sorted(want)
    T = want["done"].shape[0]
    assert 50 < T < MAX_STEPS
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        if k in ("num_episodes", "hoop_pos"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-6)
            continue
        exact = want[k].dtype.kind in "iu"
        first = _first_divergence(want[k], got[k], exact)
        assert first is None, f"{k}: first divergence at (tick, world) " \
            f"{first}"
