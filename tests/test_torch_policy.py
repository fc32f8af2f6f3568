"""Policy, sampling and normalizers vs the JAX package.

`agent_from_numpy` moves a flax AgentParams into the port; `forward` /
`evaluate` / `sample` with injected Gumbel noise must then match
`models.agent.forward` / `evaluate` (actions exact, logp and value 1e-4,
tests/test_rollout_kernel.py:116-119), and `pack_policy` /
`policy_forward_rows` / `sample_rows` must match their JAX counterparts."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from madrona_basketball_tpu import constants as C
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.models import normalize as jnorm
from madrona_basketball_tpu.ops import fused_rollout as JFR

from madrona_basketball_tpu_torch.models import action as taction
from madrona_basketball_tpu_torch.models import agent as tagent
from madrona_basketball_tpu_torch.models import normalize as tnorm
from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy

B = 96
NL = sum(C.ACTION_BUCKETS)


def _agents():
    net, ap = jagent.init_agent(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    obs = jnp.asarray(rng.uniform(-20, 20, (B, C.OBS_SIZE)), jnp.float32)
    ap = ap.replace(obs_rms=jnorm.rms_update(ap.obs_rms, obs * 0.5 + 1.0),
                    value_rms=jnorm.rms_update(
                        ap.value_rms, jnp.asarray(rng.normal(3, 2, (50, 1)),
                                                  jnp.float32)))
    tp = agent_from_numpy(jax.tree.map(np.asarray, ap), device="cpu")
    return net, ap, tp, obs, rng


def test_forward_evaluate_sample_match_jax():
    net, ap, tp, obs, rng = _agents()
    u = rng.uniform(0, 1, (B, NL)).astype(np.float32)
    u[0, :2] = 0.0                     # the 1e-20 guard
    gumbel = -np.log(-np.log(np.maximum(u, 1e-20)))
    x = jnorm.rms_normalize(ap.obs_rms, obs, clamp=5.0)
    logits, value = net.apply(ap.params, x)
    noisy = logits + gumbel
    acts, lps = [], []
    off = 0
    for n in C.ACTION_BUCKETS:
        a = jnp.argmax(noisy[:, off:off + n], axis=-1)
        lp = jax.nn.log_softmax(logits[:, off:off + n], axis=-1)
        lps.append(jnp.take_along_axis(lp, a[:, None], axis=1)[:, 0])
        acts.append(a)
        off += n
    want_a = np.stack([np.asarray(a) for a in acts], 1)
    want_lp = np.asarray(sum(lps))

    ta, tlp, tv = tagent.forward(tp, torch.tensor(np.asarray(obs)),
                                 torch.tensor(gumbel))
    np.testing.assert_array_equal(ta.numpy(), want_a)
    np.testing.assert_allclose(tlp.numpy(), want_lp, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(value), atol=1e-4)
    ev = tagent.evaluate(tp, torch.tensor(np.asarray(obs)))
    np.testing.assert_allclose(ev.numpy(),
                               np.asarray(jagent.evaluate(net, ap, obs)),
                               atol=1e-4)

    # deterministic path: per-bucket argmax + log-probs (models/action.py)
    ba, blp, _ = tagent.forward(tp, torch.tensor(np.asarray(obs)))
    ja, jlp, _ = jagent.forward(net, ap, obs, None, stochastic=False)
    np.testing.assert_array_equal(ba.numpy(), np.asarray(ja))
    np.testing.assert_allclose(blp.numpy(), np.asarray(jlp), atol=1e-4)

    # unnormalize with the value normalizer
    vals = jnp.asarray(rng.uniform(-7, 7, (B,)), jnp.float32)
    np.testing.assert_allclose(
        tagent.unnorm_value(tp, torch.tensor(np.asarray(vals))).numpy(),
        np.asarray(jagent.unnorm_value(ap, vals)), rtol=1e-6, atol=1e-5)


def test_first_max_ties():
    logits = torch.zeros((3, NL))
    g = torch.zeros((3, NL))
    a, _ = taction.sample(g, logits)
    assert torch.equal(a, torch.zeros_like(a))
    acts, _ = TFR.sample_rows(logits.T, g.T)
    assert all(int(x.abs().sum()) == 0 for x in acts)


def test_kernel_form_policy_matches_jax():
    net, ap, tp, obs, rng = _agents()
    jm = [np.asarray(m) for m in JFR.pack_policy(ap)]
    tm = TFR.pack_policy(tp)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    jl, jv = JFR.policy_forward_rows(obs.T, *JFR.pack_policy(ap))
    tl, tv = TFR.policy_forward_rows(torch.tensor(np.asarray(obs).T), *tm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)

    u = rng.uniform(0, 1, (NL, B)).astype(np.float32)
    ja, jlp = JFR.sample_rows(jl, JFR.gumbel_from_uniform(jnp.asarray(u)))
    ta, tlp = TFR.sample_rows(tl, TFR.gumbel_from_uniform(torch.tensor(u)))
    for x, y in zip(ta, ja):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)
    assert TFR.flat_policy(tm).shape == (TFR.POLICY_FLOATS,)


def test_normalizer_merges_match_jax():
    rng = np.random.RandomState(5)
    mean = rng.uniform(-1, 1, 16).astype(np.float32)
    var = rng.uniform(0.5, 2, 16).astype(np.float32)
    jst = jnorm.RMSState(mean=jnp.asarray(mean), var=jnp.asarray(var),
                         count=jnp.asarray(300.0))
    tst = tnorm.RMSState(mean=torch.tensor(mean), var=torch.tensor(var),
                         count=torch.tensor(300.0))
    x = rng.uniform(-20, 20, (200, 16)).astype(np.float32)
    a = jnorm.rms_update(jst, jnp.asarray(x))
    b = tnorm.rms_update(tst, torch.tensor(x))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-5)
    used = 11
    m = x[:, :used].mean(0)
    m2 = ((x[:, :used] - m) ** 2).sum(0)
    a = jnorm.rms_update_padded_moments(jst, jnp.asarray(m), jnp.asarray(m2),
                                        200.0)
    b = tnorm.rms_update_padded_moments(tst, torch.tensor(m),
                                        torch.tensor(m2), 200.0)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-5)


def test_init_distribution_matches_reference_quirk():
    ag = tagent.init_agent(torch.Generator().manual_seed(0), "cpu")
    w0 = ag.net.backbone[0].weight.detach()
    std = float(w0.std())
    want = (2.0 / 3.0 / C.OBS_SIZE) ** 0.5
    assert abs(std - want) / want < 0.05
    wa = ag.net.actor.weight.detach()
    np.testing.assert_allclose((wa @ wa.T).numpy(),
                               1e-4 * np.eye(NL), atol=1e-8)
    assert float(ag.net.actor.bias.detach().abs().sum()) == 0.0
    assert float(ag.obs_rms.count) == 1.0
