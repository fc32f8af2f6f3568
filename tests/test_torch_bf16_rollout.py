"""Kernel B's bf16 branches in plain torch (the trainer's --bf16-traj and
--bf16-policy) against the JAX rollout kernel built with them,
`make_fused_rollout(interpret=True, external_noise=True,
obs_moments=True)`, at tests/test_bf16_traj.py's size (128 worlds, 2
ticks, one 128-world block, trainee 1) on identical injected noise.

  * traj_dtype=bfloat16: the trajectory equals the JAX kernel's bit for
    bit, and the port's own float32 trajectory rounded to bf16; state,
    obs and the obs moments are the float32 run's exactly (the moments
    fold the obs before rounding), and held against JAX at
    tests/test_torch_rollout.py's tiers.
  * policy_bf16: the Dense operands rounded to bf16.  A product of two
    bf16 values is exact in float32, but JAX's CPU dot sums it in
    another order than the port's ascending k, and an ulp there can move
    a LayerNorm output across a bf16 rounding boundary.  So logp and the
    value are held at 2e-3 (a few bf16 ulps of a logit), and the sampled
    actions exactly, except in worlds where some bucket's Gumbel-max
    margin lies within that tolerance: those are counted and printed
    (run with -s), and must stay under 1 %."""

import functools

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
from madrona_basketball_tpu_torch.constants import ACTION_BUCKETS
from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy
from tests import torch_threads  # noqa: F401
from tests.torch_once import once_per_run

W, T, TI = 128, 2, 1
NL = TFR.N_LOGITS
BF16 = torch.bfloat16
POLICY_TOL = 2e-3


def _jax_inputs():
    """The inputs from numpy seeds and the JAX init and reset tick: both
    agents, the rows after the tick and the packed external noise, as
    numpy."""
    jcfg = JSimConfig()
    _, agent = jagent.init_agent(jax.random.PRNGKey(11))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(12))
    sf, si = JL.pack(engine.init_batch(jcfg, jax.random.PRNGKey(5), W))
    rng = np.random.RandomState(21)

    def sim_noise():
        return np.concatenate([rng.uniform(-1, 1, (8, W)),
                               rng.uniform(0, 1, (1, W))]).astype(np.float32)

    sf, si, obs0 = fused_step_xla(jcfg, sf, si, jnp.asarray(sim_noise()))
    chunks = [sim_noise() for _ in range(T)]
    t_u = rng.uniform(0, 1, (T, NL, W)).astype(np.float32)
    f_u = rng.uniform(0, 1, (T, NL, W)).astype(np.float32)
    noise = np.asarray(JFR.pack_rollout_noise(
        [jnp.asarray(c) for c in chunks], jnp.asarray(t_u),
        jnp.asarray(f_u)))
    return dict(agent=jax.tree.map(np.asarray, agent),
                frozen=jax.tree.map(np.asarray, frozen),
                rows=[np.asarray(x) for x in (sf, si, obs0)], noise=noise)


def _jax_kernel(j, name):
    """The JAX kernel's outputs with bf16 storage ("traj", trainee only)
    or the bf16 policy ("policy", the frozen opponent on): one
    interpret-mode compile each."""
    kw, frz = {"traj": (dict(traj_dtype=jnp.bfloat16), False),
               "policy": (dict(policy_bf16=True), True)}[name]
    mats = JFR.pack_policy(j["agent"]) + JFR.pack_policy(j["frozen"])
    rk = JFR.make_fused_rollout(JSimConfig(), W, T, trainee_idx=TI,
                                use_frozen=frz, block=128, interpret=True,
                                external_noise=True, obs_moments=True, **kw)
    out = rk(jnp.asarray(j["noise"]), *(jnp.asarray(x) for x in j["rows"]),
             *(mats if frz else mats[:5]))
    return out[3].dtype, [np.asarray(x.astype(jnp.float32))
                          if x.dtype == jnp.bfloat16 else np.asarray(x)
                          for x in out]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the JAX kernel's outputs with bf16 storage and with
    the bf16 policy (each once a run, tests/torch_once.py), and the
    port's agent."""
    j = once_per_run(tmp_path_factory, "bf16_rollout_inputs",
                     {(W, T): _jax_inputs})[(W, T)]
    got = once_per_run(tmp_path_factory, "bf16_rollout", {
        (W, T, TI, n): functools.partial(_jax_kernel, j, n)
        for n in ("traj", "policy")})
    assert got[(W, T, TI, "traj")][0] == jnp.bfloat16
    ta = agent_from_numpy(j["agent"], "cpu")
    tf = agent_from_numpy(j["frozen"], "cpu")
    rows = tuple(torch.tensor(x) for x in j["rows"])
    return dict(rows=rows, noise=torch.tensor(j["noise"]),
                want={n: got[(W, T, TI, n)][1] for n in ("traj", "policy")},
                mats=TFR.pack_policy(ta), fmats=TFR.pack_policy(tf))


def _run(c, frozen=False, **kw):
    return TFR.fused_rollout(SimConfig(), *c["rows"], c["mats"],
                             c["fmats"] if frozen else None, n_steps=T,
                             trainee_idx=TI, noise=c["noise"], **kw)


def test_bf16_store_matches_the_jax_kernel(case):
    got = _run(case, traj_dtype=BF16)
    assert got[3].dtype == BF16
    sf_k, si_k, obs_k, traj_k, mom_k = case["want"]["traj"]
    np.testing.assert_array_equal(got[3].float().numpy(), traj_k)
    # tests/test_torch_rollout.py's tiers for what stays float32
    np.testing.assert_array_equal(got[1].numpy(), si_k)
    np.testing.assert_allclose(got[0].numpy(), sf_k, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), obs_k, atol=1e-5)
    assert float(got[4][0, 2]) == T * W
    np.testing.assert_allclose(got[4][:, 0].numpy(), mom_k[:, 0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[4][:, 1].numpy(), mom_k[:, 1], rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("policy_bf16", [False, True])
def test_bf16_store_is_the_f32_rollout_rounded(case, frozen, policy_bf16):
    """bf16 storage changes nothing but the stored rows: each is the
    float32 run's value rounded to nearest even (zero rows included),
    and state, obs, moments and fold partials are the float32 run's bit
    for bit; `rollout_plain` is the wrapper's CPU path."""
    f32 = _run(case, frozen, policy_bf16=policy_bf16, moment_partials=True)
    b16 = _run(case, frozen, policy_bf16=policy_bf16, moment_partials=True,
               traj_dtype=BF16)
    assert torch.equal(b16[3].view(torch.int16),
                       f32[3].to(BF16).view(torch.int16))
    for i in (0, 1, 2, 4, 5):
        assert torch.equal(b16[i], f32[i]), i
    plain = TFR.rollout_plain(SimConfig(), *case["rows"], case["mats"],
                              case["fmats"] if frozen else None, n_steps=T,
                              trainee_idx=TI, noise=case["noise"],
                              traj_dtype=BF16, policy_bf16=policy_bf16)
    for a, b in zip(plain, b16[:5]):
        assert torch.equal(a, b)


def _near_tie_worlds(case, tol):
    """Worlds where, at some tick, some bucket's best and second-best
    noisy logits (the port's bf16-policy logits plus the Gumbel draws of
    the trainee and the frozen policy) lie within `tol`: there an
    ulp-level difference of the logits may pick another action."""
    rows = case["rows"]
    near = torch.zeros(W, dtype=torch.bool)
    for t in range(T):
        chunk = case["noise"][t * TFR.EXT_NOISE_CHUNK:
                              (t + 1) * TFR.EXT_NOISE_CHUNK]
        obs = rows[2]
        for agent, mats, u0 in ((TI, case["mats"], TFR.EXT_TRAINEE_U),
                                (1 - TI, case["fmats"], TFR.EXT_FROZEN_U)):
            lg, _ = TFR.policy_forward_rows(
                obs[agent * TFR.OBS:(agent + 1) * TFR.OBS], *mats,
                mm_dtype=BF16)
            noisy = lg + TFR.gumbel_from_uniform(chunk[u0:u0 + NL])
            off = 0
            for n in ACTION_BUCKETS:
                top = noisy[off:off + n].topk(2, dim=0).values
                near |= (top[0] - top[1]) <= tol
                off += n
        rows = TFR.rollout_plain(
            SimConfig(), *rows, case["mats"], case["fmats"], n_steps=1,
            trainee_idx=TI, noise=chunk, policy_bf16=True)[:3]
    return near


def test_bf16_policy_matches_the_jax_kernel(case):
    got = [x.numpy() for x in _run(case, frozen=True, policy_bf16=True)]
    sf_k, si_k, obs_k, traj_k, mom_k = case["want"]["policy"]
    near = _near_tie_worlds(case, POLICY_TOL).numpy()
    acts = slice(TFR.R_ACT, TFR.R_ACT + 6)
    diff = (got[3][:, acts] != traj_k[:, acts]).any(axis=(0, 1)) | \
        (got[1] != si_k).any(axis=0)
    print(f"\nbf16 policy vs the JAX kernel: {int(near.sum())} of {W} worlds"
          f" at a Gumbel-max margin <= {POLICY_TOL}; {int(diff.sum())} "
          f"differ in actions or state (all of them near ties: "
          f"{bool(not (diff & ~near).any())})")
    assert not (diff & ~near).any()
    assert near.sum() <= 0.01 * W
    ok = ~near
    np.testing.assert_array_equal(got[3][:, TFR.R_DONE][:, ok],
                                  traj_k[:, TFR.R_DONE][:, ok])
    for r in (TFR.R_LOGP, TFR.R_VALUE):
        np.testing.assert_allclose(got[3][:, r][:, ok], traj_k[:, r][:, ok],
                                   atol=POLICY_TOL)
    np.testing.assert_allclose(got[3][:, :TFR.ROLL_OBS][..., ok],
                               traj_k[:, :TFR.ROLL_OBS][..., ok], atol=1e-5)
    np.testing.assert_allclose(got[0][:, ok], sf_k[:, ok], atol=1e-5)
    np.testing.assert_allclose(got[2][:, ok], obs_k[:, ok], atol=1e-5)


def test_policy_forward_rounds_the_dense_operands():
    """policy_forward_rows(mm_dtype=bf16) is the float32 forward of the
    bf16-rounded weights on bf16-rounded activations: each Dense layer's
    products are exact, so rounding its inputs by hand gives the same
    bits; a float32 forward moves by a few bf16 ulps."""
    g = torch.Generator().manual_seed(3)
    from madrona_basketball_tpu_torch.models.agent import init_agent
    mats = TFR.pack_policy(init_agent(g, "cpu"))
    obs = torch.randn((TFR.OBS, 64), generator=g) * 3.0
    lg16, v16 = TFR.policy_forward_rows(obs, *mats, mm_dtype=BF16)
    lg32, v32 = TFR.policy_forward_rows(obs, *mats)
    r = [m.to(BF16).float() for m in mats[1:4]]
    x = torch.clamp((obs - mats[0][:, 0:1]) * mats[0][:, 1:2], -5.0, 5.0)
    h = TFR._matvec(r[0], x.to(BF16).float()) + mats[4][:, 0:1]
    h = torch.clamp(TFR._layer_norm(h, mats[4][:, 1:2], mats[4][:, 2:3]),
                    min=0.0)
    h = TFR._matvec(r[1], h.to(BF16).float()) + mats[4][:, 3:4]
    h = torch.clamp(TFR._layer_norm(h, mats[4][:, 4:5], mats[4][:, 5:6]),
                    min=0.0)
    out = TFR._matvec(r[2], h.to(BF16).float()) + mats[4][0:NL + 1, 6:7]
    assert torch.equal(lg16, out[:NL]) and torch.equal(v16, out[NL])
    assert 0.0 < float((lg16 - lg32).abs().max()) < 0.1
