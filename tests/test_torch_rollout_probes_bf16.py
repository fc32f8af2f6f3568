"""Kernel B's timing probes with the bf16 flags in plain torch against the
JAX rollout kernel built with the same probe and flags
(`make_fused_rollout(probe=..., traj_dtype=bfloat16 | policy_bf16=True)`,
interpret mode, external noise, obs moments on), in
tests/test_torch_rollout_probes.py's setting: 128 worlds x 2 ticks, one
128-world block, trainee 1, the frozen opponent on, inputs from numpy
seeds, the weights carried over by `agent_from_numpy`.  sim_only and
policy_only here; no_prng and no_traj in
tests/test_torch_rollout_probes_bf16_b.py (xdist splits by file).

Tiers, as tests/test_torch_bf16_rollout.py's:
  * bf16 storage: the trajectory equals the JAX kernel's bit for bit;
    state, obs and moments at tests/test_torch_rollout.py's tiers.
  * the bf16 policy: logp and value within 2e-3, the actions exact but
    in worlds where some bucket's Gumbel-max margin lies within that
    tolerance (counted and printed; run with -s).  The worlds whose
    actions or state differ must all be such near ties, and under 1 %.
    The near ties themselves are not bounded: here each world samples
    24 buckets (2 ticks, 2 policies), and on drawn uniforms ~5 % of the
    worlds hold one within 2e-3; with no_prng's constant uniforms the
    logits alone pick the actions, and the initial policy's logits lie
    within ~0.02 of each other, so there every world does.  In the
    worlds that agree, the other rows and the state are held at the
    float32 tiers (a bf16-stored row within one bf16 ulp more).
And identities of the port that need no JAX compile: sim_only with the
bf16 policy is sim_only, bit for bit (no policy runs); every probe with
bf16 storage is the float32-storage probe with its trajectory rounded
once, its state, obs, moments and partials that run's; policy_only with
a bf16 flag leaves the state and obs as the input holds them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.constants import ACTION_BUCKETS
from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS
from tests import torch_threads  # noqa: F401
from tests.test_torch_rollout_probes import (NL, T, TI, W,
                                             assert_rollout_tiers,
                                             probe_case, run_probe)

BF16 = torch.bfloat16
POLICY_TOL = 2e-3
FLAGS = {"traj": {"traj_dtype": BF16}, "policy": {"policy_bf16": True},
         "both": {"traj_dtype": BF16, "policy_bf16": True}}
JAX_FLAGS = {"traj": {"traj_dtype": jnp.bfloat16},
             "policy": {"policy_bf16": True},
             "both": {"traj_dtype": jnp.bfloat16, "policy_bf16": True}}


def upcast(got):
    """The outputs with a bf16 trajectory upcast (exact) to float32."""
    return (*got[:3], got[3].float(), *got[4:])


def assert_bf16_store(got, want):
    """A bf16-stored trajectory equal to the JAX kernel's bit for bit;
    state, obs and moments at tests/test_torch_rollout.py's tiers."""
    assert got[3].dtype == BF16
    np.testing.assert_array_equal(got[3].float().numpy(), want[3])
    assert_rollout_tiers(upcast(got), want, traj=False)


def near_tie_worlds(c, probe, noise, tol=POLICY_TOL):
    """Worlds where, at some tick of the probe's plain bf16-policy run,
    some bucket's best and second-best noisy logits (the trainee's and
    the frozen policy's bf16-policy logits plus their Gumbel draws) lie
    within `tol`: there an ulp-level difference of the logits may pick
    another action."""
    rows = c["rows"]
    near = torch.zeros(W, dtype=torch.bool)
    for t in range(T):
        chunk = c["noise"][noise][t * TFR.EXT_NOISE_CHUNK:
                                  (t + 1) * TFR.EXT_NOISE_CHUNK]
        for agent, mats, u0 in ((TI, c["mats"], TFR.EXT_TRAINEE_U),
                                (1 - TI, c["fmats"], TFR.EXT_FROZEN_U)):
            lg, _ = TFR.policy_forward_rows(
                rows[2][agent * TFR.OBS:(agent + 1) * TFR.OBS], *mats,
                mm_dtype=BF16)
            noisy = lg + TFR.gumbel_from_uniform(chunk[u0:u0 + NL])
            off = 0
            for n in ACTION_BUCKETS:
                top = noisy[off:off + n].topk(2, dim=0).values
                near |= (top[0] - top[1]) <= tol
                off += n
        rows = TFR.rollout_plain(
            SimConfig(), *rows, c["mats"], c["fmats"], n_steps=1,
            trainee_idx=TI, noise=chunk, policy_bf16=True, probe=probe)[:3]
    return near


def assert_bf16_policy_tier(c, got, want, probe, noise):
    """The bf16-policy tier (the module's docstring): got the port's run,
    want the JAX kernel's (a bf16 trajectory on either side upcast)."""
    bf16_rows = got[3].dtype == BF16
    got = [x.numpy() for x in upcast(got)]
    sf_k, si_k, obs_k, traj_k, mom_k = want
    near = near_tie_worlds(c, probe, noise).numpy()
    diff = (got[1] != si_k).any(axis=0)
    if traj_k.shape[0] == T:
        acts = slice(TFR.R_ACT, TFR.R_ACT + 6)
        diff |= (got[3][:, acts] != traj_k[:, acts]).any(axis=(0, 1))
    print(f"\n{probe} with the bf16 policy vs the JAX kernel ({noise} "
          f"noise): {int(near.sum())} of {W} worlds at a Gumbel-max margin "
          f"<= {POLICY_TOL}; {int(diff.sum())} differ in actions or state "
          f"(all of them near ties: {bool(not (diff & ~near).any())})")
    assert not (diff & ~near).any()
    assert diff.sum() <= 0.01 * W
    ok = ~diff

    def close(a, b, atol):
        # a bf16-stored row: one bf16 ulp more (two values within the
        # tier may round apart)
        tol = atol + (2.0 ** -7 * np.abs(b) if bf16_rows else 0.0)
        assert np.all(np.abs(a - b) <= tol)
    if traj_k.shape[0] == T:
        np.testing.assert_array_equal(got[3][:, TFR.R_DONE][:, ok],
                                      traj_k[:, TFR.R_DONE][:, ok])
        for r in (TFR.R_LOGP, TFR.R_VALUE):
            close(got[3][:, r][:, ok], traj_k[:, r][:, ok], POLICY_TOL)
        close(got[3][:, :TFR.ROLL_OBS][..., ok],
              traj_k[:, :TFR.ROLL_OBS][..., ok], 1e-5)
    else:
        np.testing.assert_array_equal(got[3], traj_k)
    np.testing.assert_allclose(got[0][:, ok], sf_k[:, ok], atol=1e-5)
    np.testing.assert_allclose(got[2][:, ok], obs_k[:, ok], atol=1e-5)
    if not diff.any():
        np.testing.assert_allclose(got[4][:, 0], mom_k[:, 0], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[4][:, 1], mom_k[:, 1], rtol=1e-4,
                                   atol=1e-3)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Four interpret-mode compiles: sim_only with bf16 storage,
    policy_only with each flag."""
    return probe_case(
        tmp_path_factory,
        {"sim_only_traj": ("sim_only", "random", JAX_FLAGS["traj"]),
         **{f"policy_only_{b}": ("policy_only", "random", JAX_FLAGS[b])
            for b in ("traj", "policy", "both")}})


@pytest.mark.parametrize("probe", ["sim_only", "policy_only"])
def test_bf16_store_probe_matches_the_jax_kernel(case, probe):
    assert case["dtypes"][f"{probe}_traj"] == jnp.bfloat16
    assert_bf16_store(run_probe(case, probe, **FLAGS["traj"]),
                      case["want"][f"{probe}_traj"])


@pytest.mark.parametrize("branch", ["policy", "both"])
def test_policy_only_bf16_policy_matches_the_jax_kernel(case, branch):
    got = run_probe(case, "policy_only", **FLAGS[branch])
    assert got[3].dtype == (BF16 if branch == "both" else torch.float32)
    assert_bf16_policy_tier(case, got, case["want"][f"policy_only_{branch}"],
                            "policy_only", "random")


@pytest.mark.parametrize("branch", ["traj", "policy", "both"])
def test_policy_only_with_a_bf16_flag_runs_no_tick(case, branch):
    """sf and obs the input's bit for bit, si changed in the action rows
    only, reward and done 0."""
    sf, si, obs, traj, _ = run_probe(case, "policy_only", **FLAGS[branch])
    sf0, si0, obs0 = case["rows"]
    assert torch.equal(sf, sf0) and torch.equal(obs, obs0)
    acts = [r for a in range(2) for r in ACTION_ROWS[a]]
    rest = [r for r in range(si.shape[0]) if r not in acts]
    assert torch.equal(si[rest], si0[rest])
    assert not torch.equal(si[acts], si0[acts])
    assert not torch.any(traj[:, TFR.R_REW:TFR.R_DONE + 1])


@pytest.mark.parametrize("traj_dtype", [torch.float32, BF16])
def test_sim_only_ignores_the_bf16_policy(case, traj_dtype):
    """No policy runs, so the flag changes nothing (the JAX kernel never
    uses its policy dtype there): every output bit for bit."""
    want = run_probe(case, "sim_only", traj_dtype=traj_dtype)
    got = run_probe(case, "sim_only", traj_dtype=traj_dtype,
                    policy_bf16=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy_bf16", [False, True])
@pytest.mark.parametrize("probe", TFR.PROBES)
def test_bf16_store_probe_is_the_f32_probe_rounded(case, probe, policy_bf16):
    """bf16 storage changes the stored rows only: each the float32-storage
    run's value rounded to nearest even (a zero block for no_traj), the
    state, obs, moments and fold partials that run's, bit for bit;
    `rollout_plain` is the wrapper's CPU path."""
    noise = None if probe == "no_prng" else "random"
    kw = dict(policy_bf16=policy_bf16, moment_partials=True)
    f32 = run_probe(case, probe, noise, **kw)
    b16 = run_probe(case, probe, noise, traj_dtype=BF16, **kw)
    assert b16[3].dtype == BF16 and b16[3].shape == f32[3].shape
    assert torch.equal(b16[3].view(torch.int16),
                       f32[3].to(BF16).view(torch.int16))
    for i in (0, 1, 2, 4, 5):
        assert torch.equal(b16[i], f32[i]), i
    plain = TFR.rollout_plain(
        SimConfig(), *case["rows"], case["mats"], case["fmats"], n_steps=T,
        trainee_idx=TI, noise=case["noise"][noise or "constant"],
        probe=probe, traj_dtype=BF16, policy_bf16=policy_bf16)
    for a, b in zip(plain, b16[:5]):
        assert torch.equal(a, b)
