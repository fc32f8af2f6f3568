"""Kernel B's no_prng and no_traj probes with the bf16 flags in plain torch
against the JAX rollout kernel built with them
(tests/test_torch_rollout_probes_bf16.py's setting and tiers).

  * no_prng: with external noise the JAX probe is the full kernel
    (fused_rollout.py:335-339), so it runs on the no_prng constants
    (sim noise 0.0, uniforms 0.5) as external noise, and the port's side
    is the wrapper with no noise given (its CPU path draws them).
  * no_traj: a (1, 128, W) zero block of the trajectory's dtype
    (fused_rollout.py:393-398, :468-480); state, obs and moments as the
    full kernel's, the moments folding the float32 obs (:387-392).
Both flags at once are held against the bf16-policy compile: the rows
the bf16-policy run stores, rounded (within one bf16 ulp of the JAX
kernel's), and the port's own bf16-policy run rounded, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from tests import torch_threads  # noqa: F401
from tests.test_torch_rollout_probes import T, W, probe_case, run_probe
from tests.test_torch_rollout_probes_bf16 import (BF16, FLAGS, JAX_FLAGS,
                                                  assert_bf16_policy_tier,
                                                  assert_bf16_store)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Four interpret-mode compiles: no_prng on the constants and no_traj
    on drawn noise, each with bf16 storage and with the bf16 policy."""
    return probe_case(
        tmp_path_factory,
        {**{f"no_prng_{b}": ("no_prng", "constant", JAX_FLAGS[b])
            for b in ("traj", "policy")},
         **{f"no_traj_{b}": ("no_traj", "random", JAX_FLAGS[b])
            for b in ("traj", "policy")}})


def test_no_prng_bf16_store_matches_the_jax_kernel(case):
    assert case["dtypes"]["no_prng_traj"] == jnp.bfloat16
    assert_bf16_store(run_probe(case, "no_prng", None, **FLAGS["traj"]),
                      case["want"]["no_prng_traj"])


@pytest.mark.parametrize("branch", ["policy", "both"])
def test_no_prng_bf16_policy_matches_the_jax_kernel(case, branch):
    got = run_probe(case, "no_prng", None, **FLAGS[branch])
    assert_bf16_policy_tier(case, got, case["want"]["no_prng_policy"],
                            "no_prng", "constant")
    if branch == "both":
        pol = run_probe(case, "no_prng", None, **FLAGS["policy"])
        assert torch.equal(got[3].view(torch.int16),
                           pol[3].to(BF16).view(torch.int16))


@pytest.mark.parametrize("branch", ["traj", "policy", "both"])
def test_no_traj_bf16_matches_the_jax_kernel(case, branch):
    got = run_probe(case, "no_traj", **FLAGS[branch])
    dtype = BF16 if branch != "policy" else torch.float32
    assert got[3].shape == (1, TFR.ROLL_ROWS, W) and got[3].dtype == dtype
    assert not torch.any(got[3])
    if branch == "traj":
        assert case["dtypes"]["no_traj_traj"] == jnp.bfloat16
        assert_bf16_store(got, case["want"]["no_traj_traj"])
    else:
        assert case["dtypes"]["no_traj_policy"] == jnp.float32
        assert_bf16_policy_tier(case, got, case["want"]["no_traj_policy"],
                                "no_traj", "random")


@pytest.mark.parametrize("branch", ["traj", "policy", "both"])
def test_no_traj_bf16_is_the_full_run_without_its_rows(case, branch):
    """State, obs and moments those of the run without the probe and with
    the same flags, bit for bit (the fold reads the float32 obs)."""
    for noise in ("constant", "random"):
        got = run_probe(case, "no_traj", noise, **FLAGS[branch])
        full = run_probe(case, None, noise, **FLAGS[branch])
        for i in (0, 1, 2, 4):
            assert torch.equal(got[i], full[i])
        assert full[3].shape == (T, TFR.ROLL_ROWS, W)
