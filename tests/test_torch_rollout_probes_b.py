"""Kernel B's no_prng and no_traj probes in plain torch against the JAX
rollout kernel (tests/test_torch_rollout_probes.py's set-up and tiers),
and the attribution bench's output on the CPU.

  * no_prng: in-kernel, the JAX kernel draws constants (sim noise 0.0,
    uniforms 0.5, fused_rollout.py:335-339); with external noise it is
    the full kernel.  So the JAX side is the kernel built without a
    probe on external noise set to those constants, and the port's side
    the wrapper with no noise given (its CPU path draws
    `no_prng_noise`).
  * no_traj: in the JAX kernel a (1, 128, W) trajectory of zeros,
    state, obs and moments those of the full kernel (:393-397, :438-439,
    :468-470 only drop the row writes).  So its state, obs and moments
    are held, on the same constant noise, against the full kernel's
    outputs that no_prng is held against: one interpret-mode compile
    serves the file."""

import json

import numpy as np
import pytest
import torch

from madrona_basketball_tpu_torch import bench_rollout_attr as BA
from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from tests.test_torch_rollout_probes import (T, W, assert_rollout_tiers,
                                             probe_case, run_probe)


@pytest.fixture(scope="module")
def case():
    return probe_case({"constant": (None, "constant")})


def test_no_prng_plain_matches_the_jax_kernel_on_constants(case):
    got = run_probe(case, "no_prng", noise=None)
    assert_rollout_tiers(got, case["want"]["constant"])
    assert torch.equal(TFR.no_prng_noise(T, W, "cpu"),
                       case["noise"]["constant"])
    # with external noise the probe is the full rollout
    full = run_probe(case, None)
    for a, b in zip(run_probe(case, "no_prng"), full):
        assert torch.equal(a, b)


def test_no_traj_plain_matches_the_jax_kernel(case):
    got = run_probe(case, "no_traj", noise="constant")
    assert got[3].shape == (1, TFR.ROLL_ROWS, W)
    assert not torch.any(got[3])
    assert_rollout_tiers(got, case["want"]["constant"], traj=False)
    for noise in ("constant", "random"):
        got = run_probe(case, "no_traj", noise=noise)
        full = run_probe(case, None, noise=noise)
        for i in (0, 1, 2, 4):
            assert torch.equal(got[i], full[i])


def test_bench_output_schema_on_the_cpu(capsys):
    line = BA.main(["64", "--ticks", "2", "--quick", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    assert line["metric"] == "rollout_attr_ms_64"
    assert (line["worlds"], line["ticks"], line["trainee"]) == (64, 2, 1)
    assert set(line["variants_ms"]) == set(BA.VARIANTS)
    assert set(line["deltas_vs_full_ms"]) == set(BA.DELTAS)
    assert set(line["bf16_savings_ms"]) == set(BA.SAVINGS)
    full = line["variants_ms"]["full"]
    for k, v in BA.DELTAS.items():
        assert line["deltas_vs_full_ms"][k] == pytest.approx(
            full - line["variants_ms"][v])
    assert all(np.isfinite(v) and v > 0
               for v in line["variants_ms"].values())
    assert line["t_sweep_ms"] is None and line["per_tick_ms"] is None
    # no wrapper column on the CPU: the plain versions are the times
    assert line["wrapper_ms"] is None and line["wrapper_t_sweep_ms"] is None
    assert "host clock" in line["timing"]
    assert line["device"] == "cpu" and line["power_limit"] is None
    # the plain versions count no launch
    assert line["launches"]["fused_rollout"] == 0
    assert set(line["launches"]["probe"]) == set(TFR.PROBES)


def test_bench_fit_is_least_squares():
    slope, icpt = BA.fit_line([[1, 1.5], [4, 3.0], [16, 9.0], [32, 17.0]])
    assert slope == pytest.approx(0.5) and icpt == pytest.approx(1.0)
