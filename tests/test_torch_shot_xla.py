"""The shot's going-in decision at its threshold: the plain tick
`step_rows_plain` against the JAX package's `fused_step_xla` on the CPU.

Inputs: 512 worlds from `shot_margin_inputs` (the draw of
tests/test_torch_device_body.py::test_shot_outcome_exact_at_the_threshold:
generator seed 8, correctly rounded sqrt while the inputs are made), so
each world's shot lands within a few rounding steps of ZONE_R^2.  A world
"differs" when any integer row, `sbaskets` or a team score differs after
one tick.

XLA:CPU contracts `p*q + r` into one fused multiply-add, and the plain
shot chain (`ops/fused_step.py::shot_aim`) makes the same
contractions, found by probing each sum of products on these worlds.  What
is left is the elementary functions: XLA's `rsqrt` is an estimate plus a
Newton step (up to 2 ulp, machine-dependent), torch's CPU `rsqrt`, `sqrt`,
`sin` and `cos` are not XLA's, and an ulp of 1 / |d| moves closest_sq by
~2 ulps of dist2.  So decisions must agree beyond a margin, in ulps of
dist2, and the share that differs inside it is bounded; the parametrized
cases put XLA's own functions into the plain tick one group at a time.

Measured on an AMD EPYC CPU, torch 2.13.0+cpu, jax 0.9.0 (worlds of 512
that differ / largest |margin| of a differing world, in ulps of dist2):
  * every product of the chain rounded alone: 129 / 5.28;
  * the contracted chain, torch's functions: 70 / 3.70 (50 on the inputs
    that the rounded-alone chain's bisection picks; 8192 worlds, seed 1:
    1106 / 3.98);
  * XLA's rsqrt: 12 / 2.44 (rounded alone: 97) (8192: 112 / 3.86);
  * XLA's rsqrt, sqrt, sin and cos: 1 / 0.09 (8192: 22 / 2.36, all of them
    worlds whose defender term counts, not isolated).
The bounds below take the 8192-world margins, rounded up."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.ops.fused_step import fused_step_xla

from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops.layout import F_IDX
from tests import torch_threads  # noqa: F401
from tests.torch_once import once_per_run

W = 512
DECISION_ROWS = [F_IDX[n] for n in ("sbaskets", "t0score", "t1score")]
_XLA = {"sin": jnp.sin, "cos": jnp.cos, "sqrt": jnp.sqrt,
        "rsqrt": jax.lax.rsqrt}


def _torch_fn(jfn):
    f = jax.jit(jfn)
    return lambda x: torch.from_numpy(np.array(f(jnp.asarray(x.numpy()))))


@pytest.fixture(scope="module")
def threshold_worlds(tmp_path_factory):
    """The threshold worlds and their tick by `fused_step_xla` (once a
    run, tests/torch_once.py)."""
    cfg = GAME_MODES["1v1"]
    g = torch.Generator().manual_seed(8)
    sf, si = init_rows(cfg, W, g, "cpu")

    def sqrt(x):
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "sqrt", sqrt)
        mp.setattr(torch, "rsqrt", lambda x: 1.0 / sqrt(x))
        sf, si, noise, margin = FS.shot_margin_inputs(cfg, sf, si, g)

    def xla_tick():
        return [np.asarray(x) for x in fused_step_xla(
            JSimConfig(one_on_one=True, tag_mode=False),
            *(jnp.asarray(x.numpy()) for x in (sf, si, noise)))]
    want = once_per_run(tmp_path_factory, "shot_xla",
                        {(W, 8, "1v1"): xla_tick})[(W, 8, "1v1")]
    return cfg, sf, si, noise, margin.numpy(), want


@pytest.mark.parametrize("xla_fns,margin_ulps,max_share", [
    ((), 4.5, 0.2),
    (("rsqrt",), 4.0, 0.04),
    (("rsqrt", "sqrt", "sin", "cos"), 2.5, 0.01)])
def test_shot_decisions_match_xla_beyond_margin(threshold_worlds, xla_fns,
                                                margin_ulps, max_share):
    cfg, sf, si, noise, margin, (jsf, jsi, _) = threshold_worlds
    with pytest.MonkeyPatch.context() as mp:
        for n in xla_fns:
            mp.setattr(torch, n, _torch_fn(_XLA[n]))
        got = FS.step_rows_plain(cfg, sf, si, noise)
    psf, psi = got[0].numpy(), got[1].numpy()
    differ = (psi != jsi).any(0) | \
        (psf[DECISION_ROWS] != jsf[DECISION_ROWS]).any(0)
    share = float(differ.mean())
    worst = float(np.abs(margin[differ]).max()) if differ.any() else 0.0
    print(f"XLA functions {xla_fns or 'none'}: {int(differ.sum())} of {W} "
          f"threshold worlds differ ({share:.4f}), largest |margin| "
          f"{worst:.3f} ulps of dist2")
    assert (np.abs(margin) > margin_ulps).sum() > 0
    assert not differ[np.abs(margin) > margin_ulps].any(), \
        f"a shot {margin_ulps} ulps or more from the threshold differs"
    assert share <= max_share
