"""The port's modules that no trainer uses - PopArt (models/popart.py),
the EMA normalizer (models/moving_avg.py), `RolloutBuffer`
(ppo/buffers.py) - against the JAX package's functions on the same
seeded numpy inputs, on the CPU, within 1e-6 (relative to max(1, |x|));
and a `utils/profiling.py` session's trace written on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.models import moving_avg as JE
from madrona_basketball_tpu.models import popart as JP
from madrona_basketball_tpu.ppo import buffers as JB

from madrona_basketball_tpu_torch.models import moving_avg as E
from madrona_basketball_tpu_torch.models import popart as P
from madrona_basketball_tpu_torch.ppo import buffers as B
from madrona_basketball_tpu_torch.utils import profiling

TOL = 1e-6


def _close(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=msg)


@pytest.mark.parametrize("unnorm", [False, True])
def test_popart_matches_jax(unnorm):
    rng = np.random.RandomState(0)
    dim = 3
    st, jst = P.popart_init(dim, 0.2, "cpu"), JP.popart_init(dim, 0.2)
    kernel = rng.normal(size=(32, dim)).astype(np.float32)
    bias = rng.normal(size=(dim,)).astype(np.float32)
    for step in range(5):
        x = rng.normal(2.0, 3.0, (64, dim)).astype(np.float32)
        st, k, b = P.popart_update(st, torch.tensor(x), torch.tensor(kernel),
                                   torch.tensor(bias))
        jst, jk, jb = JP.popart_update(jst, jnp.asarray(x),
                                       jnp.asarray(kernel),
                                       jnp.asarray(bias))
        for f in ("m", "v", "debias"):
            _close(getattr(st, f), getattr(jst, f), f"{step} {f}")
        _close(k, jk, f"{step} kernel")
        _close(b, jb, f"{step} bias")
        kernel, bias = np.asarray(jk), np.asarray(jb)
        y = rng.normal(size=(16, dim)).astype(np.float32)
        _close(P.popart_normalize(st, torch.tensor(y), unnorm),
               JP.popart_normalize(jst, jnp.asarray(y), unnorm),
               f"{step} normalize")


def test_ema_matches_jax():
    rng = np.random.RandomState(1)
    st, jst = E.ema_init(0.99, device="cpu"), JE.ema_init(0.99)
    for step in range(6):
        x = rng.normal(-1.0, 4.0, (128,)).astype(np.float32)
        st = E.ema_update(st, torch.tensor(x))
        jst = JE.ema_update(jst, jnp.asarray(x))
        for f in ("mu", "inv_sigma", "sigma", "mu_biased",
                  "sigma_sq_biased", "n"):
            _close(getattr(st, f), getattr(jst, f), f"{step} {f}")
        y = rng.normal(size=(8,)).astype(np.float32)
        _close(E.ema_normalize(st, torch.tensor(y)),
               JE.ema_normalize(jst, jnp.asarray(y)), f"{step} norm")
        _close(E.ema_unnormalize(st, torch.tensor(y)),
               JE.ema_unnormalize(jst, jnp.asarray(y)), f"{step} unnorm")


def test_rollout_buffer_matches_jax():
    T, N, D, K = 4, 6, 5, 3
    rng = np.random.RandomState(2)
    buf, jbuf = B.make_buffer(T, N, D, K, "cpu"), JB.make_buffer(T, N, D, K)
    assert (buf.horizon, buf.n_envs, buf.get_total_steps()) == \
        (jbuf.horizon, jbuf.n_envs, jbuf.get_total_steps()) == (T, N, T * N)
    for t in range(T):
        row = (rng.normal(size=(N, D)).astype(np.float32),
               rng.randint(0, 4, (N, K)).astype(np.int32),
               *(rng.normal(size=(N,)).astype(np.float32) for _ in range(4)))
        before = buf.obs.clone()
        buf = buf.set_step(t, *(torch.tensor(r) for r in row))
        jbuf = jbuf.set_step(t, *(jnp.asarray(r) for r in row))
        if t == 0:
            assert not torch.equal(before, buf.obs)   # a new buffer
            assert float(before.abs().sum()) == 0.0  # the old one kept
    adv = rng.normal(size=(T, N)).astype(np.float32)
    ret = rng.normal(size=(T, N)).astype(np.float32)
    buf = B.RolloutBuffer(**{**buf.__dict__, "advantages": torch.tensor(adv),
                             "returns": torch.tensor(ret)})
    jbuf = jbuf.replace(advantages=jnp.asarray(adv),
                        returns=jnp.asarray(ret))
    for f in ("obs", "actions", "values", "log_probs", "rewards",
              "not_dones", "next_value", "advantages", "returns"):
        _close(getattr(buf, f), getattr(jbuf, f), f)
    assert buf.actions.dtype == torch.int32
    idx = rng.permutation(T * N)[:7]
    for g, w in zip(buf.get_minibatch(torch.tensor(idx)),
                    jbuf.get_minibatch(jnp.asarray(idx))):
        _close(g, w, "minibatch")


def test_profiling_trace_on_the_cpu(tmp_path):
    """A session on the CPU writes the region as a host span and the
    stamps between "start" and "end" as device phases (host clock)."""
    path = tmp_path / "trace.json"
    with profiling.trace(str(path), "cpu") as tracer:
        with profiling.annotate("mbb_region"):
            tracer.mark("start")
            torch.ones(64).cumsum(0)
            tracer.mark("cumsum")
            tracer.mark("end")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {(e["tid"], e["name"]) for e in events if e["ph"] == "X"}
    assert spans == {(0, "mbb_region"), (1, "cumsum"), (1, "end")}
    assert not profiling.TRACER.on
