"""Kernel B's timing probes in plain torch against the JAX rollout kernel
built with the same probe (`make_fused_rollout(probe=...)`, interpret
mode, external noise, obs moments on) at 128 worlds x 2 ticks, one
128-world block, trainee 1, the frozen opponent on, on identical inputs
made from numpy seeds (the worlds by the port's plain init and tick,
the weights carried over by `agent_from_numpy`):
sim_only and policy_only here, no_prng and no_traj in
tests/test_torch_rollout_probes_b.py (xdist splits by file), the probes
with the bf16 flags in tests/test_torch_rollout_probes_bf16*.py.  Integer
rows exact, float rows at tests/test_torch_rollout.py's tiers; plus each
probe's own semantics, and the wrapper's refusal of an unknown probe."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.ops import fused_rollout as JFR

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.ops import fused_rollout as TFR
from madrona_basketball_tpu_torch.ops.fused_step import step_rows_plain
from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy
from tests import torch_threads  # noqa: F401
from tests.torch_once import once_per_run

W, T, TI = 128, 2, 1
NL = TFR.N_LOGITS


def _jax_inputs(chunks, t_u, f_u):
    """The JAX side's inputs: both agents (the JAX init), the packed
    external noises and policies, as numpy."""
    _, agent = jagent.init_agent(jax.random.PRNGKey(11))
    _, frozen = jagent.init_agent(jax.random.PRNGKey(12))
    noises = {"random": np.asarray(JFR.pack_rollout_noise(
        [jnp.asarray(c) for c in chunks], jnp.asarray(t_u),
        jnp.asarray(f_u)))}
    half = jnp.full((T, NL, W), 0.5, jnp.float32)
    noises["constant"] = np.asarray(JFR.pack_rollout_noise(
        [jnp.zeros((9, W), jnp.float32)] * T, half, half))
    mats = JFR.pack_policy(agent) + JFR.pack_policy(frozen)
    return dict(agent=jax.tree.map(np.asarray, agent),
                frozen=jax.tree.map(np.asarray, frozen), noises=noises,
                mats=[np.asarray(m) for m in mats])


def probe_case(tmp_path_factory, kernels):
    """Inputs from numpy seeds and the JAX kernel's outputs for each
    kernels {name: (probe, noise[, flags])} (noise "random": the drawn
    external noise; "constant": sim rows 0.0, uniforms 0.5; flags: the
    kernel's traj_dtype / policy_bf16, a bf16 trajectory returned upcast
    to float32 and its dtype in "dtypes"), with the port's rows, noises
    and packed policies.  The worlds: the port's plain init on
    numpy spawn draws and one plain tick (its obs the rollout's first).
    The JAX inputs, and each kernel's outputs keyed by its probe, noise
    and flags, are computed once a run (tests/torch_once.py)."""
    jcfg = JSimConfig()
    rng = np.random.RandomState(21)

    def sim_noise():
        return np.concatenate([rng.uniform(-1, 1, (8, W)),
                               rng.uniform(0, 1, (1, W))]).astype(np.float32)

    cfg = SimConfig()
    sf, si = init_rows(cfg, W, None, "cpu", reset_u=torch.tensor(
        rng.uniform(0, 1, (3, W)).astype(np.float32)))
    rows = step_rows_plain(cfg, sf, si, torch.tensor(sim_noise()))
    sf, si, obs0 = (jnp.asarray(x.numpy()) for x in rows)
    chunks = [sim_noise() for _ in range(T)]
    t_u = rng.uniform(0, 1, (T, NL, W)).astype(np.float32)
    f_u = rng.uniform(0, 1, (T, NL, W)).astype(np.float32)
    key = (W, T, 11, 12, 21)
    j = once_per_run(tmp_path_factory, "rollout_probe_inputs", {
        key: functools.partial(_jax_inputs, chunks, t_u, f_u)})[key]
    mats = [jnp.asarray(m) for m in j["mats"]]

    def kernel(probe, noise, flags):
        rk = JFR.make_fused_rollout(jcfg, W, T, trainee_idx=TI,
                                    use_frozen=True, block=128,
                                    interpret=True, external_noise=True,
                                    obs_moments=True, probe=probe, **flags)
        out = rk(jnp.asarray(j["noises"][noise]), sf, si, obs0, *mats)
        return out[3].dtype, [np.asarray(x.astype(jnp.float32))
                              if x.dtype == jnp.bfloat16 else np.asarray(x)
                              for x in out]

    keys, computes = {}, {}
    for name, (probe, noise, *flags) in kernels.items():
        flags = flags[0] if flags else {}
        keys[name] = (W, T, TI, probe, noise, tuple(sorted(flags.items())))
        computes[keys[name]] = functools.partial(kernel, probe, noise, flags)
    got = once_per_run(tmp_path_factory, "rollout_probe", computes)
    want = {name: got[k][1] for name, k in keys.items()}
    dtypes = {name: got[k][0] for name, k in keys.items()}
    return dict(rows=rows, want=want, dtypes=dtypes,
                noise={k: torch.tensor(v) for k, v in j["noises"].items()},
                mats=TFR.pack_policy(agent_from_numpy(j["agent"], "cpu")),
                fmats=TFR.pack_policy(agent_from_numpy(j["frozen"], "cpu")))


def run_probe(c, probe, noise="random", **kw):
    """The wrapper on CPU tensors (the plain version), with the frozen
    policy; noise None draws the wrapper's own (no_prng: constants)."""
    return TFR.fused_rollout(SimConfig(), *c["rows"], c["mats"], c["fmats"],
                             n_steps=T, trainee_idx=TI,
                             noise=None if noise is None else
                             c["noise"][noise], probe=probe, **kw)


def assert_rollout_tiers(got, want, traj=True):
    """tests/test_torch_rollout.py's tiers: actions, done and si exact,
    obs rows, reward, sf and obs within 1e-5, logp and value within 1e-4,
    the moments within 1e-5 (mean) and 1e-4 relative (M2); traj False
    holds the state, obs and moments only."""
    sf_t, si_t, obs_t, traj_t, mom_t = (x.numpy() for x in got)
    sf_k, si_k, obs_k, traj_k, mom_k = want
    if traj:
        assert_traj_tiers(traj_t, traj_k)
    np.testing.assert_array_equal(si_t, si_k)
    np.testing.assert_allclose(sf_t, sf_k, atol=1e-5)
    np.testing.assert_allclose(obs_t, obs_k, atol=1e-5)
    assert mom_t[0, 2] == mom_k[0, 2] == T * W
    np.testing.assert_allclose(mom_t[:, 0], mom_k[:, 0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mom_t[:, 1], mom_k[:, 1], rtol=1e-4,
                               atol=1e-3)


def assert_traj_tiers(traj_t, traj_k):
    assert traj_t.shape == traj_k.shape
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
    assert not np.any(traj_t[:, pad])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return probe_case(tmp_path_factory,
                      {p: (p, "random") for p in ("sim_only",
                                                  "policy_only")})


@pytest.mark.parametrize("probe", ["sim_only", "policy_only"])
def test_probe_plain_matches_the_jax_kernel(case, probe):
    got = run_probe(case, probe)
    assert_rollout_tiers(got, case["want"][probe])
    plain = TFR.rollout_plain(SimConfig(), *case["rows"], case["mats"],
                              case["fmats"], n_steps=T, trainee_idx=TI,
                              noise=case["noise"]["random"], probe=probe)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)


def test_sim_only_runs_no_policy(case):
    """No action, logp or value: their rows 0, and the state that of T
    plain ticks on the actions the input held (no action written)."""
    got = run_probe(case, "sim_only")
    assert not torch.any(got[3][:, TFR.R_ACT:TFR.R_VALUE + 1])
    rows = case["rows"]
    for t in range(T):
        chunk = case["noise"]["random"][t * TFR.EXT_NOISE_CHUNK:]
        rows = step_rows_plain(SimConfig(), *rows[:2],
                               chunk[:TFR.N_NOISE_ROWS])
    for a, b in zip(got[:3], rows):
        assert torch.equal(a, b)
    assert not torch.equal(got[0], case["rows"][0])


def test_policy_only_runs_no_tick(case):
    """sf and obs unchanged, si changed in the action rows only, reward
    and done rows 0, the actions sampled each tick."""
    sf, si, obs, traj, _ = run_probe(case, "policy_only")
    sf0, si0, obs0 = case["rows"]
    assert torch.equal(sf, sf0) and torch.equal(obs, obs0)
    acts = [r for a in range(2) for r in ACTION_ROWS[a]]
    rest = [r for r in range(si.shape[0]) if r not in acts]
    assert torch.equal(si[rest], si0[rest])
    assert not torch.equal(si[acts], si0[acts])
    assert not torch.any(traj[:, TFR.R_REW:TFR.R_DONE + 1])
    assert not torch.equal(traj[0, TFR.R_ACT:TFR.R_LOGP],
                           traj[1, TFR.R_ACT:TFR.R_LOGP])


@pytest.mark.parametrize("kw, match", [
    ({"probe": "no_policy"}, "probe must be None or one of"),
    ({"probe": "sim_only", "traj_dtype": torch.bfloat16}, None),
    ({"probe": "no_traj", "policy_bf16": True}, None),
])
def test_probe_refusals(case, kw, match):
    """An unknown name raises (the JAX kernel's assert), on the CPU and
    before any launch.  A probe with a bf16 flag runs, as the JAX kernel
    does (tests/test_torch_rollout_probes_bf16*.py hold each against the
    JAX kernel built with the flag): sim_only with bf16 storage returns
    this file's JAX-checked sim_only run with its trajectory rounded
    once, and no_traj with the bf16 policy one float32 zero block beside
    the state, obs and moments of the full bf16-policy run."""
    probe = kw.pop("probe")
    if match is None:
        got = run_probe(case, probe, **kw)
        if probe == "sim_only":
            f32 = run_probe(case, probe)
            assert got[3].dtype == torch.bfloat16
            assert torch.equal(got[3].view(torch.int16),
                               f32[3].to(torch.bfloat16).view(torch.int16))
            assert_rollout_tiers((*got[:3], got[3].float(), got[4]),
                                 case["want"]["sim_only"], traj=False)
        else:
            assert got[3].shape == (1, TFR.ROLL_ROWS, W)
            assert got[3].dtype == torch.float32 and not torch.any(got[3])
            full = run_probe(case, None, **kw)
            for i in (0, 1, 2, 4):
                assert torch.equal(got[i], full[i])
        return
    with pytest.raises(ValueError, match=match):
        run_probe(case, probe, **kw)
    with pytest.raises(ValueError, match=match):
        TFR.rollout_plain(SimConfig(), *case["rows"], case["mats"],
                          case["fmats"], n_steps=T, trainee_idx=TI,
                          noise=case["noise"]["random"], probe=probe, **kw)
