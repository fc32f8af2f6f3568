"""The bf16 trajectory's consumers (the trainer's --bf16-traj): kernels C
(GAE), E (obs moments), D (the update phase) and G (one minibatch's
gradient), each given a trajectory of bfloat16.

Each plain version reads the bf16 rows upcast to float32, so it is held
  * against its own float32 version on the upcast trajectory, bit for bit
    (the JAX tests pin the same property of the Pallas kernels at 1e-6,
    1e-5 and 1e-7: tests/test_bf16_traj.py);
  * against the JAX kernel built with traj_dtype=bfloat16, in interpret
    mode, on the same quantized values (tests/test_bf16_traj.py's sizes:
    C at T 8 x W 256, E at T 4 x W 128, D and G at T 4 x W 64 with 16-wide
    blocks, 2 epochs x 2 minibatches), at the tiers the float32 ports hold
    against JAX (tests/test_torch_gae.py, test_torch_obs_moments.py,
    test_torch_update.py): the sums run in other orders there.
The g++ host builds of the card's tile bodies (csrc/host_gae.cpp,
csrc/host_update.cpp) read the bf16 bits as the kernels' bf16 instances
do: each equals its float32 entry on the upcast trajectory bit for bit,
and the plain version at the host tests' tiers."""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import constants as C
from madrona_basketball_tpu.models import agent as jagent
from madrona_basketball_tpu.models.normalize import rms_update as j_rms_update
from madrona_basketball_tpu.ops import fused_gae as JFG
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train import make_optimizer

from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.ops import fused_gae as FG
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.utils.jax_params import (adam_from_numpy,
                                                           agent_from_numpy)
from tests import torch_threads  # noqa: F401

BF16 = torch.bfloat16
F32 = torch.float32
D = C.OBS_USED


def _bf16(x: np.ndarray):
    """(torch bf16, jax bf16) of the same quantized values."""
    t = torch.tensor(x, dtype=F32).to(BF16)
    return t, jnp.asarray(t.to(F32).numpy()).astype(jnp.bfloat16)


def _same(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i


# ------------------------------------------------------------------ C

GAE_T, GAE_W, ROWS, RV, RR, RD = 8, 256, 32, 17, 19, 21
GAE_KW = dict(gamma=0.998, lam=0.95, r_value=RV, r_rew=RR, r_done=RD)


def _gae_inputs():
    """tests/test_bf16_traj.py's GAE inputs."""
    rng = np.random.RandomState(7)
    traj = rng.normal(scale=4.0, size=(GAE_T, ROWS, GAE_W)).astype(
        np.float32)
    traj[:, RD, :] = (rng.uniform(size=(GAE_T, GAE_W)) < 0.1)
    carry = rng.uniform(0, 50, (2, GAE_W)).astype(np.float32)
    nv = rng.uniform(-5, 5, (1, GAE_W)).astype(np.float32)
    vstats = np.zeros((1, FG.VSTAT_COLS), np.float32)
    vstats[0, :2] = (-80.0, 30.0)
    return traj, carry, nv, vstats


def test_gae_bf16_matches_jax_and_its_f32_twin_on_the_upcast():
    traj, carry, nv, vstats = _gae_inputs()
    t16, j16 = _bf16(traj)
    rest = [torch.tensor(x) for x in (carry, nv, vstats)]
    got = FG.fused_gae(t16, *rest, **GAE_KW)     # CPU: the plain version
    _same(got, FG.gae_plain(t16.to(F32), *rest, **GAE_KW))
    gb = FG.pick_gae_block(GAE_W)
    want = JFG.make_fused_gae(GAE_T, GAE_W, 0.998, 0.95, RV, RR, RD, gb=gb,
                              interpret=True, traj_dtype=jnp.bfloat16)(
        j16, *(jnp.asarray(x) for x in (carry, nv, vstats)))
    side, mom, carry_out, ticks = (x.numpy() for x in got)
    want = [np.asarray(x) for x in want]
    # tests/test_torch_gae.py's tiers
    np.testing.assert_allclose(side, want[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mom[:, 0::2], want[1][:, 0::2], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(mom[:, 1::2], want[1][:, 1::2], rtol=1e-4)
    np.testing.assert_allclose(carry_out, want[2], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(ticks, want[3], rtol=1e-5, atol=1e-3)


# ------------------------------------------------------------------ E

def test_obs_moments_bf16_matches_jax_and_its_f32_twin_on_the_upcast():
    T, W, used = 4, 128, 19
    rng = np.random.RandomState(3)
    t16, j16 = _bf16(rng.uniform(-20, 20, (T, ROWS, W)).astype(np.float32))
    got = FG.obs_moments(t16, used)              # CPU: the plain version
    assert torch.equal(got, FG.obs_moments_plain(t16.to(F32), used))
    want = np.asarray(JFG.make_obs_moments(
        T, W, used, interpret=True, traj_dtype=jnp.bfloat16)(j16))
    # tests/test_torch_obs_moments.py's tier: 1e-5 relative
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ D, G

UT, UW, WB = 4, 64, 16


def _update_inputs():
    """tests/test_bf16_traj.py's update inputs: a policy with obs
    statistics, a trajectory of valid actions and log-probs quantized to
    bf16, raw side rows and the JAX phase's block permutations."""
    rng = np.random.RandomState(17)
    _, ap = jagent.init_agent(jax.random.PRNGKey(13))
    ap = ap.replace(obs_rms=j_rms_update(ap.obs_rms, jnp.asarray(
        np.random.RandomState(13).normal(0.5, 1.5, (128, C.OBS_SIZE)),
        jnp.float32)))
    traj = rng.normal(scale=3.0, size=(UT, 128, UW)).astype(np.float32)
    for j, n in enumerate(C.ACTION_BUCKETS):
        traj[:, FU.R_ACT + j] = rng.randint(0, n, (UT, UW))
    traj[:, FU.R_LOGP] = rng.normal(scale=0.3, size=(UT, UW))
    side = rng.normal(size=(UT, FU.SIDE_ROWS, UW)).astype(np.float32)
    ustats = np.array([[rng.normal(), 0.5 + rng.uniform(), rng.normal(0, .1),
                        0.5 + rng.uniform(), 0, 0, 0, 0]], np.float32)
    n_blocks = UT * (UW // WB)
    perms = np.stack([rng.permutation(n_blocks) for _ in range(2)]).astype(
        np.int32).reshape(-1)
    return ap, traj, side, ustats, perms


@pytest.fixture(scope="module")
def update_case():
    kw = dict(num_envs=UW, num_rollout_steps=UT, num_minibatches=2,
              update_epochs=2)
    jhp, hp = JPPOParams(**kw), PPOParams(**kw)
    ap, traj, side, ustats, perms = _update_inputs()
    t16, j16 = _bf16(traj)
    opt = make_optimizer(jhp).init(ap.params)
    adam = opt[1][0]
    t_agent = agent_from_numpy(jax.tree.map(np.asarray, ap), "cpu")
    t_adam = adam_from_numpy(jax.tree.map(np.asarray, opt), "cpu")
    return dict(hp=hp, jhp=jhp, ap=ap, adam=adam, t16=t16, j16=j16,
                side=torch.tensor(side), jside=jnp.asarray(side),
                ustats=torch.tensor(ustats), justats=jnp.asarray(ustats),
                perms=perms, nrm=FU.pack_norm(t_agent.obs_rms),
                jnrm=JFU.pack_norm(ap.obs_rms, D),
                params=FU.pack_weights(t_agent.net), mu=t_adam.mu,
                nu=t_adam.nu)


@pytest.mark.parametrize("raw_side", [True, False])
def test_update_phase_bf16_matches_jax_and_its_f32_twin(update_case,
                                                       raw_side):
    """Two chained phases (the second from Adam count 4 and non-zero
    moments), with raw side rows (ustats) and normalized ones (ustats
    None, the --no-fused-gae branch)."""
    c = update_case
    hp = c["hp"]
    ufp = JFU.make_fused_update_phase(c["jhp"], D, UT, UW, WB,
                                      interpret=True, raw_side=raw_side,
                                      traj_dtype=jnp.bfloat16)
    us = c["ustats"] if raw_side else None
    jus = (c["justats"],) if raw_side else ()
    mats = (c["params"], c["mu"], c["nu"])
    jmats = (JFU.pack_weights(c["ap"].params, D) +
             JFU.pack_weights(c["adam"].mu, D) +
             JFU.pack_weights(c["adam"].nu, D))
    idx = torch.tensor(c["perms"])
    for phase in range(2):
        count = 4 * phase
        got = FU.fused_update_phase(hp, idx, count, c["t16"], c["side"],
                                    c["nrm"], us, *mats, wb=WB)
        twin = FU.update_phase_plain(hp, idx, count, c["t16"].to(F32),
                                     c["side"], c["nrm"], us, *mats, wb=WB)
        for g, t in zip(got, twin):
            _same(g, t)
        jout = ufp(jnp.asarray(c["perms"]), jnp.int32(count), c["j16"],
                   c["jside"], c["jnrm"], *jus, *jmats)
        # tests/test_torch_update.py's tier: 1e-5 absolute
        for i, (g, w) in enumerate(zip([x for m in got for x in m], jout)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5, err_msg=f"{phase} {i}")
        mats, jmats = got, tuple(jout)


def test_minibatch_grad_bf16_matches_jax_and_its_f32_twin(update_case):
    c = update_case
    hp = c["hp"]
    side_n = FU.normalize_side(c["side"], c["ustats"])
    bpm = hp.minibatch_size // WB
    idx = torch.tensor(c["perms"][:bpm])
    got = FU.fused_minibatch_grad_prefetch(hp, idx, c["t16"], side_n,
                                           c["nrm"], *c["params"], wb=WB)
    _same(got, FU.minibatch_grad_prefetch_plain(
        hp, idx, c["t16"].to(F32), side_n, c["nrm"], *c["params"], wb=WB))
    g = JFU.make_fused_minibatch_grad_prefetch(
        c["jhp"], D, UT, UW, WB, interpret=True, traj_dtype=jnp.bfloat16)
    want = g(jnp.asarray(c["perms"][:bpm]), c["j16"],
             jnp.asarray(side_n.numpy()), c["jnrm"],
             *JFU.pack_weights(c["ap"].params, D))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg=str(i))


# ------------------------------------------------------------------ host

def _host(name, entries):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = _build.BUILD_DIR / "host" / f"lib{name}_bf16_test.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out), str(_build.CSRC / f"{name}.cpp")],
                   check=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    src = _build.CSRC / f"{name}.cpp"
    for entry in entries:
        getattr(lib, entry).argtypes = _build.c_signature(src, entry)
    return lib


def _ptr(t):
    return t.data_ptr()


def test_host_gae_bf16_reads_the_bits_as_the_f32_build_the_upcast():
    lib = _host("host_gae", ("mbb_host_gae", "mbb_host_gae_bf16"))
    traj, carry, nv, vstats = _gae_inputs()
    t16, _ = _bf16(traj)
    rest = [torch.tensor(x) for x in (carry, nv, vstats)]
    gb = FG.pick_gae_block(GAE_W)
    nb = GAE_W // gb
    outs = {}
    for name, tr in (("bf16", t16.view(torch.int16)), ("f32", t16.to(F32))):
        o = [torch.empty(s) for s in ((GAE_T, FG.SIDE_ROWS, GAE_W), (nb, 8),
                                      (2, GAE_W), (nb, GAE_T, 8))]
        entry = lib.mbb_host_gae_bf16 if name == "bf16" else lib.mbb_host_gae
        entry(_ptr(tr), *map(_ptr, rest), *map(_ptr, o), GAE_T, ROWS, GAE_W,
              gb, RV, RR, RD, 0.998, 0.998 * 0.95)
        outs[name] = o
    _same(outs["bf16"], outs["f32"])
    # tests/test_torch_gae_tile.py's tiers against the plain version
    want = FG.gae_plain(t16, *rest, **GAE_KW)
    for i, (g, w) in enumerate(zip(outs["bf16"], want)):
        tol = 1e-6 if i in (0, 2) else 1e-5 * torch.clamp(w.abs(), min=1.0)
        assert bool(((g - w).abs() <= tol).all()), i


def test_host_update_bf16_reads_the_bits_as_the_f32_build_the_upcast(
        update_case):
    """Kernel D's phase (one, 2 x 2) and kernel G's minibatch in the host
    build: the bf16 entries equal the float32 ones on the upcast
    trajectory bit for bit."""
    lib = _host("host_update", (
        "mbb_host_update_phase", "mbb_host_update_phase_bf16",
        "mbb_host_minibatch_grad_prefetch",
        "mbb_host_minibatch_grad_prefetch_bf16"))
    c = update_case
    hp = c["hp"]
    bpm = hp.minibatch_size // WB
    idx = torch.tensor(c["perms"])
    loss = (float(hp.clip_coef), float(hp.vf_coef), float(hp.ent_coef),
            1 if hp.clip_vloss else 0)
    cnt = torch.tensor([0], dtype=torch.int32)
    res = {}
    for name, tr in (("bf16", c["t16"].view(torch.int16)),
                     ("f32", c["t16"].to(F32))):
        p, m, v = (FU._flat(x).clone() for x in (c["params"], c["mu"],
                                                 c["nu"]))
        phase = lib.mbb_host_update_phase_bf16 if name == "bf16" else \
            lib.mbb_host_update_phase
        phase(_ptr(idx), _ptr(cnt), _ptr(tr), _ptr(c["side"]),
              _ptr(c["nrm"]), _ptr(c["ustats"]), _ptr(p), _ptr(m), _ptr(v),
              3, 128, UW, WB, bpm, 4, *loss, float(hp.learning_rate),
              float(hp.max_grad_norm))
        g = torch.empty(FU.N_PARAMS)
        flat = FU._flat(c["params"])   # alive through the call
        grad = lib.mbb_host_minibatch_grad_prefetch_bf16 if name == "bf16" \
            else lib.mbb_host_minibatch_grad_prefetch
        grad(_ptr(idx), _ptr(tr), _ptr(c["side"]), _ptr(c["nrm"]),
             _ptr(flat), _ptr(g), 3, 128, UW, WB, bpm, *loss)
        res[name] = (p, m, v, g)
    _same(res["bf16"], res["f32"])
    assert not torch.equal(res["bf16"][0], FU._flat(c["params"]))
