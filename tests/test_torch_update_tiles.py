"""Kernels D, G and H's tile decomposition on the CPU: csrc/update_tile.cuh
compiled by g++ (csrc/host_update.cpp) vs the plain versions.

The host build runs the card's order: the same CTAs (a few here, so that
each walks several tiles of 64 samples and keeps its sums across them),
every stage of a tile for threads 0..255 in turn, each thread's 4 x 4
weight-gradient tiles and column sums, the reduce's chunk order, the
slices' norms and clip + Adam.  It differs from the plain version
(which tests/test_torch_update.py holds against the JAX package) only in
the order of its float32 sums and in libm.  Tolerances are the card's:
gradients within 1e-4 of each leaf's largest entry (+ 1e-7); after a
phase of Adam steps params within 1e-4 absolute and mu, nu within 1e-4
of each leaf's largest entry, plus `update_phase_kinks`' allowance for
the samples at a kink of the loss."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.models.agent import init_agent
from madrona_basketball_tpu_torch.models.normalize import rms_update
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from tests import torch_threads  # noqa: F401

T, W = 4, 256


@pytest.fixture(scope="module")
def host():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = _build.BUILD_DIR / "host" / "libhost_update.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out),
                    str(_build.CSRC / "host_update.cpp")], check=True,
                   timeout=120)
    lib = ctypes.CDLL(str(out))
    for entry in ("mbb_host_update_phase", "mbb_host_minibatch_grad_prefetch",
                  "mbb_host_minibatch_grad", "mbb_host_sample_owner",
                  "mbb_host_warp_stages", "mbb_host_update_layout"):
        getattr(lib, entry).argtypes = _build.c_signature(
            _build.CSRC / "host_update.cpp", entry)
    return lib


def _inputs(seed):
    """A policy with non-trivial obs statistics, and a trajectory and side
    rows made with numpy: obs ~ N(0, 3), valid actions, log-probs, raw
    side rows."""
    rng = np.random.RandomState(seed)
    agent = init_agent(torch.Generator().manual_seed(seed), "cpu")
    agent.obs_rms = rms_update(agent.obs_rms, torch.tensor(
        rng.normal(1.0, 2.0, (256, 128)), dtype=torch.float32))
    traj = rng.normal(scale=3.0, size=(T, 128, W))
    for j, n in enumerate((2, 8, 3, 2, 2, 2)):
        traj[:, FU.R_ACT + j] = rng.randint(0, n, (T, W))
    traj[:, FU.R_LOGP] = rng.normal(scale=0.3, size=(T, W))
    side = rng.normal(size=(T, FU.SIDE_ROWS, W))
    ustats = np.array([[rng.normal(), 0.5 + rng.uniform(), rng.normal(0, .1),
                        0.5 + rng.uniform(), 0, 0, 0, 0]])
    f32 = (lambda x: torch.tensor(x, dtype=torch.float32))
    return (rng, FU.pack_norm(agent.obs_rms), FU.pack_weights(agent.net),
            f32(traj), f32(side), f32(ustats))


def _args(hp):
    return (float(hp.clip_coef), float(hp.vf_coef), float(hp.ent_coef),
            1 if hp.clip_vloss else 0)


def _grad_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        lim = 1e-4 * float(w.abs().max()) + 1e-7
        err = float((g - w).abs().max())
        assert err <= lim, f"leaf {i}: {err} > {lim}"


@pytest.mark.parametrize("wb,max_parts,clip_vloss",
                         [(128, 3, True), (32, 5, False)])
def test_host_phase_matches_update_phase_plain(host, wb, max_parts,
                                               clip_vloss):
    """1 epoch x 2 minibatches of 512 samples (tiles of 64 from 128-wide
    blocks, or 32-sample tiles from 32-wide ones), the second phase from
    the first's Adam state."""
    hp = PPOParams(num_envs=W, num_rollout_steps=T, update_epochs=1,
                   num_minibatches=2, clip_vloss=clip_vloss)
    rng, nrm, params, traj, side, ustats = _inputs(5)
    n_blocks = T * W // wb
    opt = TT.init_adam(params)
    mats, count = (params, opt.mu, opt.nu), 0
    for phase in range(2):
        idx = torch.tensor(rng.permutation(n_blocks), dtype=torch.int32)
        p, m, v = (FU._flat(x).clone() for x in mats)
        cnt = torch.tensor([count], dtype=torch.int32)
        host.mbb_host_update_phase(
            idx.data_ptr(), cnt.data_ptr(), traj.data_ptr(), side.data_ptr(),
            nrm.data_ptr(), ustats.data_ptr(), p.data_ptr(), m.data_ptr(),
            v.data_ptr(), max_parts, 128, W, wb, hp.minibatch_size // wb, 2,
            *_args(hp), float(hp.learning_rate), float(hp.max_grad_norm))
        *want, rep = FU.update_phase_kinks(hp, idx, count, traj, side, nrm,
                                           ustats, *mats, wb=wb)
        assert rep["samples"] <= 1e-3 * rep["of_samples"]
        for name, got, ws, allow in zip(("params", "mu", "nu"),
                                        (p, m, v), want, rep["allow"]):
            for i, (g, w, a) in enumerate(zip(FU._split(got), ws, allow)):
                lim = 1e-4 if name == "params" else 1e-4 * float(w.abs().max())
                assert bool(torch.isfinite(g).all())
                over = (g - w).abs() > lim + a
                assert not bool(over.any()), \
                    f"phase {phase} {name}[{i}]: {float((g - w).abs().max())}"
        mats, count = tuple(want), count + 2


@pytest.mark.parametrize("wb,max_parts", [(128, 4), (64, 1)])
def test_host_grad_matches_block_grads_plain(host, wb, max_parts):
    """Kernel G's decomposition (normalized side rows) against
    `block_grads_plain` over the same gathered blocks."""
    hp = PPOParams(num_envs=W, num_rollout_steps=T, num_minibatches=2)
    rng, nrm, params, traj, side, ustats = _inputs(7)
    side_n = FU.normalize_side(side, ustats)
    bpm = hp.minibatch_size // wb
    idx = torch.tensor(rng.permutation(T * W // wb)[:bpm], dtype=torch.int32)
    grads, flat = torch.zeros(FU.N_PARAMS), FU._flat(params)
    host.mbb_host_minibatch_grad_prefetch(
        idx.data_ptr(), traj.data_ptr(), side_n.data_ptr(), nrm.data_ptr(),
        flat.data_ptr(), grads.data_ptr(), max_parts, 128, W, wb, bpm,
        *_args(hp))
    tb, sb = FU.gather_blocks(idx, traj, side_n, wb)
    want = FU.block_grads_plain(
        hp, 1.0 / hp.minibatch_size, tb[0:FU.D], tb[FU.R_ACT:FU.R_ACT + FU.NB],
        tb[FU.R_LOGP], sb[FU.SIDE_VALUE], sb[FU.SIDE_ADV], sb[FU.SIDE_RET],
        nrm, *params)
    _grad_close(FU._split(grads), want)


def test_host_feat_grad_matches_minibatch_grad_plain(host):
    """Kernel H's decomposition on a row-major feat matrix of 200 rows:
    three full tiles and a ragged one of 8 samples."""
    hp = PPOParams(num_envs=W, num_rollout_steps=T)
    rng, nrm, params, traj, side, ustats = _inputs(9)
    mb = 200
    idx = torch.tensor(rng.permutation(T * W // 8)[:mb // 8],
                       dtype=torch.int32)
    tb, sb = FU.gather_blocks(idx, traj, FU.normalize_side(side, ustats), 8)
    feat = torch.cat([tb.T, sb[:3].T], dim=1).contiguous()
    grads, flat = torch.zeros(FU.N_PARAMS), FU._flat(params)
    host.mbb_host_minibatch_grad(
        feat.data_ptr(), nrm.data_ptr(), flat.data_ptr(), grads.data_ptr(), 2,
        mb, feat.shape[1], *_args(hp))
    _grad_close(FU._split(grads),
                FU.minibatch_grad_plain(hp, feat, nrm, *params))


def test_phase_equals_its_minibatches_chained(host):
    """A phase of 4 minibatches equals its minibatches run one call each,
    chained, bit for bit: the host build of kernel D and its plain version
    (chip_smoke.py holds the card's phase that way, each step against the
    plain step from the same params and moments)."""
    hp = PPOParams(num_envs=W, num_rollout_steps=T, update_epochs=2,
                   num_minibatches=2)
    rng, nrm, params, traj, side, ustats = _inputs(11)
    wb = 64
    bpm = hp.minibatch_size // wb
    idx = torch.tensor(np.concatenate([rng.permutation(T * W // wb)
                                       for _ in range(2)]), dtype=torch.int32)
    opt = TT.init_adam(params)

    def host_run(ix, count, mats):
        p, m, v = (FU._flat(x).clone() for x in mats)
        cnt = torch.tensor([count], dtype=torch.int32)
        host.mbb_host_update_phase(
            ix.data_ptr(), cnt.data_ptr(), traj.data_ptr(), side.data_ptr(),
            nrm.data_ptr(), ustats.data_ptr(), p.data_ptr(), m.data_ptr(),
            v.data_ptr(), 3, 128, W, wb, bpm, ix.numel() // bpm,
            *_args(hp), float(hp.learning_rate), float(hp.max_grad_norm))
        return tuple(FU._split(x) for x in (p, m, v))

    def plain_run(ix, count, mats):
        return FU.update_phase_plain(hp, ix, count, traj, side, nrm, ustats,
                                     *mats, wb=wb)
    for run in (host_run, plain_run):
        whole = run(idx, 0, (params, opt.mu, opt.nu))
        st = (params, opt.mu, opt.nu)
        for k in range(4):
            st = run(idx[k * bpm:(k + 1) * bpm].clone(), k, st)
        for x, y in zip(whole, st):
            for a, b in zip(x, y):
                assert torch.equal(a, b), run.__name__
    with pytest.raises(ValueError, match="whole minibatches"):
        plain_run(idx[:bpm + 1], 0, (params, opt.mu, opt.nu))


def test_host_phase_reads_the_adam_count_from_memory(host):
    """Kernel D takes its Adam count from device memory (so a CUDA graph
    replays each iteration's count): the host build, given the count 37
    in memory, matches the plain phase at the int count 37 at the tiers
    above, differs from the phase at count 0, and leaves the count as it
    found it."""
    hp = PPOParams(num_envs=W, num_rollout_steps=T, update_epochs=1,
                   num_minibatches=2)
    rng, nrm, params, traj, side, ustats = _inputs(13)
    wb = 64
    idx = torch.tensor(rng.permutation(T * W // wb), dtype=torch.int32)
    mu = tuple(torch.tensor(rng.normal(scale=1e-3, size=x.shape),
                            dtype=torch.float32) for x in params)
    nu = tuple(m * m for m in mu)
    out = {}
    for count in (37, 0):
        p, m, v = (FU._flat(x).clone() for x in (params, mu, nu))
        cnt = torch.tensor([count], dtype=torch.int32)
        host.mbb_host_update_phase(
            idx.data_ptr(), cnt.data_ptr(), traj.data_ptr(), side.data_ptr(),
            nrm.data_ptr(), ustats.data_ptr(), p.data_ptr(), m.data_ptr(),
            v.data_ptr(), 3, 128, W, wb, hp.minibatch_size // wb, 2,
            *_args(hp), float(hp.learning_rate), float(hp.max_grad_norm))
        assert int(cnt[0]) == count
        out[count] = (p, m, v)
    assert not torch.equal(out[37][0], out[0][0])
    *want, rep = FU.update_phase_kinks(hp, idx, 37, traj, side, nrm, ustats,
                                       params, mu, nu, wb=wb)
    assert rep["samples"] <= 1e-3 * rep["of_samples"]
    for name, got, ws, allow in zip(("params", "mu", "nu"), out[37], want,
                                    rep["allow"]):
        for i, (g, w, a) in enumerate(zip(FU._split(got), ws, allow)):
            lim = 1e-4 if name == "params" else 1e-4 * float(w.abs().max())
            assert not bool(((g - w).abs() > lim + a).any()), \
                f"{name}[{i}]: {float((g - w).abs().max())}"


@pytest.mark.parametrize("n", [64, 37])
def test_warp_stages_touch_only_their_own_samples(host, n):
    """Stages 0..15 of one tile (n valid samples) in the host build, run
    by one warp's 32 threads alone, with every float outside its 8 sample
    columns of the activation, scratch and input rows poisoned (NaN, and a
    huge finite value): the warp's columns come out bit for bit as in the
    unpoisoned run of all 256 threads, and the poison is left as it was,
    for each of the 8 warps.  So a warp computes its own samples from its
    own samples, and those stages can end in warp-wide barriers; the
    gradient kernel has 2 CTA-wide barriers a tile (16 warp-wide, 17 with
    the bf16 upcast)."""
    lay = (ctypes.c_int * 8)()
    host.mbb_host_update_layout(lay)
    sm_floats, in_rows, S, SW, cta, warp, warp16, n_stages = lay
    assert (cta, warp, warp16) == (2, 16, 17)
    assert len(FU.STAGES) == n_stages + 1   # the stage probe's names
    assert S == 64 and SW * 8 == S and in_rows == FU.FEAT_COLS + 1
    hp = PPOParams(num_envs=W, num_rollout_steps=T)
    rng, nrm, params, traj, side, ustats = _inputs(15)
    t, w0 = 2, 64
    tile = torch.zeros((in_rows, S))
    tile[:FU.D] = traj[t, :FU.D, w0:w0 + S]
    tile[FU.D + 1:FU.D + 2 + FU.NB] = traj[t, FU.R_ACT:FU.R_LOGP + 1,
                                           w0:w0 + S]
    tile[FU.D + 2 + FU.NB:] = side[t, :3, w0:w0 + S]
    owner = np.zeros(sm_floats, dtype=np.int32)
    host.mbb_host_sample_owner(owner.ctypes.data)
    flat = FU._flat(params)

    def run(keep, fill):
        sm = torch.zeros(sm_floats)
        host.mbb_host_warp_stages(
            flat.data_ptr(), nrm.data_ptr(), ustats.data_ptr(),
            tile.data_ptr(), n, *_args(hp), hp.minibatch_size, keep, fill,
            sm.data_ptr())
        return sm.numpy().view(np.int32)
    base = run(-1, 0.0)
    assert np.isfinite(base.view(np.float32)[owner >= 0]).all()
    for w in range(8):
        own = owner == w
        assert own.sum() > 0
        rest = (owner >= -1) & ~own
        for fill in (float("nan"), -3e38):
            got = run(w, fill)
            assert np.array_equal(got[own], base[own]), (w, fill)
            poison = np.array([fill], dtype=np.float32).view(np.int32)
            assert (got[rest] == poison).all(), (w, fill)

