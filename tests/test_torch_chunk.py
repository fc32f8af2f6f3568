"""Chunked dispatch (`ppo/train.py::make_train_chunk`, the JAX package's
`make_train_chunk` / `unstack_metrics` / `auto_chunk`, train.py:466-502)
and the iteration's static-buffer form it captures on the card.

On the CPU a chunk is a loop over `train_iteration`; the static form
(`train_iteration.static`, which a CUDA graph captures there) runs here
without a capture.  Both must equal the eager iterations bit for bit, on
the flagship iteration and the tiled one, at a small size.  The per-
iteration generators are reseeded, and give a fresh generator's draws of
the (seed, counter) seed; kernels B, I and D take tick_base and the Adam
count as an int or as a 0-d int32 tensor (which the kernels read from
device memory) with the same results.  Without a card a chunk of a CUDA
state raises."""

import copy
import dataclasses
import types

import pytest
import torch

from madrona_basketball_tpu.ppo import train as jtrain

from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo import train as TT
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    METRICS, init_train_state, make_train_iteration, perm_seed, pulse_seed,
    state_tensors)
from tests import torch_threads  # noqa: F401

N = 3
# (worlds, ticks): the tiled rollout needs a multiple of 1024 worlds
SIZES = {False: (64, 4), True: (1024, 2)}


def _setup(tiled, use_frozen=False):
    W, T = SIZES[tiled]
    hp = PPOParams(num_envs=W, num_rollout_steps=T, use_frozen=use_frozen)
    it = make_train_iteration(SimConfig(), hp, "cpu", rollout_tiled=tiled)
    state = init_train_state(SimConfig(), hp, seed=11, device="cpu")
    return hp, it, state


def _eager(it, state, n):
    state = copy.deepcopy(state)
    metrics = []
    for _ in range(n):
        state, out = it(state)
        metrics.append(out["metrics"])
    return state, metrics


def _assert_same_state(a, b):
    assert len(state_tensors(a)) == len(state_tensors(b)) == 53
    for i, (x, y) in enumerate(zip(state_tensors(a), state_tensors(b))):
        assert torch.equal(x, y), i
    assert (a.counter, a.opt.count, a.iteration) == \
        (b.counter, b.opt.count, b.iteration)


@pytest.mark.parametrize("tiled", [False, True])
def test_chunk_equals_eager_iterations(tiled):
    hp, it, state = _setup(tiled, use_frozen=not tiled)
    want, metrics = _eager(it, state, N)
    got, stacked = TT.make_train_chunk(it, N)(copy.deepcopy(state))
    _assert_same_state(got, want)
    assert got.opt.count == N * hp.update_epochs * hp.num_minibatches
    assert set(stacked) == set(METRICS)
    for k, v in stacked.items():
        assert v.shape == (N,), k
    for i, m in enumerate(TT.unstack_metrics(stacked, N)):
        assert set(m) == set(metrics[i])
        for k in m:
            assert m[k].shape == () and torch.equal(m[k], metrics[i][k]), k


@pytest.mark.parametrize("tiled", [False, True])
def test_static_form_equals_eager_iterations(tiled):
    """What the card captures, run here without a capture: N (reseed,
    step) from the loaded buffers, then `result`."""
    _, it, state = _setup(tiled)
    state, _ = it(state)    # a non-zero counter and Adam count
    want, metrics = _eager(it, state, N)
    start = copy.deepcopy(state)
    static = it.static(start)
    rows = []
    for i in range(N):
        static.reseed(start.seed, start.counter + i)
        static.step()
        rows.append(static.metrics.clone())
    assert int(static.counter) == want.counter
    assert int(static.count) == want.opt.count
    got = static.result(start, N)
    assert got.agent.net is start.agent.net     # updated in place
    _assert_same_state(got, want)
    for i, m in enumerate(metrics):
        assert torch.equal(rows[i], torch.stack([m[k] for k in METRICS]))
    with pytest.raises(ValueError, match="seed"):
        static.load(dataclasses.replace(start, seed=12))


def test_auto_chunk_matches_the_jax_package():
    for log in (1, 2, 3, 7, 10, 40, 60, 100, 150, 1000):
        for save in (1, 4, 25, 50, 99, 100, 300, 500):
            for cap in (50, 8):
                assert TT.auto_chunk(log, save, cap) == \
                    jtrain.auto_chunk(log, save, cap), (log, save, cap)
    assert TT.auto_chunk(100, 100) == 50
    assert TT.auto_chunk(0, 0) == jtrain.auto_chunk(0, 0) == 1


def test_reseeded_generators_give_a_fresh_generators_draws():
    _, it, state = _setup(False)
    pulse, perm = it.static(state).generators
    for seed, counter in ((11, 0), (11, 5), (2 ** 40 + 3, 977)):
        assert pulse_seed(seed, counter) == \
            (seed * 1_000_003 + counter) % (2 ** 63)
        assert perm_seed(seed, counter) == \
            ((seed * 1_000_003 + counter) * 1_000_033 + 7) % (2 ** 63)
        for _ in range(2):      # a second reseed resets the stream
            it.static(state).reseed(seed, counter)
            got = (draw_noise_rows(64, pulse, "cpu"),
                   torch.rand((FR.N_LOGITS, 64), generator=pulse),
                   torch.randperm(16, generator=perm),
                   torch.randperm(16, generator=perm))
        fresh = torch.Generator().manual_seed(pulse_seed(seed, counter))
        fresh_p = torch.Generator().manual_seed(perm_seed(seed, counter))
        want = (draw_noise_rows(64, fresh, "cpu"),
                torch.rand((FR.N_LOGITS, 64), generator=fresh),
                torch.randperm(16, generator=fresh_p),
                torch.randperm(16, generator=fresh_p))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_kernel_scalars_take_ints_or_device_scalars():
    cfg = SimConfig()
    W, T = 32, 2
    hp = PPOParams(num_envs=W, num_rollout_steps=T, num_minibatches=2,
                   update_epochs=1)
    state = init_train_state(cfg, hp, seed=4, device="cpu")
    mats = FR.pack_policy(state.agent)
    for fn in (FR.fused_rollout,):
        a = fn(cfg, state.sf, state.si, state.obs, mats, n_steps=T,
               trainee_idx=1, seed=9, tick_base=5)
        b = fn(cfg, state.sf, state.si, state.obs, mats, n_steps=T,
               trainee_idx=1, seed=9,
               tick_base=torch.tensor(5, dtype=torch.int32))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    traj = FR.fused_rollout(cfg, state.sf, state.si, state.obs, mats,
                            n_steps=T, trainee_idx=1, seed=9)[3]
    side = torch.randn((T, 8, W), generator=torch.Generator().manual_seed(1))
    idx = torch.randperm(T * W // 16).to(torch.int32)
    args = (traj, side, FU.pack_norm(state.agent.obs_rms), None,
            FU.pack_weights(state.agent.net), state.opt.mu, state.opt.nu)
    a = FU.fused_update_phase(hp, idx, 7, *args, wb=16)
    b = FU.fused_update_phase(hp, idx, torch.tensor(7, dtype=torch.int32),
                              *args, wb=16)
    c = FU.fused_update_phase(hp, idx, 0, *args, wb=16)
    for x, y, z in zip(a, b, c):
        for u, v, w in zip(x, y, z):
            assert torch.equal(u, v)
    assert not torch.equal(a[0][0], c[0][0])   # the count is read
    cpu = torch.device("cpu")
    s = _build.device_int(5, cpu)
    assert s.shape == () and s.dtype == torch.int32 and int(s) == 5
    assert _build.device_int(s, cpu) is s
    for bad in (torch.tensor(5), torch.tensor([5], dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32"):
            _build.device_int(bad, cpu)


def test_a_cuda_chunk_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, it, _ = _setup(False)
    cuda_state = types.SimpleNamespace(
        sf=types.SimpleNamespace(device=torch.device("cuda")))
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.make_train_chunk(it, N)(cuda_state)
    with pytest.raises(ValueError, match="n_iters"):
        TT.make_train_chunk(it, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(SimConfig(), PPOParams(num_envs=32), seed=0,
                         device="cuda")
