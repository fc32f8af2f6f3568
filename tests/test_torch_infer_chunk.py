"""The eval chunk (`infer(chunk_size=K)`: K ticks on static buffers, the
stop tested before every tick, one host fetch a chunk; on the card the
chunk is a CUDA graph) equals the per-step loop bit for bit on the CPU,
where the same `EvalChunk.step` runs uncaptured: episode counts, every npz
array and the final rows.  Mirrors tests/test_env.py's
test_chunked_eval_matches_per_step: 3 worlds of
`SimConfig(time_per_period=1.0)`, every episode ending by tick ~62, which
stops a chunk of 8 part-way; with `max_steps` 20, not a multiple of 8, the
last chunk runs the 4-tick tail; deterministic, and stochastic with a
frozen opponent."""

import numpy as np
import pytest
import torch

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.infer import (EvalChunk, generator, infer,
                                                make_policy_fn)
from madrona_basketball_tpu_torch.models.agent import init_agent
from tests import torch_threads  # noqa: F401

CFG = SimConfig(time_per_period=1.0)
W = 3


@pytest.fixture(autouse=True)
def _one_thread():
    """A few worlds a tensor: torch's intra-op threads would only contend
    with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agents():
    return (init_agent(torch.Generator().manual_seed(2), "cpu"),
            init_agent(torch.Generator().manual_seed(5), "cpu"))


def _run(path, chunk_size, stochastic, max_steps, num_episodes=1):
    trainee, frozen = _agents()
    fp = make_policy_fn(frozen, generator(1, "cpu")) if stochastic else None
    env = BasketballEnv(W, CFG, seed=4, frozen_policy=fp,
                        trainee_agent_idx=1, device="cpu")
    counts = infer(env, trainee, str(path), num_episodes, max_steps,
                   stochastic, seed=0, trainee_idx=1,
                   frozen_params=frozen if stochastic else None,
                   chunk_size=chunk_size)
    return counts, dict(np.load(path)), env.engine


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["deterministic", "stochastic_frozen"])
@pytest.mark.parametrize("max_steps", [500, 20], ids=["stop", "tail"])
def test_chunk_matches_per_step(tmp_path, stochastic, max_steps):
    c1, log1, e1 = _run(tmp_path / "k1.npz", 1, stochastic, max_steps)
    c8, log8, e8 = _run(tmp_path / "k8.npz", 8, stochastic, max_steps)
    T = log1["done"].shape[0]
    if max_steps == 500:
        assert (c1 == 1).all() and T % 8 != 0, T   # stopped mid-chunk
    else:
        assert T == 20 and (c1 == 0).all()          # the 4-tick tail ran
    np.testing.assert_array_equal(c1, c8)
    assert sorted(log1) == sorted(log8)
    for k in log1:
        assert log1[k].dtype == log8[k].dtype, k
        np.testing.assert_array_equal(log1[k], log8[k], err_msg=k)
    for name in ("sf", "si", "obs"):
        assert torch.equal(getattr(e1, name), getattr(e8, name)), name


def test_default_chunk_and_no_log(tmp_path):
    """chunk_size 0 is the chunk of 32 (62 ticks: a whole chunk, then a
    stop part-way); without a log path the chunk keeps no log buffers and
    the counts and rows are the same."""
    c1, log1, e1 = _run(tmp_path / "k1.npz", 1, False, 500)
    c0, log0, e0 = _run(tmp_path / "k0.npz", 0, False, 500)
    np.testing.assert_array_equal(c1, c0)
    for k in log1:
        np.testing.assert_array_equal(log1[k], log0[k], err_msg=k)
    trainee, _ = _agents()
    env = BasketballEnv(W, CFG, seed=4, trainee_agent_idx=1, device="cpu")
    counts = infer(env, trainee, None, 1, 500, False, seed=0, trainee_idx=1)
    np.testing.assert_array_equal(counts, c1)
    assert torch.equal(env.engine.sf, e1.sf)


def test_masked_ticks_change_nothing():
    """budget 0: every tick is masked, so rows, counts, t_used and the log
    stay as they were (what the capture's warm-up relies on)."""
    trainee, _ = _agents()
    env = BasketballEnv(W, CFG, seed=4, trainee_agent_idx=1, device="cpu")
    env.reset()
    chunk = EvalChunk(CFG, env.engine, make_policy_fn(trainee, None, False),
                      None, 1, 4, 1, True)
    before = [t.clone() for t in (chunk.sf, chunk.si, chunk.obs,
                                  chunk.counts)]
    chunk.run(0)
    after = (chunk.sf, chunk.si, chunk.obs, chunk.counts)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(chunk.t_used) == 0
    assert all(not buf.any() for buf in chunk.logs.values())
    chunk.run(3)
    assert int(chunk.t_used) == 3 and not torch.equal(chunk.sf, before[0])
    assert chunk.logs["game_state"][2].any()
    assert not chunk.logs["game_state"][3].any()


def test_chunk_refusals():
    trainee, frozen = _agents()
    env = BasketballEnv(W, CFG, seed=4, trainee_agent_idx=1, device="cpu",
                        frozen_policy=make_policy_fn(frozen, None, False))
    with pytest.raises(ValueError, match="frozen_params"):
        infer(env, trainee, None, 1, 5, chunk_size=8)
    env = BasketballEnv(W, CFG, seed=4, trainee_agent_idx=1, device="cpu")
    with pytest.raises(ValueError, match="per-step"):
        infer(env, trainee, None, 1, 5, chunk_size=8,
              gumbel=iter([torch.zeros(W, 19)] * 8))


def test_policy_acts_as_forward():
    """The eval policy's `act` gives `forward`'s actions bit for bit, with
    and without Gumbel noise."""
    from madrona_basketball_tpu_torch.models.agent import act, forward
    trainee, _ = _agents()
    g = torch.Generator().manual_seed(3)
    obs = torch.randn((64, 128), generator=g) * 3
    gumbel = -torch.log(-torch.log(torch.rand((64, 19), generator=g)))
    for noise in (None, gumbel):
        assert torch.equal(act(trainee, obs, noise),
                           forward(trainee, obs, noise)[0])
