"""Kernel J (ops/eval_policy.py, csrc/eval_policy.cu): the eval policies'
forward and Gumbel-max sampling.

On the CPU: J's plain version against `models.agent.act` on shared
uniforms (logits within 1e-5 of each row's scale, actions equal wherever
a bucket's two best perturbed logits lie more than 1e-4 apart), the
argmax and the Gumbel seam, the wrapper's refusals (CPU tensors among
them), `infer.run_policies`' writes into the eval chunk's strided action
rows, `infer.Policy` on CPU tensors returning what `act` returns, bit
for bit, and refusing off the CPU an agent the kernel cannot run.  On the card (marked `card`,
skipped without one): J against its plain version at 10, 300 and 8192
worlds, one agent and both; the per-step loop and the 32-tick chunk
equal bit for bit; the captured chunk holding K launches of J and at
most 20 kernel nodes a tick."""

import math

import numpy as np
import pytest
import torch

from madrona_basketball_tpu_torch import constants as C
from madrona_basketball_tpu_torch import infer as IF
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.models.agent import _actor, act, init_agent
from madrona_basketball_tpu_torch.ops import eval_policy as EP
from madrona_basketball_tpu_torch.ops.fused_rollout import gumbel_from_uniform
from tests import torch_threads  # noqa: F401

NL = sum(C.ACTION_BUCKETS)
NA = len(C.ACTION_BUCKETS)


def _agent(seed, device="cpu"):
    """An agent from the seed with a fitted-looking obs normalizer and an
    actor head at the backbone's scale (logits of order 1, as a trained
    checkpoint's)."""
    g = torch.Generator().manual_seed(seed)
    ap = init_agent(g, "cpu")
    with torch.no_grad():
        ap.obs_rms.mean.copy_(torch.randn(C.OBS_SIZE, generator=g))
        ap.obs_rms.var.copy_(torch.rand(C.OBS_SIZE, generator=g) * 4 + 0.05)
        w = ap.net.actor.weight
        w.copy_(torch.randn(w.shape, generator=g) *
                math.sqrt(2.0 / 3.0 / w.shape[1]))
        ap.net.actor.bias.copy_(torch.randn(NL, generator=g) * 0.1)
    if device != "cpu":
        ap.net.to(device)
        for r in (ap.obs_rms, ap.value_rms):
            r.mean, r.var, r.count = (t.to(device) for t in
                                      (r.mean, r.var, r.count))
    return ap


def _obs(W, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((W, C.OBS_SIZE), generator=g) * 2).to(device)


def _uniforms(W, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((W, NL), generator=g).to(device)


def _clear(noisy, margin=1e-4):
    """(W, 6) bool: the bucket's best value leads its second by more than
    `margin` (a single-value bucket never; every bucket has two)."""
    out, off = [], 0
    for n in C.ACTION_BUCKETS:
        top = noisy[:, off:off + n].topk(2, dim=-1).values
        out.append(top[:, 0] - top[:, 1] > margin)
        off += n
    return torch.stack(out, dim=1)


def _agree(got, want, noisy):
    """Actions equal wherever the bucket is clear; returns the clear
    share."""
    clear = _clear(noisy)
    assert torch.equal(got[clear], want[clear])
    return float(clear.float().mean())


@pytest.mark.parametrize("W", [64, 300], ids=["one_tile", "ragged"])
def test_plain_matches_act(W):
    ap = _agent(1)
    obs, u = _obs(W, 2), _uniforms(W, 3)
    want = _actor(ap, obs)[0].detach()
    got = EP.policy_logits_plain(ap, obs)
    scale = want.abs().amax(dim=1, keepdim=True)
    assert float(((got - want).abs() / scale).max()) < 1e-5
    noisy = want + gumbel_from_uniform(u)
    assert _agree(EP.policy_plain(ap, obs, u),
                  act(ap, obs, gumbel_from_uniform(u)), noisy) > 0.99


def test_argmax_and_gumbel_seam():
    ap = _agent(4)
    obs = _obs(300, 5)
    logits = _actor(ap, obs)[0].detach()
    _agree(EP.policy_plain(ap, obs), act(ap, obs), logits)
    g = gumbel_from_uniform(_uniforms(300, 6)) * 1.5
    _agree(EP.policy_plain(ap, obs, g, gumbel=True), act(ap, obs, g),
           logits + g)
    # the seam adds the values as given, the uniforms their Gumbel noise
    u = _uniforms(300, 7)
    assert torch.equal(EP.policy_plain(ap, obs, u),
                       EP.policy_plain(ap, obs, gumbel_from_uniform(u),
                                       gumbel=True))


def _job(ap, W, **kw):
    base = dict(agent=ap, obs=_obs(W, 8), noise=_uniforms(W, 9),
                gumbel=False, act=torch.empty((W, NA), dtype=torch.int32))
    base.update(kw)
    return EP.PolicyJob(**base)


@pytest.mark.parametrize("bad", [
    dict(obs=torch.zeros((16, C.OBS_SIZE), dtype=torch.float64)),
    dict(obs=torch.zeros((16, C.OBS_SIZE - 1))),
    dict(obs=torch.zeros((15, C.OBS_SIZE))),
    dict(noise=torch.zeros((16, NL - 1))),
    dict(act=torch.empty((16, NA), dtype=torch.int64)),
    dict(act=torch.empty((16, NA), dtype=torch.int32, device="meta")),
], ids=["obs_dtype", "obs_width", "obs_worlds", "noise_shape", "act_dtype",
        "act_device"])
def test_wrapper_refusals(bad):
    ap = _agent(10)
    with pytest.raises(ValueError):
        EP.eval_policy([_job(ap, 16, **bad)])


def test_wrapper_refuses_job_counts_and_devices():
    ap = _agent(11)
    with pytest.raises(ValueError, match="1 or 2"):
        EP.eval_policy([_job(ap, 16)] * 3)
    with pytest.raises(ValueError, match="1 or 2"):
        EP.eval_policy([])
    with pytest.raises(ValueError, match="unsupported device"):
        EP.eval_policy([_job(ap, 16)])      # the CPU's policy is `act`
    meta = _agent(12, "meta")
    job = _job(meta, 16, obs=torch.empty((16, C.OBS_SIZE), device="meta"),
               noise=None, act=torch.empty((16, NA), dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        EP.eval_policy([job])
    with pytest.raises(ValueError, match="weight"):
        EP.eval_policy([_job(meta, 16)])     # weights on meta, obs on cpu
    deep = _agent(13)
    deep.net.backbone.extend(deep.net.backbone[3:6])
    with pytest.raises(ValueError, match="2 hidden layers"):
        EP.eval_policy([_job(deep, 16)])


def test_wrapper_writes_the_chunks_action_rows():
    """`infer.run_policies` on CPU tensors: two jobs into the agents' (W, 6)
    views of a (rows, W) int32 block, from the feature-major obs rows:
    each `act`'s actions, the other rows untouched."""
    W = 100
    agents = (_agent(14), _agent(15))
    obs_rows = _obs(2 * C.OBS_SIZE, 16)[:, :W].contiguous()
    si = torch.full((20, W), -7, dtype=torch.int32)
    jobs = []
    for a, (ap, lo) in enumerate(zip(agents, (2, 11))):
        obs = obs_rows[a * C.OBS_SIZE:(a + 1) * C.OBS_SIZE].T
        jobs.append(EP.PolicyJob(ap, obs, _uniforms(W, 17 + a) if a else None,
                                 False, si[lo:lo + NA].T))
    IF.run_policies(jobs)
    for (ap, obs, noise, _, _), lo in zip(jobs, (2, 11)):
        g = None if noise is None else gumbel_from_uniform(noise)
        assert torch.equal(si[lo:lo + NA].T, act(ap, obs, g))
    rest = torch.ones(20, dtype=torch.bool)
    rest[2:8] = rest[11:17] = False
    assert (si[rest] == -7).all()


@pytest.mark.parametrize("mode", ["stochastic", "deterministic", "seam"])
def test_policy_on_cpu_is_act(mode):
    """`infer.Policy` on CPU tensors draws and computes what it did before
    kernel J: `act` on gumbel_from_uniform of one (B, 19) draw a call."""
    ap, W = _agent(18), 40
    obs = _obs(W, 19)
    gs = [gumbel_from_uniform(_uniforms(W, 20 + i)) for i in range(2)]
    pol = IF.make_policy_fn(ap, IF.generator(3, "cpu"),
                            mode != "deterministic",
                            iter(gs) if mode == "seam" else None)
    twin = IF.generator(3, "cpu")
    for i in range(2):
        got = pol(obs)
        if mode == "stochastic":
            g = gumbel_from_uniform(torch.rand((W, NL), generator=twin))
        else:
            g = gs[i] if mode == "seam" else None
        assert got.dtype == torch.int32
        assert torch.equal(got, act(ap, obs, g))


def test_policy_refuses_what_the_kernel_cannot_run():
    """An agent of another depth builds a `Policy` on the CPU (`act` runs
    it) and is refused off it, where kernel J would run it."""
    deep = _agent(22)
    deep.net.backbone.extend(deep.net.backbone[3:6])
    obs = _obs(16, 23)
    pol = IF.make_policy_fn(deep, None, False)
    assert torch.equal(pol(obs), act(deep, obs))
    deep.net.to("meta")
    for r in (deep.obs_rms, deep.value_rms):
        r.mean, r.var, r.count = (t.to("meta") for t in
                                  (r.mean, r.var, r.count))
    with pytest.raises(ValueError, match="2 hidden layers"):
        IF.make_policy_fn(deep, None, False)
    IF.make_policy_fn(_agent(24, "meta"), None, False)   # the kernel's agent


# ---------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
@pytest.mark.parametrize("W", [10, 300, 8192])
def test_kernel_matches_plain(card, W):
    agents = [_agent(30 + a, card) for a in range(2)]
    rows = (torch.randn((2 * C.OBS_SIZE, W), generator=torch.Generator()
                        .manual_seed(W)) * 2).to(card)   # the chunk's obs
    obs = [rows[a * C.OBS_SIZE:(a + 1) * C.OBS_SIZE].T for a in range(2)]
    u = [_uniforms(W, 32 + a, card) for a in range(2)]
    g = gumbel_from_uniform(_uniforms(W, 34, card))
    si = torch.zeros((2 * NA, W), dtype=torch.int32, device=card)
    cases = {"uniforms": (u, False), "seam": ([g, g], True),
             "argmax": ([None, None], False)}
    for name, (noise, gumbel) in cases.items():
        both = [EP.PolicyJob(agents[a], obs[a], noise[a], gumbel,
                             si[a * NA:(a + 1) * NA].T) for a in range(2)]
        n0 = EP.launches
        EP.eval_policy(both)
        one = [IF.Policy(agents[a], None, noise[a] is not None,
                         iter([noise[a]]) if gumbel else None)
               for a in range(2)]
        for a in range(2):
            want = EP.policy_plain(agents[a], obs[a], noise[a], gumbel)
            logits = EP.policy_logits_plain(agents[a], obs[a])
            noisy = logits if noise[a] is None else logits + (
                noise[a] if gumbel else gumbel_from_uniform(noise[a]))
            got = si[a * NA:(a + 1) * NA].T
            assert _agree(got, want, noisy) > 0.99, (name, a)
            if name != "uniforms":   # one agent alone: the same launch code
                assert torch.equal(one[a](obs[a].contiguous()), got), name
        assert EP.launches - n0 == (1 if name == "uniforms" else 3)


def _infer_run(dev, chunk_size, W=256, max_steps=200):
    cfg = SimConfig(time_per_period=1.0)
    trainee, frozen = _agent(40, dev), _agent(41, dev)
    fp = IF.make_policy_fn(frozen, IF.generator(1, dev))
    env = BasketballEnv(W, cfg, seed=4, frozen_policy=fp,
                        trainee_agent_idx=1, device=dev)
    n0 = EP.launches
    counts = IF.infer(env, trainee, None, 1, max_steps, True, seed=0,
                      trainee_idx=1, frozen_params=frozen,
                      chunk_size=chunk_size)
    return counts, env.engine, EP.launches - n0


@pytest.mark.card
def test_per_step_and_chunk_equal_with_the_kernel(card, monkeypatch):
    def torch_path(*a, **kw):
        raise AssertionError("a CUDA tensor took the torch path")
    monkeypatch.setattr(IF, "act", torch_path)
    c1, e1, n1 = _infer_run(card, 1)
    c32, e32, n32 = _infer_run(card, 32)
    # the reset's step runs the frozen policy; then per step one launch an
    # agent a tick, chunked one for the capture's warm-up tick and one for
    # each of the K captured ticks, none at replay
    assert n1 > 1 and n1 % 2 == 1 and n32 == 1 + 1 + 32
    np.testing.assert_array_equal(c1, c32)
    for name in ("sf", "si", "obs"):
        assert torch.equal(getattr(e1, name), getattr(e32, name)), name


@pytest.mark.card
def test_captured_chunk_holds_k_launches(card):
    K = 32
    trainee, frozen = _agent(42, card), _agent(43, card)
    env = BasketballEnv(8192, SimConfig(), seed=5, trainee_agent_idx=1,
                        device=card)
    env.reset()
    chunk = IF.make_eval_chunk(
        env, IF.make_policy_fn(trainee, IF.generator(0, card)),
        IF.make_policy_fn(frozen, IF.generator(1, card)), K, 0, False)
    assert chunk.policy_launches == K
    assert chunk.kernel_nodes is not None and chunk.kernel_nodes / K <= 20
    n0 = EP.launches
    chunk.run(K)
    assert int(chunk.t_used) == K and EP.launches == n0   # a replay
