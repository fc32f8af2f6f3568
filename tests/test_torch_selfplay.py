"""The port's self-play league against the JAX package's
(`selfplay.py:33-160`).  With `train_generation` (and `save_agent`)
stubbed, both `run_league`s make the same sequence of sessions (model
name, trainee index, which agent is frozen, iterations, save_every) and
save the same initial checkpoints up to the suffix.  The port's
`train_generation` at 32 worlds x 4 ticks equals the frozen-opponent
`train_iteration` chained (whole chunks, then the tail), leaves its
trainee as it was, and saves under `checkpoints/{name}_gen_{g}/`."""

import copy
import os

import pytest
import torch

import madrona_basketball_tpu.selfplay as jselfplay

import madrona_basketball_tpu_torch.selfplay as selfplay
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.models.agent import init_agent
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    init_train_state, make_train_iteration, state_tensors)
from madrona_basketball_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_infer_chunk import _one_thread  # noqa: F401


def _record(module, monkeypatch):
    """Stub `train_generation` and `save_agent` in a league module; return
    the list the sessions and initial saves land in."""
    labels, calls = {}, []

    def save(agent, path):
        labels[id(agent)] = os.path.splitext(os.path.basename(path))[0]
        calls.append(("save", labels[id(agent)]))
        return path

    def train(cfg, hp, _seed_or_net, *args, **kw):
        if module is jselfplay:
            args = args[1:]          # the JAX signature: net, key
        trainee, frozen, iters, name, save_every = args[:5]
        calls.append(("train", name, hp.trainee_idx, hp.use_frozen,
                      labels[id(trainee)], labels[id(frozen)], iters,
                      save_every, hp.num_envs))
        out = object()
        labels[id(out)] = name
        return out

    monkeypatch.setattr(module, "save_agent", save)
    monkeypatch.setattr(module, "train_generation", train)
    return calls


@pytest.mark.parametrize("first", [1, 0])
def test_league_schedule_matches_jax(tmp_path, monkeypatch, first):
    monkeypatch.chdir(tmp_path)
    kw = dict(num_training_cycles=3, iter_per_agent=25, num_envs=64,
              first_trainee_idx=first, model_name_0="A", model_name_1="B")
    want = _record(jselfplay, monkeypatch)
    jselfplay.run_league(**kw)
    got = _record(selfplay, monkeypatch)
    selfplay.run_league(**kw, device="cpu")
    assert got == want
    assert got[:2] == [("save", "model_0_initial"),
                       ("save", "model_1_initial")]
    assert len(got) == 2 + 3 * 2 and got[2][7] == 2


def test_league_seeds_are_distinct():
    seeds = {selfplay.league_seed(s, g, p) for s in range(3)
             for g in range(-1, 6) for p in (0, 1)}
    assert len(seeds) == 3 * 7 * 2


def test_train_generation_is_the_chained_iteration(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = SimConfig()
    hp = PPOParams(num_envs=32, num_rollout_steps=4, trainee_idx=1,
                   use_frozen=True)
    trainee = init_agent(torch.Generator().manual_seed(1), "cpu")
    frozen = init_agent(torch.Generator().manual_seed(2), "cpu")
    before = ckpt.state_dict(trainee)
    # log and save every 2: a chunk of 2, then one iteration
    out = selfplay.train_generation(cfg, hp, 7, trainee, frozen, 3,
                                    "m_gen_0", save_every=2, log_every=2,
                                    device="cpu")
    after = ckpt.state_dict(trainee)
    assert all(torch.equal(before[k], after[k]) for k in before)

    it = make_train_iteration(cfg, hp, "cpu")
    state = init_train_state(cfg, hp, 7, "cpu", agent=copy.deepcopy(trainee),
                             frozen=frozen)
    for i in range(3):
        state, _ = it(state)
        if i == 1:
            at_2 = ckpt.state_dict(state.agent)
    want, got = ckpt.state_dict(state.agent), ckpt.state_dict(out)
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert sorted(os.listdir("checkpoints")) == ["m_gen_0"]
    assert os.listdir("checkpoints/m_gen_0") == ["m_gen_0_2.pth"]
    saved = torch.load("checkpoints/m_gen_0/m_gen_0_2.pth",
                       weights_only=True)
    assert all(torch.equal(saved[k], at_2[k]) for k in at_2)
    assert len(state_tensors(state)) == 53
