"""A run with the timed path broken underneath comes out not correct; a
sound one comes out correct, and so does no control: on the CPU at sizes
a test run holds.  Each run skips only the harness's look for a card.

Training runs at 256 worlds x 8 ticks (a minibatch holds two update
blocks, so half of one can be left out); evaluation at 64 worlds and
4-tick chunks, its control at 256 worlds and 32-tick chunks (where TF32
flips enough sampled actions to show); stepping at 8 worlds and 16-tick
launches (one altered world is 12.5 % of them, over the 8 % limit; at
8192 it is 0.0122 %, inside what sound launches part), its control at
64."""

import json
import time

import pytest

from benchmark import control
from benchmark import run as B
from madrona_basketball_tpu_torch import infer
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS

SEED = 2 ** 31 + 4242
SIZES = {"tag_ppo.train": dict(num_envs=256, num_rollout_steps=8),
         "tag_selfplay.train": dict(num_envs=256, num_rollout_steps=8),
         "tag_selfplay.eval": dict(num_envs=64),
         "tag_ppo.step": dict(num_envs=8)}
SMALL = {"tag_selfplay.eval": dict(chunk_ticks=4),
         "tag_ppo.step": dict(ticks_per_launch=16)}


def plan(cell: str, **traffic) -> dict:
    p = B.cell_plan(json.loads((B.ROOT / "BENCHMARK.json").read_text()),
                    cell)
    p["config"]["ppo"].update(SIZES[cell])
    p["config"].update(log_every=2, save_every=2)
    p["traffic"].update(traffic)
    return p


def run_small(cell: str) -> dict:
    return B.run_cell(plan(cell, **SMALL.get(cell, {})), SEED, 0.5, False,
                      "cpu", time.perf_counter())


# ---- faults of the training step (kernel D's and B's wrappers) ----

def update_unchanged(orig):
    """The update returns the weights and Adam's moments it was given."""
    def f(hp, idx, count, traj, side, nrm, ustats, params, mu, nu, **kw):
        return tuple(params), tuple(mu), tuple(nu)
    return f


def action_altered_in_rollout(orig):
    """World 0's sampled move of the trainee changed where the rollout
    produces it."""
    def f(*args, **kw):
        sf, si, obs, traj, om = orig(*args, **kw)
        row = ACTION_ROWS[kw["trainee_idx"]][0]
        si = si.clone()
        si[row, 0] = 1 - si[row, 0].clamp(max=1)
        traj = traj.clone()
        traj[-1, FR.R_ACT, 0] = si[row, 0].float()
        return sf, si, obs, traj, om
    return f


# ---- faults of the eval tick (kernel A's wrapper, the policy) ----

def tick_unchanged(orig):
    """The tick returns the rows it was given."""
    def f(cfg, sf, si, noise):
        return sf.clone(), si.clone(), orig(cfg, sf, si, noise)[2]
    return f


def half_the_worlds(orig):
    """The tick steps the first half of the worlds; the rest keep their
    rows."""
    def f(cfg, sf, si, noise):
        sf2, si2, obs2 = orig(cfg, sf, si, noise)
        h = sf.shape[1] // 2
        sf2[:, h:], si2[:, h:] = sf[:, h:], si[:, h:]
        return sf2, si2, obs2
    return f


def action_altered_in_policy(orig):
    """World 0's first sampled action changed where the policy produces
    it."""
    def f(agent, obs, gumbel=None):
        a = orig(agent, obs, gumbel).clone()
        a[0, 0] = 1 - a[0, 0].clamp(max=1)
        return a
    return f


# ---- faults of the stepping launch (kernel F's wrapper) ----

def launch_unchanged(orig):
    """The launch returns the rows it was given."""
    def f(cfg, sf, si, n_steps, **kw):
        return sf.clone(), si.clone(), orig(cfg, sf, si, n_steps, **kw)[2]
    return f


def half_the_worlds_stepped(orig):
    """The launch steps the first half of the worlds; the rest keep their
    rows."""
    def f(cfg, sf, si, n_steps, **kw):
        sf2, si2, obs = orig(cfg, sf, si, n_steps, **kw)
        h = sf.shape[1] // 2
        sf2[:, h:], si2[:, h:] = sf[:, h:], si[:, h:]
        return sf2, si2, obs
    return f


def answer_altered(orig):
    """World 0's first float row changed where the launch produces it."""
    def f(cfg, sf, si, n_steps, **kw):
        sf2, si2, obs = orig(cfg, sf, si, n_steps, **kw)
        sf2[0, 0] += 1.0
        return sf2, si2, obs
    return f


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("cell, module, name, fault", [
    ("tag_ppo.train", FU, "fused_update_phase", update_unchanged),
    ("tag_ppo.train", FU, "fused_update_phase", control.half_batch),
    ("tag_ppo.train", FR, "fused_rollout", action_altered_in_rollout),
    ("tag_selfplay.eval", infer, "fused_step", tick_unchanged),
    ("tag_selfplay.eval", infer, "fused_step", half_the_worlds),
    ("tag_selfplay.eval", infer, "act", action_altered_in_policy),
    ("tag_ppo.step", FS, "fused_multistep", launch_unchanged),
    ("tag_ppo.step", FS, "fused_multistep", half_the_worlds_stepped),
    ("tag_ppo.step", FS, "fused_multistep", answer_altered),
], ids=["train_state_unchanged", "train_half_batch", "train_action_altered",
        "eval_state_unchanged", "eval_half_the_worlds",
        "eval_action_altered", "step_state_unchanged",
        "step_half_the_worlds", "step_answer_altered"])
def test_fault_is_not_correct(monkeypatch, cell, module, name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    out = run_small(cell)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell, sizes, traffic", [
    ("tag_selfplay.train", dict(num_envs=256, num_rollout_steps=8), {}),
    ("tag_selfplay.eval", dict(num_envs=256), dict(chunk_ticks=32)),
    ("tag_ppo.step", dict(num_envs=64), dict(ticks_per_launch=16)),
])
def test_control_is_not_correct(cell, sizes, traffic):
    """The reference in the driver's control precision (TF32 products, a
    bfloat16 sim state), put in the program's place, fails a limit."""
    p = plan(cell, **traffic)
    p["config"]["ppo"].update(sizes)
    driver = B.load_module(B.HERE / "drivers" /
                           f"{p['traffic']['driver']}.py", "driver_t")
    run = driver.Run(p["config"], p["traffic"], SEED, "cpu")
    numbers = run.check(run.reference_steps(driver.CONTROL))
    limits = p["traffic"]["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
