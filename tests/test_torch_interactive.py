"""The interactive path of the port on the CPU: the human override's
order, the pause, and `InteractiveTrainer` (ppo/train_interactive.py),
with a scripted viewer object in place of the pygame one (the surface of
tests/test_interactive.py's FakeViewer).

The three cases of tests/test_interactive.py on the port - the human
action survives the trainee's bulk write (against kernel A's plain
version on the same rows and noise, exactly), the pause freezes the sim
and zeroes world 0's action but ticks the viewer, and the trainer asks
the controller manager once a tick - and one iteration against the JAX
`InteractiveTrainer` at 32 worlds x 8 ticks, 2 epochs x 2 minibatches,
with the human override on world 0's trainee: the same initial rows (the
JAX spawn draws), the JAX env's sim noise (`make_noise_fn` on its keys),
the Gumbel draws and update permutations of the JAX trainer's key splits,
all injected through the seams.  The rollout buffer must agree at atol
3e-4 / rtol 1e-3 (the JAX env steps the structured engine, which
differs from the rows by float reassociation,
tests/test_torch_engine_env.py), its actions exactly; the params after
the iteration within PARAMS_ATOL = 1e-5, the whole-phase tier of
tests/test_torch_update_fns.py (here the buffers' obs differ by up to
4.6e-6 and the params by 8.7e-7), the Adam count exactly, the metrics at
the buffer's tier."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.engine_fused import make_noise_fn
from madrona_basketball_tpu.models.agent import init_agent as jinit
from madrona_basketball_tpu.ops import fused_update as JFU
from madrona_basketball_tpu.ppo.hparams import PPOParams as JPPOParams
from madrona_basketball_tpu.ppo.train_interactive import (
    InteractiveTrainer as JInteractiveTrainer)

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS, I_IDX
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_interactive import (
    InteractiveTrainer)
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy
from tests.test_torch_infer_chunk import _one_thread  # noqa: F401
from tests.test_torch_init import _jax_reset_u

CFG = SimConfig()
PARAMS_ATOL = 1e-5


class FakeViewer:
    """Just enough surface for the env and the trainer."""

    def __init__(self, human_action=(1, 3, 0, 0, 0, 0), selected=0):
        self.training_paused = False
        self.controller_manager = None
        self._human_action = np.asarray(human_action, np.int32)
        self._selected = selected
        self.ticks = 0
        self.human_action_calls = 0

    def set_controller_manager(self, mgr):
        self.controller_manager = mgr

    def set_training_paused(self, paused):
        self.training_paused = paused

    def get_selected_agent_index(self):
        return self._selected

    def get_human_action(self):
        self.human_action_calls += 1
        return self._human_action

    def tick(self):
        self.ticks += 1


def _noise(W, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((9, W), generator=g)
    return torch.cat([2 * u[:8] - 1, u[8:]])


def test_step_with_world_actions_override_order():
    """The human action survives the trainee's bulk write (the reference,
    scripts/env.py:213-223, writes the trainee for every world first,
    then world 0)."""
    worlds, idx = 8, 1
    rng = np.random.RandomState(0)
    actions = torch.tensor(rng.randint(0, 2, (worlds, 6)), dtype=torch.int32)
    human = [1, 5, 1, 0, 0, 0]
    env = BasketballEnv(worlds, CFG, seed=3, trainee_agent_idx=idx,
                        device="cpu")
    env.reset()
    sf0, si0 = env.engine.sf.clone(), env.engine.si.clone()
    n = _noise(worlds, 1)
    env.step_with_world_actions(actions, human_action_world_0=human,
                                human_agent_idx=idx, noise=n)
    # by hand: the bulk trainee write, then world 0's override, one tick
    si = si0.clone()
    for j, r in enumerate(ACTION_ROWS[idx]):
        si[r] = actions[:, j]
        si[r, 0] = human[j]
    sf, si2, obs = FS.step_rows_plain(CFG, sf0, si, n)
    assert torch.equal(env.engine.si, si2)
    assert torch.equal(env.engine.sf, sf) and torch.equal(env.engine.obs, obs)
    assert actions[0].tolist() != human     # the override mattered


def test_pause_freezes_sim_but_ticks_viewer():
    env = BasketballEnv(4, CFG, seed=1, trainee_agent_idx=0,
                        viewer=FakeViewer(), device="cpu")
    env.reset()
    assert env.viewer.ticks == 0      # no tick before the first reset ends
    env.viewer.training_paused = True
    step_before = env.engine.si[I_IDX["a0.cur_step"]].clone()
    sf_before = env.engine.sf.clone()
    ticks_before = env.viewer.ticks
    env.step_with_world_actions(torch.ones((4, 6), dtype=torch.int32))
    assert env.is_training_paused()
    assert torch.equal(env.engine.si[I_IDX["a0.cur_step"]], step_before)
    assert torch.equal(env.engine.sf, sf_before)
    # world 0's action of the agent is zeroed, the other worlds keep theirs
    assert all(int(env.engine.si[r, 0]) == 0 for r in ACTION_ROWS[0])
    assert all(int(env.engine.si[r, 1]) == 1 for r in ACTION_ROWS[0])
    assert env.viewer.ticks == ticks_before + 1  # interaction still runs

    env.viewer.training_paused = False
    env.step_with_world_actions(torch.ones((4, 6), dtype=torch.int32))
    assert not env.is_training_paused()
    # cur_step advances every unpaused tick
    assert torch.equal(env.engine.si[I_IDX["a0.cur_step"]], step_before + 1)
    env.set_training_paused(True)     # forwarded to the viewer
    assert env.viewer.training_paused and env.is_training_paused()


def test_interactive_trainer_consults_controller_every_step():
    hp = PPOParams(num_envs=8, num_rollout_steps=3, num_minibatches=2,
                   update_epochs=1, trainee_idx=0)
    viewer = FakeViewer(selected=0)
    tr = InteractiveTrainer(CFG, hp, viewer=viewer, seed=5, device="cpu")
    # the manager reached the viewer through env.set_controller_manager
    assert viewer.controller_manager is tr.controller_manager

    tr.controller_manager.set_human_control(True)
    metrics = tr.train_iteration()
    assert viewer.human_action_calls == hp.num_rollout_steps
    assert viewer.ticks == hp.num_rollout_steps   # the reset's tick: none
    assert np.isfinite(float(metrics["adv_abs_mean"]))
    assert set(metrics) == {"mean_reward", "mean_episode_length",
                            "reward_window", "adv_abs_mean", "value_mean"}
    assert tr.controller_manager.rl_controller.agent is tr.agent
    assert tr.opt.count == hp.update_epochs * hp.num_minibatches

    # with human control off the viewer's keyboard is never read
    tr.controller_manager.set_human_control(False)
    tr.train_iteration()
    assert viewer.human_action_calls == hp.num_rollout_steps


def _jax_draws(key, jhp, n_iters):
    """The JAX trainer's Gumbel draws (one split a tick) and update
    permutations (one split after the rollout), iteration by iteration."""
    gum = jax.jit(lambda k: jax.random.gumbel(k, (jhp.num_envs, 19),
                                              jnp.float32))
    rows = jhp.rollout_batch_size // jhp.shuffle_block
    out = []
    for _ in range(n_iters):
        g = []
        for _ in range(jhp.num_rollout_steps):
            key, k = jax.random.split(key)
            g.append(torch.tensor(np.asarray(gum(k))))
        key, k_upd = jax.random.split(key)
        perms = np.asarray(jnp.argsort(jax.random.bits(
            k_upd, (jhp.update_epochs, rows), jnp.uint32), axis=1))
        out.append((g, torch.tensor(perms)))
    return out


def test_interactive_iteration_matches_jax():
    W, T, seed = 32, 8, 3
    kw = dict(num_envs=W, num_rollout_steps=T, num_minibatches=2,
              update_epochs=2, trainee_idx=1)
    jhp, hp = JPPOParams(**kw), PPOParams(**kw)
    net, ap = jinit(jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(11)
    jv, tv = FakeViewer(selected=1), FakeViewer(selected=1)
    jtr = JInteractiveTrainer(JSimConfig(), jhp, net, key, agent=ap,
                              viewer=jv, seed=seed)
    tr = InteractiveTrainer(CFG, hp, agent=agent_from_numpy(
        jax.tree.map(np.asarray, ap), "cpu"), viewer=tv, seed=seed,
        device="cpu")
    ru = _jax_reset_u(JSimConfig(), jax.random.PRNGKey(seed), W)
    tr.env.engine.sf, tr.env.engine.si = init_rows(
        CFG, W, None, "cpu", reset_u=torch.tensor(ru.T.copy()))
    jtr.controller_manager.set_human_control(True)
    tr.controller_manager.set_human_control(True)

    # the sim noise of the JAX env's next T + 1 steps (reset + T ticks)
    draw = jax.jit(make_noise_fn(JSimConfig()))
    keys, noise = jtr.env.state.key, []
    for _ in range(T + 1):
        keys, nz = draw(keys)
        noise.append(torch.tensor(np.asarray(nz)))
    gumbels, perms = _jax_draws(jax.random.split(key, 3)[2], jhp, 1)[0]

    bufs = {}
    j_rollout, t_rollout = jtr.rollout, tr.rollout

    def j_capture():
        bufs["jax"] = j_rollout()
        return bufs["jax"]

    def t_capture(noise=None, gumbel=None):
        bufs["port"] = t_rollout(noise, gumbel)
        return bufs["port"]

    jtr.rollout, tr.rollout = j_capture, t_capture
    jm = jtr.train_iteration()
    tm = tr.train_iteration(noise=iter(noise), gumbel=iter(gumbels),
                            perms=perms)
    assert jv.human_action_calls == tv.human_action_calls == T
    assert jv.ticks == tv.ticks == T

    jb, tb = bufs["jax"], bufs["port"]
    np.testing.assert_array_equal(tb["actions"].numpy(),
                                  np.asarray(jb["actions"]))
    for k in ("obs", "values", "log_probs", "not_dones", "rewards",
              "next_value"):
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                   atol=3e-4, rtol=1e-3, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=3e-4,
                                   rtol=1e-3, err_msg=k)
    got = FU.pack_weights(tr.agent.net)
    want = JFU.pack_weights(jtr.agent.params, 103)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAMS_ATOL, err_msg=f"param {i}")
    assert tr.opt.count == int(jtr.opt_state[1][0].count)
