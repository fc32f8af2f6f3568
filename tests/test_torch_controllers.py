"""The port's controllers (controllers.py) against the JAX package's, on
the CPU.

* `RLController` against the JAX `RLController` (agent.forward under its
  key splits): the same params (carried across by
  `utils/jax_params.py::agent_from_numpy`) and the same Gumbel draws (the
  JAX controller's split keys, replayed through the port's `gumbel=`
  seam) must give the same actions, exactly.
* `RulesController` against the live port env: agent 0 spawns holding
  the ball in 1v1, agent 1 does not, and HAS_BALL_IDX must read the real
  hasBall slot (tests/test_viewer_infer.py::test_rules_controller).
* `SimpleControllerManager`'s toggle, through the env's
  `toggle_human_control` too, and its routing between the keyboard and
  the policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from madrona_basketball_tpu.controllers import RLController as JRLController
from madrona_basketball_tpu.models.agent import init_agent as jinit

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.controllers import (HumanController,
                                                      RLController,
                                                      RulesController,
                                                      SimpleControllerManager)
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.ops.layout import I_IDX
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy
from tests import torch_threads  # noqa: F401


class _Keys:
    """The keyboard half of the viewer's surface."""

    def __init__(self, action=(1, 3, 0, 0, 0, 0)):
        self.action = list(action)
        self.calls = 0
        self.controller_manager = None

    def get_human_action(self):
        self.calls += 1
        return self.action

    def set_controller_manager(self, mgr):
        self.controller_manager = mgr


def _jax_controller_gumbels(seed, n):
    """The Gumbel draws of the JAX RLController seeded `seed`, call by
    call (PRNGKey(seed), one split a call)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(k, (1, 19), jnp.float32)))
    return out


def test_rl_controller_matches_jax():
    net, ap = jinit(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    n = 12
    obs = rng.normal(scale=2.0, size=(n, 128)).astype(np.float32)
    obs[:, 103:] = 0.0
    j = JRLController(net, ap, seed=5)
    want = [np.asarray(j.get_action(o)) for o in obs]
    agent = agent_from_numpy(jax.tree.map(np.asarray, ap), "cpu")
    t = RLController(agent, seed=5,
                     gumbel=iter(_jax_controller_gumbels(5, n)))
    got = [t.get_action(o) for o in obs]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (6,) and g.dtype == np.int32
        np.testing.assert_array_equal(g, w, err_msg=f"call {k}")
    # without the seam the controller samples from its own generator:
    # seeded alike, two controllers agree; the draws vary call to call
    a, b = RLController(agent, seed=7), RLController(agent, seed=7)
    seq_a = np.stack([a.get_action(obs[0]) for _ in range(8)])
    seq_b = np.stack([b.get_action(obs[0]) for _ in range(8)])
    np.testing.assert_array_equal(seq_a, seq_b)
    assert len({tuple(r) for r in seq_a}) > 1


def test_rules_controller():
    env = BasketballEnv(4, SimConfig(), seed=4, device="cpu")
    env.reset()
    ctl = RulesController()
    obs_all = env.observations.numpy()
    has_ball = np.stack([env.engine.si[I_IDX[f"a{i}.has_ball"]].numpy()
                         for i in range(2)], axis=1)
    assert has_ball[0].tolist() == [1, 0]
    for agent in range(2):
        obs = obs_all[0, agent]
        assert obs[ctl.HAS_BALL_IDX] == has_ball[0, agent], \
            f"agent {agent}: obs[{ctl.HAS_BALL_IDX}] is not hasBall"
        act = ctl.get_action(obs)
        assert act.shape == (6,)
        if has_ball[0, agent]:
            assert act[5] == 1 and act[3] == 0   # shoot
        else:
            assert act[3] == 1 and act[5] == 0   # grab


def test_manager_toggle_and_routing(capsys):
    agent = agent_from_numpy(
        jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(1))[1]), "cpu")
    keys = _Keys()
    env = BasketballEnv(4, SimConfig(), seed=0, viewer=keys, device="cpu")
    mgr = SimpleControllerManager(agent, seed=2)
    env.set_controller_manager(mgr)
    assert env.controller_manager is mgr and keys.controller_manager is mgr
    obs = np.zeros(128, np.float32)
    assert not mgr.is_human_control_active()
    mgr.get_action(obs, keys)            # the policy: no key read
    assert keys.calls == 0
    env.toggle_human_control()
    assert mgr.is_human_control_active()
    assert "Human control enabled" in capsys.readouterr().out
    np.testing.assert_array_equal(mgr.get_action(obs, keys), keys.action)
    assert keys.calls == 1
    mgr.get_action(obs)                  # no viewer: the policy
    assert keys.calls == 1
    env.toggle_human_control()
    assert not mgr.is_human_control_active()
    assert "Human control disabled" in capsys.readouterr().out
    np.testing.assert_array_equal(HumanController().get_action(obs),
                                  np.zeros(6, np.int32))
