"""`--viewer`'s world-0 episode recording in the port (cli.py::
EpisodeRecorder, `_recorder`) against the JAX CLI's recorder
(madrona_basketball_tpu/cli.py:152-199): the per-tick path's world-0
rows of three iterations, fed to both recorders, give the same npz files
bit for bit, in the reference schema, and the JAX viewer's
`load_and_parse_log` parses them.  Exact tier: the recorders only
assemble the rows."""

import os

import numpy as np

from madrona_basketball_tpu.cli import EpisodeRecorder as JEpisodeRecorder
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.ops.fused_step import _hoop_geometry
from madrona_basketball_tpu.viewer.app import ViewerClass

from madrona_basketball_tpu_torch import cli
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ppo import train_fused as TF
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from tests import torch_threads  # noqa: F401

SCHEMA = {"agent_pos": ((2, 3), "float32"), "ball_pos": ((1, 3), "float32"),
          "ball_vel": ((1, 3), "float32"), "orientation": ((2, 4), "float32"),
          "ball_physics": ((1, 7), "int32"),
          "agent_possession": ((2, 3), "int32"),
          "game_state": ((14,), "float32"), "rewards": ((2,), "float32"),
          "actions": ((2, 6), "int32"), "done": ((), "float32")}


def test_recorder_matches_the_jax_recorder(tmp_path, monkeypatch):
    cfg = SimConfig()
    hp = PPOParams(num_envs=32, num_rollout_steps=8, record_world0=True,
                   num_minibatches=2, update_epochs=1)
    it = TF.make_train_iteration(cfg, hp, "cpu", rollout_kernel=False)
    state = TF.init_train_state(cfg, hp, 2, "cpu")
    # world 0's episode ends at every 3rd tick: the recorders wait for
    # one end, record until the next and save
    rows = []
    for _ in range(3):
        state, out = it(state)
        w0 = {k: v.numpy() for k, v in out["metrics"]["world0"].items()}
        w0["done"] = np.zeros_like(w0["done"])
        rows.append(w0)
    rows[0]["done"][5, 0] = 1.0
    rows[1]["done"][6, 0] = 1.0
    monkeypatch.chdir(tmp_path)
    port = cli._recorder(cfg, "m", every_n=1)
    (h0x, h0y), (h1x, h1y) = _hoop_geometry(JSimConfig())
    jrec = JEpisodeRecorder(str(tmp_path / "jax"), np.array(
        [[[h0x, h0y, 0.0], [h1x, h1y, 0.0]]], np.float32), every_n=1)
    for i, w0 in enumerate(rows, start=1):
        for rec in (port, jrec):
            rec.maybe_arm(i)
            rec.feed(w0, i)
    assert port.saved == [os.path.join("logs/m", "iter_2_episode.npz")]
    got = dict(np.load(port.saved[0]))
    want = dict(np.load(tmp_path / "jax" / "iter_2_episode.npz"))
    assert set(got) == set(want) == set(SCHEMA) | {"hoop_pos"}
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    n = got["done"].shape[0]
    assert n == 2 + 7
    for k, (shp, dt) in SCHEMA.items():
        assert got[k].shape == (n, 1) + shp and got[k].dtype.name == dt, k
    raw, episodes, _events = ViewerClass.load_and_parse_log(port.saved[0])
    assert episodes == [(0, n)]
    assert raw["agent_pos"].shape == (n, 1, 2, 3)
