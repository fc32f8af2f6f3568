"""The port's eval logs as the JAX package's viewer reads them: an npz
written by the port's `infer` is parsed by `ViewerClass.load_and_parse_log`
and drawn headless (tests/test_viewer_infer.py); `log_row` equals the
export's tensors bit for bit; `multi_gen_infer` over a model's `.pth` and
`.ckpt` checkpoints writes the files the JAX viewer's `mgi_playlist`
lists, in its order; the CLI evaluates one checkpoint and, with
`--model-name`, a model's; `--viewer` exits naming its ROADMAP item."""

import os

import numpy as np
import pytest
import torch

from madrona_basketball_tpu.viewer.__main__ import mgi_playlist

from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.infer import (LOG_ROWS, infer, log_row,
                                                main, multi_gen_infer)
from madrona_basketball_tpu_torch.models.agent import init_agent
from madrona_basketball_tpu_torch.utils.checkpoint import save_agent
from tests import torch_threads  # noqa: F401
from tests.test_torch_infer_chunk import _one_thread  # noqa: F401

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
os.environ.setdefault("SDL_AUDIODRIVER", "dummy")

# npz key -> the export's name (the JAX infer's per-step log, infer.py:177)
EXPORT_NAME = {"agent_pos": "agent_pos", "ball_pos": "basketball_pos",
               "ball_vel": "ball_velocity", "orientation": "orientation",
               "ball_physics": "ball_physics",
               "agent_possession": "agent_possession",
               "game_state": "game_state", "rewards": "reward",
               "actions": "action"}


def _agent(seed):
    return init_agent(torch.Generator().manual_seed(seed), "cpu")


def test_log_row_is_the_export():
    env = BasketballEnv(4, SimConfig(), seed=1, trainee_agent_idx=1,
                        device="cpu")
    env.reset()
    for _ in range(3):
        env.step(torch.randint(0, 2, (4, 6), dtype=torch.int32))
    row = log_row(env.engine.sf, env.engine.si, 1)
    t = env.tensors()
    assert list(row) == [*LOG_ROWS, "done"]
    for k, name in EXPORT_NAME.items():
        assert row[k].dtype == t[name].dtype, k
        assert torch.equal(row[k], t[name]), k
    assert torch.equal(row["done"], t["done"][:, 1])


def test_viewer_parses_and_draws_the_port_log(tmp_path):
    from madrona_basketball_tpu.viewer.app import ViewerClass

    path = str(tmp_path / "traj.npz")
    env = BasketballEnv(4, SimConfig(), seed=0, trainee_agent_idx=1,
                        device="cpu")
    infer(env, _agent(1), log_path=path, num_episodes=1, max_steps=25,
          stochastic=True, seed=0, trainee_idx=1)
    raw, episodes, _ = ViewerClass.load_and_parse_log(path)
    assert len(episodes) >= 1 and raw["done"].shape == (25, 4)
    assert raw["agent_pos"].shape == (25, 4, 2, 3)
    assert raw["ball_physics"].shape == (25, 4, 1, 7)
    assert raw["game_state"].shape == (25, 4, 14)
    viewer = ViewerClass(headless=True)
    hp = np.asarray(raw["hoop_pos"]).reshape(-1, 3)
    viewer._draw_frame(raw["agent_pos"][0, 0], raw["orientation"][0, 0],
                       raw["ball_pos"][0, 0, 0], hp, raw["game_state"][0, 0],
                       possession=raw["agent_possession"][0, 0])
    viewer.pg.display.flip()


def test_multi_gen_infer_feeds_the_mgi_playlist(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    names = ["Model_gen_1_10.pth", "Model_initial.ckpt",
             "Model_gen_0_10.pth"]
    for i, name in enumerate(names):
        save_agent(_agent(i), os.path.join("checkpoints", "Model", name))
    multi_gen_infer("Model", num_envs=3, num_episodes=1, max_steps=4,
                    cfg=SimConfig(time_per_period=1.0), device="cpu")
    got = [os.path.basename(p)
           for p in mgi_playlist("Model", root="logs/mgi")]
    assert got == ["Model_initial.npz", "Model_gen_0_10.npz",
                   "Model_gen_1_10.npz"]
    for p in got:
        assert np.load(os.path.join("logs/mgi/Model_", p))["done"].shape \
            == (4, 3)


def test_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    save_agent(_agent(0), "checkpoints/M/M_5.pth")
    save_agent(_agent(1), "frozen.ckpt")
    main(["--trainee-checkpoint", "checkpoints/M/M_5.pth",
          "--frozen-checkpoint", "frozen.ckpt", "--num-envs", "3",
          "--max-steps", "6", "--deterministic", "--device", "cpu",
          "--log-path", "logs/one.npz"])
    assert np.load("logs/one.npz")["actions"].shape == (6, 3, 2, 6)
    main(["--model-name", "M", "--num-envs", "3", "--max-steps", "2",
          "--device", "cpu"])
    assert os.path.exists("logs/mgi/M_/M_5.npz")
    assert "Inference Complete" in capsys.readouterr().out
    # --viewer: the embedded viewer (headless), per step, a controller
    # manager attached through the env
    from madrona_basketball_tpu_torch import infer as infer_mod
    from madrona_basketball_tpu_torch.controllers import \
        SimpleControllerManager
    from madrona_basketball_tpu_torch.viewer.app import ViewerClass
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("SDL_AUDIODRIVER", "dummy")
    ticked = []
    monkeypatch.setattr(ViewerClass, "tick", lambda self: ticked.append(self))
    monkeypatch.setattr(infer_mod, "_infer_chunked", None)  # never called
    main(["--viewer", "--trainee-checkpoint", "checkpoints/M/M_5.pth",
          "--num-envs", "2", "--max-steps", "3", "--device", "cpu",
          "--log-path", "logs/v.npz"])
    assert np.load("logs/v.npz")["actions"].shape == (3, 2, 2, 6)
    assert len(ticked) == 3 and ticked[0].env is not None
    assert isinstance(ticked[0].controller_manager, SimpleControllerManager)
