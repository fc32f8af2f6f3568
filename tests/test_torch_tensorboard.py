"""`--tensorboard` and the WandbLogger facade of the port
(utils/wandb_logger.py, the JAX package's utils/wandb_logger.py:13-41).

The facade works without `wandb` (it is not installed here: the logger
says so and keeps the TensorBoard half); `--tensorboard --device cpu`
writes `runs/{model}` scalars that tensorboard's EventAccumulator reads
back equal to the metrics the CLI prints; a missing tensorboardX raises
ImportError, as the JAX CLI does."""

import re
import sys

import pytest
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator

from madrona_basketball_tpu_torch import cli
from madrona_basketball_tpu_torch.utils.wandb_logger import WandbLogger

SMALL = ["--device", "cpu", "--num-envs", "32", "--num-rollout-steps", "4",
         "--log-every-n-iterations", "1", "--save-model-every-n-iterations",
         "100"]


def _scalars(path):
    acc = EventAccumulator(str(path))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_logger_facade_without_wandb(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    log = WandbLogger("p", "run", config={"a": 1},
                      tensorboard_dir=str(tmp_path / "tb"))
    assert "wandb not available" in capsys.readouterr().out
    assert log.wandb is None
    log.log({"loss": 0.5, "reward": -3.0}, step=7)
    log.log({"loss": 0.25}, step=8)
    log.close()
    got = _scalars(tmp_path / "tb")
    assert got["loss"] == [(7, 0.5), (8, 0.25)]
    assert got["reward"] == [(7, -3.0)]
    quiet = WandbLogger("p", "run", use_wandb=False)
    assert quiet.wandb is None and quiet.writer is None
    quiet.log({"x": 1.0}, step=0)
    quiet.close()


def test_cli_tensorboard_writes_the_printed_metrics(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.chdir(tmp_path)
    cli.main(SMALL + ["--num-iterations", "3", "--tensorboard",
                      "--model-name", "tb"])
    out = capsys.readouterr().out
    printed = re.findall(r"Mean reward: (\S+)\. Mean episode length: (\S+)",
                         out)
    assert len(printed) == 3
    got = _scalars(tmp_path / "runs" / "tb")
    assert set(got) == {"mean_reward", "mean_episode_length",
                        "reward_window", "adv_abs_mean", "value_mean"}
    for tag, rows in got.items():
        assert [s for s, _ in rows] == [1, 2, 3], tag
    for i, (rew, length) in enumerate(printed):
        assert f"{got['mean_reward'][i][1]:.2f}" == rew.rstrip(".")
        assert f"{got['mean_episode_length'][i][1]:.2f}" == length
    assert all(abs(v) < 1e6 for _, v in got["value_mean"])


def test_cli_tensorboard_without_tensorboardx_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError):
        cli.main(SMALL + ["--num-iterations", "1", "--tensorboard"])
