"""The port's training CLI and its reference-layout `.pth` checkpoints.

A two-iteration CPU run logs and writes `checkpoints/m/m_2.pth`, which
the JAX package's `utils.checkpoint.load_agent` reads back to the port's
weights and normalizers exactly; a checkpoint written by the JAX package
(`torch_state_dict_from_agent_params` + `torch.save`) loads into the port
exactly; `--rollout-tiled` trains (kernels I and E's plain versions on
the CPU) and refuses a world count that is not a multiple of 1024; the
flags of the alternate trainer paths train and save; their invalid
combinations refuse with the JAX package's messages; flags of paths the
port does not have exit; `--dp-update` without
`--data-parallel`, or with `--rollout-tiled`, refuses with the JAX
package's messages."""

import re

import jax
import numpy as np
import pytest
import torch

from madrona_basketball_tpu.models.agent import init_agent as j_init_agent
from madrona_basketball_tpu.utils import checkpoint as jckpt
from madrona_basketball_tpu.utils.torch_compat import \
    torch_state_dict_from_agent_params

from madrona_basketball_tpu_torch import cli
from madrona_basketball_tpu_torch import constants as C
from madrona_basketball_tpu_torch.ppo.train_fused import (BF16_POLICY_NEEDS,
                                                          BF16_TRAJ_NEEDS)
from madrona_basketball_tpu_torch.utils import checkpoint as ckpt
from madrona_basketball_tpu_torch.utils.jax_params import agent_from_numpy

# 32 worlds: the rollout wrapper takes whole warps of worlds
SMALL = ["--device", "cpu", "--num-envs", "32", "--num-rollout-steps", "8",
         "--log-every-n-iterations", "1"]


def _assert_same_agent(jax_ap, agent):
    """A JAX AgentParams and a port Agent hold the same float32 values."""
    want = agent_from_numpy(jax.tree.map(np.asarray, jax_ap), "cpu")
    for (name, g), (_, w) in zip(agent.net.state_dict().items(),
                                 want.net.state_dict().items()):
        assert torch.equal(g, w), name
    for k in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            assert torch.equal(getattr(getattr(agent, k), f),
                               getattr(getattr(want, k), f)), (k, f)


def test_cli_trains_logs_and_saves_a_jax_readable_pth(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.chdir(tmp_path)
    state = cli.main(SMALL + ["--num-iterations", "2",
                              "--save-model-every-n-iterations", "2",
                              "--model-name", "m"])
    out = capsys.readouterr().out
    for it in (1, 2):
        assert f"Update: {it} Took" in out
    assert out.count("Mean reward:") == 2
    assert "Model m saved at iteration 2" in out
    assert state.iteration == 2 and state.opt.count == 2 * 16
    assert not (tmp_path / "checkpoints" / "m" / "m_1.pth").exists()
    path = tmp_path / "checkpoints" / "m" / "m_2.pth"
    assert str(path.relative_to(tmp_path)) == ckpt.checkpoint_path("m", 2)
    sd = torch.load(path, weights_only=True)
    assert sd["obs_norm.mean"].dtype == torch.float64
    assert "backbone.3.weight" in sd and "actor.bias" in sd
    _assert_same_agent(jckpt.load_agent(str(path)), state.agent)
    back = ckpt.load_agent(str(path), "cpu")
    for k, v in ckpt.state_dict(back).items():
        assert torch.equal(v, sd[k]), k
    # resume from it, against itself as the frozen opponent
    st2 = cli.main(SMALL + ["--num-iterations", "1", "--model-name", "r",
                            "--trainee-checkpoint", str(path),
                            "--frozen-checkpoint", str(path)])
    assert "Frozen Checkpoint: " + str(path) in capsys.readouterr().out
    for k, v in ckpt.state_dict(st2.frozen).items():
        assert torch.equal(v, sd[k]), k
    assert st2.agent.obs_rms.count == back.obs_rms.count + 8 * 32


def test_jax_written_pth_loads_into_the_port(tmp_path):
    _, ap = j_init_agent(jax.random.PRNGKey(8))
    rng = np.random.RandomState(8)
    mean = np.zeros(C.OBS_SIZE, np.float32)
    mean[:C.OBS_USED] = rng.normal(size=C.OBS_USED)
    ap = ap.replace(obs_rms=ap.obs_rms.replace(
        mean=mean, var=rng.uniform(0.5, 2, C.OBS_SIZE).astype(np.float32),
        count=np.float32(77.0)))
    path = tmp_path / "jax.pth"
    torch.save({k: torch.tensor(v) for k, v in
                torch_state_dict_from_agent_params(ap).items()}, path)
    _assert_same_agent(ap, ckpt.load_agent(str(path), "cpu"))


def test_foreign_obs_tail_is_zeroed_with_a_warning(tmp_path):
    _, ap = j_init_agent(jax.random.PRNGKey(9))
    sd = torch_state_dict_from_agent_params(ap)
    sd["obs_norm.mean"] = np.full(C.OBS_SIZE, 0.5)
    path = tmp_path / "tail.pth"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    with pytest.warns(UserWarning, match="structurally zero"):
        agent = ckpt.load_agent(str(path), "cpu")
    assert float(agent.obs_rms.mean[C.OBS_USED:].abs().max()) == 0.0
    assert float(agent.obs_rms.mean[0]) == 0.5


@pytest.mark.parametrize("flags", [
    ["--interactive", "--rollout-block", "2048"],
    ["--rollout-block", "2048", "--bf16-policy"],
    ["--rollout-block", "2048"],
    ["--rollout-block", "1024", "--interactive", "--bf16-traj"]])
def test_unported_flags_exit_naming_the_roadmap_item(flags):
    """--rollout-block (a TPU kernel's VMEM block) is refused for good,
    also beside --interactive, which is ported and runs (the next test)."""
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        cli.main(SMALL + ["--num-iterations", "1"] + flags)


@pytest.mark.parametrize("flags", [[], ["--bf16-traj"]])
def test_interactive_trains_and_saves(flags, tmp_path, monkeypatch, capsys):
    """--interactive (once refused, each with a case of the test above)
    trains through InteractiveTrainer with the embedded viewer, headless,
    and saves a loadable checkpoint; the path flags are ignored, as the
    JAX CLI ignores them."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("SDL_AUDIODRIVER", "dummy")
    trainer = cli.main(SMALL + ["--interactive", "--num-iterations", "2",
                                "--save-model-every-n-iterations", "2",
                                "--log-every-n-iterations", "1",
                                "--model-name", "inter"] + flags)
    out = capsys.readouterr().out
    assert "Interactive training" in out and "Update: 2 Took" in out
    assert "Model inter saved at iteration 2" in out
    assert trainer.opt.count == 2 * 16
    assert trainer.env.viewer.env is trainer.env
    assert trainer.env.viewer.controller_manager is \
        trainer.controller_manager
    back = ckpt.load_agent(str(tmp_path / ckpt.checkpoint_path("inter", 2)),
                           "cpu")
    for k, v in ckpt.state_dict(back).items():
        assert bool(torch.isfinite(v).all()), k


@pytest.mark.parametrize("flags", [
    ["--backend", "xla-rows"], ["--no-rollout-kernel"], ["--no-fused-grads"],
    ["--no-fused-gae"], ["--shuffle-block", "1"], ["--viewer"],
    ["--backend", "structured"], ["--bf16-traj", "--bf16-policy"],
    ["--bf16-policy", "--no-fused-gae"],
    ["--bf16-policy", "--no-fused-grads"],
    ["--bf16-traj", "--data-parallel", "--dp-update"]])
def test_alternate_path_flags_train_and_save(flags, tmp_path, monkeypatch,
                                             capsys):
    """The flags of the alternate trainer paths and the bf16 flags (once
    refused, each with a case of the test above), the bf16 flags on the
    paths that take them, train one iteration and save a checkpoint that
    loads back finite."""
    monkeypatch.chdir(tmp_path)
    for var in ("DISPLAY", "WAYLAND_DISPLAY", "SDL_VIDEODRIVER"):
        monkeypatch.delenv(var, raising=False)   # --viewer: headless host
    state = cli.main(SMALL + ["--num-iterations", "1",
                              "--save-model-every-n-iterations", "1",
                              "--model-name", "alt"] + flags)
    out = capsys.readouterr().out
    assert "Update: 1 Took" in out and "Model alt saved at iteration 1" in out
    assert state.iteration == 1 and state.opt.count == 16
    path = tmp_path / ckpt.checkpoint_path("alt", 1)
    back = ckpt.load_agent(str(path), "cpu")
    for k, v in ckpt.state_dict(back).items():
        assert bool(torch.isfinite(v).all()), k
    if "--viewer" in flags:
        assert "not spawning the live viewer; npz drops still land in " \
            "logs/alt" in out
        assert (tmp_path / "logs" / "alt").is_dir()


@pytest.mark.parametrize("flags, message", [
    (["--no-rollout-kernel", "--fused-gae"],
     "--fused-gae requires the rollout kernel and fused gradients"),
    (["--viewer", "--rollout-kernel"],
     "rollout_kernel does not support record_world0"),
    (["--backend", "xla-rows", "--rollout-kernel"],
     r"rollout_kernel requires the pallas backend \(TPU\)"),
    (["--no-rollout-kernel", "--rollout-tiled"],
     "rollout_tiled selects the 2-D-tiled variant"),
    (["--no-fused-gae", "--data-parallel", "--dp-update"],
     "--dp-update requires --data-parallel and the fused-GAE flagship"),
    (["--bf16-traj", "--rollout-tiled"], re.escape(BF16_TRAJ_NEEDS)),
    (["--bf16-traj", "--no-fused-gae"], re.escape(BF16_TRAJ_NEEDS)),
    (["--bf16-policy", "--no-rollout-kernel"], re.escape(BF16_POLICY_NEEDS)),
    (["--bf16-policy", "--backend", "xla-rows"],
     re.escape(BF16_POLICY_NEEDS))])
def test_invalid_path_combinations_refuse_with_the_jax_messages(flags,
                                                                message):
    with pytest.raises(SystemExit, match=message):
        cli.main(SMALL + ["--num-iterations", "1"] + flags)


@pytest.mark.parametrize("flags, message", [
    (["--dp-update"], "--dp-update requires --data-parallel and the "
                      "fused-GAE flagship path"),
    (["--data-parallel", "--dp-update", "--rollout-tiled"],
     r"dp_update shards the update phase over the data mesh "
     r"\(per-minibatch gradient psum\); it requires a mesh and the "
     r"\(untiled\) fused-GAE flagship path")])
def test_dp_update_refuses_with_the_jax_messages(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(SMALL + ["--num-iterations", "1"] + flags)


def test_cli_rollout_tiled_trains_and_saves(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    state = cli.main(["--device", "cpu", "--rollout-tiled", "--num-envs",
                      "1024", "--num-rollout-steps", "2",
                      "--num-iterations", "1", "--log-every-n-iterations",
                      "1", "--save-model-every-n-iterations", "1",
                      "--model-name", "t"])
    out = capsys.readouterr().out
    assert "Update: 1 Took" in out and "Model t saved at iteration 1" in out
    assert state.iteration == 1 and state.opt.count == 16
    assert float(state.agent.obs_rms.count) == 1.0 + 2 * 1024
    path = tmp_path / ckpt.checkpoint_path("t", 1)
    back = ckpt.load_agent(str(path), "cpu")
    for k, v in ckpt.state_dict(back).items():
        assert bool(torch.isfinite(v).all()), k


def test_cli_rollout_tiled_needs_1024_worlds():
    with pytest.raises(SystemExit, match="num_worlds % 1024 == 0"):
        cli.main(SMALL + ["--num-iterations", "1", "--rollout-tiled"])
