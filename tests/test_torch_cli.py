"""The port's training CLI and its reference-layout `.pth` checkpoints.

A two-iteration CPU run logs and writes `checkpoints/m/m_2.pth`, which
the JAX package's `utils.checkpoint.load_agent` reads back to the port's
weights and normalizers exactly; a checkpoint written by the JAX package
(`torch_state_dict_from_agent_params` + `torch.save`) loads into the port
exactly; flags of paths the port does not have exit."""

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
    ["--backend", "xla-rows"], ["--no-rollout-kernel"], ["--no-fused-grads"],
    ["--no-fused-gae"], ["--rollout-tiled"], ["--bf16-traj"],
    ["--bf16-policy"], ["--rollout-block", "2048"], ["--shuffle-block", "1"],
    ["--data-parallel"],
    ["--dp-update"], ["--distributed"], ["--interactive"], ["--viewer"],
    ["--tensorboard"], ["--iters-per-dispatch", "10"]])
def test_unported_flags_exit_naming_the_roadmap_item(flags):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        cli.main(SMALL + ["--num-iterations", "1"] + flags)
