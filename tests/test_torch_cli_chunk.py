"""The training CLI's `--iters-per-dispatch` with the JAX CLI's meaning
(madrona_basketball_tpu/cli.py:421-500), on the CPU.

5 iterations at a log cadence of 2 and a save cadence of 4: 0 (auto)
runs chunks of 2, 2 the same, 3 (which does not divide the cadences)
says so and falls back to 2, and each runs the fifth iteration as the
exact tail, one iteration a dispatch.  Every run logs at iterations 2
and 4, saves at 4, and its checkpoint and final state equal those of
`--iters-per-dispatch 1`, bit for bit."""

import pytest
import torch

from madrona_basketball_tpu_torch import cli
from madrona_basketball_tpu_torch.ppo.train_fused import state_tensors
from madrona_basketball_tpu_torch.utils import checkpoint as ckpt
from tests import torch_threads  # noqa: F401

ARGS = ["--device", "cpu", "--num-envs", "32", "--num-rollout-steps", "4",
        "--num-iterations", "5", "--log-every-n-iterations", "2",
        "--save-model-every-n-iterations", "4"]


def _train(path, ipd):
    """The CLI run in `path`: (final state, its iteration-4 checkpoint)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        state = cli.main(ARGS + ["--model-name", f"m{ipd}",
                                 "--iters-per-dispatch", ipd])
    return state, torch.load(path / ckpt.checkpoint_path(f"m{ipd}", 4),
                             weights_only=True)


@pytest.fixture(scope="module")
def eager(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("eager"), "1")


@pytest.mark.parametrize("ipd,chunk", [("0", 2), ("2", 2), ("3", 2),
                                       ("1", 1)])
def test_iters_per_dispatch_logs_saves_and_trains_as_one_a_dispatch(
        tmp_path, capsys, eager, ipd, chunk):
    capsys.readouterr()
    state, sd = _train(tmp_path, ipd)
    out = capsys.readouterr().out
    assert f"Iterations per dispatch: {chunk}" in out
    fallback = ("--iters-per-dispatch 3 does not divide the log/save "
                "cadence; using 2 instead")
    assert (fallback in out) == (ipd == "3")
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("Update:")] == ["2", "4"]
    assert out.count("Mean reward:") == 2
    assert "Model m%s saved at iteration 4" % ipd in out
    assert not (tmp_path / ckpt.checkpoint_path(f"m{ipd}", 2)).exists()
    e_state, e_sd = eager
    assert sorted(sd) == sorted(e_sd)
    for k in e_sd:
        assert torch.equal(sd[k], e_sd[k]), k
    assert state.iteration == state.counter == 5
    assert state.opt.count == 5 * 16
    for i, (x, y) in enumerate(zip(state_tensors(state),
                                   state_tensors(e_state))):
        assert torch.equal(x, y), i
