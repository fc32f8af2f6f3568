"""The port's train scripts off the card: `madrona_basketball_tpu_torch.
bench_train` and `.run_convergence` run the plain versions with `--device
cpu` at 32 worlds x 4 ticks and print their JSON line (CPU times, named by
the device).  Their `main(argv)` runs in the test's process with the
scripts' own repetition constants patched down (bench_train's REPS and
TRIES, run_convergence's CHUNK), so each takes a few iterations and every
line of it runs; run as a user runs them (`python -m`), on the card, they
refuse to start without one."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from madrona_basketball_tpu_torch import bench_train as BT
from madrona_basketball_tpu_torch import run_convergence as RC
from tests import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", f"madrona_basketball_tpu_torch.{module}",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=30)


def _stdout_lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("flags", [[], ["--no-frozen"]])
def test_bench_train_cpu_prints_one_json_line(flags, monkeypatch, capsys):
    monkeypatch.setattr(BT, "REPS", 2)
    monkeypatch.setattr(BT, "TRIES", 2)
    ret = BT.main(["32", "--num-rollout-steps", "4", "--iters-per-dispatch",
                   "2", "--device", "cpu", *flags])
    lines = _stdout_lines(capsys)
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(ret))
    assert line["metric"] == "train_iteration_ms_32"
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert line["frozen"] == (flags == []) and line["ticks"] == 4
    assert line["iters_per_dispatch"] == 2
    for k in ("eager", "chunked"):
        assert line[f"{k}_ms"] > 0
        assert line[f"{k}_train_env_steps_per_s"] == \
            pytest.approx(32 * 4 / (line[f"{k}_ms"] / 1e3))
    assert line["eager_method"] == f"best_of_{BT.TRIES}x{BT.REPS}_chained"
    # eager: an untimed call and TRIES x REPS timed; chunked: 1 + TRIES
    # chunks of 2
    assert line["iterations_run"] == \
        1 + BT.TRIES * BT.REPS + 2 * (1 + BT.TRIES)


def test_run_convergence_cpu_prints_the_curve(monkeypatch, capsys):
    monkeypatch.setattr(RC, "CHUNK", 2)
    ch = str(RC.CHUNK)
    with pytest.raises(ValueError, match="1024"):
        RC.main(["32", ch, "3", "--num-rollout-steps", "4", "--tiled",
                 "--device", "cpu"])
    capsys.readouterr()
    RC.main(["32", ch, "3", "--num-rollout-steps", "4", "--device", "cpu"])
    lines = _stdout_lines(capsys)
    assert lines[0].startswith(f"[conv seed=3 ub=auto] iter {ch}: reward ")
    assert f"DONE {ch} iters" in lines[1]
    line = json.loads(lines[-1])
    assert line["metric"] == "convergence" and line["seed"] == 3
    assert line["iterations"] == RC.CHUNK
    assert line["iters_per_dispatch"] == RC.CHUNK
    assert [p[0] for p in line["curve"]] == [RC.CHUNK]
    assert line["params_finite"] is True
    assert line["sustained_env_steps_per_s"] > 0
    assert line["device"] == "cpu"
    with pytest.raises(ValueError, match=f"multiple of ch={ch}"):
        RC.main(["32", str(RC.CHUNK * 3 // 2), "--num-rollout-steps", "4",
                 "--device", "cpu"])


def test_train_scripts_refuse_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for module in ("bench_train", "run_convergence"):
        out = _run(module, "32")
        assert out.returncode != 0 and out.stdout == ""
        assert "no CUDA card" in out.stderr
