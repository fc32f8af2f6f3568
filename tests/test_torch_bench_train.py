"""The port's train scripts off the card: `python -m
madrona_basketball_tpu_torch.bench_train` and `.run_convergence` run the
plain versions with `--device cpu` at 32 worlds x 4 ticks and print
their JSON line (CPU times, named by the device); run as a user runs
them, on the card, they refuse to start without one."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", f"madrona_basketball_tpu_torch.{module}",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("flags", [[], ["--no-frozen"]])
def test_bench_train_cpu_prints_one_json_line(flags):
    out = _run("bench_train", "32", "--num-rollout-steps", "4",
               "--iters-per-dispatch", "2", "--device", "cpu", *flags)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "train_iteration_ms_32"
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert line["frozen"] == (flags == []) and line["ticks"] == 4
    assert line["iters_per_dispatch"] == 2
    for k in ("eager", "chunked"):
        assert line[f"{k}_ms"] > 0
        assert line[f"{k}_train_env_steps_per_s"] == \
            pytest.approx(32 * 4 / (line[f"{k}_ms"] / 1e3))
    assert line["eager_method"] == "best_of_3x20_chained"
    # eager: an untimed call and 3 x 20 timed; chunked: 1 + 3 chunks of 2
    assert line["iterations_run"] == 1 + 3 * 20 + 2 * (1 + 3)


def test_run_convergence_cpu_prints_the_curve():
    out = _run("run_convergence", "32", "100", "3", "--num-rollout-steps",
               "4", "--tiled", "--device", "cpu")
    assert out.returncode != 0 and "1024" in out.stderr
    out = _run("run_convergence", "32", "100", "3", "--num-rollout-steps",
               "4", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("[conv seed=3 ub=auto] iter 100: reward ")
    assert "DONE 100 iters" in lines[1]
    line = json.loads(lines[-1])
    assert line["metric"] == "convergence" and line["seed"] == 3
    assert line["iterations"] == 100 and line["iters_per_dispatch"] == 100
    assert [p[0] for p in line["curve"]] == [100]
    assert line["params_finite"] is True
    assert line["sustained_env_steps_per_s"] > 0
    assert line["device"] == "cpu"
    bad = _run("run_convergence", "32", "150", "--num-rollout-steps", "4",
               "--device", "cpu")
    assert bad.returncode != 0 and "multiple of ch=100" in bad.stderr


def test_train_scripts_refuse_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for module in ("bench_train", "run_convergence"):
        out = _run(module, "32")
        assert out.returncode != 0 and out.stdout == ""
        assert "no CUDA card" in out.stderr
