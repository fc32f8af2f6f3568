"""The port's stepping entry points off the card.

`python -m madrona_basketball_tpu_torch.bench 64 --device cpu` runs the
plain versions and prints one JSON line with the metric key (plus one
stderr line per engine, the CUDA-graph engine skipped by name); run as a
user runs it, on the card, it refuses to start without one.  Kernel F's
CUDA entry and the card-side engine and env raise without a card: nothing
falls back to the plain versions."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from madrona_basketball_tpu_torch import _build
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine_fused import FusedEngine
from madrona_basketball_tpu_torch.env import BasketballEnv
from madrona_basketball_tpu_torch.ops import fused_step as FS
from tests import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _bench(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "madrona_basketball_tpu_torch.bench", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=30)


def test_bench_cpu_prints_one_json_line():
    out = _bench("64", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "env_steps_per_sec_64"
    assert line["unit"] == "steps/s" and line["value"] > 0
    assert line["method"] == "best_of_3_chained" and line["device"] == "cpu"
    engines = {e["engine"]: e for e in map(json.loads,
                                            out.stderr.strip().splitlines())}
    assert set(engines) == {"kernel_a_dispatch", "kernel_a_cuda_graph",
                            "kernel_f_every_tick_obs", "kernel_f_held_obs"}
    assert "skipped" in engines["kernel_a_cuda_graph"]
    assert line["value"] == max(engines[k]["env_steps_per_s"] for k in (
        "kernel_a_dispatch", "kernel_f_every_tick_obs"))


def test_card_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _bench("64")
    assert out.returncode != 0 and out.stdout == ""
    with pytest.raises(RuntimeError):
        FusedEngine(SimConfig(), 64)
    with pytest.raises(RuntimeError):
        BasketballEnv(64, SimConfig())
    if not _build.lib_path("fused_multistep").exists():
        with pytest.raises(RuntimeError):   # no nvcc here: no library
            _build.load("fused_multistep")
    sf = torch.zeros((72, 4), device="meta")
    si = torch.zeros((59, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        FS.fused_multistep(SimConfig(), sf, si, 2, seed=0)
