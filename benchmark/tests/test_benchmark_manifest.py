"""BENCHMARK.json names files that exist, keeps to the contract's
characters, and its command refuses to run without a card."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def command():
    """The manifest's command, its interpreter this one."""
    return [sys.executable] + MANIFEST["command"][1:]


def reported(metric):
    return metric.get("workloads",
                      [w["name"] for w in MANIFEST["workloads"]])


def test_every_cell_names_files_that_exist():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for cell in MANIFEST["workloads"]:
        assert (ROOT / configs[cell["config"]]["file"]).is_file()
        traffic = json.loads((BENCH / "traffic" /
                              f"{cell['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for c in MANIFEST["configs"]:
        assert c["file"].startswith(tuple(MANIFEST["paths"]))


def test_every_moved_metric_is_reported_where_its_mover_is():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(reported(m)) <= set(reported(e2e[m["moves"]])), m["name"]
    for cell in MANIFEST["workloads"]:
        mine = [m["name"] for m in MANIFEST["end_to_end"]
                if cell["name"] in reported(m)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell["name"] in reported(m) for m in MANIFEST["per_layer"])


def test_names_and_units_keep_to_the_allowed_characters():
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w[k] for w in MANIFEST["workloads"]
              for k in ("name", "config", "traffic")]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_the_command_refuses_without_a_card():
    """On this CPU machine run.py exits non-zero and prints no result."""
    cell = MANIFEST["workloads"][0]["name"]
    out = subprocess.run(
        command() + ["--workload", cell, "--seed", "1", "--seconds", "1",
                     "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "CUDA card" in out.stderr


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    """One short run of the first cell, correct, on a card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = MANIFEST["workloads"][0]["name"]
    out = subprocess.run(
        command() + ["--workload", cell, "--seed", "5",
                               "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
