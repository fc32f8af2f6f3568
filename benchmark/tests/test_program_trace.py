"""The readers of the program's own tracer (`program_trace.py` and the
five metrics after the first nine) on synthetic records and runs: what
each reads, and None where a stretch dropped records or a host-span
reader's calibration interval is wider than 50 us; the stretch itself on
the CPU at a test's sizes, and its separate process's plumbing."""

import json
import subprocess
import sys
import types

import pytest

from benchmark import program_trace as PT
from benchmark import run as B

TRAIN = ["start", "perms", "reset_pulse", "rollout", "gae", "glue", "update",
         "writeback"]


def reader(name):
    return B.load_module(B.HERE / "metrics" / f"{name}.py", f"m_{name}")


def train_records(width_ns=2_000, dropped=0):
    """Three iterations 0.7 ms apart in the ns of their stamps: each 0.6 ms
    long, the rollout 0.2, the update 0.3; the second and third start
    after a 100 us gap that a save_agent span covers for 40 us; a third
    save after the last iteration, which no start stamp follows."""
    stamps, t = [], 0
    steps = [0, 10_000, 20_000, 220_000, 240_000, 260_000, 560_000, 600_000]
    for k in range(3):
        t = k * 700_000
        stamps += [(n, t + d) for n, d in zip(TRAIN, steps)]
    spans = [("save_agent", 630_000, 670_000, -1, 100),
             ("chunk_dispatch", 670_000, 720_000, -1, 100),
             ("save_agent", 1_330_000, 1_370_000, -1, 200),
             ("save_agent", 2_030_000, 2_070_000, -1, 300)]
    return {"stamps": stamps, "spans": spans,
            "calibration": {"pairs": 32, "width_ns": width_ns,
                            "drift_ns": 0, "resolution_ns": 32},
            "dropped": {"stamps": dropped, "spans": 0}, "kernel_nodes": {}}


def eval_records():
    """Two chunks of 2 ticks: start, policies, policies, end; the second
    starts 300 us after the first ends."""
    stamps = [("start", 0), ("policies", 100_000), ("policies", 400_000),
              ("end", 600_000), ("start", 900_000), ("policies", 1_000_000),
              ("policies", 1_300_000), ("end", 1_500_000)]
    return {"stamps": stamps, "spans": [],
            "calibration": {"pairs": 32, "width_ns": 1_000,
                            "drift_ns": 0, "resolution_ns": 32},
            "dropped": {"stamps": 0, "spans": 0}, "kernel_nodes": {}}


def ctx_with(kind, records, **run):
    tr = {"records": records, **PT.derive(kind, records)}
    return {"program_trace": tr, "run": types.SimpleNamespace(**run)}


def test_derive_train_phases_other_phases_and_save_stall():
    d = PT.derive("train", train_records())
    assert d["phase_ms"]["rollout"] == pytest.approx(0.2)
    assert d["phase_ms"]["update"] == pytest.approx(0.3)
    assert d["iteration_ms"] == pytest.approx(0.6)
    assert d["other_phases_ms"] == pytest.approx(0.1)
    assert d["saves"] == 2      # not the save no iteration follows
    # 40 us of each 100 us gap under a save; the dispatch and "host" the
    # rest
    assert d["idle_ms"] == pytest.approx({"save_agent": 0.08, "host": 0.09,
                                          "chunk_dispatch": 0.03})
    assert d["save_stall_ms"] == pytest.approx(0.04)
    ctx = ctx_with("train", train_records())
    assert reader("other_phases_ms.train").read(ctx) == pytest.approx(0.1)
    assert reader("save_stall_ms.train").read(ctx) == pytest.approx(0.04)


def test_derive_eval_split_and_fetch_gap():
    d = PT.derive("eval", eval_records())
    assert d["chunk_ms"] == pytest.approx([0.6, 0.6])
    assert d["policies_ms"] == pytest.approx(0.1)
    assert d["rest_ms"] == pytest.approx(0.2)
    assert d["fetch_gaps_us"] == pytest.approx([300.0])
    ctx = ctx_with("eval", eval_records())
    assert reader("fetch_gap_us.eval").read(ctx) == pytest.approx(300.0)


def test_readers_refuse_dropped_records_and_a_wide_calibration():
    dropped = ctx_with("train", train_records(dropped=1))
    for name in ("other_phases_ms.train", "save_stall_ms.train"):
        assert reader(name).read(dropped) is None
    wide = ctx_with("train", train_records(width_ns=60_000))
    assert reader("save_stall_ms.train").read(wide) is None
    assert reader("other_phases_ms.train").read(wide) == pytest.approx(0.1)
    ev = eval_records()
    ev["dropped"]["spans"] = 2
    assert reader("fetch_gap_us.eval").read(ctx_with("eval", ev)) is None


def test_node_readers_read_the_programs_counters_or_nothing():
    chunk = types.SimpleNamespace(captured={"kernel_nodes": 57})
    ctx = {"run": types.SimpleNamespace(chunk=chunk)}
    assert reader("kernel_nodes_per_iteration.train").read(ctx) == 57
    ctx["run"].chunk = types.SimpleNamespace(captured={"graph": None})
    assert reader("kernel_nodes_per_iteration.train").read(ctx) is None
    ev = {"run": types.SimpleNamespace(
        chunk=types.SimpleNamespace(kernel_nodes=4199), K=32)}
    assert reader("kernel_nodes_per_tick.eval").read(ev) == \
        pytest.approx(4199 / 32)
    ev["run"].chunk = types.SimpleNamespace()       # a program without it
    assert reader("kernel_nodes_per_tick.eval").read(ev) is None


def test_no_tracer_in_the_program_reads_nothing(monkeypatch):
    from madrona_basketball_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "TRACER")
    ctx = {"run": object(), "plan": {"traffic": {"driver": "train"}}}
    assert PT.read(ctx) is None and ctx["program_trace"] is None
    assert reader("other_phases_ms.train").read(ctx) is None


@pytest.mark.parametrize("cell, ppo, traffic", [
    ("tag_ppo.train", dict(num_envs=32, num_rollout_steps=2), {}),
    ("tag_selfplay.eval", dict(num_envs=16), dict(chunk_ticks=2)),
])
def test_stretch_on_the_cpu(monkeypatch, cell, ppo, traffic):
    """The driver set up with the tracer on, then the traced stretch of
    the program's loop body: in training 6 iterations saved every 2 after
    a save cadence, in evaluation 3 chunks of 2 ticks; nothing dropped,
    the tracer off after."""
    from madrona_basketball_tpu_torch.utils import profiling as P
    monkeypatch.setattr(PT, "TRAIN_ITERATIONS", 4)
    monkeypatch.setattr(PT, "TRAIN_SAVES", 2)
    monkeypatch.setattr(PT, "EVAL_CHUNKS", 3)
    plan = B.cell_plan(json.loads((B.ROOT / "BENCHMARK.json").read_text()),
                       cell)
    plan["config"]["ppo"].update(ppo)
    plan["config"].update(log_every=2, save_every=2)
    plan["traffic"].update(traffic)
    out = PT.stretch(plan, 2 ** 31 + 7, "cpu")
    assert not P.TRACER.on and out["dropped"] == 0
    assert out["graphs"] == {} and out["seconds"] > 0
    if plan["traffic"]["driver"] == "train":
        # after a save cadence: saves at 4 and 6 and one more chunk (the
        # save at 8 ends the stretch, no start stamp after it)
        assert out["iterations"] == 6 and out["saves"] == 2
        assert set(out["phase_ms"]) == set(TRAIN[1:])
        assert 0 < out["other_phases_ms"] < out["iteration_ms"]
        assert out["save_stall_ms"] > 0
    else:
        assert out["iterations"] == 3 and len(out["chunk_ms"]) == 3
        assert len(out["fetch_gaps_us"]) == 2
        assert out["policies_ms"] > 0 and out["rest_ms"] > 0


def test_read_runs_the_stretch_in_a_process_of_its_own(monkeypatch):
    """`read` starts `python -m benchmark.program_trace` for the cell and
    the run's seed, takes its last line, and reads nothing where it
    fails."""
    calls = []

    def fake(cmd, **kw):
        calls.append(cmd)
        line = json.dumps({"dropped": 0, "width_ns": 9000,
                           "other_phases_ms": 0.35, "iterations": 300,
                           "seconds": 1.1})
        return subprocess.CompletedProcess(cmd, 0, f"noise\n{line}\n")
    monkeypatch.setattr(PT.subprocess, "run", fake)
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "x",
                                      "--seed", "4294967301"])
    ctx = {"run": None, "trace": None, "window": None,
           "plan": {"cell": {"name": "tag_ppo.train"},
                    "traffic": {"driver": "train"}}}
    assert reader("other_phases_ms.train").read(ctx) == pytest.approx(0.35)
    assert reader("save_stall_ms.train").read(ctx) is None
    (cmd,) = calls
    assert cmd[1:] == ["-m", "benchmark.program_trace", "--workload",
                       "tag_ppo.train", "--seed", "4294967301"]
    monkeypatch.setattr(PT.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 1, ""))
    ctx.pop("program_trace")
    assert PT.read(ctx) is None
    ctx = {"plan": {"cell": {"name": "tag_ppo.step"},
                    "traffic": {"driver": "step"}}}
    assert PT.read(ctx) is None
