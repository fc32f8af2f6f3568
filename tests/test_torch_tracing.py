"""The port's tracer (utils/profiling.py) on the CPU: off it records
nothing and adds no profiler range; on, the training loop body
(`ppo/train.py::TrainLoop`) gives its span tree at a cadence, the eager
iteration its phase stamps, the records count what a full buffer drops;
the attribution of device-idle time to host spans as a pure function;
the Chrome-trace export of the CLI's `--trace-out`."""

import json

import pytest
import torch
from torch.autograd.profiler import profile

from madrona_basketball_tpu_torch import cli
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train import TrainLoop
from madrona_basketball_tpu_torch.ppo.train_fused import (
    init_train_state, make_train_iteration)
from madrona_basketball_tpu_torch.utils import profiling as P
from tests import torch_threads  # noqa: F401

LOOP_SPANS = ("chunk_dispatch", "unstack_metrics", "log_readback",
              "save_agent")
PHASES = ["start", "perms", "reset_pulse", "rollout", "gae", "glue",
          "update", "writeback"]


@pytest.fixture(scope="module")
def tiny():
    cfg, hp = SimConfig(), PPOParams(num_envs=32, num_rollout_steps=2)
    return cfg, hp, make_train_iteration(cfg, hp, "cpu")


@pytest.fixture
def session():
    """Open a CPU session; the test stops it (and a failed test too)."""
    P.TRACER.start("cpu")
    yield P.TRACER
    if P.TRACER.on:
        P.TRACER.stop()


class _Chunk:
    """A chunk of n iterations that counts its dispatches."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def __call__(self, state):
        self.calls += 1
        return state + self.n, {"m": torch.arange(float(self.n))}


def test_tracer_off_records_nothing_and_adds_no_range(tiny, monkeypatch):
    """Off: the loop body under a CPU profiler session leaves no range of
    its own (on, its spans are ranges there); the real iteration and loop
    body open no range and stamp nothing."""
    cfg, hp, it = tiny
    saved = []
    loop = TrainLoop(lambda s: (s + 1, {"metrics": {"m": torch.tensor(0.)}}),
                     2, 2, 2, log=lambda m, i: None,
                     save=lambda s, i: saved.append(i), chunk=_Chunk(2))
    with profile() as prof:
        loop.run(0, 5)
    names = {e.name for e in prof.function_events}
    assert not names & set(LOOP_SPANS + ("capture", "build")), names
    assert saved == [2, 4]
    with profile() as prof:
        P.TRACER.start("cpu")
        try:
            loop.run(0, 2)
        finally:
            P.TRACER.stop()
    assert set(LOOP_SPANS) <= {e.name for e in prof.function_events}

    def no_range(name):
        raise AssertionError(f"a range {name!r} with the tracer off")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    stamps = P.TRACER.stamps
    loop = TrainLoop(it, 2, 2, 2, log=lambda m, i: None,
                     save=lambda s, i: saved.append(i))
    loop.run(init_train_state(cfg, hp, 1, "cpu"), 2)
    assert not P.TRACER.on and P.TRACER.stamps == stamps


def test_loop_body_span_tree_and_counts_at_a_cadence(session):
    """13 iterations in chunks of 2, log every 4, save every 6: six
    chunks and one eager tail, seven unstacks, readbacks at 4, 8, 12,
    saves at 6 and 12 (a span opened inside a save nests under it), all
    under the session's outer span."""
    logged, saved = [], []

    def save(state, i):
        with P.annotate("write", i):
            saved.append((state, i))
    chunk = _Chunk(2)
    loop = TrainLoop(lambda s: (s + 1, {"metrics": {"m": torch.tensor(0.)}}),
                     2, 4, 6, log=lambda m, i: logged.append(i), save=save,
                     chunk=chunk)
    with P.annotate("session"):
        state = loop.run(0, 13)
    rec = session.stop()
    assert state == 13 and chunk.calls == 6
    spans = rec["spans"]
    by = {}
    for k, (name, start, end, parent, index) in enumerate(spans):
        assert start <= end
        by.setdefault(name, []).append((k, parent, index))
    assert [i for _, _, i in by["chunk_dispatch"]] == [0, 2, 4, 6, 8, 10, 12]
    assert len(by["unstack_metrics"]) == 7
    assert [i for _, _, i in by["log_readback"]] == [4, 8, 12] == logged
    assert [i for _, _, i in by["save_agent"]] == [6, 12]
    assert saved == [(6, 6), (12, 12)]
    (outer, _, _), = by["session"]
    assert all(p == outer for name in LOOP_SPANS for _, p, _ in by[name])
    saves = [k for k, _, _ in by["save_agent"]]
    assert [p for _, p, _ in by["write"]] == saves
    assert rec["dropped"] == {"stamps": 0, "spans": 0}


def test_eager_iteration_stamps_its_phases(tiny, session):
    cfg, hp, it = tiny
    state = init_train_state(cfg, hp, 1, "cpu")
    marks = []
    state, _ = it(state, mark=marks.append)  # the caller's mark: no stamps
    state, _ = it(state)
    rec = session.stop()
    assert "start" not in marks and marks[0] == "perms"
    assert [n for n, _ in rec["stamps"]] == PHASES
    times = [t for _, t in rec["stamps"]]
    assert times == sorted(times)
    (run,) = P.sequences(rec["stamps"])
    assert [n for n, _ in run] == PHASES
    assert rec["calibration"]["width_ns"] == 0


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(P, "CAPACITY", 3)
    P.TRACER.start("cpu")
    try:
        for name in ("start", "a", "b", "c", "end"):
            P.TRACER.mark(name)
        for _ in range(4):
            with P.annotate("s"):
                pass
    finally:
        rec = P.TRACER.stop()
    assert [n for n, _ in rec["stamps"]] == ["start", "a", "b"]
    assert rec["dropped"] == {"stamps": 2, "spans": 1}
    assert len(rec["spans"]) == 3
    # the next session's capacity is its own, and a CPU session makes no
    # device ring
    monkeypatch.setattr(P, "CAPACITY", 8)
    P.TRACER.start("cpu")
    try:
        for name in ("start", "a", "b", "c", "end"):
            P.TRACER.mark(name)
    finally:
        rec = P.TRACER.stop()
    assert len(rec["stamps"]) == 5 and rec["dropped"]["stamps"] == 0
    assert not any(d.type == "cpu" for d in P.TRACER.rings)


@pytest.mark.card
def test_a_stamped_graph_outlives_its_session(monkeypatch):
    """A graph captured with stamps in one session replays into the same
    ring and cursor in a later session of another capacity, after the
    allocator has handed memory out again: only its own stamps, none
    dropped, and the graph's node counts kept apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.zeros(4, device=dev)

    def body():
        P.TRACER.mark("start")
        x.add_(1)
        P.TRACER.mark("end")
    monkeypatch.setattr(P, "CAPACITY", 64)
    P.TRACER.start(dev)
    try:
        where = (P.TRACER.ring.data_ptr(), P.TRACER.cursor.data_ptr())
        graph, kernels = P.capture(body, label="g")
        graph.replay()
    finally:
        first = P.TRACER.stop()
    churn = [torch.full((1 << 20,), 7, dtype=torch.int64, device=dev)
             for _ in range(4)]
    monkeypatch.setattr(P, "CAPACITY", 1 << 16)
    P.TRACER.start(dev)
    try:
        assert (P.TRACER.ring.data_ptr(),
                P.TRACER.cursor.data_ptr()) == where
        for _ in range(3):
            graph.replay()
    finally:
        rec = P.TRACER.stop()
    del churn
    assert kernels == 1
    assert first["kernel_nodes"]["g"] == {"kernels": 1, "stamps": 2}
    assert [n for n, _ in first["stamps"]] == ["start", "end"]
    assert [n for n, _ in rec["stamps"]] == ["start", "end"] * 3
    assert rec["dropped"] == {"stamps": 0, "spans": 0}
    assert x.tolist() == [4.0] * 4


def test_idle_gaps_and_sequences_on_synthetic_stamps():
    stamps = [("start", 0), ("a", 5), ("writeback", 9), ("start", 20),
              ("writeback", 30), ("stray", 31), ("start", 40), ("end", 50)]
    assert P.idle_gaps(stamps) == [(9, 20)]
    runs = P.sequences(stamps)
    assert [[n for n, _ in r] for r in runs] == [
        ["start", "a", "writeback"], ["start", "writeback"],
        ["start", "end"]]


@pytest.mark.parametrize("gap,width,want", [
    # straddles two spans: cut at the edge
    ((150, 230), 10, {"A": 50, "B": 30}),
    # covered by none
    ((300, 400), 10, {"host": 100}),
    # the innermost span takes its part, the outer the rest
    ((450, 750), 10, {"outer": 200, "save_agent": 100}),
    # part covered, part not
    ((230, 270), 10, {"B": 20, "host": 20}),
    # the calibration interval wider than the gap: whole, by its middle
    ((190, 215), 100, {"B": 25}),
    ((190, 215), 10, {"A": 10, "B": 15}),
])
def test_attribution_of_idle_gaps_to_host_spans(gap, width, want):
    spans = [("A", 0, 200, -1, 0), ("B", 200, 250, -1, 1),
             ("outer", 400, 800, -1, -1), ("save_agent", 500, 600, 2, 0)]
    assert P.attribute([gap], spans, width) == want


def test_cli_trace_out_writes_a_chrome_trace(tmp_path, monkeypatch):
    """The CLI's --trace-out on the CPU: valid Chrome-trace JSON with the
    loop's host spans on one track and the iterations' device phases on
    the other, and the records' extras."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "t.json"
    cli.main(["--device", "cpu", "--num-envs", "32", "--num-rollout-steps",
              "2", "--num-iterations", "3", "--log-every-n-iterations", "2",
              "--save-model-every-n-iterations", "2", "--model-name", "m",
              "--trace-out", str(path)])
    assert not P.TRACER.on
    trace = json.loads(path.read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    host = [e["name"] for e in spans if e["tid"] == 0]
    device = [e["name"] for e in spans if e["tid"] == 1]
    assert host.count("chunk_dispatch") == 2 and "save_agent" in host
    assert host.count("log_readback") == 1
    assert device == PHASES[1:] * 3
    assert all(e["dur"] >= 0 for e in spans)
    other = trace["otherData"]
    assert other["dropped"] == {"stamps": 0, "spans": 0}
    assert set(other) >= {"calibration", "kernel_nodes", "idle_ns_by_span"}
