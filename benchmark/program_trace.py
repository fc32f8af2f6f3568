"""The program's own tracer over a stretch of its own loop body, for the
per-layer metrics that read spans and counters inside the port
(`madrona_basketball_tpu_torch/utils/profiling.py`).

`read(ctx)` runs once per traced run and caches its result on ctx.  Where
the program has a tracer it runs, in a process of its own,

    python3 -m benchmark.program_trace --workload <cell> --seed <n>

because the traced run has just held a torch.profiler session, which
leaves the process's host work slower after it ends (eval's round trip a
chunk read 4-6x its unprofiled time there), and because a second capture
would count in the traced run's peak memory.  That process builds the
cell's driver as a run does, with the tracer on, so that the chunk's
graph holds the phase stamps; closes that session; and runs, in a second
session with no profiler, a stretch of the program's loop body (`stretch`):

  * training (`ppo/train.py::TrainLoop`, the loop of the CLI and the
    league): after one save cadence untraced (a process's first saves
    run slower, and the window's are warm), whole chunks from that save
    boundary, at least TRAIN_ITERATIONS iterations and TRAIN_SAVES
    saves, and one chunk more, whose dispatch ends the last save's idle;
    the checkpoints go to the driver's directory;
  * evaluation (`infer.py::EvalChunk.advance`, the body of
    `_infer_chunked`): EVAL_CHUNKS chunks of the cell's K ticks (the
    host's launch time wanders by 3x from one second to the next, so
    the stretch spans ~9 s).

It prints the stretch's readings (`derive`, with the calibration and the
set-up's graph node counts) as one JSON line last.  `read` returns them,
or None where the program has no tracer (a checkout before it) or the
stretch failed, and prints them on standard error beside the profiled
window's where they compare."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TRAIN_ITERATIONS = 300
TRAIN_SAVES = 3
EVAL_CHUNKS = 800
MAX_WIDTH_NS = 50_000      # a wider calibration places no host span
TIMEOUT_S = 600


def read(ctx):
    if "program_trace" not in ctx:
        ctx["program_trace"] = _trace(ctx)
    return ctx["program_trace"]


def _seed() -> int:
    """The traced run's --seed (its command line), 0 without one."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _trace(ctx):
    try:
        from madrona_basketball_tpu_torch.utils import profiling as P
    except ImportError:
        return None
    plan = ctx["plan"]
    if not hasattr(P, "TRACER") or \
            plan["traffic"]["driver"] not in ("train", "eval"):
        return None
    cmd = [sys.executable, "-m", "benchmark.program_trace", "--workload",
           plan["cell"]["name"], "--seed", str(_seed())]
    try:
        done = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                              text=True, timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"program trace: no result in {TIMEOUT_S} s", file=sys.stderr)
        return None
    lines = done.stdout.strip().splitlines()
    if done.returncode or not lines:
        print(f"program trace: the stretch failed (exit {done.returncode})",
              file=sys.stderr)
        return None
    out = json.loads(lines[-1])
    print("program trace: " + json.dumps(summary(ctx, out)),
          file=sys.stderr, flush=True)
    return out


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stretch(plan: dict, seed: int, device) -> dict:
    """The cell's driver set up with the tracer on, then a traced stretch
    of the program's loop body (the module docstring).  Returns `derive`'s
    readings with "iterations" (chunks in evaluation), "seconds",
    "calibration" and "graphs" (each graph the set-up captured: its
    kernel and stamp nodes)."""
    from benchmark import run as B
    from madrona_basketball_tpu_torch.utils import profiling as P
    B.set_precision(plan["config"])
    kind = plan["traffic"]["driver"]
    driver = B.load_module(B.HERE / "drivers" / f"{kind}.py",
                           f"benchmark_driver_{kind}")
    P.TRACER.start(device)
    try:
        run = driver.Run(plan["config"], plan["traffic"], seed, device)
    finally:
        setup = P.TRACER.stop()
    try:
        body = (_train if kind == "train" else _eval)(run)
        _sync(device)
        P.TRACER.start(device)
        try:
            t0 = time.perf_counter()
            n = body()
            _sync(device)
            seconds = time.perf_counter() - t0
        finally:
            records = P.TRACER.stop()
    finally:
        run.free()
    out = derive(kind, records)
    out.update(iterations=n, seconds=seconds,
               calibration=records["calibration"],
               graphs=setup["kernel_nodes"])
    return out


def _train(run):
    """The program's TrainLoop through the driver's captured chunk: runs
    one save cadence, and returns the stretch (whole chunks from that
    save boundary; it returns their iterations)."""
    from madrona_basketball_tpu_torch.ppo.train import TrainLoop
    from madrona_basketball_tpu_torch.utils.checkpoint import save_agent
    n = run.chunk_n
    iters = max(TRAIN_ITERATIONS, TRAIN_SAVES * run.save_every)
    iters = -(-iters // n) * n + n

    def save(state, i):
        save_agent(state.agent, os.path.join(run.ckpt_dir,
                                             f"stretch_{i}.pth"))
    loop = TrainLoop(run.train_iteration, n, run.log_every, run.save_every,
                     log=lambda m, i: None, save=save, chunk=run.chunk)
    state, it = run.state, 0
    while it < run.save_every:
        state, it = loop.step(state, it)

    def body():
        nonlocal state, it
        stop = it + iters
        while it < stop:
            state, it = loop.step(state, it)
        run.state = state
        return iters
    return body


def _eval(run):
    """The stretch: EVAL_CHUNKS chunks of `EvalChunk.advance` (the run
    and its t_used fetch) through the driver's captured chunk."""
    def body():
        for i in range(EVAL_CHUNKS):
            run.chunk.advance(run.K, i)
        return EVAL_CHUNKS
    return body


def _ms(ns):
    return ns * 1e-6


def derive(kind: str, records: dict) -> dict:
    """The readers' numbers from a session's records: "dropped" (records
    lost), "width_ns" (the calibration interval) and, for training,
    "phase_ms" (each phase's median ms an iteration: from the stamp
    before it to its own), "iteration_ms" (start -> writeback),
    "other_phases_ms", "idle_ms" (device idle a host span name),
    "saves" (those a chunk's start stamp follows) and "save_stall_ms"
    (the median over them of the device idle inside each); for
    evaluation "chunk_ms" (each chunk's start -> end), "policies_ms" and
    "rest_ms" a tick (start -> first "policies", last "policies" ->
    end), "fetch_gaps_us" (end -> next start)."""
    from madrona_basketball_tpu_torch.utils import profiling as P
    stamps, spans = records["stamps"], records["spans"]
    width = records["calibration"]["width_ns"]
    out = {"dropped": sum(records["dropped"].values()), "width_ns": width}
    runs = [dict(r) if kind == "train" else r
            for r in P.sequences(stamps)]
    if kind == "train":
        phases = {}
        for r in runs:
            names = list(r)
            for a, b in zip(names, names[1:]):
                phases.setdefault(b, []).append(r[b] - r[a])
        out["phase_ms"] = {k: _ms(statistics.median(v))
                           for k, v in phases.items()}
        total = [r["writeback"] - r["start"] for r in runs]
        other = [r["writeback"] - r["start"] - (r["rollout"] -
                                                r["reset_pulse"]) -
                 (r["update"] - r["glue"]) for r in runs]
        out["iteration_ms"] = _ms(statistics.median(total)) if total \
            else None
        out["other_phases_ms"] = _ms(statistics.median(other)) if other \
            else None
        idle = P.attribute(P.idle_gaps(stamps), spans, width)
        out["idle_ms"] = {k: _ms(v) for k, v in idle.items()}
        last = max((t for name, t in stamps if name in P.OPENS),
                   default=None)
        stalls = [P.attribute(P.idle_gaps(stamps), [(*s[:3], -1, s[4])],
                              width).get("save_agent", 0)
                  for s in spans if s[0] == "save_agent" and last and
                  s[1] < last]
        out["saves"] = len(stalls)
        out["save_stall_ms"] = _ms(statistics.median(stalls)) \
            if stalls else None
    else:
        out["chunk_ms"] = [_ms(r[-1][1] - r[0][1]) for r in runs]
        pol = [_ms(r[1][1] - r[0][1]) for r in runs if len(r) > 2]
        rest = [_ms(r[-1][1] - r[-2][1]) for r in runs if len(r) > 2]
        out["policies_ms"] = statistics.median(pol) if pol else None
        out["rest_ms"] = statistics.median(rest) if rest else None
        out["fetch_gaps_us"] = [(b - a) * 1e-3
                                for a, b in P.idle_gaps(stamps)]
    return out


def sound(tr, host_spans: bool = False) -> bool:
    """Whether a reader may take a number from `tr`: a stretch with no
    dropped records and, for a reader of host spans, a calibration
    interval no wider than MAX_WIDTH_NS."""
    return tr is not None and tr["dropped"] == 0 and (
        not host_spans or tr["width_ns"] <= MAX_WIDTH_NS)


def summary(ctx, tr) -> dict:
    """The stretch's readings for the result's stderr, beside the
    profiled window's (`ctx["trace"]`) where they compare."""
    out = {k: v for k, v in tr.items() if k not in ("chunk_ms",
                                                    "fetch_gaps_us")}
    out["rate_per_s"] = tr["iterations"] / tr["seconds"]
    prof = ctx.get("trace") or {}
    from benchmark import trace
    if "chunk_ms" in tr:
        q = statistics.quantiles(tr["fetch_gaps_us"], n=4) \
            if len(tr["fetch_gaps_us"]) > 1 else None
        out["fetch_gap_us_quartiles"] = q
        out["chunk_ms"] = [round(x, 4) for x in tr["chunk_ms"]]
        if prof.get("kernels"):
            counts = {}
            for name, (_, c) in prof["kernels"].items():
                counts[trace.short(name)[:40]] = counts.get(
                    trace.short(name)[:40], 0) + c
            out["profiled_kernels"] = {"chunks": prof.get("iterations"),
                                       "counts": counts}
        return out
    from benchmark.counts import rollout_B, update_D
    n = prof.get("iterations")
    if n and prof.get("kernels"):
        out["profiled_D_ms"] = trace.kernel_seconds(
            prof, update_D.KERNELS)[0] * 1e3 / n
        out["profiled_B_ms"] = trace.kernel_seconds(
            prof, rollout_B.KERNELS)[0] * 1e3 / n
    w = ctx.get("window") or {}
    if w.get("iterations"):
        out["window_ms_per_iteration"] = 1e3 * w["window_s"] / \
            w["iterations"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="A traced stretch of a "
                                 "cell's loop body, one JSON line last")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from benchmark import run as B
    plan = B.cell_plan(json.loads((ROOT / "BENCHMARK.json").read_text()),
                       args.workload)
    B.use_checkout_caches()
    print(json.dumps(stretch(plan, args.seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
