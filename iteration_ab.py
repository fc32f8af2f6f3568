#!/usr/bin/env python3
"""The flagship training iteration of this checkout against another
tree's, on one card, in turns.

    python3 iteration_ab.py --other DIR [--turns other,this,this,other]
                            [--tiled | --multistep] [--chunk N]

DIR is another checkout of the repository (for example the parent
commit, unpacked with `git archive`).  Each turn is a fresh process that
imports `madrona_basketball_tpu_torch` from its own tree (building that
tree's kernels into its own `_build/` at first use) and measures what
chip_smoke.py's `main_path` measures: `init_train_state` at the flagship
shape (8192 worlds x 32 ticks, 4 epochs x 4 minibatches, seed 1),
warm-up iterations until the 10 s game clock runs out inside the timed
window, then three iterations timed with CUDA events (the median of each
span: reset_pulse, rollout, gae, [obs_moments,] glue, update, and the
iteration), then
one more iteration under torch.profiler for the device's busy time and
idle share and the kernels by device time.  One JSON line per turn,
each with the card's name and power limit; the last line is the
per-tree medians over the turns.  `--tiled` measures the
`--rollout-tiled` iteration (chip_smoke.py's `tiled_path`) instead.
`--chunk N` times this checkout's iteration chunked instead
(`ppo/train.py::make_train_chunk`: one iteration captured as a CUDA
graph and replayed N times a dispatch): after the same warm-up, one
chunk (the capture), then three chunks timed with CUDA events, each
divided by N, and one chunk profiled (device busy ms an iteration); the
other tree's turns stay eager (a tree without the chunk), so the two
compare the dispatch modes.  Every turn also gives its idle share
against the un-profiled iteration (`device_idle_share_unprofiled`).
`--multistep` measures kernel F as the stepping bench's engines (c) and
(d) launch it: 8192 worlds from `init_rows` (seed 0), 5000 ticks a
launch with in-kernel Philox, obs every tick with agent 0 blanked, and
held obs; each the fastest of three launches timed with CUDA events.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPANS = ("reset_pulse", "rollout", "gae", "glue", "update")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(tree: Path, tiled: bool = False, chunk: int = 0) -> dict:
    """One turn, in this process, with the port imported from `tree`
    (chunked N = `chunk` iterations a dispatch when it is not 0)."""
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile
    import madrona_basketball_tpu_torch as port
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.config import SimConfig
    from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
    from madrona_basketball_tpu_torch.ppo.train_fused import (
        init_train_state, make_train_iteration)
    if Path(port.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"imported the port from {port.__file__}, not "
                         f"{tree}")
    if not torch.cuda.is_available():
        raise SystemExit("iteration_ab: needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda:0")
    cfg = SimConfig()
    hp = PPOParams(num_envs=8192, num_rollout_steps=32)
    state = init_train_state(cfg, hp, seed=1, device=dev)
    it_fn = make_train_iteration(cfg, hp, device=dev, rollout_tiled=tiled)
    warmup = max(1, int(cfg.time_per_period * 62) // (hp.num_rollout_steps
                                                       + 1) - 1)
    for _ in range(warmup):
        state, _ = it_fn(state)
    torch.cuda.synchronize()
    if chunk:
        return measure_chunk(tree, tiled, chunk, it_fn, state, build_s,
                             warmup)
    spans = SPANS[:3] + ("obs_moments",) * tiled + SPANS[3:]
    times = {k: [] for k in spans + ("iteration",)}
    wall = []
    for _ in range(3):
        evs = [torch.cuda.Event(enable_timing=True)]

        def mark(name, evs=evs):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            evs.append(e)
        w0 = time.perf_counter()
        evs[0].record()
        state, _ = it_fn(state, mark=mark)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - w0) * 1e3)
        for name, a, b in zip(spans, evs[:-1], evs[1:]):
            times[name].append(a.elapsed_time(b))
        times["iteration"].append(evs[0].elapsed_time(evs[-1]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        state, _ = it_fn(state)
        torch.cuda.synchronize()
        trace_wall = (time.perf_counter() - w0) * 1e3
    rows = sorted(((getattr(e, "self_device_time_total", 0.0) / 1e3, e.key,
                    e.count) for e in prof.key_averages()), reverse=True)
    rows = [r for r in rows if r[0] > 0]
    busy = sum(r[0] for r in rows)
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"tree": str(tree), "tiled": tiled, "chunk": 0, "card": card(),
            "build_s": build_s,
            "warmup_iterations": warmup,
            "ms_median": med, "ms": times, "wall_ms": wall,
            "trace_wall_ms": trace_wall,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / trace_wall,
            "device_idle_share_unprofiled": 1.0 - busy / med["iteration"],
            "top_device_ms": [[round(ms, 4), k[:60], n]
                              for ms, k, n in rows[:8]]}


def measure_chunk(tree: Path, tiled: bool, n: int, it_fn, state,
                  build_s: float, warmup: int) -> dict:
    """The rest of a `--chunk N` turn: the iteration n at a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from madrona_basketball_tpu_torch.ppo.train import make_train_chunk
    chunk = make_train_chunk(it_fn, n)
    t0 = time.perf_counter()
    state, _ = chunk(state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    its = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, _ = chunk(state)
        b.record()
        torch.cuda.synchronize()
        its.append(a.elapsed_time(b) / n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        state, _ = chunk(state)
        torch.cuda.synchronize()
        trace_wall = (time.perf_counter() - w0) * 1e3 / n
    rows = sorted(((getattr(e, "self_device_time_total", 0.0) / 1e3 / n,
                    e.key, e.count) for e in prof.key_averages()),
                  reverse=True)
    rows = [r for r in rows if r[0] > 0]
    busy = sum(r[0] for r in rows)
    med = statistics.median(its)
    return {"tree": str(tree), "tiled": tiled, "chunk": n, "card": card(),
            "build_s": build_s, "warmup_iterations": warmup,
            "first_chunk_s": first_s,
            "ms_median": {"iteration": med}, "ms": {"iteration": its},
            "trace_wall_ms": trace_wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / trace_wall,
            "device_idle_share_unprofiled": 1.0 - busy / med,
            "top_device_ms": [[round(ms, 4), k[:60], c]
                              for ms, k, c in rows[:8]]}


def measure_multistep(tree: Path, K: int = 5000) -> dict:
    """One turn of `--multistep`, with the port imported from `tree`."""
    sys.path.insert(0, str(tree))
    import torch
    import madrona_basketball_tpu_torch as port
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.config import SimConfig
    from madrona_basketball_tpu_torch.engine import init_rows
    from madrona_basketball_tpu_torch.ops import fused_step as FS
    if Path(port.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"imported the port from {port.__file__}, not "
                         f"{tree}")
    if not torch.cuda.is_available():
        raise SystemExit("iteration_ab: needs one CUDA card")
    t0 = time.perf_counter()
    _build.build(["fused_multistep"])
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda:0")
    cfg = SimConfig()
    sf, si = init_rows(cfg, 8192, torch.Generator(device=dev).manual_seed(0),
                       dev)
    ms = {}
    for name, every in (("every_tick_obs", True), ("held_obs", False)):
        kw = dict(obs_every_tick=every, blank_agent=0 if every else None)
        FS.fused_multistep(cfg, sf, si, K, seed=1, **kw)
        torch.cuda.synchronize()
        best = float("inf")
        for seed in (2, 3, 4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = FS.fused_multistep(cfg, sf, si, K, seed=seed, **kw)
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b))
        if not bool(torch.isfinite(out[0]).all()):
            raise SystemExit("iteration_ab: kernel F gave non-finite state")
        ms[name] = best
    return {"tree": str(tree), "multistep": True, "card": card(),
            "build_s": build_s, "ticks": K, "launch_ms": ms}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=False)
    ap.add_argument("--turns", default="other,this,this,other")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--tiled", action="store_true")
    mode.add_argument("--multistep", action="store_true")
    ap.add_argument("--chunk", type=int, default=0,
                    help="time this tree's iteration N at a time")
    ap.add_argument("--measure", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        line = measure_multistep(args.measure) if args.multistep else \
            measure(args.measure, args.tiled, args.chunk)
        print(json.dumps(line), flush=True)
        return
    if args.other is None:
        raise SystemExit("iteration_ab: --other DIR is required")
    trees = {"this": ROOT, "other": args.other.resolve()}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    results = {"this": [], "other": []}
    for turn in args.turns.split(","):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             str(trees[turn])] + ["--tiled"] * args.tiled +
            ["--multistep"] * args.multistep +
            ["--chunk", str(args.chunk)] * (turn == "this"),
            cwd=trees[turn], env=env,
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"turn {turn} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["turn"] = turn
        results[turn].append(line)
        print(json.dumps(line), flush=True)
    if args.multistep:
        print(json.dumps({"multistep_ab": {
            name: {"turns": len(rs), "launch_ms": [r["launch_ms"]
                                                   for r in rs]}
            for name, rs in results.items() if rs}, "card": card()}),
            flush=True)
        return
    summary = {name: {
        "turns": len(rs), "chunk": rs[0]["chunk"],
        "iteration_ms": [r["ms_median"]["iteration"] for r in rs],
        "span_ms_median": {k: statistics.median(r["ms_median"][k]
                                                for r in rs)
                           for k in rs[0]["ms_median"]},
        "device_idle_share": [r["device_idle_share"] for r in rs],
        "device_idle_share_unprofiled": [
            r["device_idle_share_unprofiled"] for r in rs],
        "device_busy_ms": [r["device_busy_ms"] for r in rs]}
        for name, rs in results.items() if rs}
    print(json.dumps({"iteration_ab": summary, "tiled": args.tiled,
                      "chunk": args.chunk, "card": card()}), flush=True)


if __name__ == "__main__":
    main()
