"""Env-stepping throughput: the port's counterpart of the root `bench.py`
(bench.py:88-215), which is the reference's only performance harness
(`scripts/run.py`: blank-action stepping FPS at N worlds).

    python -m madrona_basketball_tpu_torch.bench [worlds] [--device cpu]

Engines (a)-(c) run all 19 systems with the observations written on every
tick and the trainee's (agent 0) actions zeroed before every tick, the
scripts/run.py workload, at `worlds` worlds of `SimConfig()` (1v1 tag):

  (a) kernel_a_dispatch - kernel A from a host loop, the trainee's action
      rows zeroed and the noise drawn each tick (it stands in for both of
      the JAX loop engines: the port has no pytree engine);
  (b) kernel_a_cuda_graph - 500 ticks of (a) captured once in a CUDA
      graph and replayed, the counterpart of one jitted `lax.scan`
      dispatch; the noise generator is registered with the graph;
  (c) kernel_f_every_tick_obs - kernel F, K ticks per launch (5000),
      obs every tick, agent 0 blanked in-kernel (the headline engine);
  (d) kernel_f_held_obs - kernel F with obs on the last tick only and no
      blanked agent (the JAX bench's held variant, the eval-burst shape):
      a lighter workload, reported on stderr, left out of the headline.

Each engine is timed over 3 rounds of chained launches (each consumes the
previous one's state), synchronized with torch.cuda.synchronize(); the best
round counts.  Stdout gets one JSON line:
  {"metric": "env_steps_per_sec_<W>", "value", "unit": "steps/s",
   "method", "device", "power_limit"}
with the best of (a)-(c); each engine gets a JSON line on stderr with the
same device name and power limit, and its kernel launches.  On the card a
failed engine is reported as failed (and the run exits 1), never replaced.
`--device cpu` runs the plain versions at a small size (2 ticks a round)
and skips (b); its numbers are CPU times, not device metrics.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .config import SimConfig
from .engine import init_rows
from .engine_fused import draw_noise_rows
from .ops import fused_step as FS
from .ops.layout import ACTION_ROWS

ROUNDS = 3
GRAPH_TICKS = 500


def card_name_and_power_limit():
    """(name, power limit) as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_round(dev, run):
    """Seconds of the fastest of ROUNDS calls of run()."""
    best = float("inf")
    for _ in range(ROUNDS):
        _sync(dev)
        t0 = time.perf_counter()
        run()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _launches():
    return {"fused_step": FS.launches, **FS.multistep_launches}


def _delta(before):
    return {k: v - before[k] for k, v in _launches().items()
            if v != before[k]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("worlds", nargs="?", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    W, cfg = args.worlds, SimConfig()
    on_card = dev.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA card (pass --device cpu for "
                             "the plain versions)")
        name, power = card_name_and_power_limit()
    else:
        name, power = str(dev), None
    n_disp = 250 if on_card else 2      # engine (a)'s ticks per round
    K = 5000 if on_card else 2          # kernel F's ticks per launch

    gen = torch.Generator(device=dev).manual_seed(0)
    sf0, si0 = init_rows(cfg, W, gen, dev)
    blank = torch.tensor(ACTION_ROWS[0], device=dev)
    results, failed = {}, []

    def report(engine, ticks, seconds, launches, **extra):
        fps = ticks * W / seconds
        results[engine] = fps
        print(json.dumps({"engine": engine, "env_steps_per_s": fps,
                          "worlds": W, "ticks_per_round": ticks,
                          "best_round_s": seconds, "launches": launches,
                          "device": name, "power_limit": power, **extra}),
              file=sys.stderr, flush=True)

    def tick(sf, si):
        si.index_fill_(0, blank, 0)
        sf, si, _ = FS.fused_step(cfg, sf, si, draw_noise_rows(W, gen, dev))
        return sf, si

    # (a) kernel A, host-dispatch loop
    before = _launches()
    st = list(tick(sf0, si0.clone()))

    def run_dispatch():
        for _ in range(n_disp):
            st[:] = tick(*st)
    report("kernel_a_dispatch", n_disp, _best_round(dev, run_dispatch),
           _delta(before))

    # (b) the same ticks captured once in a CUDA graph
    if on_card:
        before = _launches()
        try:
            g_sf, g_si = st[0].clone(), st[1].clone()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):     # warm-up off the capture
                tick(g_sf.clone(), g_si.clone())
            torch.cuda.current_stream(dev).wait_stream(side)
            with torch.cuda.graph(graph):
                a, b = g_sf, g_si
                for _ in range(GRAPH_TICKS):
                    a, b = tick(a, b)
                g_sf.copy_(a)
                g_si.copy_(b)
            graph.replay()
            replays = 4

            def run_graph():
                for _ in range(replays):
                    graph.replay()
            report("kernel_a_cuda_graph", replays * GRAPH_TICKS,
                   _best_round(dev, run_graph), _delta(before),
                   note="launches counted once, at capture")
        except Exception as e:  # reported, never replaced
            failed.append("kernel_a_cuda_graph")
            print(json.dumps({"engine": "kernel_a_cuda_graph",
                              "failed": f"{type(e).__name__}: {e}",
                              "device": name, "power_limit": power}),
                  file=sys.stderr, flush=True)
    else:
        print(json.dumps({"engine": "kernel_a_cuda_graph",
                          "skipped": "no CUDA graphs on the CPU",
                          "device": name, "power_limit": power}),
              file=sys.stderr, flush=True)

    # (c), (d) kernel F, K ticks per launch
    for engine, every in (("kernel_f_every_tick_obs", True),
                          ("kernel_f_held_obs", False)):
        before = _launches()
        seeds = iter(range(1, 1 << 30))
        kw = dict(obs_every_tick=every, blank_agent=0 if every else None)
        ms = list(FS.fused_multistep(cfg, sf0, si0, K, seed=0, **kw))

        def run_multistep():
            for _ in range(3):
                ms[:] = FS.fused_multistep(cfg, ms[0], ms[1], K,
                                           seed=next(seeds), **kw)
        report(engine, 3 * K, _best_round(dev, run_multistep),
               _delta(before), ticks_per_launch=K)

    headline = max(v for k, v in results.items() if k != "kernel_f_held_obs")
    line = {"metric": f"env_steps_per_sec_{W}", "value": headline,
            "unit": "steps/s", "method": "best_of_3_chained",
            "device": name, "power_limit": power}
    print(json.dumps(line), flush=True)
    if failed:
        raise SystemExit(f"bench: {', '.join(failed)} failed")
    return line


if __name__ == "__main__":
    main()
