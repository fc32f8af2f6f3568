"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json.  Its configuration
file (`configs`' `file`) holds the sizes as they are run; its traffic
file `benchmark/traffic/<traffic>.json` names the driver
(`benchmark/drivers/<driver>.py`) and its parameters and limits; each
per-layer metric is read by `benchmark/metrics/<metric>.py`.  The run
makes its inputs and weights from the seed, times the window with the
end-to-end metrics (--trace 0) or reads the per-layer metrics from a
traced run (--trace 1), holds the timed path's output against the plain
reference (`benchmark/reference/`), and prints one JSON line last on
standard output.  It refuses to run without a card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "madrona_basketball_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(manifest: dict, workload: str) -> dict:
    """The cell's entry, its configuration and traffic files, and the
    names of the metrics it reports (with --trace 0 and with --trace 1)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]

    def ours(m):
        return workload in m.get("workloads", [workload])
    return {
        "cell": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" /
                               f"{cell['traffic']}.json").read_text()),
        "end_to_end": [m for m in manifest["end_to_end"] if ours(m)],
        "per_layer": [m for m in manifest["per_layer"] if ours(m)],
    }


def use_checkout_caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = HERE / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def set_precision(config: dict):
    """torch's TF32 flags as the configuration's policy block states."""
    import torch
    tf32 = bool(config["policy"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def run_cell(plan: dict, seed: int, seconds: float, trace: bool, device,
             setup_started: float) -> dict:
    """Set up, time the window, read the metrics, check the output.
    Returns the result line's object."""
    import torch
    set_precision(plan["config"])
    traffic = plan["traffic"]
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                         f"benchmark_driver_{traffic['driver']}")
    cuda = torch.device(device).type == "cuda"
    run = driver.Run(plan["config"], traffic, seed, device)
    setup_s = time.perf_counter() - setup_started
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window = run.window(seconds)
    ctx = {"run": run, "plan": plan, "window": window, "trace": None}
    metrics = {}
    if trace:
        from benchmark import trace as tr
        tw = run.trace_window()
        ctx["trace"] = summary = tr.summarize(tw["prof"], tw["window_s"])
        summary.update((k, v) for k, v in tw.items()
                       if k not in ("prof", "window_s"))
        for m in plan["per_layer"]:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"benchmark_metric_{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in plan["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else \
                window.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.free()
    t_check = time.perf_counter()
    numbers = run.check()
    print(f"check took {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    limits = traffic["limits"]
    check = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in numbers.items())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": window["iterations"],
           "failed": 0, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = ctx["trace"]["busy_s"]
        device_info["window_s"] = ctx["trace"]["window_s"]
        out["breakdown"] = ctx["trace"]["breakdown"]
    out["check"] = check
    return out


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    plan = cell_plan(manifest, args.workload)
    use_checkout_caches()
    import torch
    need = plan["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {need} CUDA card(s); this machine has "
              f"{n}. Nothing was run.", file=sys.stderr)
        return 2
    print(f"card: {nvidia_smi()}", flush=True)
    out = run_cell(plan, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    found = loaded_forbidden()
    if found:
        print(f"the process loaded {found}: the benchmark runs the port "
              f"alone", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
