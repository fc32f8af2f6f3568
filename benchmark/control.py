"""The readings that the limits of `correct` are set from, at a cell's own
size: the program's numbers over many seeds (the lower readings), and on
a few of them the control and the planted faults (the upper readings).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3

The control is the reference put in the program's place and computed in
the nearest precision below the one the configuration states (TF32 for
float32 with TF32 off).  Each fault is planted in the reference put in
the program's place: for training
"half_batch" (every minibatch's gradient taken over half of its blocks,
the mean over the rest), for evaluation "action_altered" (world 0's
first sampled action changed where it is produced).  One JSON line a
seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def half_batch(update_phase):
    """update_phase with each minibatch's second half of blocks replaced by
    its first half."""
    def wrapped(hp, idx, count, traj, side, nrm, ustats, params, mu, nu, *,
                wb):
        bpm = hp.minibatch_size // wb
        n = bpm // 2
        idx = idx.clone().reshape(-1, bpm)
        idx[:, n:2 * n] = idx[:, :n]
        return update_phase(hp, idx.reshape(-1), count, traj, side, nrm,
                            ustats, params, mu, nu, wb=wb)
    return wrapped


def action_altered(greedy_actions):
    """greedy_actions with world 0's first action changed."""
    def wrapped(logits):
        acts = greedy_actions(logits).clone()
        acts[0, 0] = 1 - acts[0, 0].clamp(max=1)
        return acts
    return wrapped


# each driver's faults: (module of the reference, attribute, wrapper)
FAULTS = {"train": {"half_batch": ("iteration", "update_phase", half_batch)},
          "eval": {"action_altered": ("eval", "greedy_actions",
                                      action_altered)},
          "step": {}}


def fault_steps(run, driver: str, name: str) -> list:
    """The reference with the fault planted, in the program's place."""
    import importlib
    mod_name, attr, wrap = FAULTS[driver][name]
    mod = importlib.import_module(f"benchmark.reference.{mod_name}")
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    try:
        return run.reference_steps("float32")
    finally:
        setattr(mod, attr, orig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run as B
    plan = B.cell_plan(json.loads((ROOT / "BENCHMARK.json").read_text()),
                       args.workload)
    B.use_checkout_caches()
    B.set_precision(plan["config"])
    drv = plan["traffic"]["driver"]
    driver = B.load_module(B.HERE / "drivers" / f"{drv}.py", "driver")
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = driver.Run(plan["config"], plan["traffic"], seed, args.device)
        run.free()
        line = {"workload": args.workload, "seed": seed,
                "program": run.check()}
        if seed in args.control_seeds:
            line[f"control_{driver.CONTROL}"] = run.check(
                run.reference_steps(driver.CONTROL))
            for name in FAULTS[drv]:
                line[f"fault_{name}"] = run.check(fault_steps(run, drv,
                                                              name))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run


if __name__ == "__main__":
    main()
