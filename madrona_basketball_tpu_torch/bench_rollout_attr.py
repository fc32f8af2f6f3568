"""Kernel B's time attribution: the timing probes against the full kernel
(the port's counterpart of the root `bench_rollout_attr.py`).

    python -m madrona_basketball_tpu_torch.bench_rollout_attr [W] [--quick]
        [--ticks T] [--device cpu]

Each probe of `ops/fused_rollout.py::fused_rollout` (kernel B's probe
instances, csrc/fused_rollout_probe.cu) takes one cost term out of the
rollout, so its difference from the full kernel attributes that term:

    full          the flagship's kernel B
    sim_only      - both policies' forward and the sampling
    policy_only   - the 19-system sim tick
    no_traj       - the per-tick trajectory writes
    no_prng       - the in-kernel Philox draws (47 a world-tick)
    bf16_mm       full with policy_bf16 (the bf16 tensor-core policy)
    bf16_traj     full with the trajectory stored in bf16

at W worlds (default 8192) x T ticks (32), trainee 1, the frozen opponent
on, from `init_train_state(seed=1)`, in-kernel Philox with seed 7; then
(unless --quick) the full kernel at T = 1, 4, 16 and 32, with the
least-squares per-tick and per-launch fit.  On the card every time,
delta and fit is the rollout kernel's own device time a call
(torch.profiler over 25 calls after a warm-up call: the kernels named
fused_rollout*, mean over the launches it recorded), which the host's
speed does not move.  Beside it, as a per-call cost only, the wrapper's
time (the median over 5 CUDA-event windows of 5 back-to-back calls):
it adds the wrapper's copies of the state and, where the host takes
longer to issue a call than the card to run it, the host's time, so no
attribution is taken from it.  Probes break the training semantics, so
only this bench and chip_smoke.py launch them.

Prints one line a variant, the four deltas and the two bf16 savings, the
T-sweep, and ends with one JSON line (the card's name and power limit,
every time, the launches each kernel instance counted).  A variant that
fails raises: the exit code is non-zero.  `--device cpu` runs the plain
versions (the host clock over one call, a small W; no wrapper column);
its numbers are CPU times, not device metrics.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from .bench import card_name_and_power_limit
from .config import SimConfig
from .ops import fused_rollout as FR
from .ppo.hparams import PPOParams
from .ppo.train_fused import init_train_state

SEED = 7            # the root script's in-kernel seed
TRAINEE = 1
T_SWEEP = (1, 4, 16, 32)
REPS, WINDOWS = 5, 5  # the wrapper's calls a window, windows a time
# variant: fused_rollout's keyword arguments
VARIANTS = {"full": {},
            "sim_only": {"probe": "sim_only"},
            "policy_only": {"probe": "policy_only"},
            "no_traj": {"probe": "no_traj"},
            "no_prng": {"probe": "no_prng"},
            "bf16_mm": {"policy_bf16": True},
            "bf16_traj": {"traj_dtype": torch.bfloat16}}
# delta name: the probe whose difference from full attributes it
DELTAS = {"policy_and_sampling": "sim_only", "sim_tick": "policy_only",
          "traj_writes": "no_traj", "prng_draws": "no_prng"}
SAVINGS = {"bf16_matmuls": "bf16_mm", "bf16_traj_store": "bf16_traj"}


def median_ms(fn, dev, reps: int, windows: int) -> float:
    """Median over `windows` of the mean time of `reps` back-to-back fn()
    calls (CUDA events on the card, the host clock on the CPU), after one
    warm-up call."""
    fn()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    out = []
    for _ in range(windows):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        else:
            t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if cuda:
            b.record()
            torch.cuda.synchronize(dev)
            out.append(a.elapsed_time(b) / reps)
        else:
            out.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(out)


def kernel_ms(fn, dev, reps: int) -> float:
    """Device time of the rollout kernel a fn() call: torch.profiler over
    `reps` calls after a warm-up call, the mean over the launches it
    recorded of the CUDA kernels named fused_rollout* (kernel B and its
    probe and bf16 instances)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    hits = [e for e in prof.key_averages() if "fused_rollout" in e.key]
    n = sum(e.count for e in hits)
    us = sum(e.self_device_time_total for e in hits)
    if not 1 <= n <= reps or us <= 0:
        raise RuntimeError(f"the profiler recorded {n} rollout launches "
                           f"({us} us) of {reps}")
    return us / n / 1e3


def variant_ms(fn, dev):
    """(time, wrapper time) of one fn() call: on the card the rollout
    kernel's device time and the wrapper's CUDA-event time; on the CPU
    the plain version's host time and None."""
    if dev.type != "cuda":
        return median_ms(fn, dev, 1, 1), None
    return kernel_ms(fn, dev, REPS * WINDOWS), \
        median_ms(fn, dev, REPS, WINDOWS)


def fit_line(points):
    """Least-squares (slope, intercept) of ms against T."""
    n = len(points)
    mx = sum(t for t, _ in points) / n
    my = sum(m for _, m in points) / n
    sxx = sum((t - mx) ** 2 for t, _ in points)
    slope = sum((t - mx) * (m - my) for t, m in points) / sxx
    return slope, my - slope * mx


def reset_counts():
    FR.launches = 0
    FR.probe_launches = dict.fromkeys(FR.probe_launches, 0)
    FR.bf16_launches = dict.fromkeys(FR.bf16_launches, 0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("worlds", nargs="?", type=int, default=8192)
    ap.add_argument("--quick", action="store_true",
                    help="skip the T-sweep")
    ap.add_argument("--ticks", type=int, default=PPOParams.num_rollout_steps)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_rollout_attr: no CUDA card (pass "
                             "--device cpu for the plain versions)")
        name, power = card_name_and_power_limit()
        timing = ("torch.profiler device time of the fused_rollout* "
                  f"kernels, mean over {REPS * WINDOWS} calls after a "
                  "warm-up call; wrapper_*: the wrapper's per-call time, "
                  f"median of {WINDOWS} CUDA-event windows of {REPS} "
                  "back-to-back calls")
    else:
        name, power = str(dev), None
        timing = "host clock of one plain-version call after a warm-up"
    W, T = args.worlds, args.ticks
    cfg = SimConfig()
    hp = PPOParams(num_envs=W, num_rollout_steps=T, use_frozen=True)
    ts = init_train_state(cfg, hp, seed=1, device=dev)
    mats, fmats = FR.pack_policy(ts.agent), FR.pack_policy(ts.frozen)

    def call(n_steps, **kw):
        return lambda: FR.fused_rollout(cfg, ts.sf, ts.si, ts.obs, mats,
                                        fmats, n_steps=n_steps,
                                        trainee_idx=TRAINEE, seed=SEED, **kw)

    def show(label, m, wm, n_steps):
        print(f"[attr] {label:12s} {m:9.4f} ms  "
              f"({W * n_steps / m / 1e3:.0f}M env-steps/s)"
              + ("" if wm is None else f"  wrapper {wm:.4f} ms a call"),
              flush=True)

    reset_counts()
    ms, wms = {}, {}
    for label, kw in VARIANTS.items():
        ms[label], wms[label] = variant_ms(call(T, **kw), dev)
        show(label, ms[label], wms[label], T)
    full = ms["full"]
    deltas = {k: full - ms[v] for k, v in DELTAS.items()}
    savings = {k: full - ms[v] for k, v in SAVINGS.items()}
    print(f"[attr] --- attribution at W={W}, T={T} (deltas vs full "
          f"{full:.4f} ms) ---", flush=True)
    for k, d in deltas.items():
        print(f"[attr]   {k:20s} ~{d:8.4f} ms ({100 * d / full:.0f}%)",
              flush=True)
    for k, d in savings.items():
        print(f"[attr]   {k:20s} saves {d:8.4f} ms -> "
              f"{ms[SAVINGS[k]]:.4f} ms", flush=True)
    sweep, wsweep, per_tick, per_launch = None, None, None, None
    if not args.quick:
        print("[attr] --- T-sweep (full kernel) ---", flush=True)
        sweep, wsweep = [], []
        for t_len in T_SWEEP:
            m, wm = variant_ms(call(t_len), dev)
            sweep.append([t_len, m])
            wsweep.append([t_len, wm])
            show(f"T={t_len}", m, wm, t_len)
        per_tick, per_launch = fit_line(sweep)
        print(f"[attr] per-tick {per_tick * 1e3:.2f} us, per-launch "
              f"{per_launch:.4f} ms (least squares)", flush=True)
    cuda = dev.type == "cuda"
    line = {"metric": f"rollout_attr_ms_{W}", "worlds": W, "ticks": T,
            "trainee": TRAINEE, "frozen": True, "seed": SEED,
            "variants_ms": ms, "deltas_vs_full_ms": deltas,
            "delta_shares": {k: d / full for k, d in deltas.items()},
            "bf16_savings_ms": savings, "t_sweep_ms": sweep,
            "per_tick_ms": per_tick, "per_launch_ms": per_launch,
            "wrapper_ms": wms if cuda else None,
            "wrapper_t_sweep_ms": wsweep if cuda else None,
            "launches": {"fused_rollout": FR.launches,
                         "probe": dict(FR.probe_launches),
                         "bf16": dict(FR.bf16_launches)},
            "timing": timing, "device": name, "power_limit": power}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
