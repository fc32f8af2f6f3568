#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds kernels A (fused_step), B (fused_rollout), C (fused_gae) and the
meter-scan kernel (meter_scan) from madrona_basketball_tpu_torch/csrc,
holds each against its plain torch version on the card at 8192 worlds,
then drives the port's main path -
`init_rollout_state` and three `collect` iterations of the flagship shape
(8192 worlds x 32 ticks, trainee 1, no frozen opponent, in-kernel Philox
noise) - checks the results, counts the kernel launches of that run and
times every phase with CUDA events.  Each kernel's own device time comes
from torch.profiler, beside the CUDA-event time of back-to-back wrapper
calls and of its plain version.  Every phase prints one JSON line;
any failure raises and the exit code is non-zero.  The last lines are
the per-kernel JSON line, the card's name and power limit, and
{"ok": true, "device": {...}}.

Tolerances: kernels vs plain versions on identical inputs - integers and
sampled actions exact, floats within 1e-4 absolute (GAE: 1e-4 relative to
max(1, |x|)) for the short runs; over 32 ticks of in-kernel Philox noise
at most 0.1% of worlds may diverge in integer state or actions, and every
float of sf', obs' and the trajectory in the other worlds stays within
1e-4 absolute; one 32-tick launch equals 32 one-tick launches bit for bit;
the meter scan within 1e-5 of max(1, |x|).  The whole slice on a small
input (256 worlds x 8 ticks, two iterations) on the card vs the plain
path on the CPU: integer state and actions exact, every float output
within 1e-4 of max(1, |x|).
"""

import copy
import dataclasses
import json
import statistics
import subprocess
import time

W = 8192                    # PPOParams().num_envs, the flagship width
T = 32                      # PPOParams().num_rollout_steps
DEVICE = "cuda:0"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, non-tensor FP32


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Fail(RuntimeError):
    pass


def compare(name, got, want, atol=1e-4, rel=False):
    """Integers exact, floats within atol (relative to max(1,|want|) when
    rel); returns the max abs float error."""
    import torch
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype in (torch.int32, torch.int64):
            bad = int((g != w).sum())
            if bad:
                raise Fail(f"{name}[{i}]: {bad} integer entries differ")
            continue
        if not bool(torch.isfinite(g).all()):
            raise Fail(f"{name}[{i}]: non-finite values")
        d = (g - w).abs()
        e = float(d.max()) if d.numel() else 0.0
        scale = torch.clamp(w.abs(), min=1.0) if rel else 1.0
        if bool((d > atol * scale).any()):
            raise Fail(f"{name}[{i}]: float error {e} above {atol}")
        err = max(err, e)
    return err


def cuda_ms(fn, reps, windows=1):
    """Device time of one fn() call, CUDA events: the mean over `reps`
    back-to-back calls, median over `windows` such windows."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def kernel_ms(fn, reps, kernel):
    """Device time of one launch of the CUDA kernel whose name contains
    `kernel`, from torch.profiler over `reps` calls of fn().  Unlike
    CUDA events around back-to-back calls, it leaves out the time the
    device waits while the host runs the wrapper.  The profiler can drop
    a launch's record (one run saw 19 of 20), so the time is the mean
    over the launches it recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in hits)
    count = sum(e.count for e in hits)
    if not 1 <= count <= reps or total <= 0:
        raise Fail(f"profiler saw {count} launches of {kernel} with "
                   f"{total} us device time, expected 1 to {reps}")
    return total / count / 1e3


def count_ops(fn, *args, **kw):
    """Float arithmetic a plain version issues: elementwise results count
    one op per output element, reductions one per input element.  Used
    for the operation side of each kernel's bound."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    arith = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt", "sin",
             "cos", "exp", "log", "abs", "sign", "clamp", "clamp_min",
             "clamp_max", "maximum", "minimum", "pow", "reciprocal"}
    reduce = {"sum", "mean"}

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            base = func.__name__.split(".")[0].rstrip("_")
            if base in arith and isinstance(out, torch.Tensor) and \
                    out.is_floating_point():
                Counter.n += out.numel()
            elif base in reduce and isinstance(args[0], torch.Tensor):
                Counter.n += args[0].numel()
            return out

    with Counter():
        fn(*args, **kw)
    return Counter.n


def state_to(state, dev):
    """A copy of a RolloutState with every tensor on `dev`."""
    from madrona_basketball_tpu_torch.models.agent import Agent
    from madrona_basketball_tpu_torch.models.normalize import RMSState

    def rms(r):
        return RMSState(mean=r.mean.to(dev), var=r.var.to(dev),
                        count=r.count.to(dev))

    def agent(a):
        return Agent(net=copy.deepcopy(a.net).to(dev), obs_rms=rms(a.obs_rms),
                     value_rms=rms(a.value_rms))
    stats = dataclasses.replace(state.stats, **{
        f.name: getattr(state.stats, f.name).to(dev)
        for f in dataclasses.fields(state.stats)})
    return dataclasses.replace(state, agent=agent(state.agent),
                               frozen=agent(state.frozen),
                               sf=state.sf.to(dev), si=state.si.to(dev),
                               obs=state.obs.to(dev), stats=stats)


def bound(nbytes, nops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA card")
    try:
        import madrona_basketball_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port package is missing ({e})")
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.config import SimConfig
    from madrona_basketball_tpu_torch.engine import init_rows
    from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
    from madrona_basketball_tpu_torch.models.agent import init_agent
    from madrona_basketball_tpu_torch.models.normalize import rms_update
    from madrona_basketball_tpu_torch.ops import fused_gae as FG
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    from madrona_basketball_tpu_torch.ops import fused_step as FS
    from madrona_basketball_tpu_torch.ops.layout import (ACTION_ROWS,
                                                         RESET_ROWS)
    from madrona_basketball_tpu_torch.ppo import train as TT
    from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
    from madrona_basketball_tpu_torch.ppo.train_fused import (
        CollectNoise, init_rollout_state, make_collect)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---------------------------------------------------------- build
    b = _build.build()
    emit({"phase": "build", "seconds": round(b["seconds"], 2),
          "built": b["built"], "ptxas": b["ptxas"]})

    cfg = SimConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    gen_cpu = torch.Generator().manual_seed(0)
    errs = {"fused_step": 0.0, "fused_rollout": 0.0, "fused_gae": 0.0,
            "meter_scan": 0.0}

    # ---------------------------------------------------------- parity A
    sf, si = init_rows(cfg, W, gen, dev)
    k_sf, k_si, p_sf, p_si = sf, si.clone(), sf, si.clone()
    buckets = (2, 8, 3, 2, 2, 2)
    for tick in range(4):
        if tick == 0:
            for r in RESET_ROWS:
                k_si[r] = 1
                p_si[r] = 1
        else:
            for i in range(2):
                for r, n in zip(ACTION_ROWS[i], buckets):
                    a = torch.randint(0, n, (W,), generator=gen, device=dev,
                                      dtype=torch.int32)
                    k_si[r] = a
                    p_si[r] = a
        noise = draw_noise_rows(W, gen, dev)
        k = FS.fused_step(cfg, k_sf, k_si, noise)
        p = FS.step_rows_plain(cfg, p_sf, p_si, noise)
        torch.cuda.synchronize()
        errs["fused_step"] = max(errs["fused_step"],
                                 compare(f"fused_step tick {tick}", k, p))
        k_sf, k_si, p_sf, p_si = k[0], k[1].clone(), p[0], p[1].clone()
        if tick == 0:
            for r in RESET_ROWS:
                k_si[r] = 0
                p_si[r] = 0
    obs0 = k[2]
    emit({"phase": "parity_fused_step", "worlds": W, "ticks": 4,
          "max_abs_err": errs["fused_step"]})

    # ---------------------------------------------------------- parity B
    agent = init_agent(gen_cpu, dev)
    frozen = init_agent(gen_cpu, dev)
    agent.obs_rms = rms_update(agent.obs_rms, obs0[128:256].T)
    mats, fmats = FR.pack_policy(agent), FR.pack_policy(frozen)
    for use_frozen in (False, True):
        Ts = 4
        u = torch.rand((Ts * FR.EXT_NOISE_CHUNK, W), generator=gen,
                       device=dev)
        row = torch.arange(Ts * FR.EXT_NOISE_CHUNK, device=dev) % \
            FR.EXT_NOISE_CHUNK
        ext = torch.where((row < 8)[:, None], 2.0 * u - 1.0, u)
        fm = fmats if use_frozen else None
        k = FR.fused_rollout(cfg, k_sf, k_si, obs0, mats, fm, n_steps=Ts,
                             trainee_idx=1, noise=ext)
        p = FR.rollout_plain(cfg, k_sf, k_si, obs0, mats, fm, n_steps=Ts,
                             trainee_idx=1, noise=ext)
        torch.cuda.synchronize()
        exact = list(range(FR.R_ACT, FR.R_ACT + 6)) + [FR.R_DONE]
        compare("fused_rollout actions", [k[3][:, exact].to(torch.int32)],
                [p[3][:, exact].to(torch.int32)])
        e = compare(f"fused_rollout T={Ts} frozen={use_frozen}", k[:4], p[:4])
        mom_rel = float(((k[4] - p[4]).abs() /
                         torch.clamp(p[4].abs(), min=1.0)).max())
        if mom_rel > 1e-5:
            raise Fail(f"obs moments differ: {mom_rel}")
        errs["fused_rollout"] = max(errs["fused_rollout"], e)
        emit({"phase": "parity_fused_rollout", "worlds": W, "ticks": Ts,
              "frozen": use_frozen, "noise": "external", "max_abs_err": e,
              "obs_moment_rel_err": mom_rel})

    seed = 12345
    k32 = FR.fused_rollout(cfg, k_sf, k_si, obs0, mats, n_steps=T,
                           trainee_idx=1, seed=seed)
    ph_noise = FR.philox_noise(seed, 0, T, W, dev)
    p32 = FR.rollout_plain(cfg, k_sf, k_si, obs0, mats, n_steps=T,
                           trainee_idx=1, noise=ph_noise)
    torch.cuda.synchronize()
    acts = slice(FR.R_ACT, FR.R_ACT + 6)
    div = (k32[1] != p32[1]).any(dim=0) | \
        (k32[3][:, acts] != p32[3][:, acts]).any(dim=0).any(dim=0)
    frac = float(div.float().mean())
    ok = ~div
    e32 = max(float((k32[i][..., ok] - p32[i][..., ok]).abs().max())
              for i in (0, 2, 3))
    if frac > 1e-3:
        raise Fail(f"32-tick Philox rollout: {frac:.4%} of worlds diverged")
    if not e32 <= 1e-4:
        raise Fail(f"32-tick Philox rollout: float error {e32} above 1e-4 "
                   "in the worlds that agree")
    errs["fused_rollout"] = max(errs["fused_rollout"], e32)
    steps = (k_sf, k_si, obs0)
    trajs = []
    for t in range(T):
        o = FR.fused_rollout(cfg, *steps, mats, n_steps=1, trainee_idx=1,
                             seed=seed, tick_base=t)
        steps = o[:3]
        trajs.append(o[3])
    torch.cuda.synchronize()
    composes = all(torch.equal(a, b) for a, b in zip(k32[:3], steps)) and \
        torch.equal(k32[3], torch.cat(trajs))
    if not composes:
        raise Fail("one 32-tick launch != 32 one-tick launches")
    emit({"phase": "parity_fused_rollout", "worlds": W, "ticks": T,
          "noise": "philox", "diverged_world_fraction": frac,
          "max_abs_err_agreeing_worlds": e32, "composes": composes})

    # ---------------------------------------------------------- parity C
    carry = torch.stack([
        -50.0 * torch.rand((W,), generator=gen, device=dev),
        torch.randint(0, 300, (W,), generator=gen, device=dev).float()])
    nv = torch.randn((1, W), generator=gen, device=dev)
    vstats = torch.zeros((1, 8), device=dev)
    vstats[0, 0], vstats[0, 1] = -2.0, 3.0
    gae_args = (k32[3], carry, nv, vstats)
    gae_kw = dict(gamma=0.998, lam=0.95, r_value=FR.R_VALUE, r_rew=FR.R_REW,
                  r_done=FR.R_DONE)
    k = FG.fused_gae(*gae_args, **gae_kw)
    p = FG.gae_plain(*gae_args, **gae_kw)
    torch.cuda.synchronize()
    # the per-block M2 sums of `moments` reach ~1e5, where a different
    # summation order moves the last f32 ulp: hence rel=True
    by_out = {n: compare(f"fused_gae {n}", [k[i]], [p[i]], atol=1e-4,
                         rel=True)
              for i, n in enumerate(("side", "moments", "carry", "ticks"))}
    errs["fused_gae"] = max(by_out.values())
    emit({"phase": "parity_fused_gae", "T": T, "worlds": W,
          "max_abs_err": errs["fused_gae"], "by_output": by_out})

    # ---------------------------------------------------------- meter scan
    # kernel C's per-(block, tick) sums of the 32-tick Philox rollout, with
    # more episode ends than one rollout of a fresh policy gives, so both
    # meters reach their 100-episode window
    ticks = k[3].clone()
    ticks[0, ::4, 0] += 100.0
    ticks[0, ::4, 1] -= 4000.0
    ticks[0, ::4, 2] += 30000.0
    meters0 = torch.tensor([-2.5, 17.0, 140.0, 17.0], device=dev)
    km = TT.meter_scan(ticks, meters0)
    pm = TT.meter_scan_plain(ticks, meters0)
    errs["meter_scan"] = compare("meter_scan", [km], [pm], atol=1e-5,
                                 rel=True)
    if float(km[1]) != 100.0:
        raise Fail(f"meter window {float(km[1])} after the scan, want 100")
    emit({"phase": "parity_meter_scan", "blocks": ticks.shape[0], "T": T,
          "max_abs_err": errs["meter_scan"], "meters": km.tolist()})

    # ---------------------------------------------------------- the slice
    # small input, whole collect on the card vs the plain path on the CPU
    # (which tests/test_torch_collect.py holds against the JAX package):
    # same state, same pulse noise, the rollout on the Philox stream that
    # kernel B draws and `philox_noise` reproduces
    hp_s = PPOParams(num_envs=256, num_rollout_steps=8)
    c_state = init_rollout_state(cfg, hp_s, seed=3, device="cpu")
    g_state = state_to(c_state, dev)
    collect_c = make_collect(cfg, hp_s, device="cpu")
    collect_g = make_collect(cfg, hp_s, device=dev)
    slice_err = 0.0
    for it in range(2):
        pulse = draw_noise_rows(hp_s.num_envs, gen_cpu, "cpu")
        c_state, oc = collect_c(c_state, CollectNoise(pulse=pulse))
        g_state, og = collect_g(g_state, CollectNoise(pulse=pulse.to(dev)))
        torch.cuda.synchronize()
        exact = list(range(FR.R_ACT, FR.R_ACT + 6)) + [FR.R_DONE]
        compare("collect actions", [og["traj"][:, exact].int().cpu()],
                [oc["traj"][:, exact].int()])
        compare("collect state", [g_state.si.cpu()], [c_state.si])
        got = [og["traj"], og["side"], og["ustats"], g_state.sf, g_state.obs]
        want = [oc["traj"], oc["side"], oc["ustats"], c_state.sf, c_state.obs]
        for key in ("obs_rms", "value_rms"):
            for f in ("mean", "var", "count"):
                got.append(getattr(og[key], f))
                want.append(getattr(oc[key], f))
        for f in dataclasses.fields(og["stats"]):
            got.append(getattr(og["stats"], f.name))
            want.append(getattr(oc["stats"], f.name))
        got += [og["metrics"][k] for k in sorted(oc["metrics"])]
        want += [oc["metrics"][k] for k in sorted(oc["metrics"])]
        slice_err = max(slice_err, compare(
            f"collect iteration {it}", [g.cpu() for g in got], want,
            atol=1e-4, rel=True))
    emit({"phase": "parity_collect", "worlds": hp_s.num_envs,
          "ticks": hp_s.num_rollout_steps, "iterations": 2,
          "reference": "plain path on the CPU",
          "max_err_rel_to_max_1_abs": slice_err})

    # ---------------------------------------------------------- main path
    hp = PPOParams(num_envs=W, num_rollout_steps=T)
    state = init_rollout_state(cfg, hp, seed=1, device=dev)
    collect = make_collect(cfg, hp, device=dev)
    # Warm-up iterations, also placed so that the 10 s game clock (620
    # ticks, every world started together) expires inside the timed
    # window: with a fresh random policy few tag episodes end sooner.
    clock_ticks = int(cfg.time_per_period * 62)       # 62 Hz sim
    warmup = max(1, clock_ticks // (T + 1) - 1)
    for _ in range(warmup):
        state, _ = collect(state)
    torch.cuda.synchronize()
    n0_obs = float(state.agent.obs_rms.count)
    n0_val = float(state.agent.value_rms.count)
    FS.launches = FR.launches = FG.launches = TT.launches = 0
    times = {k: [] for k in ("reset_pulse", "rollout", "gae", "glue",
                             "collect")}
    wall, dones = [], 0.0
    for it in range(3):
        evs = [torch.cuda.Event(enable_timing=True)]

        def mark(name, evs=evs):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            evs.append(e)

        t0 = time.perf_counter()
        evs[0].record()
        state, out = collect(state, mark=mark)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        for name, a, b_ in zip(("reset_pulse", "rollout", "gae", "glue"),
                               evs[:-1], evs[1:]):
            times[name].append(a.elapsed_time(b_))
        times["collect"].append(evs[0].elapsed_time(evs[-1]))
        for key in ("traj", "side", "ustats"):
            if not bool(torch.isfinite(out[key]).all()):
                raise Fail(f"main path: non-finite {key}")
        for key in ("obs_rms", "value_rms"):
            for f in ("mean", "var"):
                if not bool(torch.isfinite(getattr(out[key], f)).all()):
                    raise Fail(f"main path: non-finite {key}.{f}")
        dones += float(out["traj"][:, FR.R_DONE].sum())
    launches = {"fused_step": FS.launches, "fused_rollout": FR.launches,
                "fused_gae": FG.launches, "meter_scan": TT.launches}
    if min(launches.values()) < 1:
        raise Fail(f"main path skipped a kernel: {launches}")
    d_obs = float(state.agent.obs_rms.count) - n0_obs
    d_val = float(state.agent.value_rms.count) - n0_val
    if d_obs != 3 * T * W or d_val != 3 * 2 * T * W:
        raise Fail(f"normalizer counts grew by {d_obs}, {d_val}")
    if dones <= 0:
        raise Fail("no episode ended in 3 iterations")
    med = {k: statistics.median(v) for k, v in times.items()}
    m = {k: float(v) for k, v in out["metrics"].items()}
    emit({"phase": "main_path", "worlds": W, "ticks": T, "iterations": 3,
          "launches": launches, "ms_median": med,
          "wall_ms": wall, "env_steps_per_s": W * T / (med["collect"] / 1e3),
          "done_count": dones, "obs_rms_count_delta": d_obs,
          "value_rms_count_delta": d_val, "metrics": m})

    # ---------------------------------------------------------- trace
    # one more collect under torch.profiler: device busy share and the
    # kernels by device time (after the counted run, so not in `launches`)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = collect(state)
        torch.cuda.synchronize()
        trace_wall = (time.perf_counter() - t0) * 1e3
    rows_t = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.key,
               e.count) for e in prof.key_averages()]
    rows_t = sorted([r for r in rows_t if r[0] > 0], reverse=True)
    busy = sum(r[0] for r in rows_t)
    emit({"phase": "trace", "wall_ms": trace_wall,
          "device_busy_ms": busy if busy else None,
          "device_idle_share": (1.0 - busy / trace_wall) if busy else None,
          "top_device_ms": [[round(ms, 4), k[:60], n]
                            for ms, k, n in rows_t[:8]]})

    # ---------------------------------------------------------- kernel times
    pulse_si = state.si.clone()
    for r in RESET_ROWS:
        pulse_si[r] = 1
    pulse_noise = draw_noise_rows(W, gen, dev)
    a_args = (cfg, state.sf, pulse_si, pulse_noise)
    mats = FR.pack_policy(state.agent)
    r_args = (cfg, state.sf, state.si, state.obs, mats)
    g_args = (out["traj"], torch.stack([state.stats.curr_rewards,
                                        state.stats.episode_lengths]),
              nv, vstats)
    ph_noise = FR.philox_noise(seed, 0, T, W, dev)
    m_args = (ticks, meters0)
    # name: (wrapper call, plain call, reps, plain reps)
    calls = {
        "fused_step": (lambda: FS.fused_step(*a_args),
                       lambda: FS.step_rows_plain(*a_args), 20, 2),
        "fused_rollout": (
            lambda: FR.fused_rollout(*r_args, n_steps=T, trainee_idx=1,
                                     seed=seed),
            lambda: FR.rollout_plain(*r_args, n_steps=T, trainee_idx=1,
                                     noise=ph_noise), 5, 1),
        "fused_gae": (lambda: FG.fused_gae(*g_args, **gae_kw),
                      lambda: FG.gae_plain(*g_args, **gae_kw), 20, 2),
        "meter_scan": (lambda: TT.meter_scan(*m_args),
                       lambda: TT.meter_scan_plain(*m_args), 20, 2),
    }
    # ms: the kernel's own device time; wrapper_ms: CUDA events around
    # back-to-back wrapper calls (median of 5 windows), which also holds
    # the device's wait for the host; plain_ms: the plain version
    ms = {name: (kernel_ms(k, reps, name + "_kernel"),
                 cuda_ms(k, reps, 5), cuda_ms(p, p_reps))
          for name, (k, p, reps, p_reps) in calls.items()}

    # bounds: bytes each input read once / each output written once, and
    # the plain versions' float arithmetic counted at a small width
    cpu = torch.device("cpu")
    ws = 64
    sf_s, si_s = init_rows(cfg, ws, torch.Generator().manual_seed(0), cpu)
    n_s = draw_noise_rows(ws, torch.Generator().manual_seed(1), cpu)
    ops_a = count_ops(FS.step_rows_plain, cfg, sf_s, si_s, n_s) / ws
    obs_s = torch.zeros((256, ws))
    mats_s = FR.pack_policy(init_agent(torch.Generator().manual_seed(0),
                                       cpu))
    ops_b = count_ops(FR.rollout_plain, cfg, sf_s, si_s, obs_s, mats_s,
                      n_steps=1, trainee_idx=1,
                      noise=FR.philox_noise(0, 0, 1, ws, cpu)) / ws
    tr_s = torch.zeros((4, 128, ws))
    ops_c = count_ops(FG.gae_plain, tr_s, torch.zeros((2, ws)),
                      torch.zeros((1, ws)), torch.zeros((1, 8)),
                      **gae_kw) / (ws * 4)
    ops_m = count_ops(TT.meter_scan_plain, ticks.cpu(), meters0.cpu())
    nb = ticks.shape[0]
    bytes_a = W * (9 + 72 + 59) * 4 + W * (72 + 59 + 256) * 4
    bytes_b = (W * (72 + 59 + 256) * 4 * 2 + FR.POLICY_FLOATS * 4 +
               T * 128 * W * 4 + T * (W // 32) * FR.ROLL_OBS * 2 * 4)
    bytes_c = (3 * T * W * 4 + 3 * W * 4 + 8 * 4 + T * 8 * W * 4 +
               2 * W * 4 + nb * 8 * 4 + nb * T * 8 * 4)
    bytes_m = nb * T * 8 * 4 + 4 * 4 + 4 * 4
    rows = []
    for name, src, rep, nbytes, nops in (
            ("fused_step", "madrona_basketball_tpu_torch/csrc/fused_step.cu",
             "madrona_basketball_tpu/ops/fused_step.py:1034", bytes_a,
             ops_a * W),
            ("fused_rollout",
             "madrona_basketball_tpu_torch/csrc/fused_rollout.cu",
             "madrona_basketball_tpu/ops/fused_rollout.py:239", bytes_b,
             ops_b * W * T),
            ("fused_gae", "madrona_basketball_tpu_torch/csrc/fused_gae.cu",
             "madrona_basketball_tpu/ops/fused_gae.py:58", bytes_c,
             ops_c * W * T),
            # no Pallas kernel: the XLA scan of the fused iteration
            ("meter_scan", "madrona_basketball_tpu_torch/csrc/meter_scan.cu",
             "madrona_basketball_tpu/ppo/train_fused.py:611", bytes_m,
             ops_m)):
        bms, by = bound(nbytes, nops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms[name][0],
                     "wrapper_ms": ms[name][1],
                     "plain_ms": ms[name][2], "bound_ms": bms,
                     "bound_by": by, "library_ms": None,
                     "bytes": nbytes, "ops": nops})
    emit({"phase": "kernel_times", "note": "library_ms is null: no single "
          "PyTorch call computes a sim tick, a rollout, this GAE pass or "
          "the meter recursion"})
    emit({"kernels": rows})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
