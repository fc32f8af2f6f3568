#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds every kernel of madrona_basketball_tpu_torch/csrc - A (fused_step),
B (fused_rollout), C (fused_gae), the meter scan (meter_scan) and the
update kernels D, G and H (fused_update) - holds each against its plain
torch version on the card at the flagship shapes, then drives the port's
main path: `init_train_state` and three `train_iteration`s of the
flagship shape (8192 worlds x 32 ticks, then 4 epochs x 4 minibatches of
65536 samples; trainee 1, no frozen opponent, in-kernel Philox noise),
checks the results, counts the kernel launches of that run and times
every phase with CUDA events.  Then 600 training iterations must reach
the JAX package's learning band, and the training CLI runs as a
subprocess and writes a loadable checkpoint.  Each kernel's own device
time comes from torch.profiler, beside the CUDA-event time of
back-to-back wrapper calls and of its plain version.  Every phase prints
one JSON line; any failure raises and the exit code is non-zero.  The
last lines are the per-kernel JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}.

Tolerances: kernels vs plain versions on identical inputs - integers and
sampled actions exact, floats within 1e-4 absolute (GAE: 1e-4 relative to
max(1, |x|)) for the short runs; over 32 ticks of in-kernel Philox noise
at most 0.1% of worlds may diverge in integer state or actions, and every
float of sf', obs' and the trajectory in the other worlds stays within
1e-4 absolute; one 32-tick launch equals 32 one-tick launches bit for bit;
the meter scan within 1e-5 of max(1, |x|).  The whole collect on a small
input (256 worlds x 8 ticks, two iterations) on the card vs the plain
path on the CPU: integer state and actions exact, every float output
within 1e-4 of max(1, |x|).  Update kernels on a real flagship collect
output: each gradient leaf within 1e-4 of the leaf's largest plain entry
(+ 1e-7); after a phase of 16 Adam steps params within 1e-4 absolute and
mu, nu within 1e-4 of each leaf's largest entry; two launches of D on
identical inputs bit-identical.  Learning: mean reward after 600
iterations in -150..-105 (the JAX package's records on this task,
-133.4 at 600 iterations and a -114..-131 plateau, widened by ~10).
"""

import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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


def kernel_ms(fn, reps, kernels):
    """Device time of one fn() call from torch.profiler over `reps` calls:
    the CUDA kernels whose names contain each key of `kernels`, which one
    call launches kernels[key] times.  Unlike CUDA events around
    back-to-back calls, it leaves out the time the device waits while the
    host runs the wrapper.  The profiler can drop a launch's record (one
    run saw 19 of 20), so each kernel's time is the mean over the launches
    it recorded, times its launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for kernel, per_call in kernels.items():
        hits = [e for e in prof.key_averages() if kernel in e.key]
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in hits)
        count = sum(e.count for e in hits)
        if not 1 <= count <= reps * per_call or us <= 0:
            raise Fail(f"profiler saw {count} launches of {kernel} with "
                       f"{us} us device time, expected 1 to "
                       f"{reps * per_call}")
        total += us / count * per_call / 1e3
    return total


def count_ops(fn, *args, **kw):
    """Float arithmetic a plain version issues: elementwise results count
    one op per output element, reductions one per input element, matrix
    products two (a multiply and an add) per multiply-add.  Used for the
    operation side of each kernel's bound."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    arith = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt", "sin",
             "cos", "exp", "log", "abs", "sign", "clamp", "clamp_min",
             "clamp_max", "maximum", "minimum", "pow", "reciprocal"}
    reduce = {"sum", "mean"}
    products = {"mm", "bmm", "addmm"}

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
            elif base in products and out.is_floating_point():
                Counter.n += 2 * args[-2].numel() * args[-1].shape[-1]
                if base == "addmm":
                    Counter.n += out.numel()
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
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    from madrona_basketball_tpu_torch.ops.layout import (ACTION_ROWS,
                                                         RESET_ROWS)
    from madrona_basketball_tpu_torch.ppo import train as TT
    from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
    from madrona_basketball_tpu_torch.ppo.train_fused import (
        CollectNoise, init_rollout_state, init_train_state, make_collect,
        make_train_iteration, update_block)
    from madrona_basketball_tpu_torch.utils import checkpoint as CK

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
            "meter_scan": 0.0, "fused_update_phase": 0.0,
            "fused_minibatch_grad_prefetch": 0.0,
            "fused_minibatch_grad": 0.0}

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

    # ---------------------------------------------------------- parity G, H
    # the update kernels on a real flagship collect output (8192 x 32,
    # the flagship update geometry: E = M = 4, 65536-sample minibatches
    # of wb-wide (tick, world-block) blocks)
    hp = PPOParams(num_envs=W, num_rollout_steps=T)
    wb = update_block(hp)
    bpm = hp.minibatch_size // wb
    n_mb = hp.update_epochs * hp.num_minibatches
    u_state = init_train_state(cfg, hp, seed=7, device=dev)
    u_collect = make_collect(cfg, hp, device=dev)
    for _ in range(2):
        u_state, u_out = u_collect(u_state)
    u_traj, u_side, u_ustats = u_out["traj"], u_out["side"], u_out["ustats"]
    u_nrm = FU.pack_norm(u_out["obs_rms"])
    u_params = FU.pack_weights(u_state.agent.net)
    u_idx = torch.stack([
        torch.randperm(T * W // wb, generator=gen, device=dev)
        for _ in range(hp.update_epochs)]).reshape(-1).to(torch.int32)
    side_n = FU.normalize_side(u_side, u_ustats)
    g_args = (hp, u_idx[:bpm], u_traj, side_n, u_nrm, *u_params)
    # the same samples as a row-major (mb, 113) feat matrix for kernel H
    tb, sb = FU.gather_blocks(u_idx[:bpm], u_traj, side_n, wb)
    feat = torch.cat([tb.T, sb[:3].T], dim=1).contiguous()
    h_args = (hp, feat, u_nrm, *u_params)
    gk = FU.fused_minibatch_grad_prefetch(*g_args, wb=wb)
    gp = FU.minibatch_grad_prefetch_plain(*g_args, wb=wb)
    hk = FU.fused_minibatch_grad(*h_args)
    hpl = FU.minibatch_grad_plain(*h_args)
    torch.cuda.synchronize()

    def grad_err(name, got, want):
        e_max = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            if not bool(torch.isfinite(g).all()):
                raise Fail(f"{name} leaf {i}: non-finite values")
            e = float((g - w).abs().max())
            lim = 1e-4 * float(w.abs().max()) + 1e-7
            if e > lim:
                raise Fail(f"{name} leaf {i}: error {e} above {lim}")
            e_max = max(e_max, e)
        return e_max
    errs["fused_minibatch_grad_prefetch"] = grad_err("kernel G", gk, gp)
    errs["fused_minibatch_grad"] = grad_err("kernel H", hk, hpl)
    emit({"phase": "parity_fused_update_grad", "minibatch": hp.minibatch_size,
          "wb": wb, "max_abs_err": {
              "G": errs["fused_minibatch_grad_prefetch"],
              "H": errs["fused_minibatch_grad"]},
          "leaf_max_abs": [float(w.abs().max()) for w in gp]})

    # ---------------------------------------------------------- parity D
    # two chained phases (the second from Adam count 16 and non-zero
    # moments); each phase gets identical inputs on both sides
    mom = TT.init_adam(u_params)
    d_in = (u_params, mom.mu, mom.nu)
    count, d_err, n_off, bitwise = 0, {}, 0, True
    for phase in range(2):
        args = (hp, u_idx, count, u_traj, u_side, u_nrm, u_ustats)
        dk = FU.fused_update_phase(*args, *d_in, wb=wb)
        dk2 = FU.fused_update_phase(*args, *d_in, wb=wb)
        dp = FU.update_phase_plain(*args, *d_in, wb=wb)
        torch.cuda.synchronize()
        bitwise &= all(torch.equal(a, b) for x, y in zip(dk, dk2)
                       for a, b in zip(x, y))
        for name, ks, ps in zip(("params", "mu", "nu"), dk, dp):
            for i, (k_, p_) in enumerate(zip(ks, ps)):
                if not bool(torch.isfinite(k_).all()):
                    raise Fail(f"kernel D phase {phase} {name}[{i}]: "
                               "non-finite")
                e = float((k_ - p_).abs().max())
                lim = 1e-4 if name == "params" else \
                    1e-4 * float(p_.abs().max())
                if e > lim:
                    raise Fail(f"kernel D phase {phase} {name}[{i}]: error "
                               f"{e} above {lim}")
                d_err[name] = max(d_err.get(name, 0.0), e)
                if name == "params":
                    n_off += int(((k_ - p_).abs() > 1e-5).sum())
        d_in = dp
        count += n_mb
    if not bitwise:
        raise Fail("two launches of kernel D on identical inputs differ")
    errs["fused_update_phase"] = d_err["params"]
    emit({"phase": "parity_fused_update_phase", "epochs": hp.update_epochs,
          "minibatches": hp.num_minibatches, "wb": wb, "phases": 2,
          "adam_count_after": count, "max_abs_err": d_err,
          "params_off_by_more_than_1e-5": n_off,
          "of_params": 2 * FU.N_PARAMS, "bit_identical_relaunch": bitwise})

    # ---------------------------------------------------------- main path
    state = init_train_state(cfg, hp, seed=1, device=dev)
    train_iteration = make_train_iteration(cfg, hp, device=dev)
    # Warm-up iterations, also placed so that the 10 s game clock (620
    # ticks, every world started together) expires inside the timed
    # window: with a fresh random policy few tag episodes end sooner.
    clock_ticks = int(cfg.time_per_period * 62)       # 62 Hz sim
    warmup = max(1, clock_ticks // (T + 1) - 1)
    for _ in range(warmup):
        state, _ = train_iteration(state)
    torch.cuda.synchronize()
    n0_obs = float(state.agent.obs_rms.count)
    n0_val = float(state.agent.value_rms.count)
    p0 = FU.pack_weights(state.agent.net)
    FS.launches = FR.launches = FG.launches = TT.launches = 0
    FU.launches = dict.fromkeys(FU.launches, 0)
    FU.device_launches = 0
    spans = ("reset_pulse", "rollout", "gae", "glue", "update")
    times = {k: [] for k in spans + ("collect", "iteration")}
    wall, dones = [], 0.0
    for it in range(3):
        evs = [torch.cuda.Event(enable_timing=True)]

        def mark(name, evs=evs):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            evs.append(e)

        t0 = time.perf_counter()
        evs[0].record()
        state, out = train_iteration(state, mark=mark)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        for name, a, b_ in zip(spans, evs[:-1], evs[1:]):
            times[name].append(a.elapsed_time(b_))
        times["collect"].append(evs[0].elapsed_time(evs[4]))
        times["iteration"].append(evs[0].elapsed_time(evs[5]))
        for key in ("traj", "side", "ustats"):
            if not bool(torch.isfinite(out[key]).all()):
                raise Fail(f"main path: non-finite {key}")
        for key in ("obs_rms", "value_rms"):
            for f in ("mean", "var"):
                if not bool(torch.isfinite(getattr(out[key], f)).all()):
                    raise Fail(f"main path: non-finite {key}.{f}")
        dones += float(out["traj"][:, FR.R_DONE].sum())
    launches = {"fused_step": FS.launches, "fused_rollout": FR.launches,
                "fused_gae": FG.launches, "meter_scan": TT.launches,
                **FU.launches}
    on_path = ("fused_step", "fused_rollout", "fused_gae", "meter_scan",
               "fused_update_phase")
    if min(launches[k] for k in on_path) < 1:
        raise Fail(f"main path skipped a kernel: {launches}")
    if launches["fused_update_phase"] != 3 or \
            FU.device_launches != 3 * 2 * n_mb:
        raise Fail(f"kernel D: {launches['fused_update_phase']} calls, "
                   f"{FU.device_launches} device launches in 3 iterations")
    p1 = FU.pack_weights(state.agent.net)
    if not all(bool(torch.isfinite(p).all()) for p in p1):
        raise Fail("main path: non-finite params")
    if all(torch.equal(a, b) for a, b in zip(p0, p1)):
        raise Fail("main path: the update left the params unchanged")
    if state.opt.count != n_mb * (warmup + 3):
        raise Fail(f"Adam count {state.opt.count} after {warmup + 3} "
                   "iterations")
    d_obs = float(state.agent.obs_rms.count) - n0_obs
    d_val = float(state.agent.value_rms.count) - n0_val
    if d_obs != 3 * T * W or d_val != 3 * 2 * T * W:
        raise Fail(f"normalizer counts grew by {d_obs}, {d_val}")
    if dones <= 0:
        raise Fail("no episode ended in 3 iterations")
    med = {k: statistics.median(v) for k, v in times.items()}
    m = {k: float(v) for k, v in out["metrics"].items()}
    emit({"phase": "main_path", "worlds": W, "ticks": T,
          "epochs": hp.update_epochs, "minibatches": hp.num_minibatches,
          "iterations": 3, "warmup_iterations": warmup,
          "launches": launches,
          "fused_update_phase_device_launches": FU.device_launches,
          "ms_median": med, "iteration_ms": med["iteration"],
          "train_env_steps_per_s": W * T / (med["iteration"] / 1e3),
          "collect_env_steps_per_s": W * T / (med["collect"] / 1e3),
          "wall_ms": wall, "done_count": dones,
          "adam_count": state.opt.count, "obs_rms_count_delta": d_obs,
          "value_rms_count_delta": d_val, "metrics": m})

    # ---------------------------------------------------------- trace
    # one more iteration under torch.profiler: device busy share and the
    # kernels by device time (after the counted run, so not in `launches`)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = train_iteration(state)
        torch.cuda.synchronize()
        trace_wall = (time.perf_counter() - t0) * 1e3
    rows_t = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.key,
               e.count) for e in prof.key_averages()]
    rows_t = sorted([r for r in rows_t if r[0] > 0], reverse=True)
    busy = sum(r[0] for r in rows_t)
    emit({"phase": "trace", "what": "one train_iteration",
          "wall_ms": trace_wall,
          "device_busy_ms": busy if busy else None,
          "device_idle_share": (1.0 - busy / trace_wall) if busy else None,
          "top_device_ms": [[round(ms, 4), k[:60], n]
                            for ms, k, n in rows_t[:8]]})

    # ---------------------------------------------------------- learning
    # 600 flagship iterations from a fresh policy on the JAX package's
    # canonical task; its records: -133.4 after 600 iterations, a
    # -114..-131 plateau over 10 000 (BENCHMARKS.md)
    l_state = init_train_state(cfg, hp, seed=321, device=dev)
    curve = []
    t0 = time.perf_counter()
    for it in range(1, 601):
        l_state, l_out = train_iteration(l_state)
        if it % 50 == 0:
            lm = l_out["metrics"]
            curve.append([it, float(lm["mean_reward"]),
                          float(lm["mean_episode_length"])])
    l_secs = time.perf_counter() - t0
    if not all(bool(torch.isfinite(p).all())
               for p in FU.pack_weights(l_state.agent.net)):
        raise Fail("learning: non-finite params")
    final = curve[-1][1]
    emit({"phase": "learning", "iterations": 600, "seed": 321,
          "seconds": l_secs, "curve": curve, "final_mean_reward": final,
          "band": [-150.0, -105.0]})
    if not -150.0 <= final <= -105.0:
        raise Fail(f"learning: mean reward {final} after 600 iterations is "
                   "outside -150..-105")

    # ---------------------------------------------------------- cli
    # the training CLI as a user runs it, in a fresh directory inside
    # the checkout's git-ignored build directory
    root = Path(FU.__file__).resolve().parents[2]
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(root), os.environ.get("PYTHONPATH")])))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "madrona_basketball_tpu_torch.cli",
             "--num-iterations", "4", "--log-every-n-iterations", "2",
             "--save-model-every-n-iterations", "4",
             "--model-name", "chip_smoke"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        cli_secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise Fail(f"cli exited {proc.returncode}: "
                       f"{proc.stderr[-3000:]}")
        logs = [ln for ln in proc.stdout.splitlines()
                if ln.startswith(("Update:", "Mean reward", "Model "))]
        path = Path(tmp) / CK.checkpoint_path("chip_smoke", 4)
        saved = torch.load(path, weights_only=True)
        back = CK.state_dict(CK.load_agent(str(path), dev))
        if sorted(back) != sorted(saved) or \
                not all(torch.equal(back[k], saved[k]) for k in saved):
            raise Fail("cli checkpoint does not load back equal")
        if not all(bool(torch.isfinite(v).all()) for v in saved.values()):
            raise Fail("cli checkpoint holds non-finite values")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli", "exit_code": proc.returncode, "seconds": cli_secs,
          "checkpoint": CK.checkpoint_path("chip_smoke", 4),
          "checkpoint_tensors": len(saved), "log": logs})

    # ---------------------------------------------------------- kernel times
    pulse_si = state.si.clone()
    for r in RESET_ROWS:
        pulse_si[r] = 1
    pulse_noise = draw_noise_rows(W, gen, dev)
    a_args = (cfg, state.sf, pulse_si, pulse_noise)
    mats = FR.pack_policy(state.agent)
    r_args = (cfg, state.sf, state.si, state.obs, mats)
    c_args = (out["traj"], torch.stack([state.stats.curr_rewards,
                                        state.stats.episode_lengths]),
              nv, vstats)
    ph_noise = FR.philox_noise(seed, 0, T, W, dev)
    m_args = (ticks, meters0)
    d_args = (hp, u_idx, 0, u_traj, u_side, u_nrm, u_ustats, u_params,
              mom.mu, mom.nu)
    grad_k = {"update_grad_kernel<0>": 1, "update_reduce_kernel": 1}
    # name: (wrapper call, plain call, reps, plain reps, profiled kernels)
    calls = {
        "fused_step": (lambda: FS.fused_step(*a_args),
                       lambda: FS.step_rows_plain(*a_args), 20, 2,
                       {"fused_step_kernel": 1}),
        "fused_rollout": (
            lambda: FR.fused_rollout(*r_args, n_steps=T, trainee_idx=1,
                                     seed=seed),
            lambda: FR.rollout_plain(*r_args, n_steps=T, trainee_idx=1,
                                     noise=ph_noise), 5, 1,
            {"fused_rollout_kernel": 1}),
        "fused_gae": (lambda: FG.fused_gae(*c_args, **gae_kw),
                      lambda: FG.gae_plain(*c_args, **gae_kw), 20, 2,
                      {"fused_gae_kernel": 1}),
        "meter_scan": (lambda: TT.meter_scan(*m_args),
                       lambda: TT.meter_scan_plain(*m_args), 20, 2,
                       {"meter_scan_kernel": 1}),
        "fused_update_phase": (
            lambda: FU.fused_update_phase(*d_args, wb=wb),
            lambda: FU.update_phase_plain(*d_args, wb=wb), 3, 1,
            {k: n_mb for k in grad_k}),
        "fused_minibatch_grad_prefetch": (
            lambda: FU.fused_minibatch_grad_prefetch(*g_args, wb=wb),
            lambda: FU.minibatch_grad_prefetch_plain(*g_args, wb=wb), 10, 2,
            grad_k),
        "fused_minibatch_grad": (
            lambda: FU.fused_minibatch_grad(*h_args),
            lambda: FU.minibatch_grad_plain(*h_args), 10, 2,
            {"update_grad_kernel<1>": 1, "update_reduce_kernel": 1}),
    }
    # ms: the kernels' own device time per call; wrapper_ms: CUDA events
    # around back-to-back wrapper calls (median of 5 windows), which also
    # holds the device's wait for the host; plain_ms: the plain version
    ms = {name: (kernel_ms(k, reps, kern), cuda_ms(k, reps, 5),
                 cuda_ms(p, p_reps))
          for name, (k, p, reps, p_reps, kern) in calls.items()}

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
    # the update: per-sample gradient arithmetic from a 512-sample
    # minibatch, plus one clip + Adam step per minibatch
    wu, tu = min(256, W), min(8, T)
    hp_u = PPOParams(num_envs=wu, num_rollout_steps=tu)
    wb_u = update_block(hp_u)
    small = [x.cpu() for x in (u_idx[:hp_u.minibatch_size // wb_u] %
                               (tu * wu // wb_u), u_traj[:tu, :, :wu],
                               side_n[:tu, :, :wu], u_nrm)]
    cpu_params = tuple(p.cpu() for p in u_params)
    ops_g_per = count_ops(FU.minibatch_grad_prefetch_plain, hp_u, *small,
                          *cpu_params, wb=wb_u) / hp_u.minibatch_size
    ops_h_per = count_ops(FU.minibatch_grad_plain, hp_u,
                          feat[:hp_u.minibatch_size].cpu(), small[3],
                          *cpu_params) / hp_u.minibatch_size
    ops_adam = count_ops(TT.clip_adam_step, cpu_params, cpu_params,
                         cpu_params, cpu_params, 1, lr=hp.learning_rate,
                         max_norm=hp.max_grad_norm)
    ops_d = ops_g_per * hp.update_epochs * T * W + ops_adam * n_mb
    nb = ticks.shape[0]
    bytes_a = W * (9 + 72 + 59) * 4 + W * (72 + 59 + 256) * 4
    bytes_b = (W * (72 + 59 + 256) * 4 * 2 + FR.POLICY_FLOATS * 4 +
               T * 128 * W * 4 + T * (W // 32) * FR.ROLL_OBS * 2 * 4)
    bytes_c = (3 * T * W * 4 + 3 * W * 4 + 8 * 4 + T * 8 * W * 4 +
               2 * W * 4 + nb * 8 * 4 + nb * T * 8 * 4)
    bytes_m = nb * T * 8 * 4 + 4 * 4 + 4 * 4
    # traj rows obs | actions | logp and side rows value | adv | return of
    # every sample read once, the weights read and the gradient written
    per_sample = (FU.R_LOGP + 1 + 3) * 4
    small_in = 2 * FU.D * 4 + FU.N_PARAMS * 4
    bytes_d = (u_idx.numel() * 4 + T * W * per_sample + small_in + 8 * 4 +
               2 * 3 * FU.N_PARAMS * 4)
    bytes_g = bpm * 4 + hp.minibatch_size * per_sample + small_in + \
        FU.N_PARAMS * 4
    bytes_h = feat.numel() * 4 + small_in + FU.N_PARAMS * 4
    upd = "madrona_basketball_tpu_torch/csrc/fused_update.cu"
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
             ops_m),
            ("fused_update_phase", upd,
             "madrona_basketball_tpu/ops/fused_update.py:457", bytes_d,
             ops_d),
            ("fused_minibatch_grad_prefetch", upd,
             "madrona_basketball_tpu/ops/fused_update.py:326", bytes_g,
             ops_g_per * hp.minibatch_size),
            ("fused_minibatch_grad", upd,
             "madrona_basketball_tpu/ops/fused_update.py:249", bytes_h,
             ops_h_per * hp.minibatch_size)):
        bms, by = bound(nbytes, nops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms[name][0],
                     "wrapper_ms": ms[name][1],
                     "plain_ms": ms[name][2], "bound_ms": bms,
                     "bound_by": by, "library_ms": None,
                     "bytes": nbytes, "ops": nops})
    emit({"phase": "kernel_times", "note": "library_ms is null: no single "
          "PyTorch call computes a sim tick, a rollout, this GAE pass, "
          "the meter recursion, or the PPO loss's hand-derived gradient "
          "with clip + Adam; fused_update_phase launches 2 x E x M = "
          f"{2 * n_mb} kernels per wrapper call, and its ms sums them"})
    emit({"kernels": rows})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
