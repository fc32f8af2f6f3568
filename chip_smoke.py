#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds every kernel of madrona_basketball_tpu_torch/csrc - A (fused_step),
B (fused_rollout), C (fused_gae), the meter scan (meter_scan), the
update kernels D, G and H (fused_update), the K-tick kernel F
(fused_multistep, both instances), the tiled rollout I
(fused_rollout_tiled), the obs moments E (obs_moments) and kernel B's
bf16 instances (fused_rollout_bf16; C, D, E and G keep their bf16
instances in their own sources), kernel B's timing probes
(fused_rollout_probe) and its probe x bf16 instances
(fused_rollout_probe_bf16, fused_rollout_probe_pbf), kernel D's stage
probe (fused_update_probe; held bit for bit against D's own gradient
launch) and the eval policies' kernel J (eval_policy) - holds each
against its plain torch version on the card at the flagship shapes
(plus the shot's going-in test on worlds at its threshold, and the tiled
collect), then drives the port's training paths: `init_train_state` and
three `train_iteration`s of the flagship shape (8192 worlds x 32 ticks,
then 4 epochs x 4 minibatches of 65536 samples; trainee 1, no frozen
opponent, in-kernel Philox noise), once with kernel B (`main_path`) and
once with `rollout_tiled=True` (kernels I and E, `tiled_path`); each
checks the results, counts the kernel launches of its run from 0 and
times every phase with CUDA events.  The chunked dispatch
(`ppo/train.py::make_train_chunk`, one iteration captured as a CUDA graph
and replayed with its generators reseeded) follows on both paths: 3
eager iterations against one chunk of 3 from clones of one state, every
tensor, metric and counter bit for bit (`chunk_parity`,
`chunk_parity_tiled`, and `chunk_parity_frozen`: the league's iteration
with the frozen opponent, kernel B's frozen forward and the pulse's
frozen draws), then chunks of 50 (`chunked_path`,
`chunked_tiled_path`: launches counted from 0 around the first chunk,
which holds the warm-up step and the capture, none at replay; the
median of 3 chunks by CUDA events over 50; one chunk profiled for the
device's busy time, its idle share against the un-profiled chunk; peak
device memory; the eager iteration of the same state beside it).  Then
600 training iterations on each path must reach the JAX package's
learning band, and the same 600 iterations in chunks of 50 must give the
eager curve bit for bit (`learning_chunked`, `learning_chunked_tiled`).
The training CLI runs as a subprocess (with and without
`--rollout-tiled`, at its default auto chunk) and writes a loadable
checkpoint, and with `--iters-per-dispatch` 0 (auto: 4 here) and 1 it
writes equal checkpoints at iterations 4 and 8 (`cli_chunk`).  The
stepping path comes
next: `FusedEngine` (kernel A's `step`, kernel F's `step_many`), the
state view and the export at 8192 worlds, held against the plain path on
the CPU at 256 worlds, the env's reset and step (one with a frozen
policy), and the stepping bench (`python -m
madrona_basketball_tpu_torch.bench 8192`) as a subprocess, whose JSON
line is re-emitted; each path's kernel launches are counted from 0
around that path alone.  The eval path (infer.py) follows: kernel J
against its plain version, its times beside its bound and `act`'s, and
10 seeds of a 96-tick eval against `act`'s ticks (`eval_policy`, see
`eval_policy_phase()`); the per-step
loop and the eval chunk (32 ticks captured as a CUDA graph, the stop
tested on the device) at 256 worlds of `SimConfig(time_per_period=1.0)`
must agree bit for bit - counts, every npz array, the final rows - with
the episodes stopping mid-chunk and, without a stop, over the 8-tick tail
of 200 ticks, deterministic and stochastic with a frozen opponent; the
per-step tick body and an eager chunk tick run under
`torch.cuda.set_sync_debug_mode("error")` (`eval_parity`); 16 ticks of
injected noise and Gumbel draws on the card against the plain path on the
CPU, at the CLI's 10 worlds and at 256 (`eval_card_vs_cpu`); ms a tick
and eval env-steps/s of both loops through `infer` at the CLI's defaults
(10 worlds, 5 episodes, log on) and at 8192 worlds x 320 ticks (no stop,
no log), kernel A's and kernel J's launches counted from 0 around each
run, a 32-tick window of each (median of 3, the chunked-over-per-step
ratio taken from these medians), one window profiled, and peak memory (`eval_path`).  The eval CLI runs as a subprocess on the `cli`
phase's checkpoint and with `--model-name` (`infer_cli`: the npz keys,
shapes and dtypes against NPZ_SCHEMA).  The league's CLI
(`selfplay.main`, 1 cycle x 100 iterations a generation at 8192 worlds)
runs in a temp directory in this process, its launches counted from 0,
its printed lines time-stamped (seconds a generation), its checkpoints
and reward lines checked, then `multi_gen_infer` over one generation
against the other's last checkpoint, kernel J launched 34 times a
checkpoint (`selfplay`).  A train state saved after 2 flagship
iterations and restored continues bit for bit (`resume`).  The data-parallel trainer follows, on an in-process NCCL
group of one rank (its collectives run for real): kernels B and I at
world_base 4096 on 4096 worlds equal the right half of the whole-fleet
launch bit for bit (`parity_rollout_world_base`, earlier, beside parity
I); one iteration of the plain `--data-parallel` path equals the tiled
flagship's bit for bit (kernel I is kernel B's tile body, kernel E the
same obs moments) and the flagship's but for the obs moments (1e-5 of
max(1, |x|); params within 1e-4 after the iteration); one `--dp-update`
iteration's collect equals the flagship's bit for bit, and its update,
held per Adam step (kernel G, the all-reduce, torch clip + Adam) at
kernel D's kink-aware tiers, equals its steps chained; launches counted
from 0 around 3 eager iterations of each (kernel G 16 an iteration,
kernel E on the plain path), eager and chunked iteration times beside
the flagship's, the idle share and peak memory (`dp_path`); 3 eager
iterations against a chunk of 3 with the collectives captured, bit for
bit (`dp_chunk_parity*`); two gloo ranks of 4096 worlds on this one card
(a harness choice: NCCL takes one rank a GPU) against the one-rank 8192
run: plain bit for bit, dp_update with the rows, value normalizer,
episode stats and meters bit for bit, the obs normalizer at 1e-5 of
max(1, |x|) and the learner within 5e-3 (`dp_two_rank`); 600 dp_update
iterations from seed 321 in chunks of 50 inside the learning band
(`learning_dp_update`); the CLI with `--data-parallel`, with
`--data-parallel --dp-update` and with `--distributed --data-parallel`
under torchrun's variables at world size 1, each at its auto chunk of
50, writing a loadable checkpoint (`cli_dp`); and the weak-scaling
sweep's one-GPU row (`python -m madrona_basketball_tpu_torch.
bench_scaling`, re-emitted as `bench_scaling`).  The JAX trainer's alternate
paths follow at the flagship width (`alt_paths`): --no-rollout-kernel
(kernel A 33 launches an iteration, the policy in torch, the autodiff
update), --no-fused-gae and its tiled twin (kernel D with ustats None),
--no-fused-grads at shuffle_block 8 and 1, and the structured backend,
each with its launches counted from 0 around 3 eager iterations, a chunk
of 3 equal to 3 eager iterations bit for bit, eager and chunked ms,
device busy and idle share, peak memory, and 600 learning iterations
from seed 321 (100 on the structured path, whose chunks would take over
30 s); then the per-tick collect against kernel B's on the same draws,
--no-fused-gae against the flagship from one state (the first
trajectory bit for bit, the drift of 3 iterations printed),
the autodiff update's gradient and first Adam step against kernel H's
plain gradient, the structured tick against kernel A after
`layout.pack`, and the CLI with each new flag (`cli_alt`, --viewer's
episode npz in the reference schema).  The bf16 flags (ROADMAP item
16c) follow: `bf16_kernels` holds each bf16 branch at the main path's
shapes - kernel B's bf16 storage (its trajectory the float32 launch's
rounded to bf16 and its state, obs, moments and fold partials the
float32 launch's, bit for bit; against its plain version at B's Philox
tier, plus one bf16 ulp), B's bf16 policy without and with the frozen
policy (B's Philox tier, logp and value within POLICY_TOL = 2e-3: an
FMA-contracted LayerNorm sum can round a Dense operand to the next bf16
value; both flags at once are the bf16-policy launch rounded, bit for
bit; the bf16-policy instances run their Dense layers on the tensor
cores: HMMA in the SASS of each, none in the storage-only ones, printed
with ptxas's registers and spills and the warps per SM), and kernels C,
E, D and G on a bf16 trajectory (each the float32
instance on the upcast trajectory bit for bit, and its plain version at
the float32 phase's tier, D per Adam step in
`parity_fused_update_phase_bf16`; E's time beside its byte bound);
`bf16_paths` runs --bf16-traj,
--bf16-policy, both, --data-parallel --bf16-traj and --dp-update
--bf16-traj beside each other (launches counted from 0 around 3 eager
iterations: each path's bf16 branches launched, nothing else; a chunk of
3 equal to 3 eager iterations bit for bit; eager and chunked ms, device
busy and idle share, peak memory); `learning_bf16_traj` and
`learning_bf16_policy` run 2000 iterations from seed 321 in chunks of
100 and hold the plateau (min..max of the mean reward from iteration
1100 on) inside -150..-112 (the value at 600 printed, not gated); and
`cli_bf16` runs the CLI with both flags (a loadable checkpoint) and with
--rollout-tiled --bf16-traj (the JAX trainer's refusal).  The interactive
path (ROADMAP item 13) follows: `InteractiveTrainer` at the flagship
width with a scripted viewer object (no pygame), 3 counted iterations
(kernel A 33 launches an iteration), human control of world 0's trainee
over a span of ticks (kernel A's input rows hold the scripted action
there, the policy's elsewhere), a scripted iteration with two paused
ticks (state unchanged, world 0's action zeroed, 31 launches), the
viewer ticking once a call after the first reset, ms an iteration, the
timer's spans, the idle share and peak memory, and one iteration with
the frozen opponent (`interactive_path`); one iteration at 256 x 8, 2 x
2 on the card and on the CPU on injected draws (`interactive_card_vs_cpu`,
tiers in its docstring); the native host executor (item 17) against
kernel A at 8192 worlds over 100 ticks, 1 thread against all bit for
bit, host env-steps/s beside the host CPU's model (`native_engine`); the
cross-check trainer at 512 worlds, 3 iterations, the agent on the card
(`crosscheck`); PopArt, EMA and RolloutBuffer on the card against the
CPU within 1e-6, and a `utils/profiling.trace` session around one
interactive iteration writing its host span and clock calibration
(`aux_modules`; item 15).  Each kernel's
own device time comes from torch.profiler, beside the CUDA-event time of
back-to-back wrapper calls and of its plain version; kernel D's is also
split into its gradient and reduce launches, and the redesigned kernels'
rows carry ptxas's registers and spills and their warps per SM (what an
SM could hold; for F and C also what the 8192-world grid places on it;
for D also its barriers a tile, CTA-wide and warp-wide); kernels A and E
also carry the median and spread of 30 profiled launches.  Kernel D's
stage probe (csrc/fused_update_probe.cu) then prints the SM cycles of
each stage of a tile, work and barrier wait, for warps 0 and 6 of CTA 0
over one flagship minibatch, after its partial sums have equalled those
of D's own gradient launch bit for bit (`update_stage_probe`).
Kernel B's timing probes (the JAX kernel's `probe`: sim_only,
policy_only, no_prng, no_traj; csrc/fused_rollout_probe.cu), alone and
with each bf16 flag (csrc/rollout_probe_bf16.cuh), run at the main
path's shapes, without and with the frozen policy, against their plain
versions at B's Philox tier (`rollout_probes`, see `rollout_probes()`,
with each instance's registers and spills, none spilling): no_prng
in-kernel also equals the float32 launch on its constants as external
noise, no_traj's state, obs, moments and partials the float32 launch's,
bit for bit, its trajectory one zero block; with bf16 storage each is
the launch of its policy rounded, bit for bit; the bf16 policy holds
logp and value at POLICY_TOL (no_prng: at most 1 % of worlds
diverged); then the attribution of the float32 and the bf16-policy
instances (each probe's device ms, frozen off and on, the probe x bf16
launches counted there).  The float32 probes' path is the attribution
bench,
`python -m madrona_basketball_tpu_torch.bench_rollout_attr 8192` as a
subprocess after the stepping bench (`rollout_attr`: its lines and JSON
line re-emitted, every probe, the float32 and both bf16 instances
launched there; no trainer path launches a probe).
Every phase line carries the card's name and power limit.  Every phase prints
one JSON line; any failure raises and the exit code is non-zero.  The
last lines are the per-kernel JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}.

Tolerances: kernels vs plain versions on identical inputs - integers and
sampled actions exact, floats within 1e-4 absolute (GAE: 1e-4 relative to
max(1, |x|)) for the short runs; over 32 ticks of in-kernel Philox noise
at most 0.1% of worlds may diverge in integer state or actions, and every
float of sf', obs' and the trajectory in the other worlds stays within
1e-4 absolute; one 32-tick launch equals 32 one-tick launches bit for bit;
the meter scan within 1e-5 of max(1, |x|).  Kernel F at A's tier over 8
ticks of external noise (held obs, obs every tick with agent 0 blanked,
agent 1 blanked) and at B's Philox tier over 32 ticks; one 32-tick F
launch equals 32 one-tick launches bit for bit; one 8-tick F launch
equals 8 launches of kernel A bit for bit (state and obs); the CPU build
of F's CTA (csrc/host_step.cpp, g++) at A's tier on 1024 worlds; and in
F's SASS the every-tick instance's tick loop holds system 18's
shared-memory stores and no global store.  The whole collect on a small
input (256 worlds x 8 ticks, two iterations) on the card vs the plain
path on the CPU: integer state and actions exact, every float output
within 1e-4 of max(1, |x|).  Update kernels on a real flagship collect
output: each gradient leaf within 1e-4 of the leaf's largest plain entry
(+ 1e-7); a phase of 16 Adam steps equal to its 16 one-minibatch
launches chained, bit for bit, and each step against the plain step from
the same params and moments with params within 1e-4 / 16 absolute and
mu, nu within 1e-4 / 16 of each leaf's largest entry; two launches of D
on identical inputs bit-identical; the samples at a kink of the loss (a
branch margin within 1e-5 of its operands' size: ReLU, ratio clip,
surrogate min, value max and clip) at most 0.1 % of the phase, and what
they can change (each one's two branches, carried through the clip and
Adam) added to those tiers entry by entry.  Kernel A's shot outcome
(integer state, score and ball rows) exactly the plain version's on 8192
worlds at the going-in threshold, and kernel B's 4-tick frozen parity
on the draws that once flipped a shot there.  Kernel B's fold partials
within 1e-5 of max(1, |x|) of the plain `obs_moment_partials` of its own
trajectory.  Kernel I at B's tiers (external noise, 32 Philox ticks,
composition) against its plain version, and bit for bit against kernel B
on the same seed and state (one tile body); kernel E within 1e-5 of max(1,
|x|) of the sequential fold, a relaunch bit-identical; the tiled collect
(1024 worlds x 8 ticks, two iterations) at the collect's tiers.
Learning: mean reward after 600
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
BF16_TC_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
# the policy's Dense products a world-tick: 2 x (32 x 128 + 32 x 32 + 20 x
# 32) operations (the bf16 policy runs them on the tensor cores)
DENSE_OPS = 2 * (32 * 128 + 32 * 32 + 20 * 32)


CARD = {}  # the card's name and power limit, beside every phase's numbers


T_START = time.perf_counter()


def emit(obj):
    if "phase" in obj and CARD:
        obj = {**obj, **CARD,
               "elapsed_s": round(time.perf_counter() - T_START, 1)}
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


def compare_collect(name, c_state, oc, g_state, og):
    """A collect on the card vs the plain path on the CPU: integer state
    and sampled actions exact, every float output within 1e-4 of
    max(1, |x|)."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    exact = list(range(FR.R_ACT, FR.R_ACT + 6)) + [FR.R_DONE]
    compare(f"{name} actions", [og["traj"][:, exact].int().cpu()],
            [oc["traj"][:, exact].int()])
    compare(f"{name} state", [g_state.si.cpu()], [c_state.si])
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
    return compare(name, [g.cpu() for g in got], want, atol=1e-4, rel=True)


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
    it recorded, times its launches per call; a window in which it
    recorded none of a kernel's launches (one run, for a 43 ms kernel F
    launch) is profiled again, up to three windows, then timed with CUDA
    events around the calls, with a note."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, missing = 0.0, None
        for kernel, per_call in kernels.items():
            hits = [e for e in prof.key_averages() if kernel in e.key]
            us = sum(getattr(e, "self_device_time_total", 0.0) for e in hits)
            count = sum(e.count for e in hits)
            if count > reps * per_call:
                raise Fail(f"profiler saw {count} launches of {kernel}, "
                           f"expected at most {reps * per_call}")
            if count < 1 or us <= 0:
                missing = f"{kernel} ({count} launches, {us} us)"
                break
            total += us / count * per_call / 1e3
        if missing is None:
            return total
    # when the profiler shows no device time for a kernel: CUDA
    # events around back-to-back calls (host gaps included)
    emit({"phase": "kernel_ms", "note": f"profiler recorded no launch of "
          f"{missing} in 3 windows; CUDA events instead"})
    return cuda_ms(fn, reps)


def launch_ms(fn, reps, kernels, need=21):
    """Device time of each of `reps` profiled fn() calls: per call, the
    sum over the kernels whose names contain each key of `kernels` (one
    launch of each per call, in that order; a call whose launches the
    profiler did not all record is left out).  Profiles up to three
    windows until `need` calls are whole; returns the list of the
    largest window (ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = []
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e.time_range.start, k, e.time_range.elapsed_us())
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     for k, key in enumerate(kernels) if key in e.name)
        calls, cur = [], []
        for _, k, us in evs:
            cur = cur + [us] if k == len(cur) else ([us] if k == 0 else [])
            if len(cur) == len(kernels):
                calls.append(sum(cur) / 1e3)
                cur = []
        if len(calls) > len(best):
            best = calls
        if len(best) >= need:
            break
    return best


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


def state_to_agent(agent, dev):
    """A copy of an Agent with every tensor on `dev`."""
    from madrona_basketball_tpu_torch.models.agent import Agent
    from madrona_basketball_tpu_torch.models.normalize import RMSState

    def rms(r):
        return RMSState(mean=r.mean.to(dev), var=r.var.to(dev),
                        count=r.count.to(dev))
    return Agent(net=copy.deepcopy(agent.net).to(dev),
                 obs_rms=rms(agent.obs_rms), value_rms=rms(agent.value_rms))


def state_to(state, dev):
    """A copy of a RolloutState with every tensor on `dev`."""
    stats = dataclasses.replace(state.stats, **{
        f.name: getattr(state.stats, f.name).to(dev)
        for f in dataclasses.fields(state.stats)})
    return dataclasses.replace(state, agent=state_to_agent(state.agent, dev),
                               frozen=state_to_agent(state.frozen, dev),
                               sf=state.sf.to(dev), si=state.si.to(dev),
                               obs=state.obs.to(dev), stats=stats)


def host_multistep_lib():
    """csrc/host_step.cpp built with g++ by the package's builder
    (native/__init__.py::load_host_step, contraction off, as the CPU tests
    build it), every entry typed from its signature."""
    from madrona_basketball_tpu_torch.native import load_host_step
    if shutil.which("g++") is None:
        raise Fail("g++ is missing: the host twin of kernel F needs it")
    return load_host_step()


# the eval log's keys, per-world shapes and dtypes (the reference's key
# schema, scripts/infer.py:116-129, as madrona_basketball_tpu/infer.py
# writes it): (shape after (T, W), dtype); hoop_pos is (W, 2, 3) and
# num_episodes a 0-d int64
NPZ_SCHEMA = {"agent_pos": ((2, 3), "float32"),
              "ball_pos": ((1, 3), "float32"),
              "ball_vel": ((1, 3), "float32"),
              "orientation": ((2, 4), "float32"),
              "ball_physics": ((1, 7), "int32"),
              "agent_possession": ((2, 3), "int32"),
              "game_state": ((14,), "float32"),
              "rewards": ((2,), "float32"),
              "actions": ((2, 6), "int32"),
              "done": ((), "float32")}


def check_npz(path, worlds) -> int:
    """Raise unless the npz at `path` has the eval log's schema for
    `worlds` worlds and finite floats; returns its tick count."""
    import numpy as np
    raw = dict(np.load(path))
    want = {**NPZ_SCHEMA, "hoop_pos": None, "num_episodes": None}
    if set(raw) != set(want):
        raise Fail(f"{path}: keys {sorted(raw)}")
    T = raw["done"].shape[0]
    shapes = {k: ((T, worlds) + shp, dt)
              for k, (shp, dt) in NPZ_SCHEMA.items()}
    shapes["hoop_pos"] = ((worlds, 2, 3), "float32")
    shapes["num_episodes"] = ((), "int64")
    for k, (shp, dt) in shapes.items():
        if raw[k].shape != shp or raw[k].dtype.name != dt:
            raise Fail(f"{path}: {k} {raw[k].shape} {raw[k].dtype}, want "
                       f"{shp} {dt}")
        if dt == "float32" and not np.isfinite(raw[k]).all():
            raise Fail(f"{path}: {k} holds non-finite values")
    if T < 1:
        raise Fail(f"{path}: no ticks logged")
    return T


def run_clis(jobs: dict, cwd, env, timeout=600) -> dict:
    """The CLI subprocesses `jobs` {name: (argv, extra env)} started
    together (they share the card), each waited for: {name: (exit code,
    stdout, stderr, seconds from the start to its exit)}."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", *argv], cwd=cwd,
                                    env={**env, **extra},
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, (argv, extra) in jobs.items()}
    out = {}
    for name, proc in procs.items():
        so, se = proc.communicate(timeout=timeout)
        out[name] = (proc.returncode, so, se, time.perf_counter() - t0)
    return out


def bound(nbytes, nops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


TWO_RANK_SEED = 4


def _two_rank_record(state, out) -> dict:
    """CPU copies of what dp_two_rank compares: the learner (weights and
    Adam moments), both normalizers, the frozen agent, the rows, the
    episode stats and the metrics of a whole TrainState."""
    def cpu(x):
        return x.detach().to("cpu", copy=True)
    rec = {}
    for name, xs in (("learner.param", state.agent.net.parameters()),
                     ("learner.mu", state.opt.mu),
                     ("learner.nu", state.opt.nu),
                     ("frozen", state.frozen.net.parameters())):
        rec.update({f"{name}{i}": cpu(x) for i, x in enumerate(xs)})
    for r in ("obs_rms", "value_rms"):
        rec.update({f"{r}.{f}": cpu(getattr(getattr(state.agent, r), f))
                    for f in ("mean", "var", "count")})
    rec.update({k: cpu(getattr(state, k)) for k in ("sf", "si", "obs")})
    rec.update({f"stats.{f.name}": cpu(getattr(state.stats, f.name))
                for f in dataclasses.fields(state.stats)})
    rec.update({f"metrics.{k}": cpu(v) for k, v in out["metrics"].items()})
    return rec


def two_rank_tier(key: str, want, dp_update: bool) -> float:
    """dp_two_rank's tier for one record entry: plain, every entry bit
    for bit; dp_update, the learner within JAX's 5e-3 envelope of the
    stratified shuffle, the obs normalizer at the cross-shard Chan
    combine's 1e-5 of max(1, |x|), the two metrics averaged over the
    ranks within 1e-4, everything else (rows, value normalizer, episode
    stats and meters, the frozen agent) bit for bit."""
    if not dp_update:
        return 0.0
    if key.startswith("learner."):
        return 5e-3
    if key.startswith("obs_rms."):
        return 1e-5 * max(1.0, float(want.abs().max()))
    if key in ("metrics.adv_abs_mean", "metrics.value_mean"):
        return 1e-4
    return 0.0


def _two_rank_worker(rank: int, out_dir: str):
    """One of two gloo ranks on cuda:0: one iteration of the plain and of
    the dp_update data-parallel path from `init_train_state(TWO_RANK_SEED)`
    at W worlds (W / 2 a rank); rank 0 saves the gathered state."""
    import torch
    import torch.distributed as dist
    from madrona_basketball_tpu_torch.config import SimConfig
    from madrona_basketball_tpu_torch.parallel import mesh as PM
    from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
    from madrona_basketball_tpu_torch.ppo.train_fused import (
        init_train_state, make_train_iteration)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdv",
                            rank=rank, world_size=2)
    try:
        mesh = PM.make_mesh(DEVICE)
        cfg, hp = SimConfig(), PPOParams(num_envs=W, num_rollout_steps=T)
        for dp in (False, True):
            st = PM.shard_train_state(init_train_state(
                cfg, hp, seed=TWO_RANK_SEED, device=mesh.device), mesh, dp)
            it = make_train_iteration(cfg, hp, mesh.device, mesh=mesh,
                                      dp_update=dp)
            st, out = it(st)
            whole = PM.gather_train_state(st, mesh, dp)
            if rank == 0:
                torch.save(_two_rank_record(whole, out),
                           f"{out_dir}/two_rank_{int(dp)}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------
# The alternate trainer paths (ROADMAP item 16)
# ---------------------------------------------------------------------

# kernel B's probe x bf16 instances (csrc/rollout_probe_bf16.cuh, built
# from fused_rollout_probe_bf16.cu and fused_rollout_probe_pbf.cu;
# ops/fused_rollout.py's PROBE_BF16): bf16 storage ("traj"), the bf16
# policy ("policy") or both; sim_only runs no policy, so it has a
# bf16-storage instance only
PROBE_BF16_KERNELS = tuple(
    f"fused_rollout_probe_bf16_{p}_{b}"
    for p in ("sim_only", "policy_only", "no_prng", "no_traj")
    for b in ("traj", "policy", "both") if p != "sim_only" or b == "traj")
# kernel B's timing probes: the attribution's; no trainer path
PROBE_KERNELS = ("fused_rollout_probe_sim_only",
                 "fused_rollout_probe_policy_only",
                 "fused_rollout_probe_no_prng", "fused_rollout_probe_no_traj",
                 *PROBE_BF16_KERNELS)
KERNELS = ("fused_step", "fused_rollout", "fused_rollout_tiled", "fused_gae",
           "meter_scan", "obs_moments", "fused_update_phase",
           "fused_minibatch_grad_prefetch", "fused_minibatch_grad",
           *PROBE_KERNELS)
# phase, make_train_iteration's path flags (None: the structured
# trainer), PPOParams changes, the kernels the path must launch
ALT_PATHS = (
    ("per_tick_path", {"rollout_kernel": False}, {}, ("fused_step",)),
    ("nofgae_path", {"fused_gae": False}, {},
     ("fused_step", "fused_rollout", "fused_update_phase")),
    ("nofgae_tiled_path", {"fused_gae": False, "rollout_tiled": True}, {},
     ("fused_step", "fused_rollout_tiled", "fused_update_phase")),
    ("nofgrads_path", {"fused_grads": False}, {},
     ("fused_step", "fused_rollout")),
    ("nofgrads_g1_path", {"fused_grads": False}, {"shuffle_block": 1},
     ("fused_step", "fused_rollout")),
    ("structured_path", None, {}, ()),
)
LEARN_BUDGET_S = 30.0  # a path whose chunks run 600 iterations in less
#                        runs them (seed 321); the others run
LEARN_SHORT = 100      # this many, their curve printed
LEARNED_FLOOR = -200.0  # the 600-iteration mean reward every alternate
# path must pass: a random policy sits at -569, every run of every path
# measured so far (PERF.md §6, PR 10: 4 seeds x 5 paths) at -124.9 ..
# -163.6.  Whether it lands in the flagship's -150..-105 band is printed:
# at one seed the band misses correct runs (flagship seed 1 tiled -156.20,
# PR 7; -152.36 here on --no-fused-gae at seed 321)
ALT_CLI_ARGS = []      # extra flags of cli_alt's runs (a CPU rehearsal
#                        gives --device cpu and a small width)


def _events_ms(fn, n):
    """n calls of fn, each timed alone with CUDA events (ms)."""
    import torch
    out = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def eager_counted(it, state, reset_counts, counts, dev):
    """A warm-up iteration (first uses, constants), then 3 eager
    iterations, each timed alone with CUDA events, with every kernel's
    launches counted from 0 around them: (state, out, numbers)."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    t0 = time.perf_counter()
    state, _ = it(state)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev)
    reset_counts()
    box = {"state": state}

    def step():
        box["state"], box["out"] = it(box["state"])
    eager_ms = _events_ms(step, 3)
    e_ms = statistics.median(eager_ms)
    return box["state"], box["out"], {
        "warmup_s": warm_s, "launches_3_iterations": counts(),
        "fused_update_phase_device_launches": FU.device_launches,
        "eager_ms": eager_ms, "eager_iteration_ms": e_ms,
        "eager_train_env_steps_per_s": W * T / (e_ms / 1e3),
        "eager_peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "start_bytes": start_bytes}


def chunked_numbers(it, state, n, reps, reset_counts, counts, profiled,
                    dev, phase):
    """Chunks of n iterations (make_train_chunk): the first (its warm-up
    step and capture) with launches counted from 0, then `reps` chunks
    timed with CUDA events (the replays must count no launch), one graph
    replay profiled for the device's busy time (a whole chunk holds n x
    10^4..10^5 kernels, too many to profile), and the peak memory:
    (state, numbers)."""
    import torch
    from madrona_basketball_tpu_torch.ppo import train as TT
    chunk = TT.make_train_chunk(it, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    state, _ = chunk(state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cap = counts()
    box = {"state": state}

    def run_chunk():
        box["state"], box["stacked"] = chunk(box["state"])
    chunk_ms = _events_ms(run_chunk, reps)
    peak = torch.cuda.max_memory_allocated(dev)
    if counts() != cap:
        raise Fail(f"{phase}: replays counted launches")
    state = box["state"]
    static, graph = chunk.captured["static"], chunk.captured["graph"]

    def one_replay():
        static.reseed(state.seed, state.counter)
        graph.replay()
    _, busy, wall, top = profiled(one_replay)
    it_ms = statistics.median(chunk_ms) / n
    return state, {
        "iters_per_dispatch": n, "chunk_ms": chunk_ms,
        "chunked_iteration_ms": it_ms,
        "chunked_train_env_steps_per_s": W * T / (it_ms / 1e3),
        "first_chunk_s": first_s, "launches_at_capture": cap,
        "device_busy_ms_per_iteration": busy,
        "device_idle_share": (1.0 - busy / it_ms) if busy else None,
        "profiled_replay_wall_ms": wall, "top_device_ms_chunk": top,
        "peak_memory_bytes": peak}


def path_line(eager, busy, wall, top, chunked):
    """The phase line of a path from `eager_counted`'s and
    `chunked_numbers`' numbers and one profiled eager iteration's busy,
    wall and top kernels (None where not profiled)."""
    start = eager.pop("start_bytes")
    return {**eager, "eager_device_busy_ms": busy,
            "eager_device_idle_share": (1.0 - busy / wall) if busy else None,
            "eager_profiled_wall_ms": wall, "top_device_ms_eager": top,
            **chunked,
            "peak_over_start_bytes": chunked["peak_memory_bytes"] - start,
            "eager_peak_over_start_bytes":
            eager["eager_peak_memory_bytes"] - start}


def alt_paths(cfg, hp, dev, gen, n_mb, reset_counts, counts, profiled,
              chunk_parity):
    """Each alternate path at the flagship width (8192 x 32, 4 x 4): a
    warm-up iteration, then 3 eager iterations with every kernel's
    launches counted from 0 (the path's kernels launched, no other:
    kernel A 33 times an iteration on the per-tick path, once elsewhere;
    kernel D with ustats None on --no-fused-gae), the eager ms; one
    profiled eager iteration (device busy and idle share; not on the
    structured path); 3 eager iterations against a chunk of 3 bit for bit
    (`chunk_parity`); the chunked ms (make_train_chunk: 50 iterations a
    chunk, 10 on the structured path), the device busy time of one
    profiled graph replay against it (the idle share) and peak memory;
    then learning from seed 321 in chunks of 50: 600 iterations where
    the chunks run them in under LEARN_BUDGET_S (above LEARNED_FLOOR,
    whether in the band printed), else 100 with the curve printed.
    Returns the
    launches of each path's 3 eager iterations and its numbers."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    from madrona_basketball_tpu_torch.ppo import train as TT
    from madrona_basketball_tpu_torch.ppo import train_fused as TF
    res = {"launches": {}}
    for phase, kw, hp_kw, on in ALT_PATHS:
        hp_p = dataclasses.replace(hp, **hp_kw)
        if kw is None:
            def init(seed, hp_p=hp_p):
                return TT.init_train_state(cfg, hp_p, seed, dev)

            def make(hp_p=hp_p):
                return TT.make_train_iteration(cfg, hp_p, dev)
        else:
            def init(seed, hp_p=hp_p):
                return TF.init_train_state(cfg, hp_p, seed, dev)

            def make(hp_p=hp_p, kw=kw):
                return TF.make_train_iteration(cfg, hp_p, dev, **kw)
        it = make()
        state = init(1)
        p0 = FU.pack_weights(state.agent.net)
        state, out, eager = eager_counted(it, state, reset_counts, counts,
                                          dev)
        launches = eager["launches_3_iterations"]
        d_dev = eager["fused_update_phase_device_launches"]
        missing = [k for k in on if launches[k] < 1]
        stray = [k for k in KERNELS if k not in on and launches[k]]
        if missing or stray:
            raise Fail(f"{phase}: kernels {missing} not launched, {stray} "
                       f"launched: {launches}")
        want_a = 3 * (T + 1) if kw is not None and \
            not kw.get("rollout_kernel", True) else (3 if on else 0)
        if launches["fused_step"] != want_a:
            raise Fail(f"{phase}: kernel A launched {launches['fused_step']}"
                       f" times in 3 iterations, not {want_a}")
        if "fused_update_phase" in on and (
                launches["fused_update_phase"] != 3 or
                d_dev != 3 * 2 * n_mb):
            raise Fail(f"{phase}: kernel D {launches['fused_update_phase']}"
                       f" calls, {d_dev} device launches in 3 iterations")
        for k in ("fused_rollout", "fused_rollout_tiled"):
            if k in on and launches[k] != 3:
                raise Fail(f"{phase}: {k} launched {launches[k]} times")
        m = {k: float(out["metrics"][k]) for k in TF.METRICS}
        if not all(map(lambda v: v == v and abs(v) < 1e30, m.values())):
            raise Fail(f"{phase}: metrics {m}")
        p1 = FU.pack_weights(state.agent.net)
        if not all(bool(torch.isfinite(p).all()) for p in p1) or \
                all(torch.equal(a, b) for a, b in zip(p0, p1)):
            raise Fail(f"{phase}: params non-finite or unchanged")
        if state.opt.count != 4 * n_mb:
            raise Fail(f"{phase}: Adam count {state.opt.count}")
        busy = wall = top = None
        if kw is not None:
            # (the structured iteration's ~150 000 eager ops are not
            # profiled: its busy time comes from one graph replay below)
            (state, _), busy, wall, top = profiled(lambda: it(state))
        chunk_parity(f"{phase}_chunk_parity", False, state, it)

        n = 10 if kw is None else 50
        state, chunked = chunked_numbers(it, state, n, 2, reset_counts,
                                         counts, profiled, dev, phase)
        it_ms = chunked["chunked_iteration_ms"]
        emit({"phase": phase, "worlds": W, "ticks": T,
              "epochs": hp_p.update_epochs,
              "minibatches": hp_p.num_minibatches,
              "shuffle_block": hp_p.shuffle_block,
              "flags": "structured" if kw is None else kw,
              **path_line(eager, busy, wall, top, chunked), "metrics": m})
        del state, out, it
        torch.cuda.empty_cache()

        # learning, in chunks of 50
        n_learn = 600 if it_ms * 600 / 1e3 < LEARN_BUDGET_S else LEARN_SHORT
        l_state = init(321)
        l_chunk = TT.make_train_chunk(make(), 50)
        curve = []
        t0 = time.perf_counter()
        for k in range(n_learn // 50):
            l_state, st = l_chunk(l_state)
            curve.append([50 * (k + 1), float(st["mean_reward"][-1]),
                          float(st["mean_episode_length"][-1])])
        l_secs = time.perf_counter() - t0
        if not all(bool(torch.isfinite(p).all())
                   for p in l_state.agent.net.parameters()):
            raise Fail(f"{phase} learning: non-finite params")
        final = curve[-1][1]
        emit({"phase": f"learning_{phase}", "iterations": n_learn,
              "seed": 321, "iters_per_dispatch": 50, "seconds": l_secs,
              "curve": curve, "final_mean_reward": final,
              "band": [-150.0, -105.0] if n_learn == 600 else None,
              "in_band": -150.0 <= final <= -105.0 if n_learn == 600
              else None,
              "learned_floor": LEARNED_FLOOR if n_learn == 600 else None,
              "note": None if n_learn == 600 else
              f"chunked {it_ms:.3f} ms an iteration: 600 iterations take "
              f"more than {LEARN_BUDGET_S} s, so {LEARN_SHORT} and the "
              "curve"})
        if n_learn == 600 and not final >= LEARNED_FLOOR:
            raise Fail(f"{phase}: mean reward {final} after 600 iterations "
                       f"is below {LEARNED_FLOOR}: the path did not learn")
        del l_chunk, l_state
        torch.cuda.empty_cache()
        res["launches"][phase] = launches
        res[phase] = {"eager_ms": eager["eager_iteration_ms"],
                      "chunked_ms": it_ms, "learning_iterations": n_learn,
                      "final": final}
    return res


def alt_per_tick_vs_b(cfg, hp, dev, gen):
    """The per-tick collect (kernel A a tick, the policy in torch) against
    kernel B's collect on the same draws (the pulse, and B's external
    noise matrix, which the per-tick path reads tick by tick), from one
    state: B's Philox tier (at most 0.1 % of worlds differ in integer
    state or actions, every float of the other worlds' trajectory rows
    and final rows within 1e-4 absolute)."""
    import torch
    from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    from madrona_basketball_tpu_torch.ppo import train_fused as TF
    state = TF.init_train_state(cfg, hp, 5, dev)
    pt = TF.make_train_iteration(cfg, hp, dev, rollout_kernel=False)
    state, _ = pt(state)                  # a state past its first pulse
    CH = FR.EXT_NOISE_CHUNK
    u = torch.rand((T * CH, W), generator=gen, device=dev)
    row = torch.arange(T * CH, device=dev)[:, None] % CH
    noise = TF.CollectNoise(pulse=draw_noise_rows(W, gen, dev),
                            rollout=torch.where(row < 8, 2 * u - 1, u))
    s1, o1 = pt(copy.deepcopy(state), noise)
    s2, o2 = TF.make_collect(cfg, hp, dev)(copy.deepcopy(state), noise)
    torch.cuda.synchronize()
    buf, traj = o1["buf"], o2["traj"]
    acts = traj[:, FR.R_ACT:FR.R_ACT + 6].transpose(1, 2).int()
    bad = (buf["actions"] != acts).any(dim=2).any(dim=0)
    bad |= ((1.0 - buf["not_dones"]) != traj[:, FR.R_DONE]).any(dim=0)
    bad |= (s1.si != s2.si).any(dim=0)
    n_bad = int(bad.sum())
    if n_bad > 1e-3 * W:
        raise Fail(f"per-tick vs kernel B: {n_bad} of {W} worlds differ")
    ok = ~bad
    errs = {
        "obs": buf["obs"][:, :, :FR.ROLL_OBS].transpose(1, 2) -
        traj[:, :FR.ROLL_OBS],
        "value": buf["values"] - traj[:, FR.R_VALUE],
        "log_prob": buf["log_probs"] - traj[:, FR.R_LOGP],
        "reward": buf["rewards"] - traj[:, FR.R_REW],
        "sf": s1.sf - s2.sf, "obs_rows": s1.obs - s2.obs}
    e = {k: float(v[..., ok].abs().max()) for k, v in errs.items()}
    if max(e.values()) > 1e-4:
        raise Fail(f"per-tick vs kernel B: float errors {e}")
    emit({"phase": "parity_per_tick_vs_rollout_kernel", "worlds": W,
          "ticks": T, "worlds_differing": n_bad, "max_abs_err": e,
          "tier": "B's Philox tier: <= 0.1 % of worlds, floats 1e-4"})


def alt_nofgae_vs_flagship(cfg, hp, dev):
    """--no-fused-gae against the flagship from one state on the same
    draws (the pulse and permutation generators, kernel B's Philox):
    the first iteration's trajectory bit for bit and its side rows (the
    flagship's raw rows normalized by its ustats) within 1e-4 of max(1,
    |x|); then how far 3 chained iterations of each drift apart
    (printed: the two differ only in rounding, which is what their
    learning curves amplify)."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    from madrona_basketball_tpu_torch.ppo import train_fused as TF
    state = TF.init_train_state(cfg, hp, 9, dev)
    fl = TF.make_train_iteration(cfg, hp, dev)
    ng = TF.make_train_iteration(cfg, hp, dev, fused_gae=False)
    state, _ = fl(state)
    a, b = copy.deepcopy(state), copy.deepcopy(state)
    drift = []
    for it in range(3):
        a, oa = fl(a)
        b, ob = ng(b)
        if it == 0:
            if not torch.equal(oa["traj"], ob["traj"]):
                raise Fail("nofgae vs flagship: the trajectories differ")
            compare("nofgae vs flagship side",
                    [ob["side"][:, :3]],
                    [FU.normalize_side(oa["side"], oa["ustats"])[:, :3]],
                    atol=1e-4, rel=True)
        drift.append({
            "params": max(float((x - y).abs().max()) for x, y in zip(
                FU.pack_weights(a.agent.net), FU.pack_weights(b.agent.net))),
            "obs_rms_var": float((a.agent.obs_rms.var -
                                  b.agent.obs_rms.var).abs().max()),
            "worlds_differing": int((a.si != b.si).any(dim=0).sum())})
    emit({"phase": "parity_nofgae_vs_flagship", "worlds": W, "ticks": T,
          "first_trajectory_bit_identical": True,
          "drift_per_iteration": drift})


def alt_update_step(hp, feat, nrm, obs_rms, agent, h_plain):
    """The autodiff update (make_update_fns, the per-tick, structured and
    --no-fused-grads paths) on the 65536 samples of parity G, H's
    minibatch (the feat layout of kernel H): autograd of `loss_fn`
    against kernel H's plain gradient (H's tier: 1e-4 of the leaf's
    largest entry + 1e-7), and the update's first Adam step against the
    plain step of that gradient: Adam's moments (mu = 0.1 u, nu = 0.001
    u^2 of the clipped gradient u) at the gradient's tier, the params
    within 1e-4 / 16, or 2 x lr where the plain gradient is within its
    tier of zero (Adam's first step has the gradient's sign)."""
    import torch
    from madrona_basketball_tpu_torch.models.agent import Agent
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    from madrona_basketball_tpu_torch.ppo import train as TT
    net = copy.deepcopy(agent.net)
    D = FU.D
    params = list(net.parameters())
    with torch.enable_grad():
        loss = TT.loss_fn(hp, net, obs_rms, feat[:, :D],
                          feat[:, D:D + 6].long(), *(feat[:, D + 6 + i]
                                                     for i in range(4)))
        g = dict(zip(map(id, params), torch.autograd.grad(loss, params)))
    ga = FU.pack_weights(net, of=lambda p: g[id(p)])
    tiers = [1e-4 * float(w.abs().max()) + 1e-7 for w in h_plain]
    g_err = [float((a - b).abs().max()) for a, b in zip(ga, h_plain)]
    if any(e > t for e, t in zip(g_err, tiers)):
        raise Fail(f"autodiff gradient vs kernel H's plain: {g_err} above "
                   f"{tiers}")
    mb = feat.shape[0]
    hp1 = dataclasses.replace(hp, num_rollout_steps=mb // hp.num_envs,
                              num_minibatches=1, update_epochs=1,
                              shuffle_block=1)
    _, up = TT.make_update_fns(hp1)
    p0 = FU.pack_weights(net)
    opt = TT.init_adam(p0)
    a1, o1 = up.with_feat(Agent(net=net, obs_rms=obs_rms,
                                value_rms=agent.value_rms), opt,
                          feat.contiguous(), D, 6,
                          torch.arange(mb, device=feat.device)[None])
    pa = FU.pack_weights(a1.net)
    ph, mh, vh = TT.clip_adam_step(p0, opt.mu, opt.nu, h_plain, 1,
                                   lr=hp.learning_rate,
                                   max_norm=hp.max_grad_norm)
    # Adam's moments after its first step hold the clipped gradient the
    # update used: mu = 0.1 u, nu = 0.001 u^2
    m_err = [float((a - b).abs().max()) for a, b in zip(o1.mu, mh)]
    v_err = [float((a - b).abs().max()) for a, b in zip(o1.nu, vh)]
    for i, t in enumerate(tiers):
        gmax = float(h_plain[i].abs().max())
        if m_err[i] > 0.1 * t or v_err[i] > 1e-3 * t * (2 * gmax + t):
            raise Fail(f"autodiff first Adam step, leaf {i}: moments off "
                       f"by {m_err[i]}, {v_err[i]}")
    s_err, signs = [], 0
    for a, b, gh, t in zip(pa, ph, h_plain, tiers):
        near0 = gh.abs() <= t
        lim = torch.where(near0, 2 * hp.learning_rate, 1e-4 / 16)
        d = (a - b).abs()
        if bool((d > lim).any()):
            raise Fail(f"autodiff first Adam step: error {float(d.max())}")
        s_err.append(float(d[~near0].max()) if bool((~near0).any()) else 0.)
        signs += int(near0.sum())
    emit({"phase": "parity_autodiff_update", "samples": mb,
          "loss": float(loss.detach()), "grad_max_abs_err": g_err,
          "grad_tier": tiers, "first_step_mu_max_abs_err": m_err,
          "first_step_nu_max_abs_err": v_err,
          "first_step_params_max_abs_err": s_err,
          "entries_with_a_gradient_within_its_tier_of_zero": signs})


def alt_structured_tick(cfg, dev, gen):
    """The structured tick (engine.step_core over systems.py, torch on
    the card) against kernel A after layout.pack, one tick from the same
    rows at 8 points of a kernel-A trajectory with random actions, 8192
    worlds: integers exact but for at most 0.1 % of worlds (shots at the
    going-in threshold: torch's CUDA sin / cos / atan2 are not the
    kernel's), floats of the other worlds within 1e-4; and the time of
    one structured tick beside kernel A's."""
    import torch
    from madrona_basketball_tpu_torch import engine as E
    from madrona_basketball_tpu_torch import systems as S
    from madrona_basketball_tpu_torch.engine import init_rows
    from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
    from madrona_basketball_tpu_torch.ops import fused_step as FS
    from madrona_basketball_tpu_torch.ops import layout as L
    sf, si = init_rows(cfg, W, gen, dev)
    obs = torch.zeros((L.N_OBS_ROWS, W), device=dev)
    n_bad, e_f = 0, 0.0
    for tick in range(8):
        for i in range(2):
            for r, n in zip(L.ACTION_ROWS[i], (2, 8, 3, 2, 2, 2)):
                si[r] = torch.randint(0, n, (W,), generator=gen, device=dev,
                                      dtype=torch.int32)
        noise = draw_noise_rows(W, gen, dev)
        st = E.step_core(cfg, L.unpack(cfg, sf, si, obs),
                         S.StepNoise.from_rows(noise))
        sf, si, obs = FS.fused_step(cfg, sf, si, noise)
        gsf, gsi = L.pack(st)
        gobs = st.agents.obs.permute(1, 2, 0).reshape(L.N_OBS_ROWS, W)
        bad = (gsi != si).any(dim=0)
        n_bad += int(bad.sum())
        ok = ~bad
        e_f = max(e_f, float((gsf - sf)[:, ok].abs().max()),
                  float((gobs - obs)[:, ok].abs().max()))
    if n_bad > 1e-3 * W * 8 or e_f > 1e-4:
        raise Fail(f"structured tick vs kernel A: {n_bad} world-ticks "
                   f"differ in integers, float error {e_f}")
    state = L.unpack(cfg, sf, si, obs)
    noise = S.StepNoise.from_rows(draw_noise_rows(W, gen, dev))
    s_ms = statistics.median(_events_ms(
        lambda: E.step_core(cfg, state, noise), 5))
    a_ms = statistics.median(_events_ms(
        lambda: FS.fused_step(cfg, sf, si, noise.rows()), 5))
    emit({"phase": "parity_structured_tick", "worlds": W, "ticks": 8,
          "world_ticks_differing": n_bad, "max_abs_err": e_f,
          "structured_tick_ms": s_ms, "kernel_a_tick_ms": a_ms,
          "tier": "integers exact but <= 0.1 % of world-ticks, floats 1e-4"})


def check_recorded_npz(path) -> int:
    """Raise unless the npz at `path` is a world-0 episode drop in the
    reference schema (NPZ_SCHEMA at one world, hoop_pos (1, 2, 3)) with
    finite floats; returns its tick count."""
    import numpy as np
    raw = dict(np.load(path))
    if set(raw) != set(NPZ_SCHEMA) | {"hoop_pos"}:
        raise Fail(f"{path}: keys {sorted(raw)}")
    n = raw["done"].shape[0]
    for k, (shp, dt) in NPZ_SCHEMA.items():
        if raw[k].shape != (n, 1) + shp or raw[k].dtype.name != dt:
            raise Fail(f"{path}: {k} {raw[k].shape} {raw[k].dtype}")
        if dt == "float32" and not np.isfinite(raw[k]).all():
            raise Fail(f"{path}: {k} holds non-finite values")
    if raw["hoop_pos"].shape != (1, 2, 3) or n < 1:
        raise Fail(f"{path}: hoop_pos {raw['hoop_pos'].shape}, {n} ticks")
    return n


def alt_cli(dev):
    """The training CLI once with each flag of the alternate paths, as
    subprocesses started together on this card (8192 worlds): each
    trains a few iterations (at its auto chunk) and writes a checkpoint
    that loads back equal and finite; --viewer (the per-tick rollout,
    world 0 recorded) trains 60 eager iterations and must drop at least
    one episode npz in the reference schema."""
    import torch
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    from madrona_basketball_tpu_torch.utils import checkpoint as CK
    root = Path(FU.__file__).resolve().parents[2]
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    short = ["--num-iterations", "4", "--log-every-n-iterations", "2",
             "--save-model-every-n-iterations", "4"]
    runs = {"xla_rows": (short + ["--backend", "xla-rows"], 4),
            "no_rollout_kernel": (short + ["--no-rollout-kernel"], 4),
            "no_fused_gae": (short + ["--no-fused-gae"], 4),
            "no_fused_grads": (short + ["--no-fused-grads"], 4),
            "shuffle_block_1": (short + ["--no-fused-grads",
                                         "--shuffle-block", "1"], 4),
            "structured": (short + ["--backend", "structured"], 4),
            "viewer": (["--viewer", "--num-iterations", "60",
                        "--log-every-n-iterations", "1",
                        "--save-model-every-n-iterations", "60"], 60)}
    try:
        t0 = time.perf_counter()
        done = run_clis({name: (["madrona_basketball_tpu_torch.cli",
                                 "--model-name", name, *flags,
                                 *ALT_CLI_ARGS], {})
                         for name, (flags, _) in runs.items()}, tmp, env)
        result = {}
        for name, (rc, out_, err_, secs) in done.items():
            flags, last = runs[name]
            if rc != 0:
                raise Fail(f"cli {flags} exited {rc}: {err_[-3000:]}")
            path = Path(tmp) / CK.checkpoint_path(name, last)
            saved = torch.load(path, weights_only=True)
            back = CK.state_dict(CK.load_agent(str(path), dev))
            if sorted(back) != sorted(saved) or not all(
                    torch.equal(back[k], saved[k]) for k in saved) or \
                    not all(bool(torch.isfinite(v).all())
                            for v in saved.values()):
                raise Fail(f"cli {flags}: the checkpoint does not load back "
                           "equal and finite")
            result[name] = {"flags": flags, "seconds_since_start": secs,
                            "checkpoint": CK.checkpoint_path(name, last),
                            "log": [ln for ln in out_.splitlines()
                                    if ln.startswith(("Mean reward",
                                                      "Iterations per"))]}
        drops = sorted((Path(tmp) / "logs" / "viewer").glob(
            "iter_*_episode.npz"))
        if not drops:
            raise Fail("cli --viewer dropped no episode npz")
        result["viewer"]["npz"] = {p.name: check_recorded_npz(p)
                                   for p in drops}
        emit({"phase": "cli_alt", "runs": result,
              "seconds": time.perf_counter() - t0,
              "note": "subprocesses started together on one card"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------
# The bf16 flags (ROADMAP item 16c)
# ---------------------------------------------------------------------

# kernel E's bf16 instance: its partial and combine launches
E16_KERNELS = {"obs_moment_partial_bf16_kernel": 1,
               "obs_moment_combine_kernel": 1}
POLICY_TOL = 2e-3  # the bf16 policy's logp and value rows against the
# plain version: the kernel contracts a LayerNorm's sums into FMAs, the
# plain version does not, and that ulp can move a Dense operand across a
# bf16 rounding boundary: a few bf16 ulps of a logit (the plain version
# holds the JAX kernel at the same tolerance,
# tests/test_torch_bf16_rollout.py)
# phase, make_train_iteration's flags ("mesh": on the in-process group),
# the kernels (float32 or bf16 instances) the path launches
BF16_PATHS = (
    ("bf16_traj_path", {"bf16_traj": True},
     ("fused_step", "fused_rollout_bf16_traj", "fused_gae_bf16",
      "meter_scan", "fused_update_phase_bf16")),
    ("bf16_policy_path", {"bf16_policy": True},
     ("fused_step", "fused_rollout_bf16_policy", "fused_gae", "meter_scan",
      "fused_update_phase")),
    ("bf16_both_path", {"bf16_traj": True, "bf16_policy": True},
     ("fused_step", "fused_rollout_bf16_traj", "fused_rollout_bf16_policy",
      "fused_gae_bf16", "meter_scan", "fused_update_phase_bf16")),
    ("bf16_dp_traj_path", {"bf16_traj": True, "mesh": True},
     ("fused_step", "fused_rollout_bf16_traj", "fused_gae_bf16",
      "meter_scan", "obs_moments_bf16", "fused_update_phase_bf16")),
    ("bf16_dp_update_traj_path", {"bf16_traj": True, "mesh": True,
                                  "dp_update": True},
     ("fused_step", "fused_rollout_bf16_traj", "fused_gae_bf16",
      "meter_scan", "fused_minibatch_grad_prefetch_bf16")),
)
BF16_LEARN = 2000        # learning iterations of each flag, seed 321
BF16_LEARN_CHUNK = 100   # iterations a dispatch (run_convergence's)
BF16_PLATEAU_FROM = 1100  # the plateau: min..max of the chunks' mean
# reward over the second half of the run (as the flagship's
# 10 000-iteration runs take 5100..10 000, PERF.md §7)
BF16_BAND = (-150.0, -112.0)  # the plateau's gate: the JAX record's
# -122..-140 band of its 2000-iteration bf16 A/B (a TPU's: bf16 traj
# -133.0, f32 -130.7; BENCHMARKS.md:31-35) widened by ~10, as the
# flagship's


def philox_tier(name, k, p, row_tol=None, max_frac=1e-3):
    """Kernel B's tier over 32 ticks of in-kernel Philox noise against its
    plain version (k, p: (sf, si, obs, traj, ...)): at most max_frac (0.1
    %) of worlds diverge (integer state or sampled actions); in the others
    every float of sf', obs' and the trajectory within 1e-4 absolute
    (trajectory rows in row_tol {row: tol} at theirs), plus, for a bf16
    trajectory, one bf16 ulp (2**-7 of the value: two values within the
    tier may round apart).  Returns (diverged fraction, max abs error)."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    kt, pt = k[3].float(), p[3].float()
    acts = slice(FR.R_ACT, FR.R_ACT + 6)
    div = (k[1] != p[1]).any(dim=0) | \
        (kt[:, acts] != pt[:, acts]).any(dim=0).any(dim=0)
    frac = float(div.float().mean())
    if frac > max_frac:
        raise Fail(f"{name}: {frac:.4%} of worlds diverged")
    ok = ~div
    err = max(float((k[i][:, ok] - p[i][:, ok]).abs().max()) for i in (0, 2))
    tol = torch.full((FR.ROLL_ROWS, 1), 1e-4, device=kt.device)
    for r, t in (row_tol or {}).items():
        tol[r] = t
    d = (kt[..., ok] - pt[..., ok]).abs()
    lim = tol[None] + (2.0 ** -7 * pt[..., ok].abs()
                       if k[3].dtype == torch.bfloat16 else 0.0)
    if err > 1e-4 or bool((d > lim).any()):
        raise Fail(f"{name}: float error {max(err, float(d.max()))} above "
                   "the tier in the worlds that agree")
    return frac, max(err, float(d.max()))


def fold_check(k):
    """Kernel B's fold partials (k[5]) against the plain
    `obs_moment_partials` of the trajectory's obs rows (the pre-tick
    obs): within 1e-5 of max(1, |x|); reports whether they are equal
    bit for bit (the plain version sums in torch's order, the kernel
    in the warp butterfly's)."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    want = torch.stack([FR.obs_moment_partials(x[0:FR.ROLL_OBS])
                        for x in k[3]])
    rel = float(((k[5] - want).abs() /
                 torch.clamp(want.abs(), min=1.0)).max())
    if not rel <= 1e-5:
        raise Fail(f"kernel B fold partials: {rel} of max(1, |x|) "
                   "from the plain obs_moment_partials")
    return {"max_rel_err": rel, "bit_identical": torch.equal(k[5], want)}


def _ext_noise(gen, n_steps, worlds, dev):
    """External noise for kernel B: n_steps chunks of uniforms, the sim
    rows mapped to [-1, 1) as the draws are."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    u = torch.rand((n_steps * FR.EXT_NOISE_CHUNK, worlds), generator=gen,
                   device=dev)
    row = torch.arange(n_steps * FR.EXT_NOISE_CHUNK, device=dev) % \
        FR.EXT_NOISE_CHUNK
    return torch.where((row < 8)[:, None], 2.0 * u - 1.0, u)


def rollout_probes(cfg, dev, sf, si, obs0, mats, fmats, seed):
    """Kernel B's timing probes at the main path's shapes (W x T, trainee
    1), without and with the frozen policy: the float32 instances
    (csrc/fused_rollout_probe.cu) and the probe x bf16 instances
    (csrc/fused_rollout_probe_bf16.cu with bf16 storage,
    csrc/fused_rollout_probe_pbf.cu with the bf16 policy only), each
    against its plain version.
    sim_only, policy_only and no_traj run on external noise, no_prng on
    its in-kernel constants (its plain version on `no_prng_noise`).
      * float32: B's Philox tier; no_prng also equals the float32 launch
        on the constants as external noise, and no_traj's state, obs,
        moments and partials the float32 launch's, bit for bit.
      * bf16 storage: the float32 probe launch's trajectory rounded, its
        state, obs, moments and partials that launch's, bit for bit; B's
        Philox tier plus one bf16 ulp against the plain version (whose
        trajectory is the float32 plain one rounded, checked at frozen
        off, where it is timed).
      * bf16 policy: B's Philox tier with logp and value at POLICY_TOL,
        no_prng's at most 1 % of worlds diverged (its uniforms constant,
        the logits alone pick the actions, summed by the tensor cores in
        another order than the plain version's); both flags the
        bf16-policy launch rounded, bit for bit; sim_only runs no policy,
        so with policy_bf16 it is the sim_only launch of its storage
        type, bit for bit.
      * policy_only leaves sf, obs and si's non-action rows as the input
        holds them, bit for bit; no_traj returns one (1, 128, W) zero
        block of the asked dtype.
    Then each probe and branch on the other trainee and a last tile of 32
    worlds (96 worlds x 4 ticks, the frozen policy on, external noise),
    the instances' ptxas registers and spills (none may spill), and the
    attribution (the probes' path): the device ms (torch.profiler) and
    wrapper ms (CUDA events) of the full launch and each probe of the
    float32 and bf16-policy instances, without and with the frozen
    policy, and of the bf16-storage and both-flag instances without it,
    on in-kernel Philox (no_prng: its constants), the probe x bf16
    launches counted from 0 around it.  Returns {"errs", "plain_ms",
    "times", "launches", "ptxas"}."""
    import torch
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.engine import init_rows
    from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    from madrona_basketball_tpu_torch.ops import fused_step as FS
    from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS
    BF = torch.bfloat16
    pol_tol = {FR.R_LOGP: POLICY_TOL, FR.R_VALUE: POLICY_TOL}
    act_rows = [r for a in range(2) for r in ACTION_ROWS[a]]
    other = [r for r in range(si.shape[0]) if r not in act_rows]
    errs = {f"fused_rollout_probe_{p}": 0.0 for p in FR.PROBES}
    errs.update(dict.fromkeys(PROBE_BF16_KERNELS, 0.0))
    plain_ms = {}

    def flags(branch):
        """A probe x bf16 branch's wrapper flags."""
        return {"traj": {"traj_dtype": BF}, "policy": {"policy_bf16": True},
                "both": {"traj_dtype": BF, "policy_bf16": True}}[branch]

    def moments(k, p, name):
        rel = float(((k[4] - p[4]).abs() /
                     torch.clamp(p[4].abs(), min=1.0)).max())
        if rel > 1e-5:
            raise Fail(f"{name}: obs moments {rel}")
        return rel

    def rounded(f32, bf16):
        """bf16 equals f32 with its trajectory rounded, bit for bit."""
        return torch.equal(bf16[3].view(torch.int16),
                           f32[3].to(BF).view(torch.int16)) and \
            all(torch.equal(a, b) for a, b in zip(f32[:3] + f32[4:],
                                                  bf16[:3] + bf16[4:]))

    def timed(fn):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    const = FR.no_prng_noise(T, W, dev)
    gen_p = torch.Generator(device=dev).manual_seed(13)
    for use_frozen in (False, True):
        fm = fmats if use_frozen else None
        ext = _ext_noise(gen_p, T, W, dev)
        for probe in FR.PROBES:
            pn = const if probe == "no_prng" else ext
            kn = None if probe == "no_prng" else ext
            tag = f"probe {probe} frozen={use_frozen}"

            def run(**kw):
                return FR.fused_rollout(cfg, sf, si, obs0, mats, fm,
                                        n_steps=T, trainee_idx=1, seed=seed,
                                        probe=probe, noise=kn,
                                        moment_partials=True, **kw)

            def plain(**kw):
                return FR.rollout_plain(cfg, sf, si, obs0, mats, fm,
                                        n_steps=T, trainee_idx=1, noise=pn,
                                        probe=probe, **kw)
            k = run()
            p = plain()
            extra = {}
            if probe in ("no_prng", "no_traj"):
                f32 = FR.fused_rollout(cfg, sf, si, obs0, mats, fm,
                                       n_steps=T, trainee_idx=1, noise=pn,
                                       moment_partials=True)
                same = (0, 1, 2, 4, 5) + ((3,) if probe == "no_prng" else ())
                if not all(torch.equal(k[i], f32[i]) for i in same):
                    raise Fail(f"{tag}: not the float32 launch's outputs "
                               "bit for bit")
                extra["bit_identical_to_f32_launch"] = [
                    ("sf", "si", "obs", "traj", "moments", "partials")[i]
                    for i in same]
                del f32
            torch.cuda.synchronize()
            frac_p, e_p = philox_tier(tag, k, p)
            mom_rel = moments(k, p, tag)
            if probe != "no_traj":
                extra["fold_partials"] = fold_check(k)
            errs[f"fused_rollout_probe_{probe}"] = max(
                errs[f"fused_rollout_probe_{probe}"], e_p)
            # the probe x bf16 instances on the same inputs
            b16 = {}
            out = {"float32": k}
            for branch in ("traj", "policy", "both"):
                name = f"fused_rollout_probe_bf16_{probe}_{branch}"
                kb = out[branch] = run(**flags(branch))
                if probe == "sim_only" and branch != "traj":
                    # no policy runs: the sim_only launch of the storage
                    # type, bit for bit
                    want = out["traj" if branch == "both" else "float32"]
                    if not all(torch.equal(a, b) for a, b in zip(kb, want)):
                        raise Fail(f"{tag} {branch}: not the sim_only "
                                   "launch of its storage type")
                    b16[branch] = {"equals_sim_only_launch": True}
                    continue
                if branch == "policy":
                    if use_frozen:
                        pb = plain(**flags(branch))
                    else:
                        pb, plain_ms[name] = timed(
                            lambda: plain(**flags("policy")))
                    pp = pb
                else:
                    # bf16 storage: the launch of its policy rounded, and
                    # the plain version the float32-storage one rounded
                    base_k, base_p = (k, p) if branch == "traj" else \
                        (out["policy"], pp)
                    if not rounded(base_k, kb):
                        raise Fail(f"{tag} {branch}: not the launch of its "
                                   "policy rounded, bit for bit")
                    if use_frozen:
                        pb = (*base_p[:3], base_p[3].to(BF), base_p[4])
                    else:
                        pb, plain_ms[name] = timed(
                            lambda: plain(**flags(branch)))
                        if not rounded(base_p, pb):
                            raise Fail(f"{tag} {branch}: the plain version "
                                       "is not that of its policy rounded")
                pol = branch != "traj"
                torch.cuda.synchronize()
                frac_b, e_b = philox_tier(
                    f"{tag} {branch}", kb, pb, pol_tol if pol else None,
                    max_frac=1e-2 if pol and probe == "no_prng" else 1e-3)
                line = {"diverged_world_fraction": frac_b,
                        "max_abs_err_agreeing_worlds": e_b,
                        "obs_moment_rel_err": moments(kb, pb,
                                                      f"{tag} {branch}")}
                if branch == "policy" and probe != "no_traj":
                    line["fold_partials"] = fold_check(kb)
                if branch != "policy":
                    line["equals_launch_rounded"] = True
                b16[branch] = line
                errs[name] = max(errs[name], e_b)
            for branch, kb in out.items():
                if probe == "policy_only" and not (
                        torch.equal(kb[0], sf) and torch.equal(kb[2], obs0)
                        and torch.equal(kb[1][other], si[other])):
                    raise Fail(f"{tag} {branch}: sf, obs or si's non-action "
                               "rows moved")
                want = BF if branch in ("traj", "both") else torch.float32
                if probe == "no_traj" and (
                        kb[3].shape != (1, FR.ROLL_ROWS, W) or
                        kb[3].dtype != want or bool(kb[3].any())):
                    raise Fail(f"{tag} {branch}: trajectory "
                               f"{tuple(kb[3].shape)} {kb[3].dtype} is not "
                               "one zero block")
            emit({"phase": "rollout_probes", "probe": probe,
                  "frozen": use_frozen, "worlds": W, "ticks": T,
                  "noise": "philox constants" if probe == "no_prng" else
                  "external", "diverged_world_fraction": frac_p,
                  "max_abs_err_agreeing_worlds": e_p,
                  "obs_moment_rel_err": mom_rel, **extra, "bf16": b16})
            del k, p, out
    # ptxas: every instance of both libraries, none spilling
    tt_of = {"traj": ("t", 0), "policy": ("f", 1), "both": ("t", 1)}
    ptx32 = _build.ptxas_kernels("fused_rollout_probe")
    ptx16 = {**_build.ptxas_kernels("fused_rollout_probe_bf16"),
             **_build.ptxas_kernels("fused_rollout_probe_pbf")}
    ptxas = {}
    for probe, code in FR.PROBE_CODES.items():
        for fr in (False, True):
            ptxas[f"{probe}{' frozen' if fr else ''}"] = next(
                (v for key, v in ptx32.items()
                 if f"fused_rollout_probe_kernelILi1ELb{int(fr)}ELi{code}E"
                 in key), None)
            for branch, (tt, pbf) in tt_of.items():
                if f"fused_rollout_probe_bf16_{probe}_{branch}" not in \
                        PROBE_BF16_KERNELS:
                    continue
                ptxas[f"{probe}_{branch}{' frozen' if fr else ''}"] = next(
                    (v for key, v in ptx16.items()
                     if f"fused_rollout_probe_bf16_kernelILi1ELb{int(fr)}E"
                     f"{tt}Lb{pbf}ELi{code}E" in key), None)
    spills = {k: v for k, v in {**ptx32, **ptx16}.items()
              if v.get("spill_store_bytes") or v.get("spill_load_bytes")}
    if len(ptx16) != 4 * len(PROBE_BF16_KERNELS) or spills or \
            None in ptxas.values():
        raise Fail(f"kernel B probes: {len(ptx16)} probe x bf16 instances "
                   f"in the build log, spills {spills}, ptxas {ptxas}")
    emit({"phase": "rollout_probes", "ptxas": ptxas,
          "probe_bf16_instances": len(ptx16)})
    # the other trainee and a last tile of 32 worlds (96 worlds x 4 ticks,
    # the frozen policy on, external noise): each probe against its plain
    # version at parity B's tiers (the bf16 policy's logp and value at
    # POLICY_TOL, its actions and state exact); the bf16-storage launches
    # the launch of the same policy rounded, bit for bit
    we = 96
    g_e = torch.Generator(device=dev).manual_seed(17)
    sf_e, si_e = init_rows(cfg, we, g_e, dev)
    sf_e, si_e, obs_e = FS.fused_step(cfg, sf_e, si_e,
                                      draw_noise_rows(we, g_e, dev))
    ext = _ext_noise(g_e, 4, we, dev)
    edge = {}
    e_args = (cfg, sf_e, si_e, obs_e, mats, fmats)
    cases = [(pr, {"probe": pr}) for pr in FR.PROBES] + \
        [("bf16_policy", {"policy_bf16": True})] + \
        [(f"{pr}_policy", {"probe": pr, "policy_bf16": True})
         for pr in FR.PROBES if pr != "sim_only"]
    launched = {}
    for name, kw in cases:
        k = launched[name] = FR.fused_rollout(
            *e_args, n_steps=4, trainee_idx=0, noise=ext, **kw)
        p = FR.rollout_plain(*e_args, n_steps=4, trainee_idx=0, noise=ext,
                             **kw)
        torch.cuda.synchronize()
        exact = list(range(FR.R_ACT, FR.R_ACT + 6)) + [FR.R_DONE]
        compare(f"rollout {name} trainee 0 actions",
                [k[3][:, exact].to(torch.int32), k[1]],
                [p[3][:, exact].to(torch.int32), p[1]])
        tol = POLICY_TOL if "policy_bf16" in kw else 1e-4
        e = compare(f"rollout {name} trainee 0", [k[0], k[2], k[3]],
                    [p[0], p[2], p[3]], atol=tol)
        mom = float(((k[4] - p[4]).abs() /
                     torch.clamp(p[4].abs(), min=1.0)).max())
        if mom > 1e-5:
            raise Fail(f"rollout {name} trainee 0: obs moments {mom}")
        edge[name] = {"max_abs_err": e, "obs_moment_rel_err": mom}
    for pr in FR.PROBES:
        for branch in ("traj", "policy", "both"):
            kw = {"probe": pr, **flags(branch)}
            k = FR.fused_rollout(*e_args, n_steps=4, trainee_idx=0,
                                 noise=ext, **kw)
            if pr == "sim_only":
                want = launched["sim_only"]
                ok = rounded(want, k) if branch != "policy" else all(
                    torch.equal(a, b) for a, b in zip(want, k))
            elif branch == "policy":
                continue  # held against its plain version above
            else:
                ok = rounded(launched[pr if branch == "traj" else
                                      f"{pr}_policy"], k)
            if not ok:
                raise Fail(f"rollout {pr} {branch} trainee 0: not the "
                           "launch of its policy rounded, bit for bit")
        edge[f"{pr}_bf16_storage_equals_rounded_launch"] = True
    emit({"phase": "rollout_probes", "worlds": we, "ticks": 4,
          "trainee": 0, "frozen": True, "noise": "external", **edge})

    # the attribution: device ms and wrapper ms of each variant,
    # in-kernel Philox (no_prng: its constants), the probe x bf16 launches
    # counted from 0 around it
    FR.probe_bf16_launches = dict.fromkeys(FR.probe_bf16_launches, 0)
    times = {}
    for use_frozen in (False, True):
        fm = fmats if use_frozen else None
        for fam in ("float32", "policy") + (
                () if use_frozen else ("traj", "both")):
            kw = {} if fam == "float32" else flags(fam)
            row = times.setdefault(f"frozen={use_frozen}", {})[fam] = {}
            for pr in (None, *FR.PROBES):
                if pr is None:
                    key = "fused_rollout_kernel" if fam == "float32" else \
                        "fused_rollout_bf16_kernel"
                elif fam == "float32" or (pr == "sim_only" and
                                          fam == "policy"):
                    key = "fused_rollout_probe_kernel"
                else:
                    key = "fused_rollout_probe_bf16_kernel"

                def fn(pr=pr, kw=kw):
                    return FR.fused_rollout(cfg, sf, si, obs0, mats, fm,
                                            n_steps=T, trainee_idx=1,
                                            seed=seed, probe=pr, **kw)
                row[pr or "full"] = {"ms": kernel_ms(fn, 5, {key: 1}),
                                     "wrapper_ms": cuda_ms(fn, 5, 5)}
    launches = dict(FR.probe_bf16_launches)
    attribution = {}
    for fr, fams in times.items():
        for fam in ("float32", "policy"):
            full = fams[fam]["full"]["ms"]
            attribution[f"{fam} {fr}"] = {
                "ms": {v: t["ms"] for v, t in fams[fam].items()},
                "delta_vs_full_ms": {pr: full - fams[fam][pr]["ms"]
                                     for pr in FR.PROBES},
                "delta_share": {pr: (full - fams[fam][pr]["ms"]) / full
                                for pr in FR.PROBES}}
    emit({"phase": "rollout_probes", "worlds": W, "ticks": T,
          "noise": "philox (no_prng: constants)", "times": times,
          "attribution": attribution, "probe_bf16_launches": launches,
          "note": "ms: torch.profiler device time of the rollout kernel a "
                  "call; wrapper_ms: CUDA events around back-to-back "
                  "calls; the deltas: full minus each probe, the term it "
                  "drops"})
    return {"errs": errs, "plain_ms": plain_ms, "times": times,
            "launches": launches, "ptxas": ptxas}


def bf16_paths(cfg, hp, dev, mesh, reset_counts, counts, profiled,
               chunk_parity):
    """Each path of BF16_PATHS at the flagship width (8192 x 32, 4 x 4),
    the data-parallel ones on `mesh` (the in-process NCCL group of one
    rank): a warm-up iteration, 3 eager iterations with every kernel's
    launches counted from 0 (the path's kernels, each bf16 branch at
    least once, and no other; the trajectory's dtype), the eager ms; one
    profiled eager iteration (device busy and idle share); 3 eager
    iterations against a chunk of 3 bit for bit (`chunk_parity`); chunks
    of 50 (make_train_chunk), their ms by CUDA events (median of 3), one
    profiled graph replay against it (the idle share) and peak memory.
    Returns each path's launches and numbers."""
    import torch
    from madrona_basketball_tpu_torch.parallel import mesh as PM
    from madrona_basketball_tpu_torch.ppo import train_fused as TF
    every = {k for _, _, on in BF16_PATHS for k in on} | {
        "fused_rollout", "fused_rollout_tiled", "fused_gae", "obs_moments",
        "fused_update_phase", "fused_minibatch_grad_prefetch",
        "fused_minibatch_grad", *PROBE_KERNELS}
    res = {"launches": {}}
    for phase, flags, on in BF16_PATHS:
        kw = dict(flags)
        on_mesh = kw.pop("mesh", False)
        dp = kw.get("dp_update", False)
        it = TF.make_train_iteration(cfg, hp, dev,
                                     mesh=mesh if on_mesh else None, **kw)
        state = TF.init_train_state(cfg, hp, 1, dev)
        if on_mesh:
            state = PM.shard_train_state(state, mesh, dp)
        state, out, eager = eager_counted(it, state, reset_counts, counts,
                                          dev)
        launches = eager["launches_3_iterations"]
        missing = [k for k in on if launches[k] < 1]
        stray = [k for k in every if k not in on and launches.get(k)]
        if missing or stray:
            raise Fail(f"{phase}: kernels {missing} not launched, {stray} "
                       f"launched: {launches}")
        want = torch.bfloat16 if kw.get("bf16_traj") else torch.float32
        if out["traj"].dtype != want:
            raise Fail(f"{phase}: trajectory {out['traj'].dtype}")
        m = {k: float(out["metrics"][k]) for k in TF.METRICS}
        if not all(v == v and abs(v) < 1e30 for v in m.values()) or \
                not all(bool(torch.isfinite(p).all())
                        for p in state.agent.net.parameters()):
            raise Fail(f"{phase}: metrics {m} or params non-finite")
        (state, _), busy, wall, top = profiled(lambda: it(state))
        chunk_parity(f"{phase}_chunk_parity", False, state, it)
        state, chunked = chunked_numbers(it, state, 50, 3, reset_counts,
                                         counts, profiled, dev, phase)
        emit({"phase": phase, "worlds": W, "ticks": T,
              "epochs": hp.update_epochs, "minibatches": hp.num_minibatches,
              "flags": flags, "traj_dtype": str(want),
              **path_line(eager, busy, wall, top, chunked), "metrics": m})
        res["launches"][phase] = launches
        res[phase] = {"eager_ms": eager["eager_iteration_ms"],
                      "chunked_ms": chunked["chunked_iteration_ms"]}
        del state, out, it
        torch.cuda.empty_cache()
    return res


def bf16_learning(cfg, hp, dev):
    """BF16_LEARN iterations of each bf16 flag from seed 321 in chunks of
    BF16_LEARN_CHUNK: the plateau (min..max of the chunks' mean reward
    from BF16_PLATEAU_FROM on) must lie in BF16_BAND; the value at 600
    iterations and whether it lies in the flagship's 600-iteration band
    (-150..-105) are printed, not gated (a rounding-level change moves
    the 600-iteration value chaotically: ROADMAP §3)."""
    import torch
    from madrona_basketball_tpu_torch.ppo import train as TT
    from madrona_basketball_tpu_torch.ppo import train_fused as TF
    for phase, kw in (("learning_bf16_traj", {"bf16_traj": True}),
                      ("learning_bf16_policy", {"bf16_policy": True})):
        l_state = TF.init_train_state(cfg, hp, 321, dev)
        l_chunk = TT.make_train_chunk(TF.make_train_iteration(
            cfg, hp, dev, **kw), BF16_LEARN_CHUNK)
        curve = []
        t0 = time.perf_counter()
        for k in range(BF16_LEARN // BF16_LEARN_CHUNK):
            l_state, st = l_chunk(l_state)
            curve.append([BF16_LEARN_CHUNK * (k + 1),
                          float(st["mean_reward"][-1]),
                          float(st["mean_episode_length"][-1])])
        secs = time.perf_counter() - t0
        if not all(bool(torch.isfinite(p).all())
                   for p in l_state.agent.net.parameters()):
            raise Fail(f"{phase}: non-finite params")
        tail = [r for i, r, _ in curve if i >= BF16_PLATEAU_FROM]
        plateau = [min(tail), max(tail)]
        at600 = next(r for i, r, _ in curve if i == 600)
        emit({"phase": phase, "iterations": BF16_LEARN, "seed": 321,
              "flags": kw, "iters_per_dispatch": BF16_LEARN_CHUNK,
              "seconds": secs, "curve": curve,
              "plateau_from": BF16_PLATEAU_FROM, "plateau": plateau,
              "band": list(BF16_BAND),
              "in_band": BF16_BAND[0] <= plateau[0] and
              plateau[1] <= BF16_BAND[1],
              "at_600": at600, "at_600_in_band": -150.0 <= at600 <= -105.0})
        if not (BF16_BAND[0] <= plateau[0] and plateau[1] <= BF16_BAND[1]):
            raise Fail(f"{phase}: plateau {plateau} over iterations "
                       f"{BF16_PLATEAU_FROM}..{BF16_LEARN} outside "
                       f"{BF16_BAND}")
        del l_chunk, l_state
        torch.cuda.empty_cache()


def bf16_cli():
    """The training CLI with --bf16-traj --bf16-policy (4 iterations,
    logged every 2, at the auto chunk of 2: one iteration captured and
    replayed) writes a checkpoint that loads back equal and finite; with
    --rollout-tiled --bf16-traj it exits with the JAX trainer's message.
    The two run side by side as subprocesses."""
    import torch
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.ppo import train_fused as TF
    from madrona_basketball_tpu_torch.utils import checkpoint as CK
    root = Path(__file__).resolve().parent
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(root), os.environ.get("PYTHONPATH")])))
        base = ["madrona_basketball_tpu_torch.cli", *ALT_CLI_ARGS,
                "--num-iterations", "4", "--log-every-n-iterations", "2",
                "--save-model-every-n-iterations", "4"]
        jobs = {"bf16": (base + ["--model-name", "bf16", "--bf16-traj",
                                 "--bf16-policy"], {}),
                "tiled": (base + ["--model-name", "bf16t", "--rollout-tiled",
                                  "--bf16-traj"], {})}
        done = run_clis(jobs, tmp, env)
        rc, so, se, secs = done["bf16"]
        if rc != 0 or "Iterations per dispatch: 2" not in so:
            raise Fail(f"cli --bf16-traj --bf16-policy exited {rc}: "
                       f"{se[-3000:]} {so[-1000:]}")
        path = Path(tmp) / CK.checkpoint_path("bf16", 4)
        saved = torch.load(path, weights_only=True)
        back = CK.state_dict(CK.load_agent(str(path), "cpu"))
        if sorted(back) != sorted(saved) or not all(
                torch.equal(back[k], saved[k].cpu()) and
                bool(torch.isfinite(saved[k]).all()) for k in saved):
            raise Fail("cli bf16: the checkpoint does not load back equal "
                       "and finite")
        rc_t, so_t, se_t, secs_t = done["tiled"]
        if rc_t == 0 or TF.BF16_TRAJ_NEEDS not in se_t:
            raise Fail(f"cli --rollout-tiled --bf16-traj exited {rc_t}: "
                       f"{se_t[-2000:]}")
        emit({"phase": "cli_bf16", "seconds": [secs, secs_t],
              "checkpoint": CK.checkpoint_path("bf16", 4),
              "log": [ln for ln in so.splitlines()
                      if ln.startswith(("Update:", "Mean reward", "Model "))],
              "tiled_exit_code": rc_t,
              "tiled_message": se_t.strip().splitlines()[-1],
              "note": "2 CLI runs started together"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------
# The interactive path, the host executor, the cross-check trainer and
# the modules no trainer uses (ROADMAP items 13, 15, 17)
# ---------------------------------------------------------------------

HUMAN_ACTION = (1, 3, 0, 0, 0, 0)   # the scripted keyboard's action
HUMAN_TICKS = (10, 20)   # the ticks of counted iteration 2 under human control
PAUSE_TICKS = (5, 7)     # the ticks of the scripted iteration that pause
NATIVE_TICKS = 100       # ticks of the host executor against kernel A


class ScriptedViewer:
    """The viewer's surface (tests/test_interactive.py:19-43) without
    pygame, scripted by its tick count: after tick k it turns human
    control on for the next call when k is in `human`, sets the pause for
    the next call when k is in `pause`, and stores a copy of the rows at
    the ticks in `snap`.  `record` (set by the phase) receives the action
    rows of the selected agent that each launch of kernel A is given."""

    def __init__(self, selected: int):
        self.training_paused = False
        self.controller_manager = None
        self.selected = selected
        self.ticks = 0
        self.human_calls = 0
        self.human, self.pause, self.snap = set(), set(), {}
        self.snaps = {}
        self.env = None

    def set_controller_manager(self, mgr):
        self.controller_manager = mgr

    def set_training_paused(self, paused):
        self.training_paused = paused

    def get_selected_agent_index(self):
        return self.selected

    def get_human_action(self):
        self.human_calls += 1
        return list(HUMAN_ACTION)

    def tick(self):
        self.ticks += 1
        k = self.ticks
        mgr = self.controller_manager
        if mgr.human_control_active != (k in self.human):
            mgr.human_control_active = k in self.human
        self.training_paused = k in self.pause
        if k in self.snap:
            e = self.env.engine
            self.snaps[self.snap[k]] = (e.sf.clone(), e.si.clone(),
                                        e.obs.clone())


def interactive_path(cfg, hp, dev, reset_counts, counts, profiled):
    """`InteractiveTrainer` (ppo/train_interactive.py) at the flagship
    width (8192 x 32, 4 x 4; trainee 1) with a ScriptedViewer: a warm-up
    iteration, then 3 iterations with kernel A's launches counted from 0
    (33 an iteration: the reset pulse and 32 ticks), timed on the host
    clock (the trainer fences the card at every phase) with the timer's
    rollout / inference / sim / update spans and the peak memory; in the
    second, human control over ticks HUMAN_TICKS on world 0's trainee:
    kernel A's input rows must hold HUMAN_ACTION there and the policy's
    actions (the buffer's) in every other world and tick, and the
    keyboard read once a tick.  A scripted iteration pauses over
    PAUSE_TICKS: sf and obs unchanged across the two paused calls, si
    unchanged but the trainee's action rows (written for every world, as
    the JAX env writes them) and world 0's zeroed, 31 launches.  The
    viewer must tick once a call after the first reset.  One profiled
    iteration gives the device's busy time (idle share against the
    un-profiled median); one more runs with the frozen opponent
    (use_frozen: 33 launches of kernel A and 33 of kernel J, finite
    metrics; none of J in the 3 counted iterations).  No pygame is
    imported.
    Returns the trainer and the phase's numbers."""
    import torch
    from madrona_basketball_tpu_torch.models.agent import init_agent
    from madrona_basketball_tpu_torch.ops import eval_policy as EP
    from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS
    from madrona_basketball_tpu_torch.ppo.train_interactive import (
        InteractiveTrainer)
    ti = hp.trainee_idx
    viewer = ScriptedViewer(selected=ti)
    trainer = InteractiveTrainer(cfg, hp, viewer=viewer, seed=1, device=dev)
    env = viewer.env = trainer.env
    launched, bufs = [], []
    step0, roll0 = env.engine.step, trainer.rollout

    def step(noise=None):
        launched.append(env.engine.si[ACTION_ROWS[ti]].clone())
        step0(noise)

    def rollout(noise=None, gumbel=None):
        bufs.append(roll0(noise, gumbel))
        return bufs[-1]
    env.engine.step, trainer.rollout = step, rollout
    calls = {"n": 0}
    sw0 = env.step_with_world_actions

    def step_with_world_actions(*a, **k):
        calls["n"] += env.first_reset_done
        return sw0(*a, **k)
    env.step_with_world_actions = step_with_world_actions
    reset0 = env.reset

    def reset(noise=None):
        calls["n"] += env.first_reset_done
        return reset0(noise)
    env.reset = reset

    def base(i):
        """The viewer's tick count before iteration i's reset (iteration
        0, the warm-up, ticks T times: its reset precedes the first)."""
        return T + (i - 1) * (T + 1)

    trainer.train_iteration()                       # warm-up
    torch.cuda.synchronize()
    a, b = HUMAN_TICKS
    viewer.human = set(range(base(2) + 1 + a, base(2) + 1 + b))
    trainer.timer.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev)
    launched.clear()
    bufs.clear()
    reset_counts()
    EP.launches = 0
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = trainer.train_iteration()
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = counts()
    spans = {k: v / 3 * 1e3 for k, v in trainer.timer.t.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["fused_step"] != 3 * (T + 1) or EP.launches or any(
            n for k, n in launches.items() if k != "fused_step"):
        raise Fail(f"interactive_path: launches {launches}, kernel J "
                   f"{EP.launches}, want kernel A {3 * (T + 1)} and no "
                   f"other (the trainee's policy is `forward`)")
    if not all(bool(torch.isfinite(v).all()) for v in m.values()):
        raise Fail(f"interactive_path: non-finite metrics {m}")
    # the human override: the second iteration's launches 1..T are its
    # ticks (launch 0 is the reset pulse)
    human = torch.tensor(HUMAN_ACTION, dtype=torch.int32, device=dev)
    bad = 0
    for t in range(T):
        rows, acts = launched[(T + 1) + 1 + t], bufs[1]["actions"][t].T
        want_w0 = human if a <= t < b else acts[:, 0]
        bad += int((rows[:, 0] != want_w0).sum())
        bad += int((rows[:, 1:] != acts[:, 1:]).sum())
    if bad or viewer.human_calls != b - a:
        raise Fail(f"interactive_path: the override left {bad} action "
                   f"entries wrong, the keyboard read {viewer.human_calls} "
                   f"times (want {b - a})")
    # the pause (a scripted iteration, not counted above)
    p0, p1 = PAUSE_TICKS
    # the tick before tick t's call is number base + 1 + t
    viewer.pause = set(range(base(4) + 1 + p0, base(4) + 1 + p1))
    viewer.snap = {base(4) + 1 + p0: "before", base(4) + 1 + p1: "after"}
    reset_counts()
    trainer.train_iteration()
    paused_launches = counts()["fused_step"]
    (sf0, si0, ob0), (sf1, si1, ob1) = viewer.snaps["before"], \
        viewer.snaps["after"]
    act_rows = [r for rr in ACTION_ROWS for r in rr]
    keep = [r for r in range(si0.shape[0]) if r not in act_rows]
    if not (torch.equal(sf0, sf1) and torch.equal(ob0, ob1) and
            torch.equal(si0[keep], si1[keep]) and
            not bool(si1[ACTION_ROWS[ti], 0].any()) and
            paused_launches == T + 1 - (p1 - p0)):
        raise Fail(f"interactive_path: the pause moved the state or "
                   f"launched kernel A {paused_launches} times")
    ticks_ok = viewer.ticks == calls["n"] == T + 4 * (T + 1)
    if not ticks_ok:
        raise Fail(f"interactive_path: the viewer ticked {viewer.ticks} "
                   f"times over {calls['n']} calls after the first reset")
    # one profiled iteration: device busy
    _, busy, prof_wall, top = profiled(trainer.train_iteration)
    it_ms = statistics.median(wall)
    # the frozen opponent: one iteration of a trainer with use_frozen
    hp_f = dataclasses.replace(hp, use_frozen=True)
    frozen = init_agent(torch.Generator().manual_seed(9), dev)
    tr_f = InteractiveTrainer(cfg, hp_f, frozen=frozen, seed=2, device=dev)
    reset_counts()
    EP.launches = 0
    t0 = time.perf_counter()
    m_f = tr_f.train_iteration()
    f_ms = (time.perf_counter() - t0) * 1e3
    f_launch, f_j = counts()["fused_step"], EP.launches
    # the frozen opponent is kernel J: one launch at the reset pulse and
    # one a tick, as kernel A
    if f_launch != T + 1 or f_j != T + 1 or not all(
            bool(torch.isfinite(v).all()) for v in m_f.values()):
        raise Fail(f"interactive_path frozen: {f_launch} launches of A, "
                   f"{f_j} of J, {m_f}")
    if "pygame" in sys.modules:
        raise Fail("interactive_path: pygame was imported")
    line = {"phase": "interactive_path", "worlds": W, "ticks": T,
            "epochs_x_minibatches": [hp.update_epochs, hp.num_minibatches],
            "iteration_ms": wall, "iteration_ms_median": it_ms,
            "train_env_steps_per_s": W * T / (it_ms / 1e3),
            "timer_spans_ms_per_iteration": spans,
            "launches_3_iterations": launches["fused_step"],
            "launches_per_iteration": launches["fused_step"] / 3,
            "human_ticks": [a, b], "keyboard_reads": viewer.human_calls,
            "paused_ticks": p1 - p0,
            "paused_iteration_launches": paused_launches,
            "viewer_ticks": viewer.ticks, "env_calls_after_reset":
            calls["n"], "profiled_wall_ms": prof_wall,
            "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / it_ms) if busy else None,
            "top_device_ms": top, "peak_memory_bytes": peak,
            "peak_over_start_bytes": peak - start_bytes,
            "frozen_iteration_ms": f_ms, "frozen_launches": f_launch,
            "frozen_j_launches": f_j,
            "metrics": {k: float(v) for k, v in m.items()},
            "pygame_imported": False}
    emit(line)
    env.engine.step, trainer.rollout = step0, roll0
    env.step_with_world_actions, env.reset = sw0, reset0
    return trainer, line


def interactive_card_vs_cpu(cfg, dev):
    """One interactive iteration at 256 worlds x 8 ticks, 2 x 2, on the
    card and on the CPU (kernel A's plain version and torch there) from
    one state (the card trainer's rows and agent copied), with one set
    of injected draws (the sim noise, the Gumbel draws, the update's
    permutations, through the trainer's seams).  Rollout rows at kernel
    A's tier: the buffer's actions and the engine's integer rows exact
    but in worlds at the shot's going-in threshold (F1, counted; at most
    0.1 % of world-ticks), every float of the other worlds within 1e-5
    of max(1, |x|); the params after the update at
    parity_autodiff_update's tier, carried over the E x M = 4 Adam
    steps: within 4 x 1e-4 / 16, but entries whose update may flip sign
    on a near-zero gradient, which may move up to 4 x 2 lr and must stay
    under 1 % of the entries (counted)."""
    import torch
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    from madrona_basketball_tpu_torch.ops.fused_rollout import (
        N_LOGITS, gumbel_from_uniform)
    from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
    from madrona_basketball_tpu_torch.ppo.train_interactive import (
        InteractiveTrainer)
    w, t_, cpu = 256, 8, torch.device("cpu")
    hp = PPOParams(num_envs=w, num_rollout_steps=t_, num_minibatches=2,
                   update_epochs=2)
    card = InteractiveTrainer(cfg, hp, seed=4, device=dev)
    host = InteractiveTrainer(cfg, hp, agent=state_to_agent(card.agent, cpu),
                              seed=4, device="cpu")
    host.env.engine.sf = card.env.engine.sf.cpu()
    host.env.engine.si = card.env.engine.si.cpu()
    g = torch.Generator().manual_seed(12)
    u = torch.rand((t_ + 1, 9, w), generator=g)
    noise = torch.cat([2 * u[:, :8] - 1, u[:, 8:]], dim=1)
    gum = gumbel_from_uniform(torch.rand((t_, w, N_LOGITS), generator=g))
    perms = card._update_policy.draw_perms(g, cpu)
    bufs = {}
    for name, tr in (("card", card), ("cpu", host)):
        d = tr.device
        r0 = tr.rollout

        def rollout(noise=None, gumbel=None, r0=r0, name=name):
            bufs[name] = r0(noise, gumbel)
            return bufs[name]
        tr.rollout = rollout
        tr.train_iteration(noise=iter(noise.to(d)), gumbel=iter(gum.to(d)),
                           perms=perms.to(d))
    cb, hb = bufs["card"], bufs["cpu"]
    bad_w = (cb["actions"].cpu() != hb["actions"]).any(dim=2).any(dim=0)
    bad_w |= (card.env.engine.si.cpu() != host.env.engine.si).any(dim=0)
    n_bad = int(bad_w.sum())
    if n_bad > max(1, 1e-3 * w * t_):
        raise Fail(f"interactive_card_vs_cpu: {n_bad} worlds diverge")
    ok = ~bad_w
    err = 0.0
    for k in ("obs", "values", "log_probs", "not_dones", "rewards"):
        gk, hk = cb[k].cpu()[:, ok], hb[k][:, ok]
        d_ = ((gk - hk).abs() / torch.clamp(hk.abs(), min=1.0)).max()
        err = max(err, float(d_))
    for gk, hk in ((card.env.engine.sf.cpu(), host.env.engine.sf),
                   (card.env.engine.obs.cpu(), host.env.engine.obs)):
        d_ = ((gk - hk)[:, ok].abs() / torch.clamp(hk[:, ok].abs(),
                                                     min=1.0)).max()
        err = max(err, float(d_))
    if err > 1e-5:
        raise Fail(f"interactive_card_vs_cpu: rollout float error {err}")
    steps = hp.update_epochs * hp.num_minibatches
    p_err, flips = 0.0, 0
    for a, b in zip(FU.pack_weights(card.agent.net),
                    FU.pack_weights(host.agent.net)):
        d_ = (a.cpu() - b).abs()
        if bool((d_ > steps * 2 * hp.learning_rate + 1e-6).any()):
            raise Fail(f"interactive_card_vs_cpu: params off by "
                       f"{float(d_.max())}")
        over = d_ > steps * 1e-4 / 16
        flips += int(over.sum())
        p_err = max(p_err, float(d_[~over].max()) if bool((~over).any())
                    else 0.0)
    n_params = sum(p.numel() for p in card.agent.net.parameters())
    if flips > 0.01 * n_params or card.opt.count != host.opt.count:
        raise Fail(f"interactive_card_vs_cpu: {flips} param entries beyond "
                   f"{steps} x 1e-4 / 16")
    emit({"phase": "interactive_card_vs_cpu", "worlds": w, "ticks": t_,
          "epochs_x_minibatches": [2, 2], "diverged_worlds": n_bad,
          "rollout_max_rel_err": err, "params_max_abs_err": p_err,
          "param_entries_beyond_the_step_tier": flips,
          "tier": "ints exact but <= 0.1 % of world-ticks, floats 1e-5 of "
                  "max(1, |x|); params 4 x 1e-4 / 16, or 4 x 2 lr on < 1 % "
                  "of entries"})


def eval_policy_phase(dev) -> dict:
    """Kernel J (ops/eval_policy.py): both eval policies' forward and
    Gumbel-max sampling in one launch.  Against its plain version on the
    card at 10, 300 and 8192 worlds (both agents, on uniforms, on Gumbel
    values and the argmax): actions equal wherever a bucket's two best
    perturbed logits lie more than 1e-4 apart.  At 8192 worlds x 2
    agents: J's profiled device ms a launch beside its byte bound, the
    wrapper's ms, the plain version's ms and `act`'s torch ms for the same
    two agents (with the old tick's action writes).  Then 10 seeds of a
    96-tick eval (three captured 32-tick chunks, the frozen opponent on)
    against the same ticks with `act`'s torch policies and kernel A from
    the same state and generators: the share of worlds whose int rows or
    episode counts differ, or whose float rows differ by more than 1e-3
    of their row's scale (the benchmark's `worlds_off_pct`); the chunk's
    kernel nodes and J launches, and its CUDA-event ms a tick.  Emits
    the phase line; returns J's kernel-table row."""
    import torch

    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch import infer as IF
    from madrona_basketball_tpu_torch.config import SimConfig
    from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
    from madrona_basketball_tpu_torch.env import BasketballEnv
    from madrona_basketball_tpu_torch.models.agent import act, init_agent
    from madrona_basketball_tpu_torch.ops import eval_policy as EP
    from madrona_basketball_tpu_torch.ops.fused_rollout import (
        N_LOGITS, OBS, gumbel_from_uniform)
    from madrona_basketball_tpu_torch.ops.fused_step import fused_step
    from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS, F_IDX

    t0 = time.perf_counter()
    NA = len(ACTION_ROWS[0])
    cpu = torch.Generator().manual_seed(61)

    def agent(seed):
        """Weights from the seed, a fitted-looking obs normalizer and the
        actor head at the backbone's scale (a trained checkpoint's)."""
        ap = init_agent(torch.Generator().manual_seed(seed), dev)
        with torch.no_grad():
            ap.obs_rms.mean.copy_(torch.randn(OBS, generator=cpu))
            ap.obs_rms.var.copy_(torch.rand(OBS, generator=cpu) * 4 + 0.05)
            w = ap.net.actor.weight
            w.copy_(torch.randn(tuple(w.shape), generator=cpu) *
                    (2.0 / 3.0 / w.shape[1]) ** 0.5)
        return ap

    agents = [agent(62), agent(63)]

    def clear(noisy, margin=1e-4):
        out, off = [], 0
        for n in (2, 8, 3, 2, 2, 2):
            top = noisy[:, off:off + n].topk(2, dim=-1).values
            out.append(top[:, 0] - top[:, 1] > margin)
            off += n
        return torch.stack(out, dim=1)

    def jobs_at(W, kind):
        rows = torch.randn((2 * OBS, W), generator=cpu).to(dev) * 2
        si = torch.zeros((2 * NA, W), dtype=torch.int32, device=dev)
        out = []
        for a in range(2):
            u = torch.rand((W, N_LOGITS), generator=cpu).to(dev)
            noise = {"uniforms": u, "seam": gumbel_from_uniform(u),
                     "argmax": None}[kind]
            out.append(EP.PolicyJob(agents[a], rows[a * OBS:(a + 1) * OBS].T,
                                    noise, kind == "seam",
                                    si[a * NA:(a + 1) * NA].T))
        return out

    parity = []
    for W_ in (10, 300, W):
        for kind in ("uniforms", "seam", "argmax"):
            jobs = jobs_at(W_, kind)
            EP.eval_policy(jobs)
            for a, j in enumerate(jobs):
                logits = EP.policy_logits_plain(j.agent, j.obs)
                noisy = logits if j.noise is None else logits + (
                    j.noise if j.gumbel else gumbel_from_uniform(j.noise))
                want = EP.policy_plain(j.agent, j.obs, j.noise, j.gumbel)
                ok = clear(noisy)
                bad = int((j.act[ok] != want[ok]).sum())
                if bad:
                    raise Fail(f"eval_policy {W_} worlds {kind} agent {a}: "
                               f"{bad} clear actions differ from the plain "
                               "version's")
                parity.append({"worlds": W_, "noise": kind, "agent": a,
                               "clear_share": float(ok.float().mean()),
                               "near_tie_differ": int(
                                   (j.act[~ok] != want[~ok]).sum())})
    torch.cuda.synchronize()

    # times at 8192 worlds x 2 agents
    jobs = jobs_at(W, "uniforms")
    si_old = torch.zeros((2 * NA, W), dtype=torch.int32, device=dev)

    def torch_policies():
        for a, j in enumerate(jobs):
            si_old[a * NA:(a + 1) * NA] = act(
                j.agent, j.obs, gumbel_from_uniform(j.noise)).T.to(
                    torch.int32)

    j_ms = kernel_ms(lambda: EP.eval_policy(jobs), 50,
                     {"eval_policy_kernel": 1})
    wrapper_ms = cuda_ms(lambda: EP.eval_policy(jobs), 50)
    plain_ms = cuda_ms(lambda: [EP.policy_plain(j.agent, j.obs, j.noise)
                                for j in jobs], 3)
    act_ms = cuda_ms(torch_policies, 20)
    nbytes = 2 * W * (OBS + N_LOGITS + NA) * 4
    nops = 2 * W * 2 * (32 * OBS + 32 * 32 + N_LOGITS * 32)
    bms, by = bound(nbytes, nops)

    # worlds_off_pct of 96 ticks, J's captured chunk against act's ticks
    cfg = SimConfig()
    off_pct, nodes, pol_launches, tick_ms = [], None, None, None
    done_row = F_IDX["a1.done"]
    for s in range(10):
        env = BasketballEnv(W, cfg, seed=7000 + s, trainee_agent_idx=1,
                            device=dev)
        env.reset()
        pols = [IF.make_policy_fn(agents[a], IF.generator(100 * s + a, dev))
                for a in range(2)]
        chunk = IF.make_eval_chunk(env, pols[0], pols[1], 32, 0, False)
        gens = [pols[0].gen, pols[1].gen, env.engine.gen]
        start = [t.clone() for t in (chunk.sf, chunk.si, chunk.obs)]
        states = [g.get_state() for g in gens]
        for _ in range(3):
            chunk.run(32)
        got = (chunk.sf, chunk.si, chunk.obs, chunk.counts)
        g_ = []
        for g, st in zip(gens, states):
            g2 = torch.Generator(device=dev)
            g2.set_state(st)
            g_.append(g2)
        sf, si, obs = start
        counts = torch.zeros_like(chunk.counts)
        with torch.no_grad():
            for _ in range(96):
                si_in = si.clone()
                for a, ap, g in ((1, agents[0], g_[0]), (0, agents[1], g_[1])):
                    u = torch.rand((W, N_LOGITS), generator=g, device=dev)
                    lo = ACTION_ROWS[a][0]
                    si_in[lo:lo + NA] = act(ap, obs[a * OBS:(a + 1) * OBS].T,
                                            gumbel_from_uniform(u)).T
                sf, si, obs = fused_step(cfg, sf, si_in,
                                         draw_noise_rows(W, g_[2], dev))
                counts = counts + sf[done_row].to(torch.int32)
        off = (got[1] != si).any(dim=0) | (got[3] != counts)
        for p_, r_ in ((got[0], sf), (got[2], obs)):
            scale = r_.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
            off |= ((p_ - r_).abs() / scale).amax(dim=0) > 1e-3
        off_pct.append(100.0 * float(off.sum()) / W)
        if s == 0:
            nodes, pol_launches = chunk.kernel_nodes, chunk.policy_launches
            tick_ms = cuda_ms(lambda: chunk.run(32), 20, windows=3) / 32
    if pol_launches != 32 or nodes is None or nodes / 32 > 20:
        raise Fail(f"eval_policy: the captured chunk holds {pol_launches} "
                   f"launches of J and {nodes} kernel nodes")
    row = {"name": "eval_policy", "route": "cuda",
           "source": "madrona_basketball_tpu_torch/csrc/eval_policy.cu",
           "replaces": None, "ms": j_ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "library_ms": act_ms, "bound_ms": bms,
           "bound_by": by, "bytes": nbytes, "ops": nops,
           "bound_share": bms / j_ms, "agents": 2, "worlds": W,
           "ptxas": _build.ptxas_kernels("eval_policy")}
    emit({"phase": "eval_policy", "seconds": time.perf_counter() - t0,
          "parity": parity, **row,
          "library_ms_is": "act's torch policies for both agents with the "
                           "old tick's action writes",
          "worlds_off_pct_96_ticks": off_pct,
          "worlds_off_pct_max": max(off_pct),
          "chunk_kernel_nodes": nodes, "chunk_policy_launches": pol_launches,
          "kernel_nodes_per_tick": nodes / 32,
          "chunk_ms_per_tick": tick_ms})
    return row


def update_stage_probe(hp, idx, traj, side, nrm, ustats, params, wb):
    """Kernel D's gradient launch over one minibatch with the stage probe
    (csrc/fused_update_probe.cu): SM cycles of each stage of a tile, its
    own work and its wait at the barrier after it, for warps 0 and 6 of
    CTA 0 (medians over the CTA's tiles, three launches), and the probe's
    registers and spills.  Each launch's partial sums must equal those of
    D's own gradient launch on the same minibatch bit for bit."""
    import torch
    from madrona_basketball_tpu_torch import _build
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    FU.probe_launches = 0
    runs = [FU.stage_probe(hp, idx, traj, side, nrm, ustats, params, wb=wb)
            for _ in range(3)]
    d_rows = FU.grad_partials(hp, idx, traj, side, nrm, ustats, params,
                              wb=wb)
    torch.cuda.synchronize()
    differing = [int((r["partials"].view(torch.int32) !=
                      d_rows.view(torch.int32)).sum()) for r in runs]
    if any(differing):
        raise Fail(f"the stage probe's partial sums differ from D's "
                   f"gradient launch in {differing} of {d_rows.numel()} "
                   "entries")
    last = runs[-1]
    ptx = _build.ptxas_kernels("fused_update_probe")
    if any(v.get("spill_store_bytes", 0) for v in ptx.values()):
        raise Fail(f"the stage probe spills: {ptx}")
    emit({"phase": "update_stage_probe", "warps": last["warps"],
          "tiles": last["tiles"],
          "tile_cycles": [r["tile_cycles"] for r in runs],
          "work": last["work"], "wait": last["wait"],
          "partials_equal_d": True, "partial_entries": d_rows.numel(),
          "launches": FU.probe_launches, "ptxas": ptx})
    print(f"{'stage':<15}" + "".join(f"{'work / wait, warp ' + str(w):>26}"
                                     for w in last["warps"]))
    for name in FU.STAGES:
        print(f"{name:<15}" + "".join(
            f"{last['work'][name][k]:>16.0f} / {last['wait'][name][k]:>7.0f}"
            for k in range(2)))
    print(f"{'tile':<15}" + "".join(f"{c:>26.0f}" for c in
                                     last["tile_cycles"]), flush=True)


def cpu_model() -> str:
    """The host CPU: lscpu's model name, or, where the machine hides it,
    its vendor, family and model numbers; and the CPU count."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
    except OSError:
        out = ""
    f = {k.strip(): v.strip() for k, _, v in
         (line.partition(":") for line in out.splitlines())}
    name = f.get("Model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{f.get('Vendor ID', '?')} family "
                f"{f.get('CPU family', '?')} model {f.get('Model', '?')} "
                "(model name not exposed)")
    return f"{name}, {os.cpu_count()} CPUs"


def native_engine(cfg, dev):
    """The port's native host executor (native/__init__.py::NativeEngine,
    csrc/host_step.cpp over sim_world.cuh's step_world, g++) at 8192
    worlds against kernel A on the same rows, random actions and noise,
    NATIVE_TICKS ticks, the host rows resynchronized to the card's after
    each tick: integer rows exact but for world-ticks at the shot's
    going-in threshold (F1: the card's sinf / cosf and contracted FMAs
    against the host's libm, unfused; counted, at most 0.1 %), float rows
    and obs of the other worlds within 1e-4 (A's tier, the g++ body's in
    parity_multistep).  Then 1 thread against all threads, 5 ticks, bit
    for bit.  Host env-steps/s (the host's clock around `step`) beside
    the host CPU's model and the thread count."""
    import numpy as np
    import torch
    from madrona_basketball_tpu_torch.native import NativeEngine
    from madrona_basketball_tpu_torch.ops import fused_step as FS
    from madrona_basketball_tpu_torch.ops.layout import ACTION_ROWS
    eng = NativeEngine(cfg, W, seed=5)
    sf, si = (torch.tensor(x, device=dev) for x in (eng.sf, eng.si))
    rng = np.random.RandomState(3)
    bad, err, host_s = 0, 0.0, 0.0
    for _ in range(NATIVE_TICKS):
        acts = rng.randint(0, [2, 8, 3, 2, 2, 2],
                           size=(W, 2, 6)).astype(np.int32)
        eng.set_actions(acts)
        a_d = torch.from_numpy(acts).to(dev)
        si = si.clone()
        for i in range(2):
            for j, r in enumerate(ACTION_ROWS[i]):
                si[r] = a_d[:, i, j]
        noise = eng.draw_noise()
        t0 = time.perf_counter()
        eng.step(noise)
        host_s += time.perf_counter() - t0
        sf, si, obs = FS.fused_step(cfg, sf, si,
                                    torch.from_numpy(noise).to(dev))
        h_sf, h_si, h_obs = (torch.from_numpy(x) for x in
                             (eng.sf, eng.si, eng.obs))
        g_sf, g_si, g_obs = sf.cpu(), si.cpu(), obs.cpu()
        wb = (g_si != h_si).any(dim=0)
        bad += int(wb.sum())
        ok = ~wb
        if bool(ok.any()):
            err = max(err, float((g_sf - h_sf)[:, ok].abs().max()),
                      float((g_obs - h_obs)[:, ok].abs().max()))
        np.copyto(eng.sf, g_sf.numpy())
        np.copyto(eng.si, g_si.numpy())
    if bad > 1e-3 * W * NATIVE_TICKS or err > 1e-4:
        raise Fail(f"native_engine vs kernel A: {bad} world-ticks differ "
                   f"in integers, float error {err}")
    one = NativeEngine(cfg, W, seed=5, n_threads=1)
    every = NativeEngine(cfg, W, seed=5)
    one_s = 0.0
    for _ in range(5):
        noise = one.draw_noise()
        t0 = time.perf_counter()
        one.step(noise)
        one_s += time.perf_counter() - t0
        every.step(noise)
    same = all(np.array_equal(x, y) for x, y in
               ((one.sf, every.sf), (one.si, every.si),
                (one.obs, every.obs)))
    if not same:
        raise Fail("native_engine: 1 thread and all threads differ")
    emit({"phase": "native_engine", "worlds": W, "ticks": NATIVE_TICKS,
          "world_ticks_differing": bad, "max_abs_err": err,
          "threads": eng.n_threads, "host_cpu": cpu_model(),
          "host_env_steps_per_s_all_threads": W * NATIVE_TICKS / host_s,
          "host_env_steps_per_s_1_thread": W * 5 / one_s,
          "one_thread_equals_all_threads": True,
          "note": "host numbers: the host CPU's clock, not the card's",
          "tier": "ints exact but <= 0.1 % of world-ticks, floats 1e-4"})


def crosscheck(dev):
    """The cross-check trainer (crosscheck/torch_ppo.py::train) at 512
    worlds, 3 iterations of PPOParams' T = 32 and 4 x 4, the agent and
    the update on the card, the native host executor stepping: ms an
    iteration (the host's clock over the run / 3) and the mean reward."""
    import torch
    from madrona_basketball_tpu_torch.crosscheck.torch_ppo import train
    from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
    hp = PPOParams(num_envs=512)
    t0 = time.perf_counter()
    agent, history = train(512, 3, seed=0, log_every=1, hp=hp, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 3
    if next(agent.parameters()).device != torch.device(dev) or \
            len(history) != 3 \
            or not all(bool(torch.isfinite(p).all())
                       for p in agent.parameters()):
        raise Fail(f"crosscheck: {history}")
    emit({"phase": "crosscheck", "worlds": 512, "iterations": 3,
          "iteration_ms": ms, "mean_reward": history[-1]["mean_reward"],
          "episodes": history[-1]["episodes"], "host_cpu": cpu_model()})


def aux_modules(dev, trainer):
    """PopArt, the EMA normalizer and RolloutBuffer on CUDA tensors
    against the same calls on the CPU, within 1e-6 (of max(1, |x|));
    a `utils/profiling.trace` session around one interactive iteration
    must write its host span and a clock calibration."""
    import torch
    from madrona_basketball_tpu_torch.models import moving_avg as EMA
    from madrona_basketball_tpu_torch.models import popart as PA
    from madrona_basketball_tpu_torch.ppo import buffers as BUF
    from madrona_basketball_tpu_torch.utils import profiling
    g = torch.Generator().manual_seed(21)
    errs = []

    def close(a, b):
        e = float(((a.cpu() - b).abs() /
                   torch.clamp(b.abs(), min=1.0)).max())
        errs.append(e)
        if e > 1e-6:
            raise Fail(f"aux_modules: error {e}")
    out = []
    for d in (dev, torch.device("cpu")):
        g.manual_seed(21)
        x = torch.randn((4096, 2), generator=g).mul(3).add(1)
        k, b = torch.randn((32, 2), generator=g), torch.randn(2, generator=g)
        st = PA.popart_init(2, device=d)
        res = []
        for _ in range(3):
            st, kk, bb = PA.popart_update(st, x.to(d), k.to(d), b.to(d))
            res += [st.m, st.v, kk, bb, PA.popart_normalize(st, x.to(d)),
                    PA.popart_normalize(st, x.to(d), unnorm=True)]
        e = EMA.ema_init(0.99, device=d)
        for i in range(3):
            e = EMA.ema_update(e, x[:, 0].to(d) * (i + 1))
            res += [e.mu, e.sigma, EMA.ema_normalize(e, x[:, 1].to(d)),
                    EMA.ema_unnormalize(e, x[:, 1].to(d))]
        buf = BUF.make_buffer(8, 512, 16, 6, d)
        for t in range(8):
            buf = buf.set_step(t, x[:512, :1].repeat(1, 16).to(d) + t,
                               torch.zeros((512, 6), dtype=torch.int32,
                                           device=d) + t,
                               *(x[:512, 0].to(d) * (t + j) for j in range(4)))
        idx = torch.arange(0, 4096, 7)
        res += list(buf.get_minibatch(idx.to(d)))[:1] + \
            [v.float() for v in buf.get_minibatch(idx.to(d))[1:]]
        out.append(res)
    for a, b in zip(*out):
        close(a, b)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profiling.trace(path, dev):
            with profiling.annotate("interactive_iteration"):
                trainer.train_iteration()
        trace = json.loads(Path(path).read_text())
        size = Path(path).stat().st_size
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    cal = trace["otherData"]["calibration"]
    if "interactive_iteration" not in names or cal["pairs"] < 16:
        raise Fail(f"aux_modules: the trace lacks the host span or the "
                   f"calibration: {sorted(names)}, {cal}")
    emit({"phase": "aux_modules", "max_rel_err": max(errs),
          "compared": len(errs), "trace_bytes": size,
          "trace_host_span": True, "calibration": cal})


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
    from madrona_basketball_tpu_torch.engine_fused import (FusedEngine,
                                                           draw_noise_rows)
    from madrona_basketball_tpu_torch.env import BasketballEnv
    from madrona_basketball_tpu_torch.export import export_tensors
    from madrona_basketball_tpu_torch.models.agent import forward as act
    from madrona_basketball_tpu_torch.models.agent import init_agent
    from madrona_basketball_tpu_torch.models.normalize import rms_update
    from madrona_basketball_tpu_torch.ops import fused_gae as FG
    from madrona_basketball_tpu_torch.ops import fused_rollout as FR
    from madrona_basketball_tpu_torch.ops import fused_step as FS
    from madrona_basketball_tpu_torch.ops import fused_update as FU
    from madrona_basketball_tpu_torch.ops.layout import (ACTION_ROWS, F_IDX,
                                                         N_OBS_ROWS,
                                                         RESET_ROWS)
    from madrona_basketball_tpu_torch.ppo import train as TT
    from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
    from madrona_basketball_tpu_torch.ppo.train_fused import (
        CollectNoise, init_rollout_state, init_train_state, make_collect,
        make_train_iteration, restore_train_state, save_train_state,
        state_tensors, update_block)
    from madrona_basketball_tpu_torch.utils import checkpoint as CK
    from madrona_basketball_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = nvidia_smi_line()
    CARD["card"] = smi
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---------------------------------------------------------- build
    b = _build.build()
    emit({"phase": "build", "seconds": round(b["seconds"], 2),
          "built": b["built"], "library_seconds": b["library_seconds"],
          "ptxas": b["ptxas"]})

    cfg = SimConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    gen_cpu = torch.Generator().manual_seed(0)
    errs = {"fused_step": 0.0, "fused_rollout": 0.0, "fused_gae": 0.0,
            "meter_scan": 0.0, "fused_update_phase": 0.0,
            "fused_minibatch_grad_prefetch": 0.0,
            "fused_minibatch_grad": 0.0,
            "fused_multistep_every_tick_obs": 0.0,
            "fused_multistep_held_obs": 0.0, "fused_rollout_tiled": 0.0,
            "obs_moments": 0.0}

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
                             trainee_idx=1, noise=ext, moment_partials=True)
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
        fold = fold_check(k)
        errs["fused_rollout"] = max(errs["fused_rollout"], e)
        emit({"phase": "parity_fused_rollout", "worlds": W, "ticks": Ts,
              "frozen": use_frozen, "noise": "external", "max_abs_err": e,
              "obs_moment_rel_err": mom_rel, "fold_partials": fold})

    seed = 12345
    k32 = FR.fused_rollout(cfg, k_sf, k_si, obs0, mats, n_steps=T,
                           trainee_idx=1, seed=seed, moment_partials=True)
    ph_noise = FR.philox_noise(seed, 0, T, W, dev)
    p32 = FR.rollout_plain(cfg, k_sf, k_si, obs0, mats, n_steps=T,
                           trainee_idx=1, noise=ph_noise)
    torch.cuda.synchronize()
    frac, e32 = philox_tier("32-tick Philox rollout", k32, p32)
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
    fold32 = fold_check(k32)
    emit({"phase": "parity_fused_rollout", "worlds": W, "ticks": T,
          "noise": "philox", "diverged_world_fraction": frac,
          "max_abs_err_agreeing_worlds": e32, "composes": composes,
          "fold_partials": fold32})

    # ---------------------------------------------------------- bf16: B
    # kernel B's bf16 instances (csrc/fused_rollout_bf16.cu) on the same
    # state and Philox seed: bf16 storage is the float32 launch's rows
    # rounded, its state, obs, moments and fold partials the float32
    # launch's, bit for bit; each branch against its plain version at B's
    # Philox tier (the bf16 policy's logp and value at POLICY_TOL)
    BF = torch.bfloat16
    b16 = FR.fused_rollout(cfg, k_sf, k_si, obs0, mats, n_steps=T,
                           trainee_idx=1, seed=seed, moment_partials=True,
                           traj_dtype=BF)
    p16 = FR.rollout_plain(cfg, k_sf, k_si, obs0, mats, n_steps=T,
                           trainee_idx=1, noise=ph_noise, traj_dtype=BF)
    torch.cuda.synchronize()
    if not torch.equal(b16[3].view(torch.int16),
                       k32[3].to(BF).view(torch.int16)) or \
            not all(torch.equal(b16[i], k32[i]) for i in (0, 1, 2, 4, 5)):
        raise Fail("kernel B bf16 storage: not the float32 launch rounded, "
                   "or its state, obs or moments differ")
    frac16, e16 = philox_tier("kernel B bf16 storage", b16, p16)
    errs["fused_rollout_bf16_traj"] = e16
    emit({"phase": "bf16_kernels", "kernel": "fused_rollout_bf16_traj",
          "worlds": W, "ticks": T, "noise": "philox",
          "traj_equals_f32_launch_rounded": True,
          "state_obs_moments_partials_equal_f32_launch": True,
          "vs_plain": {"diverged_world_fraction": frac16,
                       "max_abs_err_agreeing_worlds": e16}})
    pol16 = {}
    for use_frozen in (False, True):
        fm = fmats if use_frozen else None
        kp = FR.fused_rollout(cfg, k_sf, k_si, obs0, mats, fm, n_steps=T,
                              trainee_idx=1, seed=seed, policy_bf16=True,
                              moment_partials=True)
        pp = FR.rollout_plain(cfg, k_sf, k_si, obs0, mats, fm, n_steps=T,
                              trainee_idx=1, noise=ph_noise,
                              policy_bf16=True)
        # both flags: the bf16 policy's rows stored in bf16
        kb = FR.fused_rollout(cfg, k_sf, k_si, obs0, mats, fm, n_steps=T,
                              trainee_idx=1, seed=seed, policy_bf16=True,
                              moment_partials=True, traj_dtype=BF)
        torch.cuda.synchronize()
        fr_p, e_p = philox_tier(
            f"kernel B bf16 policy frozen={use_frozen}", kp, pp,
            {FR.R_LOGP: POLICY_TOL, FR.R_VALUE: POLICY_TOL})
        mom_rel = float(((kp[4] - pp[4]).abs() /
                         torch.clamp(pp[4].abs(), min=1.0)).max())
        if mom_rel > 1e-5:
            raise Fail(f"kernel B bf16 policy: obs moments {mom_rel}")
        if not torch.equal(kb[3].view(torch.int16),
                           kp[3].to(BF).view(torch.int16)) or \
                not all(torch.equal(kb[i], kp[i]) for i in (0, 1, 2, 4, 5)):
            raise Fail("kernel B with both bf16 flags: not the bf16-policy "
                       "launch rounded")
        logits_rows = [FR.R_LOGP, FR.R_VALUE]
        ok = ~((kp[1] != pp[1]).any(dim=0) |
               (kp[3][:, FR.R_ACT:FR.R_ACT + 6] !=
                pp[3][:, FR.R_ACT:FR.R_ACT + 6]).any(dim=0).any(dim=0))
        pol16[f"frozen={use_frozen}"] = {
            "diverged_world_fraction": fr_p, "max_abs_err_agreeing_worlds":
            e_p, "logp_value_max_abs_err": float(
                (kp[3][:, logits_rows][..., ok] -
                 pp[3][:, logits_rows][..., ok]).abs().max()),
            "obs_moment_rel_err": mom_rel,
            "both_flags_equal_policy_launch_rounded": True}
        errs["fused_rollout_bf16_policy"] = max(
            errs.get("fused_rollout_bf16_policy", 0.0), e_p)
    del kp, pp, kb, p16
    emit({"phase": "bf16_kernels", "kernel": "fused_rollout_bf16_policy",
          "worlds": W, "ticks": T, "noise": "philox",
          "logp_value_tol": POLICY_TOL, "vs_plain": pol16})
    # the bf16 policy's Dense layers on the tensor cores: HMMA in the SASS
    # of every PBF instance (and none in the storage-only ones), ptxas's
    # registers and spills, warps per SM
    b16_ptx = _build.ptxas_kernels("fused_rollout_bf16")
    b16_sass = _build.sass_loop_counts("fused_rollout_bf16",
                                       ops=("HMMA", "LDSM", "LDL", "STL"))
    hmma = {}
    for fn, c in b16_sass.items():
        inst = fn.split("fused_rollout_bf16_kernelI", 1)[-1][:16]
        pbf = "Lb1EE" in inst
        hmma[inst] = {"policy_bf16": pbf, "HMMA": c["HMMA_total"],
                      "LDSM": c["LDSM_total"],
                      "local_ld_st": c["LDL_total"] + c["STL_total"]}
        if pbf != (c["HMMA_total"] > 0):
            raise Fail(f"kernel B bf16 instance {fn}: {c['HMMA_total']} "
                       "HMMA instructions (the bf16-policy instances run "
                       "their Dense layers on the tensor cores, the others "
                       "do not)")
    if len(hmma) != 12:
        raise Fail(f"kernel B bf16: {len(hmma)} instances in the SASS")
    emit({"phase": "bf16_kernels", "kernel": "fused_rollout_bf16_policy",
          "design": "mma.sync m16n8k16 bf16 (ldmatrix fragments, float32 "
                    "sums)",
          "sass_by_instance": hmma,
          "ptxas": {k: v for k, v in b16_ptx.items() if "Lb1EE" in k},
          "occupancy": FR.rollout_occupancy(dev, "fused_rollout_bf16")})

    # ---------------------------------------------------------- probes: B
    # kernel B's timing probes, float32 and probe x bf16 instances, at the
    # main path's shapes (see rollout_probes)
    if PROBE_BF16_KERNELS != tuple(f"fused_rollout_probe_bf16_{k}"
                                   for k in FR.PROBE_BF16):
        raise Fail(f"PROBE_BF16_KERNELS is not FR.PROBE_BF16: "
                   f"{FR.PROBE_BF16}")
    probes = rollout_probes(cfg, dev, k_sf, k_si, obs0, mats, fmats, seed)
    errs.update(probes["errs"])

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
    # kernel C's bf16 instance on kernel B's bf16 trajectory: the float32
    # instance on the upcast bit for bit, the plain version at C's tier
    c_args16 = (b16[3], carry, nv, vstats)
    k16 = FG.fused_gae(*c_args16, **gae_kw)
    k16u = FG.fused_gae(b16[3].float(), carry, nv, vstats, **gae_kw)
    p16c = FG.gae_plain(*c_args16, **gae_kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip(k16, k16u)):
        raise Fail("kernel C bf16: differs from the float32 instance on "
                   "the upcast trajectory")
    by16 = {n: compare(f"fused_gae bf16 {n}", [k16[i]], [p16c[i]],
                       atol=1e-4, rel=True)
            for i, n in enumerate(("side", "moments", "carry", "ticks"))}
    errs["fused_gae_bf16"] = max(by16.values())
    emit({"phase": "bf16_kernels", "kernel": "fused_gae_bf16", "T": T,
          "worlds": W, "equals_f32_instance_on_upcast": True,
          "max_abs_err": errs["fused_gae_bf16"], "by_output": by16})

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
        slice_err = max(slice_err, compare_collect(
            f"collect iteration {it}", c_state, oc, g_state, og))
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
    # moments).  A phase's 16 Adam steps amplify last-bit differences:
    # two correct implementations whose gradients differ in the last bits
    # drift ~1e-7 apart in the params, and a sample whose ReLU margin lies
    # within that drift of zero then takes a different side in each (PERF.md
    # §6, PR 6).  So a phase is held as its steps: the phase launch equals
    # its 16 one-minibatch launches chained, bit for bit, and each of those
    # holds against the plain step from the same params and moments.  Tier
    # per step: 1/16 of the phase's (params 1e-4, mu and nu 1e-4 of each
    # leaf's largest entry), plus, per entry, what the step's samples at a
    # kink of the loss can change (the plain version's own two branches of
    # each such sample's gradient, carried through the clip and Adam step:
    # FU.update_phase_kinks); no kink, no allowance.  At most 0.1 % of the
    # phase's samples may sit at a kink.  The phase against the plain
    # phase from the same inputs is printed as `drift`, unchecked.
    mom = TT.init_adam(u_params)

    def same(x, y):
        return all(torch.equal(a, b) for u, v in zip(x, y)
                   for a, b in zip(u, v))

    def d_parity(phase_name, side, ustats, n_phases, u_traj=u_traj):
        """Kernel D held per Adam step over `n_phases` chained phases on
        the side rows `side` (raw with `ustats`, or normalized with
        ustats None: the --no-fused-gae path's branch) and the trajectory
        `u_traj` (float32, or bf16: D's bf16 instance)."""
        d_in = (u_params, mom.mu, mom.nu)
        count, d_err, n_off, bitwise, composed = 0, {}, 0, True, True
        kinks, drift = [], []
        for phase in range(n_phases):
            args = (hp, u_idx, count, u_traj, side, u_nrm, ustats)
            dk = FU.fused_update_phase(*args, *d_in, wb=wb)
            dk2 = FU.fused_update_phase(*args, *d_in, wb=wb)
            bitwise &= same(dk, dk2)
            st, n_kink, near = d_in, 0, dict.fromkeys(FU.BRANCHES, 0)
            allow_max = dict.fromkeys(("params", "mu", "nu"), 0.0)
            for k in range(n_mb):
                s_args = (hp, u_idx[k * bpm:(k + 1) * bpm], count + k,
                          u_traj, side, u_nrm, ustats)
                sk = FU.fused_update_phase(*s_args, *st, wb=wb)
                *sp, rep = FU.update_phase_kinks(*s_args, *st, wb=wb)
                n_kink += rep["samples"]
                for b in FU.BRANCHES:
                    near[b] += rep["near"][b]
                for name, ks, ps, als in zip(("params", "mu", "nu"), sk, sp,
                                             rep["allow"]):
                    for i, (k_, p_, a_) in enumerate(zip(ks, ps, als)):
                        if not bool(torch.isfinite(k_).all()):
                            raise Fail(f"kernel D phase {phase} step {k} "
                                       f"{name}[{i}]: non-finite")
                        d = (k_ - p_).abs()
                        e = float(d.max())
                        lim = (1e-4 if name == "params" else
                               1e-4 * float(p_.abs().max())) / n_mb
                        if bool((d > lim + a_).any()):
                            raise Fail(f"kernel D phase {phase} step {k} "
                                       f"{name}[{i}]: error {e} above {lim}"
                                       " + the kink allowance (max "
                                       f"{float(a_.max())})")
                        d_err[name] = max(d_err.get(name, 0.0), e)
                        allow_max[name] = max(allow_max[name],
                                              float(a_.max()))
                        if name == "params":
                            n_off += int((d > 1e-5).sum())
                st = sk
            composed &= same(st, dk)
            kinks.append({"samples_at_a_kink": n_kink,
                          "of_samples": n_mb * hp.minibatch_size,
                          "by_branch": near, "max_allowance": allow_max})
            if n_kink > 1e-3 * n_mb * hp.minibatch_size:
                raise Fail(f"kernel D phase {phase}: {n_kink} of "
                           f"{n_mb * hp.minibatch_size} samples at a kink "
                           "of the loss (more than 0.1 %)")
            dp = FU.update_phase_plain(*args, *d_in, wb=wb)
            drift.append({name: max(float((a - b).abs().max())
                                    for a, b in zip(ks, ps))
                          for name, ks, ps in zip(("params", "mu", "nu"),
                                                  dk, dp)})
            d_in = dk
            count += n_mb
        torch.cuda.synchronize()
        if not bitwise:
            raise Fail("two launches of kernel D on identical inputs differ")
        if not composed:
            raise Fail("kernel D's phase launch differs from its "
                       "one-minibatch launches chained")
        emit({"phase": phase_name, "epochs": hp.update_epochs,
              "minibatches": hp.num_minibatches, "wb": wb,
              "phases": n_phases, "ustats": None if ustats is None else
              "raw side rows",
              "adam_count_after": count, "max_abs_err_per_step": d_err,
              "params_off_by_more_than_1e-5": n_off,
              "of_params": n_phases * n_mb * FU.N_PARAMS,
              "bit_identical_relaunch": bitwise,
              "phase_equals_its_steps_chained": composed,
              "drift_from_the_plain_phase": drift,
              "kink_delta": FU.KINK_DELTA, "kinks": kinks})
        return d_err["params"]

    errs["fused_update_phase"] = d_parity("parity_fused_update_phase",
                                          u_side, u_ustats, 2)
    # the --no-fused-gae branch: ustats None, the side rows normalized
    errs["fused_update_phase_normalized_side"] = d_parity(
        "parity_fused_update_phase_normalized_side", side_n, None, 1)

    # kernels D and G's bf16 instances on a bf16 collect of the same state
    # (the --bf16-traj iteration's trajectory, raw side rows and ustats):
    # each the float32 instance on the upcast trajectory bit for bit, D
    # held per Adam step as above, G at its leaf tier
    _, u16 = make_train_iteration(cfg, hp, dev, bf16_traj=True)(
        copy.deepcopy(u_state))
    traj16, side16, us16 = u16["traj"], u16["side"], u16["ustats"]
    d16_args = (hp, u_idx, 0, traj16, side16, u_nrm, us16, u_params,
                mom.mu, mom.nu)
    d16 = FU.fused_update_phase(*d16_args, wb=wb)
    d16u = FU.fused_update_phase(hp, u_idx, 0, traj16.float(), *d16_args[4:],
                                 wb=wb)
    side16_n = FU.normalize_side(side16, us16)
    g16_args = (hp, u_idx[:bpm], traj16, side16_n, u_nrm, *u_params)
    gk16 = FU.fused_minibatch_grad_prefetch(*g16_args, wb=wb)
    gk16u = FU.fused_minibatch_grad_prefetch(
        hp, u_idx[:bpm], traj16.float(), side16_n, u_nrm, *u_params, wb=wb)
    gp16 = FU.minibatch_grad_prefetch_plain(*g16_args, wb=wb)
    torch.cuda.synchronize()
    if traj16.dtype != BF or not same(d16, d16u) or \
            not all(torch.equal(a, b_) for a, b_ in zip(gk16, gk16u)):
        raise Fail("kernels D / G bf16: differ from the float32 instances "
                   "on the upcast trajectory")
    errs["fused_update_phase_bf16"] = d_parity(
        "parity_fused_update_phase_bf16", side16, us16, 1, u_traj=traj16)
    errs["fused_minibatch_grad_prefetch_bf16"] = grad_err("kernel G bf16",
                                                          gk16, gp16)
    emit({"phase": "bf16_kernels", "kernel": "fused_update_phase_bf16",
          "equals_f32_instance_on_upcast": True,
          "max_abs_err_per_step_params": errs["fused_update_phase_bf16"],
          "per_step_tiers": "parity_fused_update_phase_bf16"})
    emit({"phase": "bf16_kernels", "kernel":
          "fused_minibatch_grad_prefetch_bf16",
          "minibatch": hp.minibatch_size, "wb": wb,
          "equals_f32_instance_on_upcast": True,
          "max_abs_err": errs["fused_minibatch_grad_prefetch_bf16"]})
    del d16, d16u

    # ---------------------------------------------------------- parity F
    # from parity A's state with random actions for both agents, after the
    # other parity phases so that its draws leave their inputs as they were
    # (kernels A and B above ran on the compute_obs build of sim_world.cuh)
    f_si = k_si.clone()
    for i in range(2):
        for r, n in zip(ACTION_ROWS[i], buckets):
            f_si[r] = torch.randint(0, n, (W,), generator=gen, device=dev,
                                    dtype=torch.int32)
    f_in = (k_sf, f_si)
    variants = {"held_obs": (False, None),
                "every_tick_obs_blank_0": (True, 0),
                "held_obs_blank_1": (False, 1)}
    ext8 = FS.pack_multistep_noise([draw_noise_rows(W, gen, dev)
                                    for _ in range(8)])
    f_err = {}
    for label, (every, blank) in variants.items():
        k = FS.fused_multistep(cfg, *f_in, 8, noise=ext8,
                               obs_every_tick=every, blank_agent=blank)
        p = FS.multistep_rows_plain(cfg, *f_in, ext8, 8, every, blank)
        torch.cuda.synchronize()
        f_err[label] = compare(f"fused_multistep {label} K=8", k, p)
        key = "fused_multistep_" + ("every_tick_obs" if every else
                                    "held_obs")
        errs[key] = max(errs[key], f_err[label])
    f_seed = (5 << 32) | 12345
    f_philox = {}
    for label in ("held_obs", "every_tick_obs_blank_0"):
        every, blank = variants[label]
        kw = dict(obs_every_tick=every, blank_agent=blank)
        k = FS.fused_multistep(cfg, *f_in, T, seed=f_seed, **kw)
        p = FS.multistep_rows_plain(
            cfg, *f_in, FS.philox_multistep_noise(f_seed, 0, T, W, dev), T,
            every, blank)
        steps = f_in
        for t in range(T):
            steps = FS.fused_multistep(cfg, *steps[:2], 1, seed=f_seed,
                                       tick_base=t, **kw)
        torch.cuda.synchronize()
        div = (k[1] != p[1]).any(dim=0)
        frac = float(div.float().mean())
        e = max(float((k[i][:, ~div] - p[i][:, ~div]).abs().max())
                for i in (0, 2))
        if frac > 1e-3:
            raise Fail(f"32-tick Philox multistep {label}: {frac:.4%} of "
                       "worlds diverged")
        if not e <= 1e-4:
            raise Fail(f"32-tick Philox multistep {label}: float error {e} "
                       "above 1e-4 in the worlds that agree")
        if not all(torch.equal(a, b) for a, b in zip(k, steps)):
            raise Fail(f"multistep {label}: one 32-tick launch != 32 "
                       "one-tick launches")
        key = "fused_multistep_" + ("every_tick_obs" if every else
                                    "held_obs")
        errs[key] = max(errs[key], e)
        f_philox[label] = {"diverged_world_fraction": frac,
                           "max_abs_err_agreeing_worlds": e,
                           "composes": True}
    # one launch of F against 8 launches of kernel A, which runs the same
    # step_world: state and the last tick's obs bit for bit
    f_vs_a = {}
    for label, (every, blank) in variants.items():
        k = FS.fused_multistep(cfg, *f_in, 8, noise=ext8,
                               obs_every_tick=every, blank_agent=blank)
        a_sf, a_si = f_in
        for t in range(8):
            if blank is not None:
                a_si = FS._blank_actions(a_si, blank)
            chunk = ext8[t * FS.NOISE_CHUNK:
                         t * FS.NOISE_CHUNK + FS.N_NOISE_ROWS].contiguous()
            a_sf, a_si, a_obs = FS.fused_step(cfg, a_sf, a_si, chunk)
        torch.cuda.synchronize()
        bad = [int((x != y).sum()) for x, y in zip(k, (a_sf, a_si, a_obs))]
        if any(bad):
            raise Fail(f"multistep {label}: one 8-tick launch != 8 launches "
                       f"of kernel A ({bad} entries of sf, si, obs differ)")
        f_vs_a[label] = "bit-identical"
    # the CPU build of F's CTA (csrc/host_step.cpp, the warp roles in the
    # card's barrier order) against the card at 1024 worlds, A's tier
    f_host = host_multistep_lib()
    wh = 1024
    h_in = [x[:, :wh].contiguous() for x in f_in]
    h_ext = ext8.reshape(8 * FS.NOISE_CHUNK, W)[:, :wh].contiguous()
    f_host_err = {}
    for label, (every, blank) in variants.items():
        k = FS.fused_multistep(cfg, *h_in, 8, noise=h_ext,
                               obs_every_tick=every, blank_agent=blank)
        c_in = [x.cpu() for x in (*h_in, h_ext)]
        sf2, si2 = torch.empty_like(c_in[0]), torch.empty_like(c_in[1])
        obs2 = torch.empty((256, wh))
        f_host.mbb_host_multistep(
            FS.sim_params(cfg), c_in[2].data_ptr(), c_in[0].data_ptr(),
            c_in[1].data_ptr(), sf2.data_ptr(), si2.data_ptr(),
            obs2.data_ptr(), wh, 8, 0, 0, 0, int(every),
            -1 if blank is None else blank)
        f_host_err[label] = compare(f"multistep host twin {label}",
                                    [x.cpu() for x in k], [sf2, si2, obs2])
    emit({"phase": "parity_multistep", "worlds": W,
          "external_noise_ticks": 8, "max_abs_err": f_err,
          "philox_ticks": T, "philox": f_philox,
          "vs_8_launches_of_kernel_a": f_vs_a,
          "host_twin_worlds": wh, "host_twin_max_abs_err": f_host_err})

    # ---------------------------------------------------------- shot margin
    # worlds whose next tick decides a shot within a few rounding steps of
    # the going-in threshold (own generator): kernel A's shot outcome must
    # equal the plain version's exactly in every world
    g_s = torch.Generator(device=dev).manual_seed(17)
    s_sf, s_si = init_rows(cfg, W, g_s, dev)
    s_sf, s_si, s_nz, margin = FS.shot_margin_inputs(cfg, s_sf, s_si, g_s)
    ks = FS.fused_step(cfg, s_sf, s_si, s_nz)
    ps = FS.step_rows_plain(cfg, s_sf, s_si, s_nz)
    torch.cuda.synchronize()
    shot_rows = [F_IDX[n] for n in (
        "sbaskets", "t0score", "t1score", "bpos_x", "bpos_y", "bpos_z",
        "bvel_x", "bvel_y", "bvel_z", "bdone")]
    bad = (ks[1] != ps[1]).any(dim=0) | \
        (ks[0][shot_rows] != ps[0][shot_rows]).any(dim=0)
    if bool(bad.any()):
        raise Fail(f"shot margin: {int(bad.sum())} of {W} worlds decide the "
                   "shot differently from the plain version")
    s_err = compare("shot margin tick", ks, ps)
    errs["fused_step"] = max(errs["fused_step"], s_err)
    made = ps[0][F_IDX["sbaskets"]] - s_sf[F_IDX["sbaskets"]]
    # kernel B's 4-tick frozen-opponent external-noise parity on the
    # inputs that failed before the shot test was rounded: the draws of
    # parity A, then parity F's, then parity B's two noise matrices
    g_r = torch.Generator(device=dev).manual_seed(0)
    init_rows(cfg, W, g_r, dev)

    def draw_actions():
        for _ in range(2):
            for n in buckets:
                torch.randint(0, n, (W,), generator=g_r, device=dev,
                              dtype=torch.int32)
    for tick in range(4):
        if tick:
            draw_actions()
        draw_noise_rows(W, g_r, dev)
    draw_actions()
    for _ in range(8):
        draw_noise_rows(W, g_r, dev)
    for _ in range(2):
        u = torch.rand((4 * FR.EXT_NOISE_CHUNK, W), generator=g_r,
                       device=dev)
    row = torch.arange(4 * FR.EXT_NOISE_CHUNK, device=dev) % \
        FR.EXT_NOISE_CHUNK
    ext = torch.where((row < 8)[:, None], 2.0 * u - 1.0, u)
    k = FR.fused_rollout(cfg, k_sf, k_si, obs0, mats, fmats, n_steps=4,
                         trainee_idx=1, noise=ext)
    p = FR.rollout_plain(cfg, k_sf, k_si, obs0, mats, fmats, n_steps=4,
                         trainee_idx=1, noise=ext)
    torch.cuda.synchronize()
    exact = list(range(FR.R_ACT, FR.R_ACT + 6)) + [FR.R_DONE]
    compare("replayed B actions", [k[3][:, exact].to(torch.int32)],
            [p[3][:, exact].to(torch.int32)])
    r_err = compare("replayed B T=4 frozen", k[:4], p[:4])
    emit({"phase": "parity_shot_margin", "worlds": W,
          "band_ulps_of_dist2": FS.SHOT_BAND_ULPS,
          "worlds_in_band": int((margin.abs() <= FS.SHOT_BAND_ULPS).sum()),
          "made_share": float(made.mean()),
          "worlds_deciding_differently": 0, "max_abs_err": s_err,
          "replayed_rollout_frozen_T4_max_abs_err": r_err})

    # ---------------------------------------------------------- parity I
    # kernel I at the flagship width from parity A's state, own generator
    g_i = torch.Generator(device=dev).manual_seed(23)
    for use_frozen in (False, True):
        u = torch.rand((4 * FR.EXT_NOISE_CHUNK, W), generator=g_i,
                       device=dev)
        ext = torch.where((row < 8)[:, None], 2.0 * u - 1.0, u)
        fm = fmats if use_frozen else None
        k = FR.fused_rollout_tiled(cfg, k_sf, k_si, obs0, mats, fm,
                                   n_steps=4, trainee_idx=1, noise=ext)
        p = FR.rollout_tiled_plain(cfg, k_sf, k_si, obs0, mats, fm,
                                   n_steps=4, trainee_idx=1, noise=ext)
        torch.cuda.synchronize()
        compare("fused_rollout_tiled actions",
                [k[3][:, exact].to(torch.int32)],
                [p[3][:, exact].to(torch.int32)])
        e = compare(f"fused_rollout_tiled T=4 frozen={use_frozen}", k, p)
        errs["fused_rollout_tiled"] = max(errs["fused_rollout_tiled"], e)
        emit({"phase": "parity_fused_rollout_tiled", "worlds": W,
              "ticks": 4, "frozen": use_frozen, "noise": "external",
              "max_abs_err": e})

    ki32 = FR.fused_rollout_tiled(cfg, k_sf, k_si, obs0, mats, n_steps=T,
                                  trainee_idx=1, seed=seed)
    pi32 = FR.rollout_tiled_plain(cfg, k_sf, k_si, obs0, mats, n_steps=T,
                                  trainee_idx=1, noise=ph_noise)
    steps, trajs = (k_sf, k_si, obs0), []
    for t in range(T):
        o = FR.fused_rollout_tiled(cfg, *steps, mats, n_steps=1,
                                   trainee_idx=1, seed=seed, tick_base=t)
        steps = o[:3]
        trajs.append(o[3])
    torch.cuda.synchronize()
    frac_i, e_i = philox_tier("32-tick Philox tiled rollout vs plain",
                              ki32, pi32)
    frac_ib, e_ib = philox_tier("32-tick Philox tiled rollout vs kernel B",
                                ki32, k32)
    composes = all(torch.equal(a, b_) for a, b_ in zip(ki32[:3], steps)) \
        and torch.equal(ki32[3], torch.cat(trajs))
    if not composes:
        raise Fail("tiled: one 32-tick launch != 32 one-tick launches")
    # kernels B and I run one tile body: the same state and trajectory
    # bit for bit on one seed and state over 32 Philox ticks
    b_eq_i = all(torch.equal(a, b_) for a, b_ in zip(ki32, k32[:4]))
    if not b_eq_i:
        raise Fail("kernels B and I differ on one seed and state over 32 "
                   "Philox ticks")
    errs["fused_rollout_tiled"] = max(errs["fused_rollout_tiled"], e_i)
    emit({"phase": "parity_fused_rollout_tiled", "worlds": W, "ticks": T,
          "noise": "philox", "diverged_world_fraction": frac_i,
          "max_abs_err_agreeing_worlds": e_i, "composes": composes,
          "vs_kernel_b": {"diverged_world_fraction": frac_ib,
                          "max_abs_err_agreeing_worlds": e_ib,
                          "bit_identical": b_eq_i}})

    # ---------------------------------------------------------- world_base
    # a data-parallel rank's shard: kernels B and I on the right half of
    # the fleet (4096 worlds at world_base = 4096, the same seed and
    # state) draw what the whole-fleet launch draws for those worlds, so
    # every output equals the right half of the 32-tick launches above
    # bit for bit (kernel B's fold partials too); the plain Philox draw
    # the same
    h = slice(W // 2, W)
    half = [x[:, h].contiguous() for x in (k_sf, k_si, obs0)]
    kb_h = FR.fused_rollout(cfg, *half, mats, n_steps=T, trainee_idx=1,
                            seed=seed, world_base=W // 2,
                            moment_partials=True)
    ki_h = FR.fused_rollout_tiled(cfg, *half, mats, n_steps=T,
                                  trainee_idx=1, seed=seed,
                                  world_base=W // 2)
    torch.cuda.synchronize()
    wb_eq = {
        "B": [torch.equal(a, b_[..., h]) for a, b_ in zip(kb_h[:4], k32[:4])]
        + [torch.equal(kb_h[5], k32[5][:, W // 64:])],
        "I": [torch.equal(a, b_[..., h]) for a, b_ in zip(ki_h, ki32)],
        "philox_noise": [torch.equal(
            FR.philox_noise(seed, 0, 2, W // 2, dev, world_base=W // 2),
            FR.philox_noise(seed, 0, 2, W, dev)[:, h])]}
    if not all(all(v) for v in wb_eq.values()):
        raise Fail(f"world_base {W // 2}: the shard differs from the right "
                   f"half of the whole-fleet launch: {wb_eq}")
    emit({"phase": "parity_rollout_world_base", "worlds": W // 2,
          "world_base": W // 2, "ticks": T, "noise": "philox",
          "bit_identical": {k: len(v) for k, v in wb_eq.items()},
          "compared": "B: sf, si, obs, traj, fold partials; I: sf, si, "
                      "obs, traj; philox_noise: 2 ticks"})

    # ---------------------------------------------------------- parity E
    # on kernel I's 32-tick flagship trajectory, tier 1e-5 of max(1, |x|)
    # (M2 reaches ~1e3-1e7: relative to its size).  The plain version is
    # the JAX kernel's sequential float32 fold of 256 tiles, whose own
    # rounding reaches ~3e-5 of M2 on features with a large mean and a
    # small spread; so kernel E is held at the tier against the exact
    # (float64) moments, and against the fold at the tier plus the fold's
    # own measured error, entry by entry
    ke = FG.obs_moments(ki32[3])
    ke2 = FG.obs_moments(ki32[3])
    pe = FG.obs_moments_plain(ki32[3])
    x64 = ki32[3][:, :FR.ROLL_OBS].double()
    m64 = x64.mean(dim=(0, 2))
    exact = torch.zeros_like(pe, dtype=torch.float64)
    exact[:, 0] = m64
    exact[:, 1] = ((x64 - m64[None, :, None]) ** 2).sum(dim=(0, 2))
    exact[:, 2] = float(T * W)
    del x64
    lv, lm = torch.var_mean(ki32[3][:, :FR.ROLL_OBS], dim=(0, 2),
                            correction=0)
    torch.cuda.synchronize()

    def rel_err(a, b_):
        return (a.double() - b_.double()).abs() / \
            torch.clamp(b_.double().abs(), min=1.0)
    e_exact = float(rel_err(ke, exact).max())
    fold_dev = (pe.double() - exact).abs()
    over = (ke.double() - pe.double()).abs() > \
        1e-5 * torch.clamp(pe.double().abs(), min=1.0) + fold_dev
    if not bool(torch.isfinite(ke).all()) or e_exact > 1e-5 or \
            bool(over.any()):
        raise Fail(f"kernel E: error {e_exact} of the exact moments, "
                   f"{int(over.sum())} entries beyond the fold's tier")
    errs["obs_moments"] = float((ke - pe).abs().max())
    if not torch.equal(ke, ke2):
        raise Fail("two launches of kernel E on identical inputs differ")
    emit({"phase": "parity_obs_moments", "T": T, "worlds": W,
          "features": FR.ROLL_OBS, "max_abs_err": errs["obs_moments"],
          "max_rel_err_vs_plain": float(rel_err(ke, pe).max()),
          "max_rel_err_vs_exact": e_exact,
          "plain_max_rel_err_vs_exact": float(rel_err(pe, exact).max()),
          "bit_identical_relaunch": True,
          "vs_torch_var_mean": {
              "mean_max_abs_err": float((ke[:, 0] - lm).abs().max()),
              "var_max_rel_err": float(rel_err(ke[:, 1] / ke[:, 2],
                                               lv).max())}})
    # kernel E's bf16 instance on kernel B's bf16 trajectory, E's tiers
    # against the exact moments of the upcast rows and the plain fold
    ke16 = FG.obs_moments(b16[3])
    ke16u = FG.obs_moments(b16[3].float())
    pe16 = FG.obs_moments_plain(b16[3])
    x64 = b16[3][:, :FR.ROLL_OBS].double()
    m64 = x64.mean(dim=(0, 2))
    exact16 = torch.zeros_like(pe16, dtype=torch.float64)
    exact16[:, 0] = m64
    exact16[:, 1] = ((x64 - m64[None, :, None]) ** 2).sum(dim=(0, 2))
    exact16[:, 2] = float(T * W)
    del x64
    torch.cuda.synchronize()
    if not torch.equal(ke16, ke16u):
        raise Fail("kernel E bf16: differs from the float32 instance on "
                   "the upcast trajectory")
    e16_exact = float(rel_err(ke16, exact16).max())
    over16 = (ke16.double() - pe16.double()).abs() > \
        1e-5 * torch.clamp(pe16.double().abs(), min=1.0) + \
        (pe16.double() - exact16).abs()
    if e16_exact > 1e-5 or bool(over16.any()):
        raise Fail(f"kernel E bf16: error {e16_exact} of the exact moments, "
                   f"{int(over16.sum())} entries beyond the fold's tier")
    errs["obs_moments_bf16"] = float((ke16 - pe16).abs().max())
    # its time (16-byte reads, csrc/obs_moments.cu) beside its byte bound
    e16_ms = kernel_ms(lambda: FG.obs_moments(b16[3]), 20,
                       E16_KERNELS)
    e16_bound = bound(T * FR.ROLL_OBS * W * 2 + FR.ROLL_OBS * 8 * 4, 0)[0]
    emit({"phase": "bf16_kernels", "kernel": "obs_moments_bf16", "T": T,
          "worlds": W, "equals_f32_instance_on_upcast": True,
          "max_abs_err": errs["obs_moments_bf16"],
          "max_rel_err_vs_exact": e16_exact, "ms": e16_ms,
          "bound_ms": e16_bound, "bound_share": e16_bound / e16_ms})
    # its other launch shapes: chunks of 32 worlds (96 worlds, 4 threads a
    # CTA) and more ticks than one shared-memory stage holds (T = 40)
    for te, we in ((40, 1024), (3, 96)):
        g_e = torch.Generator(device=dev).manual_seed(te)
        tr = (torch.randn((te, FR.ROLL_ROWS, we), generator=g_e, device=dev)
              * 3.0 + 1.0).to(BF)
        if not torch.equal(FG.obs_moments(tr), FG.obs_moments(tr.float())):
            raise Fail(f"kernel E bf16 at T={te}, W={we}: differs from the "
                       "float32 instance on the upcast trajectory")

    # ---------------------------------------------------------- tiled slice
    # the tiled collect at 1024 worlds x 8 ticks on the card vs the plain
    # path on the CPU, parity_collect's tiers (own generator)
    hp_t = PPOParams(num_envs=1024, num_rollout_steps=8)
    gen_t = torch.Generator().manual_seed(29)
    c_state = init_rollout_state(cfg, hp_t, seed=5, device="cpu")
    g_state = state_to(c_state, dev)
    collect_c = make_collect(cfg, hp_t, device="cpu", rollout_tiled=True)
    collect_g = make_collect(cfg, hp_t, device=dev, rollout_tiled=True)
    tiled_err = 0.0
    for it in range(2):
        pulse = draw_noise_rows(hp_t.num_envs, gen_t, "cpu")
        c_state, oc = collect_c(c_state, CollectNoise(pulse=pulse))
        g_state, og = collect_g(g_state, CollectNoise(pulse=pulse.to(dev)))
        torch.cuda.synchronize()
        tiled_err = max(tiled_err, compare_collect(
            f"tiled collect iteration {it}", c_state, oc, g_state, og))
    emit({"phase": "parity_collect_tiled", "worlds": hp_t.num_envs,
          "ticks": hp_t.num_rollout_steps, "iterations": 2,
          "reference": "plain path on the CPU",
          "max_err_rel_to_max_1_abs": tiled_err})

    # ---------------------------------------------------------- main path
    def reset_counts():
        FS.launches = FR.launches = FR.tiled_launches = FG.launches = 0
        FG.moment_launches = TT.launches = FU.device_launches = 0
        FG.bf16_launches = FG.bf16_moment_launches = 0
        FU.launches = dict.fromkeys(FU.launches, 0)
        FU.bf16_launches = dict.fromkeys(FU.bf16_launches, 0)
        FR.bf16_launches = dict.fromkeys(FR.bf16_launches, 0)
        FR.probe_launches = dict.fromkeys(FR.probe_launches, 0)
        FR.probe_bf16_launches = dict.fromkeys(FR.probe_bf16_launches, 0)

    def counts():
        return {"fused_step": FS.launches, "fused_rollout": FR.launches,
                "fused_rollout_tiled": FR.tiled_launches,
                "obs_moments": FG.moment_launches, "fused_gae": FG.launches,
                "meter_scan": TT.launches, **FU.launches,
                "fused_rollout_bf16_traj": FR.bf16_launches["traj"],
                "fused_rollout_bf16_policy": FR.bf16_launches["policy"],
                "fused_gae_bf16": FG.bf16_launches,
                "obs_moments_bf16": FG.bf16_moment_launches,
                **{f"{k}_bf16": n for k, n in FU.bf16_launches.items()},
                **{f"fused_rollout_probe_{k}": n
                   for k, n in FR.probe_launches.items()},
                **{f"fused_rollout_probe_bf16_{k}": n
                   for k, n in FR.probe_bf16_launches.items()}}

    def check_path(phase, tiled, launches):
        """Every kernel of the path launched, none of the other path's."""
        on_path = ("fused_step", "fused_gae", "meter_scan",
                   "fused_update_phase") + (
            ("fused_rollout_tiled", "obs_moments") if tiled else
            ("fused_rollout",))
        off_path = (("fused_rollout",) if tiled else
                    ("fused_rollout_tiled", "obs_moments")) + PROBE_KERNELS
        if min(launches[k] for k in on_path) < 1:
            raise Fail(f"{phase} skipped a kernel: {launches}")
        if any(launches[k] for k in off_path):
            raise Fail(f"{phase} launched another path's kernel: "
                       f"{launches}")

    def drive(phase, tiled):
        """Warm-up, then three timed iterations of the flagship shape with
        the launches counted from 0 around them and the run's checks.
        Returns (state, out of the last iteration, the phase's line)."""
        state = init_train_state(cfg, hp, seed=1, device=dev)
        train_iteration = make_train_iteration(cfg, hp, device=dev,
                                               rollout_tiled=tiled)
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
        reset_counts()
        spans = ("reset_pulse", "rollout", "gae") + \
            (("obs_moments",) if tiled else ()) + ("glue", "update")
        times = {k: [] for k in spans + ("collect", "iteration")}
        wall, dones = [], 0.0
        for it in range(3):
            # the tracer's eager stamps: start, perms, the phases in
            # `spans`, writeback (utils/profiling.py)
            profiling.TRACER.start(dev)
            t0 = time.perf_counter()
            try:
                state, out = train_iteration(state)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            finally:
                rec = profiling.TRACER.stop()
            (run,) = profiling.sequences(rec["stamps"])
            at = dict(run)
            for name, (_, a), (_, b_) in zip(spans, run[1:], run[2:]):
                times[name].append((b_ - a) * 1e-6)
            times["collect"].append((at["glue"] - at["start"]) * 1e-6)
            times["iteration"].append((at["update"] - at["start"]) * 1e-6)
            for key in ("traj", "side", "ustats"):
                if not bool(torch.isfinite(out[key]).all()):
                    raise Fail(f"{phase}: non-finite {key}")
            for key in ("obs_rms", "value_rms"):
                for f in ("mean", "var"):
                    if not bool(torch.isfinite(getattr(out[key], f)).all()):
                        raise Fail(f"{phase}: non-finite {key}.{f}")
            dones += float(out["traj"][:, FR.R_DONE].sum())
        launches = counts()
        check_path(phase, tiled, launches)
        if launches["fused_update_phase"] != 3 or \
                FU.device_launches != 3 * 2 * n_mb:
            raise Fail(f"kernel D: {launches['fused_update_phase']} calls, "
                       f"{FU.device_launches} device launches in 3 "
                       "iterations")
        p1 = FU.pack_weights(state.agent.net)
        if not all(bool(torch.isfinite(p).all()) for p in p1):
            raise Fail(f"{phase}: non-finite params")
        if all(torch.equal(a, b) for a, b in zip(p0, p1)):
            raise Fail(f"{phase}: the update left the params unchanged")
        if state.opt.count != n_mb * (warmup + 3):
            raise Fail(f"Adam count {state.opt.count} after {warmup + 3} "
                       "iterations")
        d_obs = float(state.agent.obs_rms.count) - n0_obs
        d_val = float(state.agent.value_rms.count) - n0_val
        if d_obs != 3 * T * W or d_val != 3 * 2 * T * W:
            raise Fail(f"normalizer counts grew by {d_obs}, {d_val}")
        if dones <= 0:
            raise Fail(f"{phase}: no episode ended in 3 iterations")
        med = {k: statistics.median(v) for k, v in times.items()}
        m = {k: float(v) for k, v in out["metrics"].items()}
        line = {
            "phase": phase, "worlds": W, "ticks": T,
            "epochs": hp.update_epochs, "minibatches": hp.num_minibatches,
            "iterations": 3, "warmup_iterations": warmup,
            "launches": launches,
            "fused_update_phase_device_launches": FU.device_launches,
            "ms_median": med, "iteration_ms": med["iteration"],
            "train_env_steps_per_s": W * T / (med["iteration"] / 1e3),
            "collect_env_steps_per_s": W * T / (med["collect"] / 1e3),
            "wall_ms": wall, "done_count": dones,
            "adam_count": state.opt.count, "obs_rms_count_delta": d_obs,
            "value_rms_count_delta": d_val, "metrics": m}
        emit(line)
        return state, out, train_iteration, launches

    def profiled(fn):
        """fn() under torch.profiler: (its result, device busy ms (None if
        the profiler saw no device time), the profiled wall ms, the
        kernels by device time)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall_ = (time.perf_counter() - t0) * 1e3
        rows_t = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.key,
                   e.count) for e in prof.key_averages()]
        rows_t = sorted([r for r in rows_t if r[0] > 0], reverse=True)
        busy = sum(r[0] for r in rows_t)
        return res, (busy or None), wall_, [[round(ms, 4), k[:60], n]
                                            for ms, k, n in rows_t[:8]]

    def trace(phase, state, train_iteration):
        """One more iteration under torch.profiler: device busy share and
        the kernels by device time (after the counted run, so not in its
        launches)."""
        (state, _), busy, trace_wall, top = profiled(
            lambda: train_iteration(state))
        emit({"phase": phase, "what": "one train_iteration",
              "wall_ms": trace_wall, "device_busy_ms": busy,
              "device_idle_share": (1.0 - busy / trace_wall) if busy
              else None, "top_device_ms": top})
        return state

    def learning(phase, tiled):
        """600 flagship iterations from a fresh policy on the JAX
        package's canonical task; its records: -133.4 after 600
        iterations, a -114..-131 plateau over 10 000 (BENCHMARKS.md)."""
        l_state = init_train_state(cfg, hp, seed=321, device=dev)
        l_iter = make_train_iteration(cfg, hp, device=dev,
                                      rollout_tiled=tiled)
        curve = []
        t0 = time.perf_counter()
        for it in range(1, 601):
            l_state, l_out = l_iter(l_state)
            if it % 50 == 0:
                lm = l_out["metrics"]
                curve.append([it, float(lm["mean_reward"]),
                              float(lm["mean_episode_length"])])
        l_secs = time.perf_counter() - t0
        if not all(bool(torch.isfinite(p).all())
                   for p in FU.pack_weights(l_state.agent.net)):
            raise Fail(f"{phase}: non-finite params")
        final = curve[-1][1]
        emit({"phase": phase, "iterations": 600, "seed": 321,
              "seconds": l_secs, "curve": curve, "final_mean_reward": final,
              "band": [-150.0, -105.0]})
        if not -150.0 <= final <= -105.0:
            raise Fail(f"{phase}: mean reward {final} after 600 iterations "
                       "is outside -150..-105")
        return curve

    def chunk_parity(phase, tiled, state, train_iteration):
        """From clones of one state, 3 eager iterations (the first under
        `torch.cuda.set_sync_debug_mode("error")`) against one chunk of 3
        (`make_train_chunk`: one iteration captured as a CUDA graph,
        replayed with the generators reseeded): every tensor of the state
        (weights, normalizers, rows, stats, Adam moments), every metric
        and the counters (host, and the chunk's device ones) bit for
        bit."""
        a, c = copy.deepcopy(state), copy.deepcopy(state)
        eager = []
        for i in range(3):
            # the first under the sync debug mode: an iteration that read
            # a value on the host could not be captured
            torch.cuda.set_sync_debug_mode("error" if i == 0 else 0)
            try:
                a, o = train_iteration(a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eager.append(o["metrics"])
        chunk = TT.make_train_chunk(train_iteration, 3)
        c, stacked = chunk(c)
        torch.cuda.synchronize()
        ta, tc = state_tensors(a), state_tensors(c)
        diff = [i for i, (x, y) in enumerate(zip(ta, tc))
                if not torch.equal(x, y)]
        mdiff = [f"{k}[{i}]" for i in range(3) for k in eager[i]
                 if not torch.equal(eager[i][k], stacked[k][i])]
        st = chunk.captured["static"]
        counters = {"counter": [a.counter, c.counter, int(st.counter)],
                    "adam_count": [a.opt.count, c.opt.count, int(st.count)],
                    "iteration": [a.iteration, c.iteration]}
        if diff or mdiff or any(len(set(v)) != 1 for v in counters.values()):
            raise Fail(f"{phase}: the chunk differs from the eager "
                       f"iterations: tensors {diff}, metrics {mdiff}, "
                       f"counters {counters}")
        emit({"phase": phase, "worlds": W, "ticks": T, "iterations": 3,
              "sync_debug_mode_error_iteration_ok": True,
              "tensors_equal": len(ta), "metrics_equal": 3 * len(eager[0]),
              "counters": counters,
              "mean_reward": [float(m["mean_reward"]) for m in eager],
              "reward_window": [float(m["reward_window"]) for m in eager]})

    def chunked(phase, tiled, state, train_iteration, eager_phase):
        """Chunks of 50 iterations at the flagship shape: launches counted
        from 0 around the first chunk (its warm-up step and capture; the
        replays count none), then 3 chunks timed with CUDA events, one
        profiled for the device's busy time; beside it the eager
        iteration of the same state, un-profiled and profiled, and the
        peak device memory of the chunked run."""
        n = 50
        chunk = TT.make_train_chunk(train_iteration, n)
        state = copy.deepcopy(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        state, stacked = chunk(state)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = counts()
        d_launches = FU.device_launches
        check_path(phase, tiled, launches)
        times = []
        for _ in range(3):
            a, b_ = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            state, stacked = chunk(state)
            b_.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b_))
        peak = torch.cuda.max_memory_allocated(dev)
        if counts() != launches:
            raise Fail(f"{phase}: replays counted launches: {counts()}")
        for k, v in stacked.items():
            if v.shape != (n,) or not bool(torch.isfinite(v).all()):
                raise Fail(f"{phase}: metric {k} {tuple(v.shape)} or "
                           "non-finite")
        if not all(bool(torch.isfinite(p).all())
                   for p in state.agent.net.parameters()):
            raise Fail(f"{phase}: non-finite params")
        it_ms = statistics.median(times) / n
        (state, _), c_busy, c_wall, c_top = profiled(lambda: chunk(state))
        # the eager iteration from the same state, in the same run
        e_state = copy.deepcopy(state)
        e_times = []
        for _ in range(3):
            a, b_ = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            e_state, _ = train_iteration(e_state)
            b_.record()
            torch.cuda.synchronize()
            e_times.append(a.elapsed_time(b_))
        e_ms = statistics.median(e_times)
        _, e_busy, e_wall, _ = profiled(lambda: train_iteration(e_state))
        c_busy_it = c_busy / n if c_busy else None
        emit({"phase": phase, "worlds": W, "ticks": T,
              "iters_per_dispatch": n, "chunk_ms": times,
              "iteration_ms": it_ms,
              "train_env_steps_per_s": W * T / (it_ms / 1e3),
              "first_chunk_s": first_s,
              "launches_at_capture": launches,
              "fused_update_phase_device_launches_at_capture": d_launches,
              "launch_note": "counted once in the warm-up step and once "
                             "at capture; replays count none",
              "device_busy_ms_per_iteration": c_busy_it,
              "device_idle_share": (1.0 - c_busy_it / it_ms) if c_busy_it
              else None, "profiled_chunk_wall_ms": c_wall,
              "top_device_ms_chunk": c_top,
              "peak_memory_bytes": peak,
              "eager_iteration_ms": e_ms, "eager_ms": e_times,
              "eager_train_env_steps_per_s": W * T / (e_ms / 1e3),
              "eager_device_busy_ms": e_busy,
              "eager_device_idle_share": (1.0 - e_busy / e_ms) if e_busy
              else None, "eager_profiled_wall_ms": e_wall,
              "eager_spans_phase": eager_phase})

    def learning_chunked(phase, tiled, eager_curve):
        """`learning` through chunks of 50 (`make_train_chunk`): the curve
        must equal the eager one bit for bit."""
        l_state = init_train_state(cfg, hp, seed=321, device=dev)
        l_iter = make_train_iteration(cfg, hp, device=dev,
                                      rollout_tiled=tiled)
        chunk = TT.make_train_chunk(l_iter, 50)
        curve = []
        t0 = time.perf_counter()
        for it in range(50, 601, 50):
            l_state, st = chunk(l_state)
            curve.append([it, float(st["mean_reward"][-1]),
                          float(st["mean_episode_length"][-1])])
        l_secs = time.perf_counter() - t0
        if not all(bool(torch.isfinite(p).all())
                   for p in l_state.agent.net.parameters()):
            raise Fail(f"{phase}: non-finite params")
        emit({"phase": phase, "iterations": 600, "seed": 321,
              "iters_per_dispatch": 50, "seconds": l_secs, "curve": curve,
              "equals_eager_curve": curve == eager_curve})
        if curve != eager_curve:
            raise Fail(f"{phase}: the chunked curve differs from the eager "
                       f"one: {curve} vs {eager_curve}")

    state, out, train_iteration, launches = drive("main_path", False)
    state = trace("trace", state, train_iteration)
    t_state, t_out, t_iteration, t_launches = drive("tiled_path", True)
    trace("trace_tiled", t_state, t_iteration)
    chunk_parity("chunk_parity", False, state, train_iteration)
    chunk_parity("chunk_parity_tiled", True, t_state, t_iteration)
    # the league's iteration: kernel B's frozen forward and the pulse's
    # frozen draws, captured
    hp_f = dataclasses.replace(hp, use_frozen=True)
    chunk_parity("chunk_parity_frozen", False,
                 init_train_state(cfg, hp_f, seed=11, device=dev),
                 make_train_iteration(cfg, hp_f, device=dev))
    chunked("chunked_path", False, state, train_iteration, "main_path")
    chunked("chunked_tiled_path", True, t_state, t_iteration, "tiled_path")
    curve = learning("learning", False)
    curve_t = learning("learning_tiled", True)
    learning_chunked("learning_chunked", False, curve)
    learning_chunked("learning_chunked_tiled", True, curve_t)

    # ---------------------------------------------------------- cli
    # the training CLI as a user runs it, in a fresh directory inside
    # the checkout's git-ignored build directory
    root = Path(FU.__file__).resolve().parents[2]
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(root), os.environ.get("PYTHONPATH")])))
        # the two training runs and cli_chunk's two, started together
        cli = "madrona_basketball_tpu_torch.cli"
        jobs = {model: ([cli, "--num-iterations", "4",
                         "--log-every-n-iterations", "2",
                         "--save-model-every-n-iterations", "4",
                         "--model-name", model, *flags], {})
                for model, flags in (("chip_smoke", []),
                                     ("chip_smoke_tiled",
                                      ["--rollout-tiled"]))}
        # the default --iters-per-dispatch 0 (auto: 4 at these cadences,
        # so two CUDA-graph chunks) against 1 (eager): equal checkpoints
        jobs.update({f"ipd{ipd}": ([cli, "--num-iterations", "8",
                                    "--log-every-n-iterations", "4",
                                    "--save-model-every-n-iterations", "4",
                                    "--iters-per-dispatch", ipd,
                                    "--model-name", f"ipd{ipd}"], {})
                     for ipd in ("0", "1")})
        done = run_clis(jobs, tmp, env)
        for model, flags in (("chip_smoke", []),
                             ("chip_smoke_tiled", ["--rollout-tiled"])):
            rc, so, se, cli_secs = done[model]
            if rc != 0:
                raise Fail(f"cli {flags} exited {rc}: {se[-3000:]}")
            logs = [ln for ln in so.splitlines()
                    if ln.startswith(("Update:", "Mean reward", "Model "))]
            path = Path(tmp) / CK.checkpoint_path(model, 4)
            saved = torch.load(path, weights_only=True)
            back = CK.state_dict(CK.load_agent(str(path), dev))
            if sorted(back) != sorted(saved) or \
                    not all(torch.equal(back[k], saved[k]) for k in saved):
                raise Fail(f"cli {flags} checkpoint does not load back equal")
            if not all(bool(torch.isfinite(v).all())
                       for v in saved.values()):
                raise Fail(f"cli {flags} checkpoint holds non-finite values")
            emit({"phase": "cli", "flags": flags, "exit_code": rc,
                  "seconds": cli_secs, "checkpoint": CK.checkpoint_path(
                      model, 4), "checkpoint_tensors": len(saved),
                  "log": logs, "note": "4 CLI runs started together"})
        ck, secs = {}, {}
        for ipd in ("0", "1"):
            rc, so, se, secs[ipd] = done[f"ipd{ipd}"]
            if rc != 0:
                raise Fail(f"cli --iters-per-dispatch {ipd} exited "
                           f"{rc}: {se[-3000:]}")
            want_n = "4" if ipd == "0" else "1"
            if f"Iterations per dispatch: {want_n}" not in so:
                raise Fail(f"cli --iters-per-dispatch {ipd}: not {want_n} "
                           f"iterations a dispatch: {so[-2000:]}")
            ck[ipd] = {it: torch.load(Path(tmp) / CK.checkpoint_path(
                f"ipd{ipd}", it), weights_only=True) for it in (4, 8)}
        same = {it: sorted(ck["0"][it]) == sorted(ck["1"][it]) and all(
            torch.equal(ck["0"][it][k], ck["1"][it][k]) for k in ck["1"][it])
            for it in (4, 8)}
        emit({"phase": "cli_chunk", "iterations": 8,
              "iters_per_dispatch": {"0": 4, "1": 1}, "seconds": secs,
              "checkpoints_equal": same})
        if not all(same.values()):
            raise Fail(f"cli: the auto-chunk checkpoints differ from the "
                       f"--iters-per-dispatch 1 ones: {same}")
        # the eval CLI as a user runs it, at its defaults (10 worlds, 5
        # episodes, the eval chunk), on the `cli` phase's checkpoint, then
        # with --model-name over that run's checkpoints
        icli = {}
        runs_i = (("single", ["--trainee-checkpoint",
                              CK.checkpoint_path("chip_smoke", 4)],
                   "logs/inference_trajectories.npz"),
                  ("model_name", ["--model-name", "chip_smoke"],
                   "logs/mgi/chip_smoke_/chip_smoke_4.npz"))
        done = run_clis({what: (["madrona_basketball_tpu_torch.infer",
                                 *flags], {})
                         for what, flags, _ in runs_i}, tmp, env)
        for what, flags, log in runs_i:
            rc, so, se, secs_i = done[what]
            if rc != 0:
                raise Fail(f"infer cli {flags} exited {rc}: {se[-3000:]}")
            ticks_i = check_npz(Path(tmp) / log, 10)
            icli[what] = {"flags": flags, "seconds": secs_i, "npz": log,
                          "ticks": ticks_i, "log": [
                              ln for ln in so.splitlines()
                              if ln.startswith(("All ", "Found "))]}
        emit({"phase": "infer_cli", "runs": icli,
              "npz_schema": "keys, shapes and dtypes as NPZ_SCHEMA",
              "note": "the 2 runs started together"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---------------------------------------------------------- engine
    # the stepping path at 256 worlds on the card vs the plain path on
    # the CPU (tests/test_torch_engine.py holds that against the JAX
    # package), same rows and noise: integers exact, floats 1e-4
    ws = 256
    e_g = FusedEngine(cfg, ws, seed=3, device=dev)
    e_c = FusedEngine(cfg, ws, seed=3, device="cpu")
    e_c.sf, e_c.si = e_g.sf.cpu(), e_g.si.cpu()
    n1 = draw_noise_rows(ws, gen_cpu, "cpu")
    n8 = FS.pack_multistep_noise([draw_noise_rows(ws, gen_cpu, "cpu")
                                  for _ in range(8)])
    for e_, dv in ((e_g, dev), (e_c, "cpu")):
        e_.step(noise=n1.to(dv))
        e_.step_many(8, noise=n8.to(dv))
    torch.cuda.synchronize()
    t_g, t_c = export_tensors(e_g.state()), export_tensors(e_c.state())
    eng_err = compare("engine step + step_many(8)",
                      [t_g[k].cpu() for k in sorted(t_c)],
                      [t_c[k] for k in sorted(t_c)])
    # the flagship width, launches counted from 0 around this path
    FS.launches = 0
    FS.multistep_launches = dict.fromkeys(FS.multistep_launches, 0)
    eng = FusedEngine(cfg, W, seed=11, device=dev)
    eng.step()
    eng.step_many(64)
    view = eng.state()
    tens = export_tensors(view)
    A_, H_, F32 = 2, 2, torch.float32
    want_t = {
        "reset": ((W, A_, 1), torch.int32), "game_state": ((W, 14), F32),
        "action": ((W, A_, 6), torch.int32),
        "action_mask": ((W, A_, 4), torch.int32),
        "observations": ((W, A_, 128), F32), "reward": ((W, A_), F32),
        "done": ((W, A_), F32), "agent_pos": ((W, A_, 3), F32),
        "orientation": ((W, A_, 4), F32),
        "agent_possession": ((W, A_, 3), torch.int32),
        "agent_team": ((W, A_, 5), torch.int32),
        "agent_stats": ((W, A_, 2), torch.int32),
        "agent_entity_id": ((W, A_), torch.int32),
        "basketball_pos": ((W, 1, 3), F32),
        "ball_physics": ((W, 1, 7), torch.int32),
        "ball_grabbed": ((W, 1, 2), torch.int32),
        "ball_velocity": ((W, 1, 3), F32),
        "ball_entity_id": ((W, 1), torch.int32),
        "hoop_pos": ((W, H_, 3), F32)}
    if set(tens) != set(want_t):
        raise Fail(f"export keys {sorted(tens)}")
    for name, (shape, dtype) in want_t.items():
        t_ = tens[name]
        if tuple(t_.shape) != shape or t_.dtype != dtype:
            raise Fail(f"export {name}: {tuple(t_.shape)} {t_.dtype}, want "
                       f"{shape} {dtype}")
        if dtype == F32 and not bool(torch.isfinite(t_).all()):
            raise Fail(f"export {name}: non-finite values")
    benv = BasketballEnv(W, cfg, seed=12, device=dev)
    _, _, r_done = benv.reset()
    if not bool((r_done == 1.0).all()):
        raise Fail("env.reset: not every world reports done")
    e_obs, e_rew, e_done = benv.step(benv.get_blank_actions())
    frozen_net = init_agent(torch.Generator().manual_seed(4), dev)
    env_f = BasketballEnv(W, cfg, seed=13, trainee_agent_idx=1, device=dev,
                          frozen_policy=lambda o: act(frozen_net, o)[0])
    env_f.reset()
    f_obs, f_rew, f_done = env_f.step(env_f.get_blank_actions())
    torch.cuda.synchronize()
    for name, t_ in (("obs", e_obs), ("reward", e_rew), ("frozen obs", f_obs),
                     ("frozen reward", f_rew)):
        if not bool(torch.isfinite(t_).all()):
            raise Fail(f"env {name}: non-finite values")
    if e_obs.shape != (W, 128) or e_done.shape != (W,):
        raise Fail(f"env.step shapes {tuple(e_obs.shape)}, "
                   f"{tuple(e_done.shape)}")
    eng_launches = {"fused_step": FS.launches, **FS.multistep_launches}
    if eng_launches["fused_step"] < 1 or eng_launches["held_obs"] < 1:
        raise Fail(f"stepping path skipped a kernel: {eng_launches}")
    emit({"phase": "engine", "worlds": W, "step_many": 64,
          "export_tensors": len(tens),
          "launches": eng_launches, "small_worlds": ws,
          "small_vs_cpu_plain_max_abs_err": eng_err,
          "env_reset_done_all": True,
          "env_step_mean_reward": float(e_rew.mean()),
          "env_frozen_step_mean_reward": float(f_rew.mean())})

    # ---------------------------------------------------------- bench
    # the stepping bench as a user runs it; its launches are counted by
    # the subprocess from 0 and reported per engine on stderr
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "madrona_basketball_tpu_torch.bench", str(W)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    bench_secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise Fail(f"bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    bench_line = json.loads(proc.stdout.strip().splitlines()[-1])
    engines = {e["engine"]: e for e in
               (json.loads(ln) for ln in proc.stderr.splitlines()
                if ln.startswith("{"))}
    for name in ("kernel_a_dispatch", "kernel_a_cuda_graph",
                 "kernel_f_every_tick_obs", "kernel_f_held_obs"):
        if not engines.get(name, {}).get("env_steps_per_s", 0) > 0:
            raise Fail(f"bench engine {name}: {engines.get(name)}")
    if bench_line["metric"] != f"env_steps_per_sec_{W}" or \
            not bench_line["value"] > 0:
        raise Fail(f"bench line {bench_line}")
    bench_launches = {
        "fused_multistep_every_tick_obs":
            engines["kernel_f_every_tick_obs"]["launches"].get(
                "every_tick_obs", 0),
        "fused_multistep_held_obs":
            engines["kernel_f_held_obs"]["launches"].get("held_obs", 0)}
    if min(bench_launches.values()) < 1:
        raise Fail(f"bench skipped kernel F: {bench_launches}")
    emit(bench_line)
    emit({"phase": "bench", "seconds": bench_secs,
          "engines": list(engines.values())})

    # ---------------------------------------------------------- attribution
    # kernel B's time attribution as a user runs it (the probes' path):
    # every probe instance, the float32 and both bf16 instances launched,
    # the launches counted by the subprocess from 0; its line re-emitted
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "madrona_basketball_tpu_torch."
         "bench_rollout_attr", str(W)], cwd=root, env=env,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise Fail(f"bench_rollout_attr exited {proc.returncode}: "
                   f"{proc.stderr[-3000:]}")
    attr = json.loads(proc.stdout.strip().splitlines()[-1])
    attr_launches = attr["launches"]
    if set(attr["variants_ms"]) != {"full", *FR.PROBES, "bf16_mm",
                                    "bf16_traj"} or \
            not all(v > 0 for v in attr["variants_ms"].values()) or \
            len(attr["t_sweep_ms"] or ()) != 4 or \
            min(attr_launches["probe"].values()) < 1 or \
            attr_launches["fused_rollout"] < 1 or \
            min(attr_launches["bf16"].values()) < 1:
        raise Fail(f"bench_rollout_attr line {attr}")
    emit({"phase": "rollout_attr", "seconds": time.perf_counter() - t0,
          "lines": [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("[attr]")]})
    emit(attr)

    # ---------------------------------------------------------- eval
    # the eval path (infer.py): kernel A a tick with the policies in
    # kernel J, per step or as the eval chunk (K ticks captured as a CUDA
    # graph)
    eval_policy_row = eval_policy_phase(dev)
    import contextlib
    import io

    import numpy as np

    from madrona_basketball_tpu_torch import infer as IF
    from madrona_basketball_tpu_torch import selfplay as SP
    from madrona_basketball_tpu_torch.ops import eval_policy as EP
    ev_tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    cfg_e = SimConfig(time_per_period=1.0)
    ev_agents = [init_agent(torch.Generator().manual_seed(s), dev)
                 for s in (21, 22)]

    def quiet(fn, *a, **kw):
        """fn's result, its prints kept off this script's stdout."""
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*a, **kw)

    def eval_run(name, chunk_size, stochastic, num_episodes, worlds,
                 cfg_, max_steps, log=True, frozen_on=None):
        """One `infer` from a fresh env (seed 31): (counts, npz arrays or
        None, engine, seconds, peak bytes)."""
        frozen_on = stochastic if frozen_on is None else frozen_on
        fp = IF.make_policy_fn(ev_agents[1], IF.generator(1, dev)) \
            if frozen_on else None
        env_ = BasketballEnv(worlds, cfg_, seed=31, frozen_policy=fp,
                             trainee_agent_idx=1, device=dev)
        path = os.path.join(ev_tmp, f"{name}.npz") if log else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        c_ = quiet(IF.infer, env_, ev_agents[0], path, num_episodes,
                   max_steps, stochastic, seed=0, trainee_idx=1,
                   frozen_params=ev_agents[1] if frozen_on else None,
                   chunk_size=chunk_size)
        torch.cuda.synchronize()
        secs_ = time.perf_counter() - t0
        return (c_, dict(np.load(path)) if log else None, env_.engine,
                secs_, torch.cuda.max_memory_allocated(dev))

    # eval_parity: per step against the chunk of 32, bit for bit
    parity = []
    for stochastic in (False, True):
        for n_ep in (1, 0):
            a_ = eval_run("p1", 1, stochastic, n_ep, 256, cfg_e, 200)
            b_ = eval_run("p32", 32, stochastic, n_ep, 256, cfg_e, 200)
            T_ = a_[1]["done"].shape[0]
            bad = [k for k in a_[1] if a_[1][k].dtype != b_[1][k].dtype or
                   not np.array_equal(a_[1][k], b_[1][k])]
            if set(a_[1]) != set(b_[1]) or bad or \
                    not np.array_equal(a_[0], b_[0]) or \
                    any(not torch.equal(getattr(a_[2], r), getattr(b_[2], r))
                        for r in ("sf", "si", "obs")):
                raise Fail(f"eval_parity stochastic={stochastic} "
                           f"num_episodes={n_ep}: the chunk differs from "
                           f"the per-step loop: arrays {bad}, counts "
                           f"{a_[0].sum()} vs {b_[0].sum()}")
            if (n_ep == 1 and (T_ % 32 == 0 or not (a_[0] >= 1).all())) or \
                    (n_ep == 0 and T_ != 200):
                raise Fail(f"eval_parity: {T_} ticks, counts {a_[0].min()}"
                           f"..{a_[0].max()}: not the stop or tail case")
            parity.append({"stochastic_frozen": stochastic,
                           "num_episodes": n_ep, "ticks": T_,
                           "stop": "mid-chunk" if n_ep else
                           "max_steps tail of 8",
                           "arrays_equal": len(a_[1]),
                           "episodes": int(a_[0].sum())})
    # the per-step tick body and an eager eval-chunk tick read nothing on
    # the host (what the capture needs)
    sd_env = BasketballEnv(256, cfg_e, seed=32, trainee_agent_idx=1,
                           device=dev)
    sd_pol = IF.make_policy_fn(ev_agents[0], IF.generator(0, dev))
    sd_obs, _, _ = sd_env.reset()
    sd_chunk = IF.EvalChunk(cfg_e, sd_env.engine, sd_pol, None, 1, 2, 1,
                            True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sd_env.step(sd_pol(sd_obs))
        IF.log_row(sd_env.engine.sf, sd_env.engine.si, 1)
        sd_chunk.tick(0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    emit({"phase": "eval_parity", "worlds": 256, "chunk": 32,
          "max_steps": 200, "time_per_period": 1.0, "cases": parity,
          "sync_debug_mode_error_tick_ok": True})

    # eval_card_vs_cpu: 16 ticks of injected draws, the card's per-step
    # loop against the plain path on the CPU, at the eval CLI's 10 worlds
    # (one partial block of kernel A, row stride 10) and at 256
    tc = 16
    cvc_cases = []
    for wc in (10, 256):
        g_cpu = torch.Generator().manual_seed(41)
        c_noise = [draw_noise_rows(wc, g_cpu, "cpu") for _ in range(tc + 1)]

        def gumbels(n, wc=wc, g_cpu=g_cpu):
            return [FR.gumbel_from_uniform(torch.rand((wc, FR.N_LOGITS),
                                                      generator=g_cpu))
                    for _ in range(n)]
        c_gt, c_gf = gumbels(tc), gumbels(tc + 1)
        cvc = []                     # the card's run, then the CPU's
        for dv in (dev, torch.device("cpu")):
            agents_ = [CK.load_agent(CK.save_agent(a, os.path.join(
                ev_tmp, f"a{i}.pth")), dv) for i, a in enumerate(ev_agents)]
            env_ = BasketballEnv(wc, cfg, seed=33, trainee_agent_idx=1,
                                 device=dv, frozen_policy=IF.make_policy_fn(
                                     agents_[1], None,
                                     gumbel=iter([g.to(dv) for g in c_gf])))
            if cvc:                # the card env's initial rows
                env_.engine.sf, env_.engine.si = (r.cpu() for r in cvc[0][3])
            init_rows_ = (env_.engine.sf.clone(), env_.engine.si.clone())
            path = os.path.join(ev_tmp, f"cvc_{wc}_{len(cvc)}.npz")
            c_ = quiet(IF.infer, env_, agents_[0], path, 0, tc, True, seed=0,
                       trainee_idx=1, frozen_params=agents_[1], chunk_size=1,
                       noise=iter([n.to(dv) for n in c_noise]),
                       gumbel=iter([g.to(dv) for g in c_gt]))
            cvc.append((c_, dict(np.load(path)), env_.engine, init_rows_))
        torch.cuda.synchronize()
        g_log, c_log = cvc[0][1], cvc[1][1]
        keys_ = sorted(c_log)
        if sorted(g_log) != keys_ or g_log["done"].shape[0] != tc or any(
                g_log[k].shape != c_log[k].shape or
                g_log[k].dtype != c_log[k].dtype for k in keys_):
            raise Fail(f"eval_card_vs_cpu {wc} worlds: the npz schemas "
                       "differ")
        cvc_err = compare(f"eval card vs cpu {wc} worlds", [
            torch.from_numpy(g_log[k]) for k in keys_] + [
            getattr(cvc[0][2], r).cpu() for r in ("sf", "si", "obs")],
            [torch.from_numpy(c_log[k]) for k in keys_] + [
            getattr(cvc[1][2], r) for r in ("sf", "si", "obs")],
            atol=1e-4, rel=True)
        cvc_cases.append({"worlds": wc, "ticks": tc,
                          "max_err_rel_to_max_1_abs": cvc_err})
    emit({"phase": "eval_card_vs_cpu", "cases": cvc_cases,
          "frozen": True, "stochastic": True, "arrays": keys_,
          "reference": "plain path on the CPU"})

    # eval_path: ms a tick and eval env-steps/s, per step against the
    # chunk, at the CLI's defaults (10 worlds, log on) and at 8192 worlds
    # x 320 ticks without stopping or logging; kernel A's and kernel J's
    # launches counted from 0 around each run
    eval_launches, eval_j_launches = {}, {}

    def per_step_ticks(env_, pol, n, log):
        """n ticks of infer's per-step loop body (policy, env step, log
        row and done fetched to the host)."""
        obs_ = env_.get_obs()
        for _ in range(n):
            obs_, _, done_ = env_.step(pol(obs_))
            if log:
                for v in IF.log_row(env_.engine.sf, env_.engine.si,
                                    1).values():
                    v.cpu()
                done_.cpu()

    ev_cases = []
    for label, worlds, cfg_, n_ep, max_steps, log in (
            ("cli_defaults_10", 10, cfg, 5, 10000, True),
            ("fleet_8192", W, cfg, 0, 320, False)):
        row = {"case": label, "worlds": worlds, "num_episodes": n_ep,
               "max_steps": max_steps, "log": log}
        for mode, k in (("per_step", 1), ("chunked", 32)):
            FS.launches = EP.launches = 0
            c_, logs_, eng_, secs_, peak_ = eval_run(
                f"{label}_{mode}", k, True, n_ep, worlds, cfg_, max_steps,
                log=log, frozen_on=False)
            n_a, n_j = FS.launches, EP.launches
            ticks_ = logs_["done"].shape[0] if log else max_steps
            if log:
                check_npz(os.path.join(ev_tmp, f"{label}_{mode}.npz"),
                          worlds)
            want_a = 1 + ticks_ if k == 1 else 1 + 1 + k
            if n_a != want_a:
                raise Fail(f"eval_path {label} {mode}: kernel A launched "
                           f"{n_a} times, want {want_a}")
            # the trainee alone: J per step one a tick, chunked one in the
            # capture's warm-up tick and one for each captured tick
            want_j = ticks_ if k == 1 else 1 + k
            if n_j != want_j:
                raise Fail(f"eval_path {label} {mode}: kernel J launched "
                           f"{n_j} times, want {want_j}")
            eval_launches[f"{label}_{mode}"] = n_a
            eval_j_launches[f"{label}_{mode}"] = n_j
            # one profiled window of 32 ticks from a fresh env
            env_ = BasketballEnv(worlds, cfg_, seed=34, trainee_agent_idx=1,
                                 device=dev)
            pol = IF.make_policy_fn(ev_agents[0], IF.generator(0, dev))
            env_.reset()
            if k == 1:
                def window(env_=env_, pol=pol, log=log):
                    per_step_ticks(env_, pol, 32, log)
            else:
                chunk_ = IF.make_eval_chunk(env_, pol, None, 32, 0, log)

                def window(chunk_=chunk_, log=log):
                    chunk_.run(32)
                    int(chunk_.t_used)
                    if log:
                        for buf in chunk_.logs.values():
                            buf.cpu()
            window()
            torch.cuda.synchronize()
            w_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                window()
                torch.cuda.synchronize()
                w_ms.append((time.perf_counter() - t0) * 1e3)
            _, busy_, p_wall, top_ = profiled(window)
            ms_tick = secs_ * 1e3 / ticks_
            w_tick = statistics.median(w_ms) / 32
            row[mode] = {
                "ticks": ticks_, "seconds": secs_, "ms_per_tick": ms_tick,
                "eval_env_steps_per_s": worlds * ticks_ / secs_,
                "episodes": int(c_.sum()), "kernel_a_launches": n_a,
                "kernel_j_launches": n_j,
                "peak_memory_bytes": peak_,
                "window_32_ticks_ms": w_ms, "window_ms_per_tick": w_tick,
                "window_device_busy_ms": busy_,
                "window_device_idle_share": (1.0 - busy_ /
                                             statistics.median(w_ms))
                if busy_ else None, "profiled_window_wall_ms": p_wall,
                "top_device_ms": top_}
        # the ratio from the windows' medians: one infer call also holds
        # the chunk's capture, which dominates a short call
        row["chunked_speedup_window_ms_per_tick"] = \
            row["per_step"]["window_ms_per_tick"] / \
            row["chunked"]["window_ms_per_tick"]
        row["chunked_speedup_infer_call_ms_per_tick"] = \
            row["per_step"]["ms_per_tick"] / row["chunked"]["ms_per_tick"]
        ev_cases.append(row)
    emit({"phase": "eval_path", "cases": ev_cases,
          "launch_note": "kernel A: per step one a tick plus the reset; "
                         "chunked one for the reset, one in the capture's "
                         "warm-up tick and 32 at capture, none at replay; "
                         "kernel J (the trainee alone, no frozen "
                         "opponent): per step one a tick, chunked one in "
                         "the warm-up tick and 32 at capture",
          "ms_per_tick_note": "host clock around infer (env set-up "
                              "excluded, the npz write included) over its "
                              "ticks; the windows are 32 ticks of a fresh "
                              "env, the per-step body or one replay and "
                              "its fetch"})

    # ---------------------------------------------------------- selfplay
    # the league's CLI at 1 cycle x 100 iterations a generation, in a temp
    # directory, in this process so that its launches can be counted;
    # each printed line is time-stamped as it arrives
    class Stamped(io.TextIOBase):
        def __init__(self):
            self.buf, self.lines = "", []

        def write(self, text):
            self.buf += text
            while "\n" in self.buf:
                line, self.buf = self.buf.split("\n", 1)
                self.lines.append((time.perf_counter(), line))
            return len(text)

    sp_dir = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    cwd = os.getcwd()
    out_sp = Stamped()
    reset_counts()
    try:
        os.chdir(sp_dir)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_sp):
            SP.main(["--num-training-cycles", "1", "--iter-per-agent", "100",
                     "--num-envs", str(W), "--device", str(dev)])
        torch.cuda.synchronize()
        sp_secs = time.perf_counter() - t0
        sp_launches = counts()
        check_path("selfplay", False, sp_launches)
        marks = [(t_, ln) for t_, ln in out_sp.lines
                 if "GENERATION" in ln or "Cycle" in ln]
        gens = {}
        for (ta, la), (tb, _) in zip(marks, marks[1:]):
            name = la.split("(")[1].split(")")[0]
            gens[name] = {"seconds": tb - ta, "ms_per_iteration":
                          (tb - ta) * 1e3 / 100}
        rewards = [ln.strip() for _, ln in out_sp.lines
                   if "mean_reward=" in ln]
        for name in ("model_1_gen_0", "model_0_gen_0"):
            files = sorted(os.listdir(os.path.join("checkpoints", name)))
            if files != sorted(f"{name}_{i}.pth"
                               for i in range(10, 101, 10)):
                raise Fail(f"selfplay {name} checkpoints: {files}")
            if not any(f"[{name}] iter 100:" in ln for ln in rewards):
                raise Fail(f"selfplay: no mean-reward line of {name}")
            sd_ = torch.load(os.path.join("checkpoints", name,
                                          f"{name}_100.pth"),
                             weights_only=True)
            if not all(bool(torch.isfinite(v).all()) for v in sd_.values()):
                raise Fail(f"selfplay {name}: non-finite checkpoint")
        for i in (0, 1):
            CK.load_agent(f"checkpoints/model_{i}_initial.pth", dev)
        if set(gens) != {"model_1_gen_0", "model_0_gen_0"}:
            raise Fail(f"selfplay: generations {sorted(gens)}")
        # multi-generation eval over one generation, against the other
        # generation's last checkpoint (one episode a world)
        FS.launches = EP.launches = 0
        t0 = time.perf_counter()
        quiet(IF.multi_gen_infer, "model_1_gen_0", num_envs=10,
              frozen_checkpoint="checkpoints/model_0_gen_0/"
                                "model_0_gen_0_100.pth",
              num_episodes=1, device=dev)
        torch.cuda.synchronize()
        mgi_secs = time.perf_counter() - t0
        mgi = sorted(os.listdir("logs/mgi/model_1_gen_0_"))
        if mgi != sorted(f"model_1_gen_0_{i}.npz"
                         for i in range(10, 101, 10)):
            raise Fail(f"multi_gen_infer wrote {mgi}")
        mgi_ticks = [check_npz(os.path.join("logs/mgi/model_1_gen_0_", f),
                               10) for f in mgi]
        mgi_launches, mgi_j = FS.launches, EP.launches
        # each checkpoint: the env's reset runs the frozen opponent (one
        # launch of J), then the chunk one in its capture's warm-up tick
        # and 32 at capture, none at replay
        if mgi_j != len(mgi) * (1 + 1 + 32):
            raise Fail(f"multi_gen_infer: kernel J launched {mgi_j} times "
                       f"over {len(mgi)} checkpoints, want "
                       f"{len(mgi) * (1 + 1 + 32)}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(sp_dir, ignore_errors=True)
    emit({"phase": "selfplay", "flags": "--num-training-cycles 1 "
          f"--iter-per-agent 100 --num-envs {W}", "seconds": sp_secs,
          "generations": gens, "reward_lines": rewards,
          "launches": sp_launches,
          "fused_update_phase_device_launches": FU.device_launches,
          "launch_note": "each generation: 10 chunks of 10 iterations, "
                         "one warm-up step and one capture counted",
          "multi_gen_infer": {"checkpoints": len(mgi), "worlds": 10,
                              "num_episodes": 1, "frozen": True,
                              "ticks": mgi_ticks, "seconds": mgi_secs,
                              "kernel_a_launches": mgi_launches,
                              "kernel_j_launches": mgi_j}})

    # ---------------------------------------------------------- resume
    # a train state saved after 2 iterations and restored continues bit
    # for bit like the uninterrupted run
    rs_iter = make_train_iteration(cfg, hp, device=dev)
    rs_state = init_train_state(cfg, hp, seed=5, device=dev)
    for _ in range(2):
        rs_state, _ = rs_iter(rs_state)
    rs_path = save_train_state(rs_state, os.path.join(ev_tmp, "ts.pt"))
    restored = restore_train_state(rs_path, dev)
    cont_a, o_a = rs_iter(copy.deepcopy(rs_state))
    cont_b, o_b = rs_iter(restored)
    torch.cuda.synchronize()
    ta_, tb_ = state_tensors(cont_a), state_tensors(cont_b)
    rs_diff = [i for i, (x, y) in enumerate(zip(ta_, tb_))
               if not torch.equal(x, y)]
    rs_mdiff = [k for k in o_a["metrics"]
                if not torch.equal(o_a["metrics"][k], o_b["metrics"][k])]
    rs_counters = [(cont_a.counter, cont_b.counter),
                   (cont_a.opt.count, cont_b.opt.count),
                   (cont_a.iteration, cont_b.iteration)]
    if rs_diff or rs_mdiff or any(a != b for a, b in rs_counters):
        raise Fail(f"resume: tensors {rs_diff}, metrics {rs_mdiff}, "
                   f"counters {rs_counters}")
    emit({"phase": "resume", "worlds": W, "ticks": T,
          "iterations": "2, save, restore, 1", "tensors_equal": len(ta_),
          "metrics_equal": len(o_a["metrics"]),
          "file_bytes": os.path.getsize(rs_path)})
    shutil.rmtree(ev_tmp, ignore_errors=True)

    # ---------------------------------------------------------- data parallel
    # The multi-GPU trainer on this card: an in-process NCCL group of one
    # rank (its collectives run for real), the plain `--data-parallel`
    # iteration (kernel E for the obs moments, D on the gathered
    # trajectory) and `--dp-update` (kernel G a minibatch, the gradient
    # all-reduced, torch clip + Adam) at the flagship shape.
    import torch.distributed as dist
    from madrona_basketball_tpu_torch.parallel import mesh as PM
    from madrona_basketball_tpu_torch.parallel.distributed import \
        init_single_process
    from madrona_basketball_tpu_torch.ppo.train_fused import dp_update_phase
    init_single_process(DEVICE)
    mesh = PM.make_mesh(DEVICE)
    if mesh.backend != "nccl" or mesh.size != 1:
        raise Fail(f"the in-process group is {mesh.backend} of {mesh.size}")
    nblk = T * W // wb
    plain_it = make_train_iteration(cfg, hp, dev, mesh=mesh)
    dpu_it = make_train_iteration(cfg, hp, dev, mesh=mesh, dp_update=True)

    def shard(st, dp=False):
        return PM.shard_train_state(copy.deepcopy(st), mesh, dp)

    def dp_timing(it_fn, st):
        """Eager: 3 iterations by CUDA events (median), one more profiled
        for the device's busy time; chunked: the first chunk of 50 (its
        warm-up and capture), then 3 chunks by CUDA events and one
        profiled; peak device memory of the chunked run (and over what
        the process held before it)."""
        st = copy.deepcopy(st)
        e_times = []
        for _ in range(3):
            a, b_ = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            st, _ = it_fn(st)
            b_.record()
            torch.cuda.synchronize()
            e_times.append(a.elapsed_time(b_))
        (st, _), e_busy, e_wall, _ = profiled(lambda: it_fn(st))
        n = 50
        chunk = TT.make_train_chunk(it_fn, n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start_mem = torch.cuda.memory_allocated(dev)
        st, _ = chunk(st)
        c_times = []
        for _ in range(3):
            a, b_ = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            st, stacked = chunk(st)
            b_.record()
            torch.cuda.synchronize()
            c_times.append(a.elapsed_time(b_))
        peak = torch.cuda.max_memory_allocated(dev)
        for k, v in stacked.items():
            if v.shape != (n,) or not bool(torch.isfinite(v).all()):
                raise Fail(f"chunk metric {k} {tuple(v.shape)} or "
                           "non-finite")
        _, busy, c_wall, top = profiled(lambda: chunk(st))
        it_ms = statistics.median(c_times) / n
        busy_it = busy / n if busy else None
        e_ms = statistics.median(e_times)
        return {"eager_iteration_ms": e_ms, "eager_ms": e_times,
                "eager_train_env_steps_per_s": W * T / (e_ms / 1e3),
                "eager_device_busy_ms": e_busy,
                "eager_device_idle_share": (1.0 - e_busy / e_ms) if e_busy
                else None, "eager_profiled_wall_ms": e_wall,
                "iters_per_dispatch": n, "chunk_ms": c_times,
                "chunked_iteration_ms": it_ms,
                "chunked_train_env_steps_per_s": W * T / (it_ms / 1e3),
                "device_busy_ms_per_iteration": busy_it,
                "device_idle_share": (1.0 - busy_it / it_ms) if busy_it
                else None, "profiled_chunk_wall_ms": c_wall,
                "top_device_ms_chunk": top, "peak_memory_bytes": peak,
                "peak_over_start_bytes": peak - start_mem}

    try:
        # dp_path: one iteration of each path from one flagship state on
        # the same permutations
        s0 = copy.deepcopy(state)
        P = torch.stack([torch.randperm(nblk, generator=gen, device=dev)
                         for _ in range(hp.update_epochs)])
        f1, fo = train_iteration(copy.deepcopy(s0), perms=P)
        t1, to_ = t_iteration(copy.deepcopy(s0), perms=P)
        p1, po = plain_it(shard(s0), perms=P)
        d1, do = dpu_it(shard(s0, True), perms=P[None])
        torch.cuda.synchronize()

        def diff_tensors(a, b_):
            return [i for i, (x, y) in enumerate(zip(state_tensors(a),
                                                     state_tensors(b_)))
                    if not torch.equal(x, y)]

        def diff_out(oa, ob, keys):
            bad = [k for k in keys if not torch.equal(oa[k], ob[k])]
            bad += [f"{r}.{f}" for r in ("value_rms",)
                    for f in ("mean", "var", "count")
                    if not torch.equal(getattr(oa[r], f), getattr(ob[r], f))]
            bad += [f"metrics.{k}" for k in oa["metrics"]
                    if not torch.equal(oa["metrics"][k], ob["metrics"][k])]
            return bad
        # plain data-parallel == the tiled flagship (kernel I == kernel B,
        # kernel E on the same trajectory), every tensor
        plain_vs_tiled = diff_tensors(p1, t1) + diff_out(
            po, to_, ("traj", "side", "ustats"))
        if plain_vs_tiled:
            raise Fail(f"dp_path: plain data-parallel differs from the "
                       f"tiled flagship: {plain_vs_tiled}")
        # plain vs the flagship: the same collect but for the obs moments
        # (kernel E, not B's fold); the update from those normalizers
        plain_vs_flag = diff_out(po, fo, ("traj", "side", "ustats"))
        if plain_vs_flag:
            raise Fail(f"dp_path: plain data-parallel collect differs from "
                       f"the flagship's: {plain_vs_flag}")
        om_rel = max(float(((getattr(po["obs_rms"], f) -
                             getattr(fo["obs_rms"], f)).abs() /
                            torch.clamp(getattr(fo["obs_rms"], f).abs(),
                                        min=1.0)).max())
                     for f in ("mean", "var"))
        if om_rel > 1e-5:
            raise Fail(f"dp_path: plain obs normalizer {om_rel} of max(1, "
                       "|x|) from the flagship's")
        plain_params = max(float((a - b_).abs().max()) for a, b_ in zip(
            FU.pack_weights(p1.agent.net), FU.pack_weights(f1.agent.net)))
        if plain_params > 1e-4:
            raise Fail(f"dp_path: plain data-parallel params {plain_params} "
                       "from the flagship's after one iteration")
        # dp_update at one rank: the collect equals the flagship's bit for
        # bit (one shard's Chan combine is the identity)
        dp_vs_flag = diff_out(do, fo, ("traj", "side", "ustats")) + [
            f"obs_rms.{f}" for f in ("mean", "var", "count")
            if not torch.equal(getattr(do["obs_rms"], f),
                               getattr(fo["obs_rms"], f))] + [
            k for k in ("sf", "si", "obs")
            if not torch.equal(getattr(d1, k), getattr(f1, k))]
        if dp_vs_flag:
            raise Fail(f"dp_path: the dp_update collect differs from the "
                       f"flagship's: {dp_vs_flag}")
        # the dp update held per Adam step, at kernel D's kink-aware tiers
        # (parity D): each step (kernel G, the all-reduce, torch clip +
        # Adam) against the plain step from the same params and moments;
        # the steps chained equal the iteration's update bit for bit
        u_nrm_dp = FU.pack_norm(fo["obs_rms"])
        idx = P.reshape(-1).to(torch.int32)
        st = (FU.pack_weights(s0.agent.net), s0.opt.mu, s0.opt.nu)
        dp_err, n_kink, allow_max = {}, 0, dict.fromkeys(("params", "mu",
                                                           "nu"), 0.0)
        for k in range(n_mb):
            s_idx = idx[k * bpm:(k + 1) * bpm]
            sk = dp_update_phase(hp, mesh, s_idx, s0.opt.count + k,
                                 fo["traj"], fo["side"], fo["ustats"],
                                 u_nrm_dp, *st, wb=wb)
            *sp, rep = FU.update_phase_kinks(
                hp, s_idx, s0.opt.count + k, fo["traj"], fo["side"],
                u_nrm_dp, fo["ustats"], *st, wb=wb)
            n_kink += rep["samples"]
            for name, ks, ps, als in zip(("params", "mu", "nu"), sk, sp,
                                         rep["allow"]):
                for i, (k_, p_, a_) in enumerate(zip(ks, ps, als)):
                    if not bool(torch.isfinite(k_).all()):
                        raise Fail(f"dp update step {k} {name}[{i}]: "
                                   "non-finite")
                    d = (k_ - p_).abs()
                    lim = (1e-4 if name == "params" else
                           1e-4 * float(p_.abs().max())) / n_mb
                    if bool((d > lim + a_).any()):
                        raise Fail(f"dp update step {k} {name}[{i}]: error "
                                   f"{float(d.max())} above {lim} + the "
                                   f"kink allowance (max {float(a_.max())})")
                    dp_err[name] = max(dp_err.get(name, 0.0),
                                       float(d.max()))
                    allow_max[name] = max(allow_max[name], float(a_.max()))
            st = sk
        if n_kink > 1e-3 * n_mb * hp.minibatch_size:
            raise Fail(f"dp update: {n_kink} samples at a kink of the loss")
        dp_composed = all(
            torch.equal(a, b_) for u, v in zip(st, (
                FU.pack_weights(d1.agent.net), d1.opt.mu, d1.opt.nu))
            for a, b_ in zip(u, v))
        if not dp_composed:
            raise Fail("dp update: the iteration's update differs from its "
                       "steps chained")
        errs["dp_update_step"] = dp_err["params"]
        dp_drift = max(float((a - b_).abs().max()) for a, b_ in zip(
            FU.pack_weights(d1.agent.net), FU.pack_weights(f1.agent.net)))

        # launches counted from 0 around 3 eager iterations of each path
        dp_launch = {}
        for mode, it_fn, dp in (("plain", plain_it, False),
                                ("dp_update", dpu_it, True)):
            st_m = shard(s0, dp)
            reset_counts()
            for _ in range(3):
                st_m, o_m = it_fn(st_m)
            torch.cuda.synchronize()
            dp_launch[mode] = {**counts(),
                               "fused_update_phase_device_launches":
                               FU.device_launches}
        on = {"plain": ("fused_step", "fused_rollout", "fused_gae",
                        "meter_scan", "obs_moments", "fused_update_phase"),
              "dp_update": ("fused_step", "fused_rollout", "fused_gae",
                            "meter_scan", "fused_minibatch_grad_prefetch")}
        for mode, ks in on.items():
            got_l = dp_launch[mode]
            off = [k for k in ("fused_rollout_tiled", "fused_minibatch_grad",
                               "fused_update_phase", "obs_moments",
                               "fused_minibatch_grad_prefetch")
                   if k not in ks and got_l[k]]
            if min(got_l[k] for k in ks) < 1 or off:
                raise Fail(f"dp_path {mode}: launches {got_l}")
        if dp_launch["dp_update"]["fused_minibatch_grad_prefetch"] != \
                3 * n_mb or dp_launch["plain"]["obs_moments"] != 3:
            raise Fail(f"dp_path: G {dp_launch['dp_update']}, E "
                       f"{dp_launch['plain']} in 3 iterations")
        timing = {"flagship": dp_timing(train_iteration, s0),
                  "plain": dp_timing(plain_it, shard(s0)),
                  "dp_update": dp_timing(dpu_it, shard(s0, True))}
        emit({"phase": "dp_path", "worlds": W, "ticks": T, "ranks": 1,
              "backend": "nccl", "epochs": hp.update_epochs,
              "minibatches": hp.num_minibatches,
              "plain_equals_tiled_flagship": True,
              "plain_collect_equals_flagship_but_obs_moments": True,
              "plain_obs_rms_rel_err": om_rel,
              "plain_params_from_flagship": plain_params,
              "dp_update_collect_equals_flagship": True,
              "dp_update_step_max_abs_err": dp_err,
              "dp_update_step_kinks": {"samples_at_a_kink": n_kink,
                                       "of_samples": n_mb * hp.minibatch_size,
                                       "max_allowance": allow_max},
              "dp_update_equals_its_steps_chained": dp_composed,
              "dp_update_params_from_flagship": dp_drift,
              "launches_3_iterations": dp_launch, "timing": timing})

        # dp_chunk_parity: 3 eager iterations against a chunk of 3, the
        # collectives captured with NCCL, bit for bit
        chunk_parity("dp_chunk_parity", False, shard(s0), plain_it)
        chunk_parity("dp_chunk_parity_dp_update", False, shard(s0, True),
                     dpu_it)

        # dp_two_rank: two gloo ranks on this one card (NCCL refuses two
        # ranks on one GPU; gloo carries the CUDA tensors through the
        # host), 2 x 4096 worlds against the one-rank 8192 run
        two_dir = tempfile.mkdtemp(dir=_build.BUILD_DIR)
        import torch.multiprocessing as mp
        t0 = time.perf_counter()
        mp.spawn(_two_rank_worker, args=(two_dir,), nprocs=2)
        two_secs = time.perf_counter() - t0
        two = {}
        for dp in (False, True):
            it_fn = dpu_it if dp else plain_it
            one_st, one_o = it_fn(shard(init_train_state(
                cfg, hp, seed=TWO_RANK_SEED, device=dev), dp))
            got = torch.load(os.path.join(two_dir, f"two_rank_{int(dp)}.pt"))
            want = _two_rank_record(one_st, one_o)
            if sorted(got) != sorted(want):
                raise Fail(f"dp_two_rank: records {sorted(got)}")
            close = {k: float((got[k].double() - want[k].double()).abs()
                              .max()) for k in want
                     if not torch.equal(got[k], want[k])}
            bad = [k for k, e in close.items()
                   if not e <= two_rank_tier(k, want[k], dp)]
            if bad:
                raise Fail(f"dp_two_rank dp_update={dp}: {bad} above their "
                           f"tiers ({close})")
            two["dp_update" if dp else "plain"] = {
                "bit_identical": len(want) - len(close),
                "of": len(want), "not_bit_identical": close}
        shutil.rmtree(two_dir, ignore_errors=True)
        emit({"phase": "dp_two_rank", "ranks": 2, "worlds_per_rank": W // 2,
              "backend": "gloo on one card (a harness choice: NCCL takes "
                         "one rank a GPU)", "iterations": 1,
              "seconds": two_secs, **two})

        # learning_dp_update: 600 iterations from seed 321 in chunks of 50
        l_state = shard(init_train_state(cfg, hp, seed=321, device=dev),
                        True)
        l_chunk = TT.make_train_chunk(
            make_train_iteration(cfg, hp, dev, mesh=mesh, dp_update=True), 50)
        curve_dp = []
        t0 = time.perf_counter()
        for it in range(50, 601, 50):
            l_state, st_l = l_chunk(l_state)
            curve_dp.append([it, float(st_l["mean_reward"][-1]),
                             float(st_l["mean_episode_length"][-1])])
        l_secs = time.perf_counter() - t0
        final = curve_dp[-1][1]
        emit({"phase": "learning_dp_update", "iterations": 600, "seed": 321,
              "iters_per_dispatch": 50, "seconds": l_secs,
              "curve": curve_dp, "final_mean_reward": final,
              "band": [-150.0, -105.0]})
        if not -150.0 <= final <= -105.0:
            raise Fail(f"learning_dp_update: mean reward {final} after 600 "
                       "iterations is outside -150..-105")

        # ------------------------------------------------------ bf16 paths
        # the bf16 flags on their paths (ROADMAP item 16c), the two
        # data-parallel ones on this group; then 2000 learning iterations
        # of each flag and the CLI with both
        bf16 = bf16_paths(cfg, hp, dev, mesh, reset_counts, counts,
                          profiled, chunk_parity)
        bf16_learning(cfg, hp, dev)
        bf16_cli()
    finally:
        dist.destroy_process_group()

    # cli_dp: the CLI as a user runs it on this card, each at the default
    # auto chunk (50 iterations a dispatch at the 100 / 100 cadences)
    root = Path(FU.__file__).resolve().parents[2]
    cli_tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        base_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(root), os.environ.get("PYTHONPATH")])))
        import socket
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        torchrun = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                        RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        runs = (("dp", ["--data-parallel"], {}, "Data-parallel over 1"),
                ("dpu", ["--data-parallel", "--dp-update"], {},
                 "sharded update"),
                ("dist", ["--distributed", "--data-parallel"], torchrun,
                 "torch.distributed: 1 process(es), 1 global GPU(s), nccl"))
        # the three started together (each its own world-size-1 group)
        done = run_clis({model: (["madrona_basketball_tpu_torch.cli",
                                  "--num-iterations", "100", "--model-name",
                                  model, *flags], extra_env)
                         for model, flags, extra_env, _ in runs},
                        cli_tmp, base_env)
        for model, flags, extra_env, want in runs:
            rc, so, se, secs = done[model]
            if rc != 0:
                raise Fail(f"cli {flags} exited {rc}: {se[-3000:]}")
            if want not in so or "Iterations per dispatch: 50" not in so:
                raise Fail(f"cli {flags}: {so[-2000:]}")
            path = Path(cli_tmp) / CK.checkpoint_path(model, 100)
            saved = torch.load(path, weights_only=True)
            back = CK.state_dict(CK.load_agent(str(path), dev))
            if sorted(back) != sorted(saved) or not all(
                    torch.equal(back[k], saved[k]) for k in saved) or \
                    not all(bool(torch.isfinite(v).all())
                            for v in saved.values()):
                raise Fail(f"cli {flags}: the checkpoint does not load back "
                           "equal and finite")
            emit({"phase": "cli_dp", "flags": flags,
                  "env": sorted(extra_env), "seconds": secs,
                  "checkpoint": CK.checkpoint_path(model, 100),
                  "note": "3 CLI runs started together",
                  "log": [ln for ln in so.splitlines()
                          if ln.startswith(("Update:", "Mean reward",
                                            "Model ", "Data-parallel",
                                            "torch.distributed"))]})
        # the weak-scaling sweep's n = 1 row (one visible GPU)
        proc = subprocess.run(
            [sys.executable, "-m",
             "madrona_basketball_tpu_torch.bench_scaling",
             "--worlds-per-gpu", str(W)], cwd=cli_tmp, env=base_env,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise Fail(f"bench_scaling exited {proc.returncode}: "
                       f"{proc.stderr[-3000:]}")
        rows_s = [json.loads(ln) for ln in proc.stdout.splitlines()
                  if ln.startswith("{")]
        if len(rows_s) != torch.cuda.device_count() or \
                rows_s[0]["gpus"] != 1:
            raise Fail(f"bench_scaling printed {rows_s}")
        emit({"phase": "bench_scaling", **rows_s[0]})
    finally:
        shutil.rmtree(cli_tmp, ignore_errors=True)

    # ---------------------------------------------------------- alt paths
    # the JAX trainer's alternate paths (ROADMAP item 16) at the flagship
    # width: --no-rollout-kernel (per tick: kernel A a tick, the policy
    # in torch, the autodiff update), --no-fused-gae (kernel B or I, torch
    # GAE, kernel D on normalized side rows) and its tiled twin,
    # --no-fused-grads (kernel B, the autodiff update) at shuffle_block 8
    # and 1, and --backend structured (systems.py in torch)
    alt = alt_paths(cfg, hp, dev, gen, n_mb, reset_counts, counts, profiled,
                    chunk_parity)
    alt_launches = alt["launches"]
    alt_per_tick_vs_b(cfg, hp, dev, gen)
    alt_nofgae_vs_flagship(cfg, hp, dev)
    # the first Adam step of the autodiff update against kernel H's plain
    # gradient on the same 65536 samples (parity G, H's minibatch)
    alt_update_step(hp, feat, u_nrm, u_out["obs_rms"], u_state.agent, hpl)
    # the structured tick against kernel A after layout.pack
    alt_structured_tick(cfg, dev, gen)
    # the CLI with each new flag, as subprocesses side by side
    alt_cli(dev)

    # ---------------------------------------------------------- interactive
    # ROADMAP items 13, 15 and 17: the interactive trainer at the flagship
    # width with a scripted viewer, the card against the CPU, the native
    # host executor against kernel A, the cross-check trainer, and the
    # modules no trainer uses
    inter_trainer, inter = interactive_path(cfg, hp, dev, reset_counts,
                                            counts, profiled)
    interactive_card_vs_cpu(cfg, dev)
    native_engine(cfg, dev)
    crosscheck(dev)
    aux_modules(dev, inter_trainer)
    del inter_trainer

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
    # kernel D's --no-fused-gae branch: normalized side rows, ustats None
    dn_args = (hp, u_idx, 0, u_traj, side_n, u_nrm, None, u_params,
               mom.mu, mom.nu)
    grad_k = {"update_grad_kernel<0, float>": 1, "update_reduce_kernel": 1}
    # the bf16 branches' inputs: the main path's, the trajectory rounded
    grad_k16 = {"update_grad_kernel<0, unsigned short>": 1,
                "update_reduce_kernel": 1}
    c_args16 = (out["traj"].to(BF),) + c_args[1:]
    t_traj16 = t_out["traj"].to(BF)
    d16_args = (hp, u_idx, 0, u_traj.to(BF), u_side, u_nrm, u_ustats,
                u_params, mom.mu, mom.nu)
    g16_args = (hp, u_idx[:bpm], u_traj.to(BF), side_n, u_nrm, *u_params)
    # kernel F at bench.py's K, one seed per call; the plain version at
    # K = 8 on 8 ticks of external noise (~35 ms a tick on the card)
    KB = 5000
    f_args = (cfg, state.sf, state.si)
    f_ext = FS.pack_multistep_noise([draw_noise_rows(W, gen, dev)
                                     for _ in range(8)])
    f_seeds = iter(range(1, 1 << 30))

    def f_calls(every):
        kw = dict(obs_every_tick=every, blank_agent=0 if every else None)
        return (lambda: FS.fused_multistep(*f_args, KB, seed=next(f_seeds),
                                           **kw),
                lambda: FS.multistep_rows_plain(*f_args, f_ext, 8, every,
                                                kw["blank_agent"]), 3, 1,
                {f"fused_multistep_kernel<{str(every).lower()}>": 1})
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
        "fused_update_phase_normalized_side": (
            lambda: FU.fused_update_phase(*dn_args, wb=wb),
            lambda: FU.update_phase_plain(*dn_args, wb=wb), 3, 1,
            {k: n_mb for k in grad_k}),
        "fused_minibatch_grad_prefetch": (
            lambda: FU.fused_minibatch_grad_prefetch(*g_args, wb=wb),
            lambda: FU.minibatch_grad_prefetch_plain(*g_args, wb=wb), 10, 2,
            grad_k),
        "fused_minibatch_grad": (
            lambda: FU.fused_minibatch_grad(*h_args),
            lambda: FU.minibatch_grad_plain(*h_args), 10, 2,
            {"update_grad_kernel<1, float>": 1, "update_reduce_kernel": 1}),
        "fused_multistep_every_tick_obs": f_calls(True),
        "fused_multistep_held_obs": f_calls(False),
        "fused_rollout_tiled": (
            lambda: FR.fused_rollout_tiled(*r_args, n_steps=T,
                                           trainee_idx=1, seed=seed),
            lambda: FR.rollout_tiled_plain(*r_args, n_steps=T,
                                           trainee_idx=1, noise=ph_noise),
            5, 1, {"fused_rollout_tiled_kernel": 1}),
        "obs_moments": (
            lambda: FG.obs_moments(t_out["traj"]),
            lambda: FG.obs_moments_plain(t_out["traj"]), 20, 2,
            {"obs_moment_partial_kernel": 1,
             "obs_moment_combine_kernel": 1}),
        # the bf16 branches (ROADMAP item 16c)
        "fused_rollout_bf16_traj": (
            lambda: FR.fused_rollout(*r_args, n_steps=T, trainee_idx=1,
                                     seed=seed, traj_dtype=BF),
            lambda: FR.rollout_plain(*r_args, n_steps=T, trainee_idx=1,
                                     noise=ph_noise, traj_dtype=BF), 5, 1,
            {"fused_rollout_bf16_kernel": 1}),
        "fused_rollout_bf16_policy": (
            lambda: FR.fused_rollout(*r_args, n_steps=T, trainee_idx=1,
                                     seed=seed, policy_bf16=True),
            lambda: FR.rollout_plain(*r_args, n_steps=T, trainee_idx=1,
                                     noise=ph_noise, policy_bf16=True), 5,
            1, {"fused_rollout_bf16_kernel": 1}),
        "fused_gae_bf16": (lambda: FG.fused_gae(*c_args16, **gae_kw),
                           lambda: FG.gae_plain(*c_args16, **gae_kw), 20, 2,
                           {"fused_gae_kernel": 1}),
        "obs_moments_bf16": (
            lambda: FG.obs_moments(t_traj16),
            lambda: FG.obs_moments_plain(t_traj16), 20, 2, E16_KERNELS),
        "fused_update_phase_bf16": (
            lambda: FU.fused_update_phase(*d16_args, wb=wb),
            lambda: FU.update_phase_plain(*d16_args, wb=wb), 3, 1,
            {k: n_mb for k in grad_k16}),
        "fused_minibatch_grad_prefetch_bf16": (
            lambda: FU.fused_minibatch_grad_prefetch(*g16_args, wb=wb),
            lambda: FU.minibatch_grad_prefetch_plain(*g16_args, wb=wb), 10,
            2, grad_k16),
        # kernel B's timing probes (the attribution bench's instances)
        **{f"fused_rollout_probe_{pr}": (
            lambda pr=pr: FR.fused_rollout(*r_args, n_steps=T, trainee_idx=1,
                                           seed=seed, probe=pr),
            lambda pr=pr: FR.rollout_plain(
                *r_args, n_steps=T, trainee_idx=1, probe=pr,
                noise=FR.no_prng_noise(T, W, dev) if pr == "no_prng"
                else ph_noise), 5, 1, {"fused_rollout_probe_kernel": 1})
           for pr in FR.PROBES},
    }
    # ms: the kernels' own device time per call; wrapper_ms: CUDA events
    # around back-to-back wrapper calls (median of 5 windows), which also
    # holds the device's wait for the host; plain_ms: the plain version
    ms = {name: (kernel_ms(k, reps, kern), cuda_ms(k, reps, 5),
                 cuda_ms(p, p_reps))
          for name, (k, p, reps, p_reps, kern) in calls.items()}
    # kernels A and E near half their bounds: each profiled launch of 30
    # calls (at least 21 recorded whole), median and spread
    per_launch = {}
    for name in ("fused_step", "obs_moments"):
        one = launch_ms(calls[name][0], 30, list(calls[name][4]))
        per_launch[name] = {
            "launch_ms_median": statistics.median(one) if one else None,
            "launch_ms_min": min(one, default=None),
            "launch_ms_max": max(one, default=None),
            "launch_ms_n": len(one)}
    # kernel D's device time split into its gradient and reduce launches
    d_split = {k: kernel_ms(calls["fused_update_phase"][0], 3, {k: n_mb})
               for k in grad_k}
    # what ptxas printed for the redesigned kernels' main-path instances,
    # and their warps per SM
    ptx = {n: _build.ptxas_kernels(n) for n in ("fused_update",
                                                 "fused_rollout",
                                                 "fused_rollout_tiled",
                                                 "fused_multistep",
                                                 "fused_gae",
                                                 "fused_rollout_bf16")}
    # kernel F's SASS: system 18's shared-memory stores inside the tick
    # loop of the every-tick instance, no global stores there
    sass = _build.sass_loop_counts("fused_multistep")
    f_occ = FS.multistep_occupancy(dev, W)

    def f_design(every):
        key = f"fused_multistep_kernelILb{int(every)}E"
        inst = "every_tick_obs" if every else "held_obs"
        return {"ptxas": ptx_of("fused_multistep", key),
                "occupancy": f_occ[inst],
                "sass": next(v for k, v in sass.items() if key in k)}

    def ptx_of(lib, key):
        return next((v for k, v in ptx[lib].items() if key in k), None)
    d_occ = FU.occupancy(dev)
    design = {
        "fused_update_phase": {
            "grad_launches_ms": d_split["update_grad_kernel<0, float>"],
            "reduce_launches_ms": d_split["update_reduce_kernel"],
            "ptxas": {"grad": ptx_of("fused_update",
                                     "update_grad_kernelILi0EfE"),
                      "reduce": ptx_of("fused_update",
                                       "update_reduce_kernel")},
            "occupancy": d_occ,
            "barriers_per_tile": d_occ["grad"]["barriers_per_tile"]},
        "fused_rollout": {
            "ptxas": ptx_of("fused_rollout", "fused_rollout_kernelILi1ELb0E"),
            "occupancy": FR.rollout_occupancy(dev)},
        "fused_rollout_tiled": {
            "ptxas": ptx_of("fused_rollout_tiled",
                            "fused_rollout_tiled_kernelILi1ELb0E")},
        "fused_multistep_every_tick_obs": f_design(True),
        "fused_multistep_held_obs": f_design(False),
        "fused_gae": {"ptxas": ptx_of("fused_gae", "fused_gae_kernelIfE"),
                      "occupancy": FG.gae_occupancy(dev, T, W)},
        # the bf16 instances (trainee 1, no frozen policy, as the main
        # path's); B's bf16 instances take B's shared memory and threads
        "fused_rollout_bf16_traj": {"ptxas": ptx_of(
            "fused_rollout_bf16", "fused_rollout_bf16_kernelILi1ELb0EtLb0E")},
        "fused_rollout_bf16_policy": {
            "ptxas": ptx_of("fused_rollout_bf16",
                            "fused_rollout_bf16_kernelILi1ELb0EfLb1E"),
            "occupancy": FR.rollout_occupancy(dev, "fused_rollout_bf16")},
        "fused_gae_bf16": {"ptxas": ptx_of("fused_gae",
                                           "fused_gae_kernelItE")},
        "fused_update_phase_bf16": {"ptxas": ptx_of(
            "fused_update", "update_grad_kernelILi0EtE")}}
    # system 18 stores N_OBS_ROWS obs rows a world each tick: the
    # every-tick loop holds at least that many more STS than the held one
    f_sts = [design[f"fused_multistep_{n}"]["sass"]["STS_in_loop"]
             for n in ("every_tick_obs", "held_obs")]
    if f_sts[0] - f_sts[1] < N_OBS_ROWS or \
            design["fused_multistep_every_tick_obs"]["sass"]["STG_in_loop"]:
        raise Fail(f"kernel F's tick loop: STS {f_sts} (every tick, held), "
                   "system 18's shared stores are not inside the loop or "
                   "obs still go to global memory there")
    if d_occ["grad"]["warps_per_sm"] != 8:
        raise Fail(f"kernel D's gradient kernel: {d_occ['grad']}, not one "
                   "CTA of 8 warps an SM")
    print(f"kernel D's gradient kernel: {d_occ['grad']['warps_per_sm']} "
          f"warps an SM, barriers a tile {d_occ['grad']['barriers_per_tile']}",
          flush=True)
    emit({"phase": "design", **design})
    update_stage_probe(hp, u_idx, u_traj, u_side, u_nrm, u_ustats, u_params,
                       wb)
    # library_ms: one PyTorch call computing the same function, where one
    # exists (only kernel E's per-feature moments: torch.var_mean)
    library = {"obs_moments": cuda_ms(
        lambda: torch.var_mean(t_out["traj"][:, :FR.ROLL_OBS], dim=(0, 2),
                               correction=0), 20, 5)}

    # bounds: bytes each input read once / each output written once, and
    # the plain versions' float arithmetic counted at a small width
    cpu = torch.device("cpu")
    ws = 64
    sf_s, si_s = init_rows(cfg, ws, torch.Generator().manual_seed(0), cpu)
    n_s = draw_noise_rows(ws, torch.Generator().manual_seed(1), cpu)
    ops_a = count_ops(FS.step_rows_plain, cfg, sf_s, si_s, n_s) / ws
    ops_a_no_obs = count_ops(FS.step_rows_plain, cfg, sf_s, si_s, n_s,
                             compute_obs=False) / ws
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
    wt = FR.TILED_WORLDS
    sf_t, si_t = init_rows(cfg, wt, torch.Generator().manual_seed(0), cpu)
    ops_i = count_ops(FR.rollout_tiled_plain, cfg, sf_t, si_t,
                      torch.zeros((256, wt)), mats_s, n_steps=1,
                      trainee_idx=1,
                      noise=FR.philox_noise(0, 0, 1, wt, cpu)) / wt
    ops_e = count_ops(FG.obs_moments_plain, torch.zeros((4, 128, wt))) / \
        (4 * FR.ROLL_OBS * wt)
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
    # kernel F: state read and written once, obs written once (the
    # every-tick instance's K obs writes, which may stay in L2, go beside)
    bytes_f = W * (72 + 59) * 4 * 2 + W * 256 * 4
    ms_src = "madrona_basketball_tpu_torch/csrc/fused_multistep.cu"
    bytes_b = (W * (72 + 59 + 256) * 4 * 2 + FR.POLICY_FLOATS * 4 +
               T * 128 * W * 4 + T * (W // 32) * FR.ROLL_OBS * 2 * 4)
    # kernel I: kernel B's bytes without the obs-moment partials
    bytes_i = (W * (72 + 59 + 256) * 4 * 2 + FR.POLICY_FLOATS * 4 +
               T * 128 * W * 4)
    bytes_e = T * FR.ROLL_OBS * W * 4 + FR.ROLL_OBS * 8 * 4
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
            # kernel D's branch for normalized side rows (ustats None):
            # launches from nofgae_path
            ("fused_update_phase_normalized_side", upd,
             "madrona_basketball_tpu/ops/fused_update.py:457", bytes_d,
             ops_d),
            ("fused_minibatch_grad_prefetch", upd,
             "madrona_basketball_tpu/ops/fused_update.py:326", bytes_g,
             ops_g_per * hp.minibatch_size),
            ("fused_minibatch_grad", upd,
             "madrona_basketball_tpu/ops/fused_update.py:249", bytes_h,
             ops_h_per * hp.minibatch_size),
            # the tiled path's kernels: launches from tiled_path
            ("fused_rollout_tiled",
             "madrona_basketball_tpu_torch/csrc/fused_rollout_tiled.cu",
             "madrona_basketball_tpu/ops/fused_rollout.py:502", bytes_i,
             ops_i * W * T),
            ("obs_moments", "madrona_basketball_tpu_torch/csrc/obs_moments.cu",
             "madrona_basketball_tpu/ops/fused_gae.py:251", bytes_e,
             ops_e * T * FR.ROLL_OBS * W)):
        bms, by = bound(nbytes, nops)
        pl = per_launch.get(name, {})
        if pl.get("launch_ms_median"):
            pl = {**pl, "bound_share_of_median": bms / pl["launch_ms_median"]}
        n_launch = t_launches[name] if name in ("fused_rollout_tiled",
                                                 "obs_moments") \
            else launches.get(name)
        path_of = {}
        if name == "fused_update_phase_normalized_side":
            n_launch = alt_launches["nofgae_path"]["fused_update_phase"]
            path_of = {"launches_path": "nofgae_path (3 iterations)",
                       "nofgae_tiled_launches": alt_launches[
                           "nofgae_tiled_path"]["fused_update_phase"]}
        elif name == "fused_minibatch_grad_prefetch":
            # kernel G's path is --dp-update: dp_path's 3 iterations
            n_launch = dp_launch["dp_update"][name]
            path_of = {"launches_path": "dp_path (dp_update, 3 iterations)",
                       "launches_per_iteration": n_launch // 3}
        elif name in dp_launch["plain"]:
            path_of = {"dp_plain_launches": dp_launch["plain"][name],
                       "dp_update_launches": dp_launch["dp_update"][name]}
        alt_of = {ph: la[name] for ph, la in alt_launches.items()
                  if la.get(name)}
        if name == "fused_update_phase":
            alt_of = {ph: n for ph, n in alt_of.items()
                      if not ph.startswith("nofgae")}
        if alt_of:
            path_of["alt_path_launches_3_iterations"] = alt_of
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": n_launch, **path_of,
                     "max_abs_err": errs[name], "ms": ms[name][0],
                     "wrapper_ms": ms[name][1],
                     "plain_ms": ms[name][2], "bound_ms": bms,
                     "bound_by": by, "library_ms": library.get(name),
                     "bytes": nbytes, "ops": nops,
                     "bound_share": bms / ms[name][0],
                     **pl, **design.get(name, {})})
    # kernel A's launches on the eval path (eval_path, counted from 0
    # around each run)
    rows[0]["eval_launches"] = eval_launches
    # kernel J's on the same runs; its row's `launches` is the fleet's
    # chunked eval (eval_path: one infer call at 8192 worlds)
    eval_policy_row.update(
        launches=eval_j_launches["fleet_8192_chunked"],
        launches_path="eval_path fleet_8192 chunked (one infer call of "
                      "320 ticks: the capture's warm-up tick and 32 "
                      "captured ticks, none at replay)",
        eval_launches=eval_j_launches,
        interactive_frozen_iteration_launches=inter["frozen_j_launches"],
        multi_gen_infer_launches=mgi_j)
    # and on the interactive path (interactive_path, counted from 0
    # around 3 iterations; the scripted pause and the frozen opponent's
    # iteration apart)
    rows[0]["interactive_launches"] = {
        "interactive_path_3_iterations": inter["launches_3_iterations"],
        "paused_iteration": inter["paused_iteration_launches"],
        "frozen_iteration": inter["frozen_launches"]}
    # kernel F: launches from the bench path; ms per launch of K ticks
    for name, nops in (
            ("fused_multistep_every_tick_obs", ops_a * W * KB),
            ("fused_multistep_held_obs",
             (ops_a_no_obs * (KB - 1) + ops_a) * W)):
        bms, by = bound(bytes_f, nops)
        obs_all = KB * W * 256 * 4 if "every" in name else W * 256 * 4
        rows.append({"name": name, "route": "cuda", "source": ms_src,
                     "replaces": "madrona_basketball_tpu/ops/fused_step.py"
                                 ":1134",
                     "launches": bench_launches[name],
                     "max_abs_err": errs[name], "ms": ms[name][0],
                     "ticks_per_launch": KB, "ms_per_tick": ms[name][0] / KB,
                     "wrapper_ms": ms[name][1], "plain_ms": ms[name][2],
                     "plain_ticks": 8, "plain_ms_per_tick": ms[name][2] / 8,
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "bytes": bytes_f, "ops": nops,
                     "obs_bytes_all_ticks": obs_all,
                     "obs_bytes_all_ticks_ms": obs_all / HBM_BYTES_PER_S
                     * 1e3, **design.get(name, {})})
    # the bf16 branches: the bytes of the bf16 variant (the trajectory
    # rows at 2 bytes), the operations of the plain version (the bf16
    # policy's roundings are conversions, not arithmetic); launches on
    # their bf16 path (bf16_paths, 3 eager iterations)
    ops_b16p = count_ops(FR.rollout_plain, cfg, sf_s, si_s, obs_s, mats_s,
                         n_steps=1, trainee_idx=1,
                         noise=FR.philox_noise(0, 0, 1, ws, cpu),
                         policy_bf16=True) / ws
    traj16_bytes = T * 128 * W * 2
    per_sample16 = (FU.R_LOGP + 1) * 2 + 3 * 4
    b16_src = "madrona_basketball_tpu_torch/csrc/fused_rollout_bf16.cu"
    dense_ops = DENSE_OPS * W * T

    def pbf_bound(nbytes, nops):
        """The bf16 policy's bound: its Dense products at the bf16
        tensor-core rate, the rest of its operations at float32's."""
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = (dense_ops / BF16_TC_FLOP_PER_S +
              (nops - dense_ops) / FP32_FLOP_PER_S) * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    for name, src, rep_, nbytes, nops, path in (
            ("fused_rollout_bf16_traj", b16_src,
             "madrona_basketball_tpu/ops/fused_rollout.py:239",
             bytes_b - traj16_bytes, ops_b * W * T, "bf16_traj_path"),
            ("fused_rollout_bf16_policy", b16_src,
             "madrona_basketball_tpu/ops/fused_rollout.py:239", bytes_b,
             ops_b16p * W * T, "bf16_policy_path"),
            ("fused_gae_bf16",
             "madrona_basketball_tpu_torch/csrc/fused_gae.cu",
             "madrona_basketball_tpu/ops/fused_gae.py:58",
             bytes_c - 3 * T * W * 2, ops_c * W * T, "bf16_traj_path"),
            ("obs_moments_bf16",
             "madrona_basketball_tpu_torch/csrc/obs_moments.cu",
             "madrona_basketball_tpu/ops/fused_gae.py:251",
             bytes_e - T * FR.ROLL_OBS * W * 2, ops_e * T * FR.ROLL_OBS * W,
             "bf16_dp_traj_path"),
            ("fused_update_phase_bf16", upd,
             "madrona_basketball_tpu/ops/fused_update.py:457",
             bytes_d - T * W * (per_sample - per_sample16), ops_d,
             "bf16_traj_path"),
            ("fused_minibatch_grad_prefetch_bf16", upd,
             "madrona_basketball_tpu/ops/fused_update.py:326",
             bytes_g - hp.minibatch_size * (per_sample - per_sample16),
             ops_g_per * hp.minibatch_size, "bf16_dp_update_traj_path")):
        bms, by = pbf_bound(nbytes, nops) \
            if name == "fused_rollout_bf16_policy" else bound(nbytes, nops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep_,
                     "launches": bf16["launches"][path][name],
                     "launches_path": f"{path} (3 iterations)",
                     "bf16_path_launches_3_iterations": {
                         ph: la[name] for ph, la in bf16["launches"].items()
                         if la.get(name)},
                     "max_abs_err": errs[name], "ms": ms[name][0],
                     "wrapper_ms": ms[name][1], "plain_ms": ms[name][2],
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "bytes": nbytes, "ops": nops,
                     "bound_share": bms / ms[name][0],
                     **design.get(name, {})})
    # kernel B's probes: their launches those of the attribution bench's
    # run (rollout_attr), none on a trainer path (main_path's counts);
    # bytes and the plain version's operations of the work each leaves
    pr_src = "madrona_basketball_tpu_torch/csrc/fused_rollout_probe.cu"
    for pr in FR.PROBES:
        name = f"fused_rollout_probe_{pr}"
        ops_p = count_ops(FR.rollout_plain, cfg, sf_s, si_s, obs_s, mats_s,
                          n_steps=1, trainee_idx=1, probe=pr,
                          noise=FR.philox_noise(0, 0, 1, ws, cpu)) / ws
        nbytes = bytes_b - (T - 1) * 128 * W * 4 if pr == "no_traj" \
            else bytes_b
        bms, by = bound(nbytes, ops_p * W * T)
        rows.append({"name": name, "route": "cuda", "source": pr_src,
                     "replaces": "madrona_basketball_tpu/ops/fused_rollout"
                                 ".py:239 (probe, :285-296)",
                     "launches": attr_launches["probe"][pr],
                     "launches_path": "rollout_attr (bench_rollout_attr "
                                      f"{W})",
                     "trainer_path_launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms[name][0],
                     "wrapper_ms": ms[name][1], "plain_ms": ms[name][2],
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "bytes": nbytes, "ops": ops_p * W * T,
                     "bound_share": bms / ms[name][0]})
    # kernel B's probe x bf16 instances: their launches those of
    # rollout_probes' attribution, none on a trainer path; their times the
    # attribution's (in-kernel Philox, no frozen policy), their plain
    # versions' the parity runs' (external noise); bytes with the
    # trajectory's rows at 2 bytes, the plain version's operations with
    # the bf16 policy's Dense products at the bf16 tensor-core rate
    csrc = "madrona_basketball_tpu_torch/csrc/"
    no_traj_bytes = bytes_b - T * 128 * W * 4
    for key in FR.PROBE_BF16:
        pr, branch = key.rsplit("_", 1)
        name = f"fused_rollout_probe_bf16_{key}"
        t16, pbf = branch != "policy", branch != "traj"
        ops_p = count_ops(FR.rollout_plain, cfg, sf_s, si_s, obs_s, mats_s,
                          n_steps=1, trainee_idx=1, probe=pr,
                          policy_bf16=pbf,
                          noise=FR.philox_noise(0, 0, 1, ws, cpu)) / ws
        nbytes = no_traj_bytes + (1 if pr == "no_traj" else T) * 128 * W * \
            (2 if t16 else 4)
        nops = ops_p * W * T
        bms, by = (pbf_bound if pbf else bound)(nbytes, nops)
        t = probes["times"]["frozen=False"][branch][pr]
        src = csrc + ("fused_rollout_probe_bf16.cu" if t16 else
                      "fused_rollout_probe_pbf.cu")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": "madrona_basketball_tpu/ops/fused_rollout"
                                 ".py:239 (probe :247 with traj_dtype / "
                                 "policy_bf16, :296-300)",
                     "launches": probes["launches"][key],
                     "launches_path": "rollout_probes (attribution, "
                                      f"{W} x {T})",
                     "trainer_path_launches": launches[name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "wrapper_ms": t["wrapper_ms"],
                     "plain_ms": probes["plain_ms"][name],
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "bytes": nbytes, "ops": nops,
                     "bound_share": bms / t["ms"],
                     "ptxas": probes["ptxas"][key]})
    emit({"phase": "kernel_times", "note": "library_ms is torch.var_mean "
          "over ticks and worlds for obs_moments (kernel E) and null "
          "elsewhere: no single PyTorch call computes a sim tick, a "
          "rollout, this GAE pass, the meter recursion, the PPO loss's "
          "hand-derived gradient with clip + Adam, or K sim ticks; "
          "fused_rollout_tiled and obs_moments count their launches on "
          "tiled_path, fused_update_phase_normalized_side (kernel D with "
          "ustats None, the --no-fused-gae branch) on nofgae_path, "
          "alt_path_launches_3_iterations those of the alternate paths' "
          "3 eager iterations (kernel A: 33 an iteration per tick), "
          "fused_minibatch_grad_prefetch (kernel G) on dp_path's "
          "--dp-update iterations, the other rows on main_path "
          "(dp_plain_launches / dp_update_launches: dp_path's 3 iterations "
          "of each data-parallel mode); fused_update_phase "
          "launches "
          f"2 x E x M = {2 * n_mb} kernels per wrapper call, and its ms "
          "sums them; fused_multistep's ms is one launch of "
          f"{KB} ticks, its plain_ms {8} ticks, its launches those of "
          "the bench path; the *_bf16* rows are the bf16 branches "
          "(--bf16-traj, --bf16-policy), their launches those of their "
          "bf16 path's 3 eager iterations (launches_path), their bytes "
          "the bf16 trajectory's; fused_rollout_bf16_policy's operations "
          "bound counts its Dense products at the bf16 tensor-core rate; "
          "the fused_rollout_probe_* rows are kernel B's timing probes, "
          "their launches those of the attribution bench (rollout_attr), "
          "trainer_path_launches main_path's; the "
          "fused_rollout_probe_bf16_* rows its probe x bf16 instances, "
          "their launches, ms and wrapper_ms those of rollout_probes' "
          "attribution, plain_ms its parity runs'"})
    rows.append(eval_policy_row)
    emit({"kernels": rows})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
