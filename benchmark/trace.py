"""Reduce a torch.profiler window to what the per-layer readers take: the
device's busy time, each kernel's device time and launch count, and the
breakdown of the result line (the device operations that took most time,
the longest idle gaps named by the host's range at their middle).  And
`event_span`: a loop's dispatches timed by CUDA events with no profiler,
for the loops' idle shares (the profiler holds each CUDA-graph launch on
the host for milliseconds, an idle the loop does not have)."""

from __future__ import annotations

import collections

TOP = 10
# the driver's host ranges (record_function); the profiler also lays
# each on the device's timeline, where it is no device operation
HOST_RANGES = ("chunk_dispatch", "unstack_metrics", "log_readback",
               "save_agent", "t_used_fetch")


def short(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].split("<")[0]


def summarize(prof, window_s: float) -> dict:
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name in HOST_RANGES or e.is_user_annotation:
            if e.device_type != DeviceType.CUDA:
                host.append((start, end, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev.append((start, end, e.name))
    dev.sort()
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for start, end, name in dev:
        per_kernel[name][0] += (end - start) * 1e-6
        per_kernel[name][1] += 1
    # the union of the device's operations, and the gaps between them
    busy, gaps, cur = 0.0, [], None
    for start, end, _ in dev:
        if cur is None:
            cur = [start, end]
        elif start > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], start))
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]

    def doing(t):
        spans = [(e - s, name) for s, e, name in host if s <= t <= e]
        return min(spans)[1] if spans else "host"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    by_short = collections.defaultdict(float)
    for name, (secs, _) in per_kernel.items():
        by_short[short(name)] += secs
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy * 1e-6,
        "window_s": window_s,
        "kernels": {k: tuple(v) for k, v in per_kernel.items()},
        "breakdown": {
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[doing((s + e) / 2), (e - s) * 1e-6]
                          for s, e in longest]},
    }


def kernel_seconds(summary: dict, keys) -> tuple:
    """(device seconds, launches) of the kernels whose names hold one of
    `keys`."""
    secs, n = 0.0, 0
    for name, (s, c) in summary["kernels"].items():
        if any(k in name for k in keys):
            secs += s
            n += c
    return secs, n


def event_span(dispatch, after, n: int) -> dict:
    """n rounds of `dispatch()` then `after()` with no profiler, each
    dispatch between two CUDA events on the current stream, one event
    after the last round: the seconds in which a dispatch's work held the
    device (its events' span, launch latency inside it) and the seconds
    from the first event to the last, both on the device's clock.  Where
    the host runs ahead, a dispatch's span starts where the last one's
    work ended, so only the waits on the host fall outside the spans."""
    import torch
    marks = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dispatch()
        end.record()
        after()
        marks.append((start, end))
    last = torch.cuda.Event(enable_timing=True)
    last.record()
    last.synchronize()
    return {"events_busy_s": 1e-3 * sum(s.elapsed_time(e) for s, e in marks),
            "events_span_s": 1e-3 * marks[0][0].elapsed_time(last)}
