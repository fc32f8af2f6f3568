"""The port's tracer: device phase stamps, host spans, one clock, and the
kernel-node counts of its CUDA graphs.

The reference's only tracing is wall-clock phase timers
(scripts/ppo_stats.py:53-150; utils/timers.py ports them).  This module
records, inside the program, what those timers and an outside profiler
cannot: where each phase of a captured iteration starts and ends on the
device, and which host work the device waited on.

There is one tracer a process, `TRACER`, because its hooks sit deep in
the hot path (`StaticIteration.step`, `EvalChunk.step`, the loop bodies)
where no caller could hand one down.  It is off by default, and off
means off: no `record_function`, no CUDA event, no device write, no
extra graph node, no synchronisation; every hook costs one attribute
check.  `trace(path, device)` is a session: the tracer on inside the
block, its records written once at the end as a Chrome trace
(chrome://tracing, Perfetto).

  * `TRACER.mark(name)`: a device phase stamp.  On a CUDA session a
    one-thread kernel (csrc/trace_stamp.cu) writes (id, %globaltimer) at
    a device-side cursor into a fixed-size ring and advances the cursor;
    launched inside a stream capture it is a node of the graph, so every
    replay stamps.  A full ring counts the records it drops (it does not
    wrap).  On a CPU session the stamp takes the host clock.  A graph
    captured while the tracer was on stamps at every replay, into the
    ring and cursor whose addresses it holds: so a device's ring (RING
    records) and cursor are made once, at its first session, and never
    made again; a session zeroes the cursor, and a replay outside one
    writes records that the next session's start discards.
  * `annotate(name, index)`: a host span (name, start, end, parent span,
    chunk or iteration index), also a `record_function` range so that
    under torch.profiler it lands on the kernels' timeline.
  * One clock: at the session's start and end, synchronised pairs (host
    CLOCK_MONOTONIC, which is `time.perf_counter_ns`, before a stamp's
    launch and after its completion; the tightest of CAL_PAIRS) put the
    host spans on the device's clock.  The records keep the interval's
    width, the drift between start and end, and the stamp clock's
    resolution.  `attribute` puts each device-idle interval (from a
    stamp that closes device work to the next that opens it) down to the
    innermost host span covering it, or to "host".
  * `capture(fn, generators)`: `fn()` captured as a CUDA graph,
    with its kernel nodes counted from the raw graph through the CUDA
    runtime torch loaded (`cudaGraphGetNodes`, `cudaGraphNodeGetType`);
    the stamps and the hooks' nodes are not counted.  Tracer on or off,
    nothing on the hot path.
  * `TRACER.hooks`: counters that other modules keep on the device and
    register by name (ops/rule_phases.py).  A hook has `zero(device)`,
    which a session's start calls, `read(device)`, whose reading the
    session's records keep under "counters", and `nodes`, the kernel
    nodes its work has added to captures so far.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import json
import re
import time
from typing import Optional

import torch

CAPACITY = 1 << 20      # host records a session: spans, a CPU's stamps
RING = 1 << 20          # a card's stamp records (16 B each), made once
CAL_PAIRS = 32          # synchronised pairs a calibration
OPENS = ("start",)      # a stamp that opens device work
CLOSES = ("writeback", "end")   # a stamp that closes it


class _Span:
    """A host span while the tracer is on (see `annotate`)."""

    __slots__ = ("name", "index", "slot", "rf")

    def __init__(self, name: str, index: int):
        self.name, self.index = name, index

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.slot = TRACER._open(self.name, self.index)
        return self

    def __exit__(self, *exc):
        if TRACER.on:
            TRACER._close(self.slot)
        self.rf.__exit__(*exc)


_OFF = contextlib.nullcontext()


def annotate(name: str, index: int = -1):
    """A host span named `name` (`index`: the chunk or iteration it
    belongs to, -1 none), nested under the span open around it."""
    return _Span(name, index) if TRACER.on else _OFF


class Tracer:
    """The process's tracer; see the module docstring."""

    def __init__(self):
        self.on = False
        self.stamps = 0         # stamp launches (a capture's stamp nodes)
        # kept for the process, as a captured stamp keeps its id and
        # pointers: the stamp names' ids, each card's (ring, cursor)
        self.names: dict = {}
        self.rings: dict = {}
        self.hooks: dict = {}   # name -> hook (the module docstring)

    def start(self, device="cuda"):
        """Open a session on `device`: its host lists hold CAPACITY spans
        (and, on the CPU, stamps); a card's ring holds RING."""
        if self.on:
            raise RuntimeError("a tracing session is already open")
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.capacity = capacity = CAPACITY
        self.spans: list = [None] * capacity
        self.n_spans = 0
        self.stack: list = []
        self.graphs: dict = {}
        if dev.type == "cuda":
            from .. import _build
            self.lib = _build.load("trace_stamp")
            if dev not in self.rings:
                self.rings[dev] = (
                    torch.zeros((RING, 2), dtype=torch.int64, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))
            self.ring, self.cursor = self.rings[dev]
            self.cursor.zero_()
        else:
            self.host: list = [None] * capacity
            self.n_host = 0
        for hook in self.hooks.values():
            hook.zero(dev)
        self.calibration = [self._calibrate()]
        self.on = True

    def mark(self, name: str):
        """A device phase stamp named `name` (see the module docstring)."""
        i = self.names.setdefault(name, len(self.names))
        self.stamps += 1
        if self.device.type == "cuda":
            from .. import _build
            err = self.lib.mbb_trace_stamp(
                self.ring.data_ptr(), self.cursor.data_ptr(),
                self.ring.shape[0], i, _build.stream(self.device))
            _build.check(err, "trace_stamp")
        else:
            if self.n_host < self.capacity:
                self.host[self.n_host] = (i, time.perf_counter_ns())
            self.n_host += 1

    def _open(self, name: str, index: int) -> int:
        slot = self.n_spans
        self.n_spans += 1
        parent = self.stack[-1] if self.stack else -1
        if slot < self.capacity:
            self.spans[slot] = [name, time.perf_counter_ns(), None, parent,
                                index]
        self.stack.append(slot)
        return slot

    def _close(self, slot: int):
        self.stack.pop()
        if slot < self.capacity:
            self.spans[slot][2] = time.perf_counter_ns()

    def _calibrate(self) -> dict:
        """The tightest of CAL_PAIRS synchronised pairs: the host's
        midpoint, the device clock minus it, the interval's width, and the
        device times read (for the clock's resolution)."""
        if self.device.type != "cuda":
            now = time.perf_counter_ns()
            return {"host_ns": now, "offset_ns": 0, "width_ns": 0,
                    "device_ns": []}
        from .. import _build
        dev_ns = torch.zeros((CAL_PAIRS,), dtype=torch.int64,
                             device=self.device)
        host_ns = torch.zeros((2 * CAL_PAIRS,), dtype=torch.int64)
        torch.cuda.synchronize(self.device)
        err = self.lib.mbb_trace_stamp_calibrate(
            dev_ns.data_ptr(), host_ns.data_ptr(), CAL_PAIRS,
            _build.stream(self.device))
        _build.check(err, "trace_stamp")
        d, h = dev_ns.tolist(), host_ns.tolist()
        i = min(range(CAL_PAIRS), key=lambda k: h[2 * k + 1] - h[2 * k])
        mid = (h[2 * i] + h[2 * i + 1]) // 2
        return {"host_ns": mid, "offset_ns": d[i] - mid,
                "width_ns": h[2 * i + 1] - h[2 * i], "device_ns": d}

    def stop(self) -> dict:
        """Close the session: calibrate again, read the ring, and return
        the records (`records` describes them)."""
        if not self.on:
            raise RuntimeError("no tracing session is open")
        self.calibration.append(self._calibrate())
        self.on = False
        names = list(self.names)
        if self.device.type == "cuda":
            n = int(self.cursor)
            raw = self.ring[:min(n, self.ring.shape[0])].tolist()
            dropped = max(0, n - self.ring.shape[0])
        else:
            n = self.n_host
            raw = self.host[:min(n, self.capacity)]
            dropped = max(0, n - self.capacity)
            self.host = None
        c0, c1 = self.calibration
        span_h = c1["host_ns"] - c0["host_ns"]

        def on_device(t):
            frac = (t - c0["host_ns"]) / span_h if span_h else 0.0
            return t + c0["offset_ns"] + round(
                frac * (c1["offset_ns"] - c0["offset_ns"]))
        end = c1["host_ns"]
        spans = [(s[0], on_device(s[1]), on_device(end if s[2] is None
                                                   else s[2]), s[3], s[4])
                 for s in self.spans[:min(self.n_spans, self.capacity)]]
        stamps = [(names[i], t) for i, t in raw]
        times = sorted({t for _, t in stamps} | set(c0["device_ns"]) |
                       set(c1["device_ns"]))
        steps = [b - a for a, b in zip(times, times[1:])]
        self.spans = self.stack = None
        return {
            "device": str(self.device),
            "stamps": stamps,
            "spans": spans,
            "calibration": {
                "pairs": CAL_PAIRS if self.device.type == "cuda" else 0,
                "width_ns": max(c0["width_ns"], c1["width_ns"]),
                "drift_ns": c1["offset_ns"] - c0["offset_ns"],
                "resolution_ns": min(steps) if steps else None},
            "dropped": {"stamps": dropped,
                        "spans": max(0, self.n_spans - self.capacity)},
            "kernel_nodes": self.graphs,
            "counters": {name: hook.read(self.device)
                         for name, hook in self.hooks.items()},
        }


TRACER = Tracer()


@contextlib.contextmanager
def trace(path: Optional[str], device="cuda"):
    """A tracing session around the block, written to `path` as a Chrome
    trace when it ends (`export`); yields the tracer.  With `path` None
    there is no session and the tracer stays off."""
    if path is None:
        yield None
        return
    TRACER.start(device)
    try:
        yield TRACER
    finally:
        export(TRACER.stop(), path)


# ---------------------------------------------------------------------
# Reading the records
# ---------------------------------------------------------------------
#
# records: "stamps" [(name, device ns)] in ring order; "spans" [(name,
# start, end, parent slot or -1, index)] on the device's clock, in the
# order they opened; "calibration" {pairs, width_ns, drift_ns,
# resolution_ns}; "dropped" {stamps, spans}; "kernel_nodes" {label:
# {kernels, stamps}} of the graphs captured in the session; "counters"
# {hook name: its reading}.

def sequences(stamps) -> list:
    """The stamps cut into runs of device work: each from an OPENS stamp
    to the next CLOSES stamp, [(name, ns), ...]; stamps outside a run are
    left out."""
    out, cur = [], None
    for name, t in stamps:
        if name in OPENS:
            cur = [(name, t)]
        elif cur is not None:
            cur.append((name, t))
            if name in CLOSES:
                out.append(cur)
                cur = None
    return out


def idle_gaps(stamps) -> list:
    """(close ns, next open ns) for each CLOSES stamp followed by an OPENS
    stamp: the intervals in which no traced device work ran."""
    return [(a[1], b[1]) for a, b in zip(stamps, stamps[1:])
            if a[0] in CLOSES and b[0] in OPENS]


def _innermost(spans, starts, t):
    """The name of the innermost span covering device time t, or "host".
    Spans nest and are in the order they opened, so only the last span
    opened by t and its ancestors can cover t."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][2] > t:
            return spans[i][0]
        i = spans[i][3]
    return "host"


def attribute(gaps, spans, width_ns: int) -> dict:
    """Device-idle ns put down to host span names (`spans` as the records
    hold them): each gap is cut at the span edges inside it and each
    piece goes to the innermost span that covers it, or to "host".  A gap
    narrower than the calibration interval `width_ns` cannot be placed
    against the edges, so it goes whole to the span at its middle."""
    out: dict = {}
    starts = [s[1] for s in spans]
    edges = sorted({t for s in spans for t in s[1:3]})
    for a, b in gaps:
        if b <= a:
            continue
        if b - a < width_ns:
            cuts = [a, b]
        else:
            lo, hi = bisect.bisect_right(edges, a), bisect.bisect_left(
                edges, b)
            cuts = [a] + edges[lo:hi] + [b]
        for s, e in zip(cuts, cuts[1:]):
            name = _innermost(spans, starts, (s + e) / 2)
            out[name] = out.get(name, 0) + (e - s)
    return out


def export(records: dict, path: str):
    """Write the records as Chrome-trace JSON: host spans on one track,
    device phases (each from the stamp before it to its own stamp within
    a run) on another, both in device-clock us from the first record;
    the calibration, kernel-node counts, dropped records, the hooks'
    readings and the idle attribution under "otherData"."""
    spans, stamps = records["spans"], records["stamps"]
    t0 = min([s[1] for s in spans] + [t for _, t in stamps] or [0])
    events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
               "args": {"name": name}}
              for tid, name in ((0, "host spans"), (1, "device phases"))]
    for name, s, e, parent, index in spans:
        events.append({"ph": "X", "name": name, "pid": 0, "tid": 0,
                       "ts": (s - t0) / 1e3, "dur": (e - s) / 1e3,
                       "args": {"index": index, "parent": parent}})
    for run in sequences(stamps):
        for (_, a), (name, b) in zip(run, run[1:]):
            events.append({"ph": "X", "name": name, "pid": 0, "tid": 1,
                           "ts": (a - t0) / 1e3, "dur": (b - a) / 1e3})
    cal = records["calibration"]
    idle = attribute(idle_gaps(stamps), spans, cal["width_ns"])
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"device": records["device"],
                                 "calibration": cal,
                                 "kernel_nodes": records["kernel_nodes"],
                                 "dropped": records["dropped"],
                                 "counters": records.get("counters", {}),
                                 "idle_ns_by_span": idle}}, f)


# ---------------------------------------------------------------------
# Kernel-node counters of a CUDA graph
# ---------------------------------------------------------------------

_CUDART: list = []
_KERNEL_NODE = 0        # cudaGraphNodeTypeKernel


def _cudart():
    """The CUDA runtime library torch loaded (ctypes), or None."""
    if not _CUDART:
        lib = None
        try:
            with open("/proc/self/maps") as f:
                m = re.search(r"/\S*libcudart[-\w]*\.so[\d.]*", f.read())
            if m:
                lib = ctypes.CDLL(m.group(0))
                lib.cudaGraphGetNodes.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t)]
                lib.cudaGraphGetNodes.restype = ctypes.c_int
                lib.cudaGraphNodeGetType.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
                lib.cudaGraphNodeGetType.restype = ctypes.c_int
        except (OSError, AttributeError):
            lib = None
        _CUDART.append(lib)
    return _CUDART[0]


def kernel_nodes(graph) -> Optional[int]:
    """The kernel nodes of a captured graph (kept: `keep_graph=True`), or
    None where the runtime cannot be reached."""
    rt = _cudart()
    if rt is None:
        return None
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(g, None, ctypes.byref(n)):
        return None
    nodes = (ctypes.c_void_p * n.value)()
    if rt.cudaGraphGetNodes(g, nodes, ctypes.byref(n)):
        return None
    kind, count = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        if rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)):
            return None
        count += kind.value == _KERNEL_NODE
    return count


def capture(fn, generators=(), label: str = "graph"):
    """`fn()` captured as a CUDA graph on the current stream, the
    generators registered with it.  Returns (graph, kernel nodes or None,
    the stamps and the hooks' nodes left out); a session keeps the kernel
    and stamp nodes under `label`."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in generators:
        graph.register_generator_state(gen)
    before, hooked = TRACER.stamps, _hook_nodes()
    with torch.cuda.graph(graph):
        fn()
    stamps = TRACER.stamps - before
    nodes = kernel_nodes(graph)
    graph.instantiate()
    hooked = _hook_nodes() - hooked
    kernels = None if nodes is None or hooked is None else \
        nodes - stamps - hooked
    if TRACER.on:
        TRACER.graphs[label] = {"kernels": kernels, "stamps": stamps}
    return graph, kernels


def _hook_nodes() -> Optional[int]:
    """The kernel nodes the tracer's hooks have added to captures so far,
    or None where a hook cannot count its own."""
    counts = [hook.nodes for hook in TRACER.hooks.values()]
    return None if None in counts else sum(counts)
