"""The rule-phase counter: how mixed the full game's rule phases are within
a warp of the kernels that step the rules tick after tick.

At each sample every world is in one phase (`PHASES`, the first that
holds): inbounding (`ginb == 1`), ball in flight (`binflight == 1`), ball
held (`bgrabbed == 1`) or loose ball.  A 32-world group is GROUP
consecutive worlds from world 0 (a last group of W % 32 worlds where W is
no multiple of 32): the lanes of one warp in both kernels that step the
rules tick after tick.  Kernel B (csrc/rollout_common.cuh, `rollout_tile`)
gives a CTA of 256 threads the tile of worlds [64 b, 64 b + 64) and thread
t world 64 b + t, so its sim warps 0 and 1 step worlds 64 b + [0, 32) and
64 b + [32, 64); kernel F (csrc/fused_multistep.cu) gives a CTA the tile
[32 b, 32 b + 32) and its sim warp's lane l world 32 b + l.  A group whose
worlds are not all in one phase is mixed: its warp runs each phase's
branches in turn.

A counter keeps, on the device, over its samples since it was last
zeroed: the samples, the groups and the mixed groups, the worlds in each
phase, and the rises of `sbaskets`, `oob` and `period` since each world's
last sample (baskets; out-of-bounds turnovers and inbound violations,
which both count in `oob`; quarter rollovers).  A world whose row fell (a
new game) counts its new value from the fresh game's start (0, 0, period
1); what happened between its last sample and that reset is lost.  The
first sample after a zero only records the rows that the next compares
with.  A sample is torch operations with no readback, under a host span
`rule_phases`; it can be captured into a CUDA graph, so its buffers are
made at its first sample of each (device, W), which must come before a
capture, and never made again.

`COUNTER` is the one the tracer reports (`utils/profiling.py`, a hook
named "rule_phases": a session zeroes it and its records keep the
reading).  Training samples it after each iteration's "writeback" stamp
while the tracer is on (`ppo/train_fused.py`; in a chunk graph captured
with the tracer on, at every replay); its nodes are left out of the
graph's kernel-node count.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import profiling
from .layout import F_IDX, I_IDX, N_F32_ROWS, N_I32_ROWS

PHASES = ("inbounding", "in_flight", "held", "loose")
GROUP = 32              # worlds a warp of kernels B and F steps
EVENTS = ("baskets", "oob", "rollovers")
_EVENT_ROWS = ("sbaskets", "oob", "period")
# the slots: samples, groups, mixed groups, worlds a phase, events
_SLOTS = 3 + len(PHASES) + len(EVENTS)


class RulePhaseCounter:
    """A rule-phase counter (the module docstring).  `nodes` is the kernel
    nodes its samples have added to CUDA graphs being captured, None once
    a sample's nodes could not be counted."""

    def __init__(self):
        # (device, W) -> (slots, the event rows at the last sample, the
        # event rows of a fresh game); the kernel nodes of one sample
        self.bufs: dict = {}
        self.sample_nodes: dict = {}
        self.nodes: Optional[int] = 0

    def sample(self, sf: torch.Tensor, si: torch.Tensor):
        """One sample of the fleet's rows sf (72, W), si (59, W)."""
        with profiling.annotate("rule_phases"):
            key = (sf.device, sf.shape[1])
            capturing = sf.is_cuda and torch.cuda.is_current_stream_capturing()
            if key not in self.bufs:
                if capturing:
                    raise RuntimeError(
                        "the rule-phase counter's first sample of a fleet "
                        "must come before a capture")
                self.bufs[key] = _buffers(*key)
                if sf.is_cuda:
                    self.sample_nodes[key] = _sample_nodes(*key)
            if capturing:
                per = self.sample_nodes[key]
                self.nodes = None if per is None or self.nodes is None \
                    else self.nodes + per
            _sample(sf, si, *self.bufs[key])

    def zero(self, device):
        for (d, _), (slots, _, _) in self.bufs.items():
            if d == torch.device(device):
                slots.zero_()

    def read(self, device) -> dict:
        """The slots of `device`'s fleets, summed: {samples, groups,
        mixed_groups, worlds {phase: n}, baskets, oob, rollovers}."""
        tot = [0] * _SLOTS
        for (d, _), (slots, _, _) in self.bufs.items():
            if d == torch.device(device):
                tot = [a + b for a, b in zip(tot, slots.tolist())]
        n = len(PHASES)
        return {"samples": tot[0], "groups": tot[1], "mixed_groups": tot[2],
                "worlds": dict(zip(PHASES, tot[3:3 + n])),
                **dict(zip(EVENTS, tot[3 + n:]))}


def mixed_share(reading: dict) -> Optional[float]:
    """100 x mixed groups / all groups of a reading, None without one."""
    if not reading["groups"]:
        return None
    return 100.0 * reading["mixed_groups"] / reading["groups"]


def _buffers(dev, W: int):
    fresh = torch.zeros((len(EVENTS), 1), device=dev)
    fresh[EVENTS.index("rollovers")] = 1.0      # period 1
    return (torch.zeros((_SLOTS,), dtype=torch.int64, device=dev),
            torch.zeros((len(EVENTS), W), device=dev), fresh)


def _sample(sf, si, slots, last, fresh):
    W = si.shape[1]
    phase = torch.where(
        si[I_IDX["ginb"]] == 1, 0,
        torch.where(si[I_IDX["binflight"]] == 1, 1,
                    3 - (si[I_IDX["bgrabbed"]] == 1).long()))
    if W % GROUP:       # the last group's lanes repeat its last world
        phase = torch.cat([phase, phase[-1:].expand(GROUP - W % GROUP)])
    lo, hi = torch.aminmax(phase.view(-1, GROUP), dim=1)
    worlds = (phase[:W] == torch.arange(len(PHASES), device=si.device)
              .unsqueeze(1)).sum(dim=1)
    rows = torch.stack([sf[F_IDX[n]] for n in _EVENT_ROWS])
    events = (rows - torch.where(rows >= last, last, fresh)).sum(dim=1)
    events = events.long() * (slots[0] > 0)
    last.copy_(rows)
    slots[0] += 1
    slots[1] += lo.numel()
    slots[2] += (lo != hi).sum()
    slots[3:3 + len(PHASES)] += worlds
    slots[3 + len(PHASES):] += events


def _sample_nodes(dev, W: int) -> Optional[int]:
    """The kernel nodes of one sample: a capture of one on scratch rows
    and buffers (None where the runtime cannot be reached)."""
    sf = torch.zeros((N_F32_ROWS, W), device=dev)
    si = torch.zeros((N_I32_ROWS, W), dtype=torch.int32, device=dev)
    bufs = _buffers(dev, W)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        _sample(sf, si, *bufs)
    return profiling.kernel_nodes(graph)


COUNTER = RulePhaseCounter()
profiling.TRACER.hooks["rule_phases"] = COUNTER
