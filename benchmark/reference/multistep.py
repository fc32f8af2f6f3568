"""K sim ticks of the reference with no policy: kernel F's launch, one
agent's actions zeroed before every tick, on its in-kernel Philox draws.

The composition of the port's plain kernel F
(`madrona_basketball_tpu_torch/ops/fused_step.py::multistep_rows_plain`)
over this folder's frozen plain tick.  The observations are a pure output
of the state, so only the last tick's are computed: the state after K
ticks is the same with them on every tick or once.

Each world's draws depend on its index alone, so any set of worlds can be
followed.  On a CUDA device each tick is the replay of one CUDA graph of
a tick over fresh draws: the tick is some 3 000 small operations, and the
graph spares their launches (graphs of 2-10 ticks ran slower a tick on
an H100).  `state_dtype` rounds the float rows to that type after every
tick (the benchmark's control).
"""

from __future__ import annotations

import torch

from .layout import ACTION_ROWS, N_NOISE_ROWS
from .rollout import philox_sim_noise
from .sim import step_rows_plain

F32 = torch.float32
NOISE_TICKS = 500   # ticks of draws made at once on the graph path


def _ticks(cfg, sf, si, noise, blank_agent, state_dtype):
    """noise.shape[0] ticks without observations."""
    for t in range(noise.shape[0]):
        if blank_agent is not None:
            si = si.clone()
            for r in ACTION_ROWS[blank_agent]:
                si[r] = 0
        sf, si, _ = step_rows_plain(cfg, sf, si, noise[t], False)
        if state_dtype is not None:
            sf = sf.to(state_dtype).to(F32)
    return sf, si


def _capture(cfg, sf, si, blank_agent, state_dtype):
    """A CUDA graph of one tick from static rows and draws onto the same
    rows."""
    g_sf, g_si = sf.clone(), si.clone()
    g_noise = torch.zeros((1, N_NOISE_ROWS, sf.shape[1]), dtype=F32,
                          device=sf.device)
    side = torch.cuda.Stream(sf.device)
    side.wait_stream(torch.cuda.current_stream(sf.device))
    with torch.cuda.stream(side):      # warm-up off the capture
        _ticks(cfg, g_sf.clone(), g_si.clone(), g_noise, blank_agent,
               state_dtype)
    torch.cuda.current_stream(sf.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a, b = _ticks(cfg, g_sf, g_si, g_noise, blank_agent, state_dtype)
        g_sf.copy_(a)
        g_si.copy_(b)
    return graph, g_sf, g_si, g_noise


@torch.no_grad()
def multistep(cfg, sf, si, worlds, *, seed: int, n_steps: int,
              tick_base: int = 0, blank_agent: int | None = None,
              state_dtype=None):
    """(sf', si', obs (256, S)) of the worlds `worlds` (whose rows sf, si
    are, column for column) after n_steps ticks keyed by `seed`, ticks
    tick_base .. tick_base + n_steps - 1."""
    t = 0
    if sf.device.type == "cuda" and n_steps > 1:
        graph, g_sf, g_si, g_noise = _capture(cfg, sf, si, blank_agent,
                                              state_dtype)
        g_sf.copy_(sf)
        g_si.copy_(si)
        while t < n_steps - 1:
            n = min(NOISE_TICKS, n_steps - 1 - t)
            noise = philox_sim_noise(seed, tick_base + t, n, worlds)
            for b in range(n):
                g_noise.copy_(noise[b:b + 1])
                graph.replay()
            t += n
        sf, si = g_sf.clone(), g_si.clone()
        del graph
    noise = philox_sim_noise(seed, tick_base + t, n_steps - t, worlds)
    sf, si = _ticks(cfg, sf, si, noise[:-1], blank_agent, state_dtype)
    if blank_agent is not None:
        si = si.clone()
        for r in ACTION_ROWS[blank_agent]:
            si[r] = 0
    sf, si, obs = step_rows_plain(cfg, sf, si, noise[-1], True)
    if state_dtype is not None:
        sf = sf.to(state_dtype).to(F32)
    return sf, si, obs
