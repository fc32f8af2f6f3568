"""K evaluation ticks of the reference: both agents' policies sample their
actions (Gumbel-max on uniforms drawn from each policy's generator), the
sim ticks on noise drawn from the engine's generator, and each world
counts the trainee's finished episodes.

The composition of the port's eval chunk
(`madrona_basketball_tpu_torch/infer.py::EvalChunk.step`, no early stop,
no log) over this folder's frozen plain tick.  The generators restart
from the states the state holds, so the reference draws what the
program drew.
"""

from __future__ import annotations

import torch

from .iteration import _backbone, _linear, greedy_actions
from .layout import ACTION_ROWS, F_IDX
from .rollout import N_LOGITS, OBS, gumbel_from_uniform
from .sim import draw_noise_rows, step_rows_plain

F32 = torch.float32
I32 = torch.int32


def _generator(state, device):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


@torch.no_grad()
def eval_chunk(cfg, s: dict, n_ticks: int, trainee_idx: int) -> dict:
    """s: sf, si, obs, counts (W,) int32, the agents {"trainee", "frozen"}
    as (module weights, normalizer) and `gens` (trainee policy, frozen
    policy, engine) generator states.  Returns the state after n_ticks."""
    dev = s["sf"].device
    W = s["sf"].shape[1]
    gens = [_generator(st, dev) for st in s["gens"]]
    sf, si, obs, counts = s["sf"], s["si"], s["obs"], s["counts"].clone()
    agents = ((trainee_idx, s["trainee"], gens[0]),
              (1 - trainee_idx, s["frozen"], gens[1]))
    done_row = F_IDX[f"a{trainee_idx}.done"]
    for _ in range(n_ticks):
        si_in = si.clone()
        for a, (net, rms), g in agents:
            u = torch.rand((W, N_LOGITS), generator=g, dtype=F32, device=dev)
            logits = _linear(_backbone(net, rms, obs[a * OBS:(a + 1) * OBS].T),
                             net, "actor")
            acts = greedy_actions(logits + gumbel_from_uniform(u))
            for j, r in enumerate(ACTION_ROWS[a]):
                si_in[r] = acts[:, j]
        sf, si, obs = step_rows_plain(cfg, sf, si_in,
                                      draw_noise_rows(W, gens[2], dev))
        counts = counts + sf[done_row].to(I32)
    return dict(s, sf=sf, si=si, obs=obs, counts=counts,
                gens=tuple(g.get_state() for g in gens))
