"""The iteration step's phases outside the rollout and the update: the
median over the program's traced stretch (`program_trace.py`) of
(start -> writeback) - (reset_pulse -> rollout) - (glue -> update), from
the device phase stamps inside the captured chunk graph: the
permutations, the reset pulse, next_value, C, the meter scan, the merges
and the metrics, and the state's write-back."""

from benchmark import program_trace


def read(ctx):
    tr = program_trace.read(ctx)
    if not program_trace.sound(tr) or "other_phases_ms" not in tr:
        return None
    return tr["other_phases_ms"]
