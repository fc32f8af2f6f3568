"""The eval loop's device gap a chunk: the median over the program's
traced stretch, in a process that never ran the profiler
(`program_trace.py`), of the time from one chunk's end stamp to the next
chunk's start stamp, in which the host fetches `t_used` and launches the
next replay."""

import statistics

from benchmark import program_trace


def read(ctx):
    tr = program_trace.read(ctx)
    if not program_trace.sound(tr) or not tr.get("fetch_gaps_us"):
        return None
    return statistics.median(tr["fetch_gaps_us"])
