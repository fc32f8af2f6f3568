"""The training loop's device stall a save: the median over the saves of
the program's traced stretch, in a process that never ran the profiler
(`program_trace.py`), of the device-idle time (from a chunk's writeback
stamp to the next chunk's start stamp) that falls inside the save's
`save_agent` host span, put on the device's clock.  None where the
clock's calibration interval is wider than 50 us."""

from benchmark import program_trace


def read(ctx):
    tr = program_trace.read(ctx)
    if not program_trace.sound(tr, host_spans=True) or \
            tr.get("save_stall_ms") is None:
        return None
    return tr["save_stall_ms"]
