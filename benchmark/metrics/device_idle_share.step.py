"""The stepping loop's device idle share: 100 x (1 - device busy / wall)
over one profiled span of whole launches, both from that span (one
kernel a launch, so the profiler adds next to nothing)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
