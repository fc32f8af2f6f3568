"""The training loop's device idle share: 100 x (1 - busy / span) over
whole chunks of the loop body (a dispatch, the metric unstack, the log
readback and the save at their cadences) run with no profiler after the
window, both from CUDA events on the device's clock
(`trace.event_span`): the share of the loop's time in which no chunk's
work held the device.  The profiler's own window is not the source: it
holds each graph launch on the host for milliseconds, an idle the loop
does not have."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.get("events_span_s"):
        return None
    return 100.0 * (1.0 - tr["events_busy_s"] / tr["events_span_s"])
