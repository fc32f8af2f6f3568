"""Device kernels an eval tick: every kernel the profiler saw in the
profiled span of whole chunks (the policies' torch kernels and kernel A;
copies and fills that are no kernel left out), over its ticks."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.get("ticks"):
        return None
    n = sum(c for name, (_, c) in tr["kernels"].items()
            if not name.startswith(("Memcpy", "Memset")))
    return n / tr["ticks"] if n else None
