"""Kernel nodes of the window's own eval chunk graph (K ticks, captured
with the tracer off), as the program counts them at capture
(`infer.py::EvalChunk.kernel_nodes`), over its K ticks."""


def read(ctx):
    run = ctx["run"]
    nodes = getattr(run.chunk, "kernel_nodes", None)
    return None if nodes is None else nodes / run.K
