"""Kernel nodes of the window's own chunk graph (one iteration, captured
with the tracer off), as the program counts them at capture
(`ppo/train.py::make_train_chunk`'s "kernel_nodes")."""


def read(ctx):
    captured = getattr(ctx["run"].chunk, "captured", None) or {}
    return captured.get("kernel_nodes")
