"""Frozen operation and byte counts of the port's kernels and the model
FLOPs of the `mfu` metrics, with the chip's published peaks."""
