"""The plain PyTorch reference that decides the benchmark's `correct`.

Frozen copies of the port's plain versions and of the constants they
read, composed into one training iteration (`iteration.py`).  Nothing
here imports the program (`madrona_basketball_tpu_torch`), the JAX
package or JAX.
"""
