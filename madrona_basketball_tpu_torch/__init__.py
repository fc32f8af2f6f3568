"""PyTorch + CUDA port of madrona_basketball_tpu for NVIDIA Hopper.

The experience-collection half of the flagship PPO iteration (reset
pulse, 32-tick policy-in-the-loop rollout, fused GAE) runs on three
hand-written CUDA kernels (csrc/), each with a plain torch version beside
it.  Entry points take `device=` and default to "cuda"; a CPU tensor runs
the plain version.  The package imports neither JAX nor the JAX package.
"""
