"""PyTorch + CUDA port of madrona_basketball_tpu for NVIDIA Hopper.

The flagship PPO training iteration - reset pulse, 32-tick
policy-in-the-loop rollout, fused GAE, then the update phase (epochs x
minibatches of hand-derived gradient + global-norm clip + Adam) - runs on
hand-written CUDA kernels (csrc/), each with a plain torch version beside
it; `python -m madrona_basketball_tpu_torch.cli` trains with it.  Entry
points take `device=` and default to "cuda"; a CPU tensor runs the plain
version.  The package imports neither JAX nor the JAX package.
"""
