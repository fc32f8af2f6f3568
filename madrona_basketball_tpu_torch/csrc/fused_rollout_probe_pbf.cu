// Kernel B's timing probes with the bf16 policy and the trajectory in
// float32: 12 instances of rollout_probe_bf16.cuh (its header says what
// they replace and why the bf16-storage ones build in
// fused_rollout_probe_bf16.cu).

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_probe_bf16.cuh"

using namespace mbb;
using namespace mbb::rollout;

// mbb_fused_rollout_probe's contract (fused_rollout_probe.cu) with the
// bf16 policy (policy_only, no_prng, no_traj: sim_only runs no policy).
extern "C" int mbb_fused_rollout_probe_pbf(
    SimParams p, float *sf, int *si, float *obs, const float *pol,
    const float *fpol, const float *ext, float *traj, float *partials, int W,
    int T, int trainee, int use_frozen, int probe, uint32_t k0, uint32_t k1,
    const int *tick_base, int world_base, cudaStream_t stream) {
    return launch_probe_bf16<float, true>(probe, p, sf, si, obs, pol, fpol,
                                          ext, traj, partials, W, T, trainee,
                                          use_frozen, k0, k1, tick_base,
                                          world_base, stream);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
