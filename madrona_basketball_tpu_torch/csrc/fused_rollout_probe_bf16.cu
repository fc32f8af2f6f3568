// Kernel B's timing probes with the trajectory stored in bf16, the policy
// float32 or bf16: 28 instances of rollout_probe_bf16.cuh (its header
// says what they replace and why the float32-storage bf16-policy ones
// build in fused_rollout_probe_pbf.cu).

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_probe_bf16.cuh"

using namespace mbb;
using namespace mbb::rollout;

// mbb_fused_rollout_probe's contract (fused_rollout_probe.cu) with traj
// of uint16_t bf16 bits and the bf16 policy when policy_bf16 (not with
// sim_only, which runs no policy).
extern "C" int mbb_fused_rollout_probe_bf16(
    SimParams p, float *sf, int *si, float *obs, const float *pol,
    const float *fpol, const float *ext, void *traj, float *partials, int W,
    int T, int trainee, int use_frozen, int policy_bf16, int probe,
    uint32_t k0, uint32_t k1, const int *tick_base, int world_base,
    cudaStream_t stream) {
    return policy_bf16
               ? launch_probe_bf16<uint16_t, true>(
                     probe, p, sf, si, obs, pol, fpol, ext, traj, partials,
                     W, T, trainee, use_frozen, k0, k1, tick_base,
                     world_base, stream)
               : launch_probe_bf16<uint16_t, false>(
                     probe, p, sf, si, obs, pol, fpol, ext, traj, partials,
                     W, T, trainee, use_frozen, k0, k1, tick_base,
                     world_base, stream);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
