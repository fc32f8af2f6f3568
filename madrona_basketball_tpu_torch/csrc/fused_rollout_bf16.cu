// Kernel B's bf16 branches: the trajectory stored in bf16
// (--bf16-traj), the policy's Dense operands in bf16 (--bf16-policy), or
// both.
//
// Replaces the bf16 branches of the Pallas kernel make_fused_rollout
// (madrona_basketball_tpu/ops/fused_rollout.py:239, pallas_call :486):
// traj_dtype=bfloat16 (:272-281, :298-300, :399-407, :440-444) and
// policy_bf16 (policy_forward_rows(mm_dtype=) :140-155, :363-376).  The
// body is kernel B's (rollout_common.cuh::rollout_tile, FOLD on) with its
// storage type TT = uint16_t and / or PBF on; fused_rollout.cu keeps the
// float32 instance, so the flagship's code is unchanged, and the twelve
// instances here (2 trainees x frozen or not x 3 branches) build in their
// own nvcc process beside it.
//
// Bound: operations, as the float32 instance (the policy and the tick);
// bf16 storage halves the trajectory write (8 KB per world at T = 32),
// and costs the float32 copy of the obs rows that the fold reads
// (rollout_common.cuh).  The bf16 policy rounds operands and runs the
// same float32 FMAs: no faster on the CUDA cores; it is what a
// tensor-core policy product would take.

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_common.cuh"

using namespace mbb;
using namespace mbb::rollout;

namespace {

template <int TI, bool FROZEN, class TT, bool PBF>
__global__ void __launch_bounds__(NT, 1)
fused_rollout_bf16_kernel(SimParams p, float *__restrict__ sf,
                          int *__restrict__ si, float *__restrict__ obs,
                          const float *__restrict__ pol,
                          const float *__restrict__ fpol,
                          const float *__restrict__ ext, TT *__restrict__ traj,
                          float *__restrict__ partials, int W, int T,
                          uint32_t k0, uint32_t k1,
                          const int *__restrict__ tick_base, int world_base) {
    rollout_tile<TI, FROZEN, true, TT, PBF>(p, sf, si, obs, pol, fpol, ext,
                                            traj, partials, W, T, k0, k1,
                                            tick_base, world_base);
}

template <class TT, bool PBF>
int launch(SimParams p, float *sf, int *si, float *obs, const float *pol,
           const float *fpol, const float *ext, void *traj, float *partials,
           int W, int T, int trainee, int use_frozen, uint32_t k0,
           uint32_t k1, const int *tick_base, int world_base,
           cudaStream_t stream) {
    TT *tr = static_cast<TT *>(traj);
#define MBB_B16_LAUNCH(TI, FR)                                                \
    launch_tiles<FR>(fused_rollout_bf16_kernel<TI, FR, TT, PBF>, p, sf, si,  \
                     obs, pol, fpol, ext, tr, partials, W, T, k0, k1,         \
                     tick_base, world_base, stream)
    if (trainee == 0)
        return use_frozen ? MBB_B16_LAUNCH(0, true) : MBB_B16_LAUNCH(0, false);
    return use_frozen ? MBB_B16_LAUNCH(1, true) : MBB_B16_LAUNCH(1, false);
#undef MBB_B16_LAUNCH
}

}  // namespace

// mbb_fused_rollout's contract (fused_rollout.cu) with traj (T, 128, W)
// of uint16_t bf16 bits when traj_bf16, else float32, and the bf16 policy
// when policy_bf16; at least one of the two is set.
extern "C" int mbb_fused_rollout_bf16(SimParams p, float *sf, int *si,
                                      float *obs, const float *pol,
                                      const float *fpol, const float *ext,
                                      void *traj, float *partials, int W,
                                      int T, int trainee, int use_frozen,
                                      int traj_bf16, int policy_bf16,
                                      uint32_t k0, uint32_t k1,
                                      const int *tick_base, int world_base,
                                      cudaStream_t stream) {
    if (W % 32 != 0 || W < 32 || T < 1 || (trainee != 0 && trainee != 1) ||
        world_base < 0 || (ext == nullptr && tick_base == nullptr) ||
        (!traj_bf16 && !policy_bf16))
        return (int)cudaErrorInvalidValue;
    if (traj_bf16 && policy_bf16)
        return launch<uint16_t, true>(p, sf, si, obs, pol, fpol, ext, traj,
                                      partials, W, T, trainee, use_frozen, k0,
                                      k1, tick_base, world_base, stream);
    if (traj_bf16)
        return launch<uint16_t, false>(p, sf, si, obs, pol, fpol, ext, traj,
                                       partials, W, T, trainee, use_frozen,
                                       k0, k1, tick_base, world_base, stream);
    return launch<float, true>(p, sf, si, obs, pol, fpol, ext, traj,
                               partials, W, T, trainee, use_frozen, k0, k1,
                               tick_base, world_base, stream);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
