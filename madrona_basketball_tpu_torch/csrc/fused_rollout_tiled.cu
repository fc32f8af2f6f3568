// Kernel I: kernel B's T-tick rollout without the obs-moment output.
//
// Replaces the Pallas kernel make_fused_rollout_tiled
// (madrona_basketball_tpu/ops/fused_rollout.py:502, pallas_call :664), the
// TPU variant that runs the whole tick on (8, blk/8) tiles and each Dense
// layer as one product over the tile.  It keeps kernel B's contract
// (ops/fused_rollout.py) without the obs-moment output: kernel E computes
// those from the trajectory afterwards.  The body is rollout_common.cuh's
// rollout_tile without the fold, the one kernel B runs: a CTA of 256
// threads per tile of 64 worlds, so on the same seed and state I and B
// write the same trajectory bit for bit.
//
// Bound: operations, as kernel B (the MLP's ~12 kflop per world-tick and
// the tick); bytes are B's without the moment partials.

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_common.cuh"

using namespace mbb;
using namespace mbb::rollout;

namespace {

template <int TI, bool FROZEN>
__global__ void __launch_bounds__(NT, 1)
fused_rollout_tiled_kernel(SimParams p, float *__restrict__ sf,
                           int *__restrict__ si, float *__restrict__ obs,
                           const float *__restrict__ pol,
                           const float *__restrict__ fpol,
                           const float *__restrict__ ext,
                           float *__restrict__ traj, float *partials, int W,
                           int T, uint32_t k0, uint32_t k1,
                           const int *__restrict__ tick_base, int world_base) {
    rollout_tile<TI, FROZEN, false>(p, sf, si, obs, pol, fpol, ext, traj,
                                    partials, W, T, k0, k1, tick_base,
                                    world_base);
}

}  // namespace

// sf (72, W), si (59, W), obs (256, W) updated in place; traj (T, 128, W);
// ext (T * 56, W) or null for in-kernel Philox, whose ticks start at
// *tick_base (device memory; null with ext) and whose worlds are numbered
// from world_base, as kernel B's.  W % 1024 == 0, the JAX kernel's
// contract (any multiple of TILE would do here).
extern "C" int mbb_fused_rollout_tiled(SimParams p, float *sf, int *si,
                                       float *obs, const float *pol,
                                       const float *fpol, const float *ext,
                                       float *traj, int W, int T, int trainee,
                                       int use_frozen, uint32_t k0,
                                       uint32_t k1, const int *tick_base,
                                       int world_base, cudaStream_t stream) {
    if (W % 1024 != 0 || T < 1 || (trainee != 0 && trainee != 1) ||
        world_base < 0 || (ext == nullptr && tick_base == nullptr))
        return (int)cudaErrorInvalidValue;
#define MBB_I_LAUNCH(TI, FR)                                                  \
    launch_tiles<FR>(fused_rollout_tiled_kernel<TI, FR>, p, sf, si, obs, pol, \
                     fpol, ext, traj, nullptr, W, T, k0, k1, tick_base,       \
                     world_base, stream)
    if (trainee == 0)
        return use_frozen ? MBB_I_LAUNCH(0, true) : MBB_I_LAUNCH(0, false);
    return use_frozen ? MBB_I_LAUNCH(1, true) : MBB_I_LAUNCH(1, false);
#undef MBB_I_LAUNCH
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
