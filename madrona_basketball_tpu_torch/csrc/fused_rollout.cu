// Kernel B: T PPO ticks with the policy in the loop, in one launch, and
// the obs moments of every tick folded into per-32-world partials.
//
// Replaces the Pallas kernel make_fused_rollout
// (madrona_basketball_tpu/ops/fused_rollout.py:239, pallas_call :486).
// The body is rollout_common.cuh's rollout_tile, which kernel I
// (fused_rollout_tiled.cu) runs too: a CTA of 256 threads per tile of 64
// worlds, the sim one thread per world, the policy a (unit, world) tile
// product out of shared memory, the obs tile resident in shared memory
// across the T ticks; so B and I write the same trajectory bit for bit.
// B adds the fold (FOLD): each tick's pre-tick obs of the trainee, 103
// features x 32-world groups, reduced by warps into (mean, M2) partials
// (T, W / 32, 103, 2), which ops/fused_rollout.py::combine_obs_moments
// merges.  W % 32 == 0: the last tile may hold 32 worlds.
//
// Bound: operations (the MLP's ~12 kflop per world-tick and the tick);
// the (T, 128, W) trajectory write is 16 KB per world at T = 32.  A
// thread that holds both its 131-field world and the MLP's activations
// spills (255 registers) and leaves ~2 warps per SM; here the
// activations live in shared memory and the policy's arithmetic is
// spread over four times as many threads, 8 warps per SM.

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_common.cuh"

using namespace mbb;
using namespace mbb::rollout;

namespace {

template <int TI, bool FROZEN>
__global__ void __launch_bounds__(NT, 1)
fused_rollout_kernel(SimParams p, float *__restrict__ sf,
                     int *__restrict__ si, float *__restrict__ obs,
                     const float *__restrict__ pol,
                     const float *__restrict__ fpol,
                     const float *__restrict__ ext, float *__restrict__ traj,
                     float *__restrict__ partials, int W, int T, uint32_t k0,
                     uint32_t k1, const int *__restrict__ tick_base,
                     int world_base) {
    rollout_tile<TI, FROZEN, true>(p, sf, si, obs, pol, fpol, ext, traj,
                                   partials, W, T, k0, k1, tick_base,
                                   world_base);
}

}  // namespace

// sf (72, W), si (59, W), obs (256, W) updated in place; traj (T, 128, W);
// partials (T, W / 32, 103, 2); ext (T * 56, W) or null for in-kernel
// Philox, whose ticks start at *tick_base (device memory; null with ext)
// and whose worlds are numbered from world_base (0 for a whole fleet).
extern "C" int mbb_fused_rollout(SimParams p, float *sf, int *si, float *obs,
                                 const float *pol, const float *fpol,
                                 const float *ext, float *traj,
                                 float *partials, int W, int T, int trainee,
                                 int use_frozen, uint32_t k0, uint32_t k1,
                                 const int *tick_base, int world_base,
                                 cudaStream_t stream) {
    if (W % 32 != 0 || W < 32 || T < 1 || (trainee != 0 && trainee != 1) ||
        world_base < 0 || (ext == nullptr && tick_base == nullptr))
        return (int)cudaErrorInvalidValue;
#define MBB_B_LAUNCH(TI, FR)                                                 \
    launch_tiles<FR>(fused_rollout_kernel<TI, FR>, p, sf, si, obs, pol, fpol, \
                     ext, traj, partials, W, T, k0, k1, tick_base,            \
                     world_base, stream)
    if (trainee == 0)
        return use_frozen ? MBB_B_LAUNCH(0, true) : MBB_B_LAUNCH(0, false);
    return use_frozen ? MBB_B_LAUNCH(1, true) : MBB_B_LAUNCH(1, false);
#undef MBB_B_LAUNCH
}

// Resident CTAs per SM, threads per CTA and dynamic shared memory of the
// trainee-1 instance without (out[0..2]) and with (out[3..5]) the frozen
// policy.
extern "C" int mbb_fused_rollout_occupancy(int *out) {
    const int err = tile_occupancy<false>(fused_rollout_kernel<1, false>, out);
    if (err != 0) return err;
    return tile_occupancy<true>(fused_rollout_kernel<1, true>, out + 3);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
