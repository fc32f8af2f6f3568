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
// Bound.  The bf16 policy's three Dense layers are 2 x (32 x 128 + 32 x
// 32 + 20 x 32) = 11,520 operations a world-tick (twice that with the
// frozen policy), 3.02 GFLOP at 8192 worlds x 32 ticks: 3.05 us at the
// bf16 tensor-core rate (989 TFLOP/s dense); the rest of B (the tick,
// LayerNorm, sampling, the fold: 0.83 GFLOP of the plain version's 3.85)
// 12.4 us at float32's 67 TFLOP/s.  Operations: 0.0155 ms.  Bytes: the
// state and obs read and written, the float32 trajectory (134 MB at 8192
// x 32) and the fold partials, 166 MB, take 0.050 ms at 3.35 TB/s, so a
// bf16-policy launch is bound by bytes, and with both flags (99 MB,
// 0.030 ms) by bytes still.  bf16 storage costs the float32 copy of the
// obs rows that the fold reads (rollout_common.cuh).
//
// Design.  The float32 instance runs each Dense layer as an FMA chain a
// (unit, world) out of shared memory, one weight broadcast a term; here
// the layers run on the tensor cores (rollout_common.cuh::dense_mma):
// the weights sit in shared memory as bf16 tiles (rounded once, in
// place of their float32 copies), the obs and LayerNorm-ReLU outputs
// are written as bf16 tiles, and each layer is a 32-unit x 64-world
// tile product of mma.sync m16n8k16 (bf16 operands, float32 sums), a
// warp per 16 units x 16 worlds, fragments loaded by ldmatrix, the bias
// added in the epilogue.  wgmma (64-row tiles, worlds as M) was not
// taken: a 64-world CTA is one m64 tile, so a warpgroup would hold the
// whole layer while the other four warps wait, and its operands need
// the swizzled shared-memory layouts of a descriptor; the products are
// 3 us of the kernel's time at either instruction.  The sums run in the
// tensor core's order, not the FMA chain's over ascending k: logp and
// value stay within 2e-3 of the plain version, and actions equal
// outside near-tie worlds.  The sim tick (one thread a world) and the
// trajectory write are unchanged.

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

// Resident CTAs per SM, threads per CTA and dynamic shared memory of the
// bf16-policy instance (float32 storage, trainee 1) without (out[0..2])
// and with (out[3..5]) the frozen policy.
extern "C" int mbb_fused_rollout_bf16_occupancy(int *out) {
    const int err = tile_occupancy<false>(
        fused_rollout_bf16_kernel<1, false, float, true>, out);
    if (err != 0) return err;
    return tile_occupancy<true>(
        fused_rollout_bf16_kernel<1, true, float, true>, out + 3);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
