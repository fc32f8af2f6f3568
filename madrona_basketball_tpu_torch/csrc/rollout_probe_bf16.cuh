// Kernel B's timing probes on its bf16 instances: a probe together with
// the trajectory stored in bf16, the policy's Dense operands in bf16, or
// both.  This header holds the kernel and its launch; two sources
// instantiate them, each in its own nvcc process beside the others:
// fused_rollout_probe_bf16.cu the bf16-storage instances (28) and
// fused_rollout_probe_pbf.cu the float32-storage bf16-policy ones (12):
// one source of all 40 built for over twice as long as the slowest
// other library, and the build waits for the slowest.
//
// Replaces the probe x bf16 branches of the Pallas kernel
// make_fused_rollout (madrona_basketball_tpu/ops/fused_rollout.py:239,
// `probe` :247 with `traj_dtype` / `policy_bf16`, asserted :296-300,
// pallas_call :486): sim_only (:364-367) with bf16 storage (:399-407,
// :440-444), policy_only (:419-421), no_prng (:335-339) and no_traj
// (:393-398, :438-439, :468-480) with bf16 storage, the bf16 policy
// (policy_forward_rows(mm_dtype=) :140-155, :369-376) or both.  The body
// is kernel B's (rollout_common.cuh::rollout_tile, FOLD on) with TT,
// PBF and PROBE set together, so each instance differs from its bf16
// instance (fused_rollout_bf16.cu) by exactly the term its probe drops.
// sim_only runs no policy, so the bf16 policy changes nothing there (the
// JAX kernel never uses pol_dt, :363-367): the wrapper routes sim_only
// with policy_bf16 to the sim_only instance of the same storage type
// (fused_rollout_probe_bf16.cu's with bf16 storage,
// fused_rollout_probe.cu's with float32), and no PBF sim_only instance
// is built.  That leaves ten combinations x 2 trainees x frozen or not
// = 40 instances.  Probes break the training semantics: no trainer path
// launches one.
//
// Bound: that of the work each probe leaves at its storage type
// (chip_smoke.py counts the operations from the plain version with the
// same probe and flags, the bf16 policy's Dense products at the bf16
// tensor-core rate; the bytes with the trajectory at 2 bytes a value).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_common.cuh"

namespace mbb {
namespace rollout {

template <int TI, bool FROZEN, class TT, bool PBF, int PROBE>
__global__ void __launch_bounds__(NT, 1)
fused_rollout_probe_bf16_kernel(SimParams p, float *__restrict__ sf,
                                int *__restrict__ si,
                                float *__restrict__ obs,
                                const float *__restrict__ pol,
                                const float *__restrict__ fpol,
                                const float *__restrict__ ext,
                                TT *__restrict__ traj,
                                float *__restrict__ partials, int W, int T,
                                uint32_t k0, uint32_t k1,
                                const int *__restrict__ tick_base,
                                int world_base) {
    rollout_tile<TI, FROZEN, true, TT, PBF, PROBE>(
        p, sf, si, obs, pol, fpol, ext, traj, partials, W, T, k0, k1,
        tick_base, world_base);
}

template <class TT, bool PBF, int PROBE>
int launch_probe_bf16_tiles(SimParams p, float *sf, int *si, float *obs,
                            const float *pol, const float *fpol,
                            const float *ext, void *traj, float *partials,
                            int W, int T, int trainee, int use_frozen,
                            uint32_t k0, uint32_t k1, const int *tick_base,
                            int world_base, cudaStream_t stream) {
    TT *tr = static_cast<TT *>(traj);
#define MBB_PB16_LAUNCH(TI, FR)                                               \
    launch_tiles<FR>(fused_rollout_probe_bf16_kernel<TI, FR, TT, PBF, PROBE>, \
                     p, sf, si, obs, pol, fpol, ext, tr, partials, W, T, k0,  \
                     k1, tick_base, world_base, stream)
    if (trainee == 0)
        return use_frozen ? MBB_PB16_LAUNCH(0, true)
                          : MBB_PB16_LAUNCH(0, false);
    return use_frozen ? MBB_PB16_LAUNCH(1, true) : MBB_PB16_LAUNCH(1, false);
#undef MBB_PB16_LAUNCH
}

// mbb_fused_rollout_bf16's contract (fused_rollout_bf16.cu) with the
// storage type TT, the bf16 policy PBF and the probe `probe` (1
// sim_only, 2 policy_only, 3 no_prng, 4 no_traj; PROBE_*): with no_traj,
// traj is (1, 128, W) and receives zeros; sim_only takes no PBF.
template <class TT, bool PBF>
int launch_probe_bf16(int probe, SimParams p, float *sf, int *si,
                      float *obs, const float *pol, const float *fpol,
                      const float *ext, void *traj, float *partials, int W,
                      int T, int trainee, int use_frozen, uint32_t k0,
                      uint32_t k1, const int *tick_base, int world_base,
                      cudaStream_t stream) {
    if (W % 32 != 0 || W < 32 || T < 1 || (trainee != 0 && trainee != 1) ||
        world_base < 0 || (ext == nullptr && tick_base == nullptr))
        return (int)cudaErrorInvalidValue;
#define MBB_PB16_PROBE(PR)                                                   \
    launch_probe_bf16_tiles<TT, PBF, PR>(p, sf, si, obs, pol, fpol, ext,    \
                                         traj, partials, W, T, trainee,     \
                                         use_frozen, k0, k1, tick_base,     \
                                         world_base, stream)
    switch (probe) {
        case PROBE_SIM_ONLY:
            // no policy runs: no PBF instance (the wrapper routes it)
            if constexpr (PBF) return (int)cudaErrorInvalidValue;
            else return MBB_PB16_PROBE(PROBE_SIM_ONLY);
        case PROBE_POLICY_ONLY: return MBB_PB16_PROBE(PROBE_POLICY_ONLY);
        case PROBE_NO_PRNG: return MBB_PB16_PROBE(PROBE_NO_PRNG);
        case PROBE_NO_TRAJ: return MBB_PB16_PROBE(PROBE_NO_TRAJ);
        default: return (int)cudaErrorInvalidValue;
    }
#undef MBB_PB16_PROBE
}

}  // namespace rollout
}  // namespace mbb
