// Kernel B's timing probes: the float32 instance with one cost term taken
// out, for the attribution bench (madrona_basketball_tpu_torch/
// bench_rollout_attr.py).
//
// Replaces the probe branches of the Pallas kernel make_fused_rollout
// (madrona_basketball_tpu/ops/fused_rollout.py:239, `probe` :247,
// :285-296, pallas_call :486): sim_only (:364-367), policy_only
// (:419-421), no_prng (:335-339) and no_traj (:393-397, :438-439,
// :468-470).  The body is kernel B's (rollout_common.cuh::rollout_tile,
// FOLD on, float32 trajectory) with its PROBE parameter set, so each
// probe differs from the flagship's launch by exactly the term it drops;
// fused_rollout.cu keeps the float32 instance unchanged, and the sixteen
// instances here (4 probes x 2 trainees x frozen or not) build in their
// own nvcc process beside it.  Probes break the training semantics: no
// trainer path launches one.
//
// Bound: that of the work each probe leaves (chip_smoke.py counts its
// operations from the plain version with the same probe, and its bytes:
// no_traj writes one zero block in place of the T-tick trajectory).

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_common.cuh"

using namespace mbb;
using namespace mbb::rollout;

namespace {

template <int TI, bool FROZEN, int PROBE>
__global__ void __launch_bounds__(NT, 1)
fused_rollout_probe_kernel(SimParams p, float *__restrict__ sf,
                           int *__restrict__ si, float *__restrict__ obs,
                           const float *__restrict__ pol,
                           const float *__restrict__ fpol,
                           const float *__restrict__ ext,
                           float *__restrict__ traj,
                           float *__restrict__ partials, int W, int T,
                           uint32_t k0, uint32_t k1,
                           const int *__restrict__ tick_base,
                           int world_base) {
    rollout_tile<TI, FROZEN, true, float, false, PROBE>(
        p, sf, si, obs, pol, fpol, ext, traj, partials, W, T, k0, k1,
        tick_base, world_base);
}

template <int PROBE>
int launch(SimParams p, float *sf, int *si, float *obs, const float *pol,
           const float *fpol, const float *ext, float *traj, float *partials,
           int W, int T, int trainee, int use_frozen, uint32_t k0,
           uint32_t k1, const int *tick_base, int world_base,
           cudaStream_t stream) {
#define MBB_BP_LAUNCH(TI, FR)                                                 \
    launch_tiles<FR>(fused_rollout_probe_kernel<TI, FR, PROBE>, p, sf, si,   \
                     obs, pol, fpol, ext, traj, partials, W, T, k0, k1,       \
                     tick_base, world_base, stream)
    if (trainee == 0)
        return use_frozen ? MBB_BP_LAUNCH(0, true) : MBB_BP_LAUNCH(0, false);
    return use_frozen ? MBB_BP_LAUNCH(1, true) : MBB_BP_LAUNCH(1, false);
#undef MBB_BP_LAUNCH
}

}  // namespace

// mbb_fused_rollout's contract (fused_rollout.cu) with the probe `probe`
// (1 sim_only, 2 policy_only, 3 no_prng, 4 no_traj; rollout_common.cuh's
// PROBE_*); with no_traj, traj is (1, 128, W) and receives zeros.
extern "C" int mbb_fused_rollout_probe(SimParams p, float *sf, int *si,
                                       float *obs, const float *pol,
                                       const float *fpol, const float *ext,
                                       float *traj, float *partials, int W,
                                       int T, int trainee, int use_frozen,
                                       int probe, uint32_t k0, uint32_t k1,
                                       const int *tick_base, int world_base,
                                       cudaStream_t stream) {
    if (W % 32 != 0 || W < 32 || T < 1 || (trainee != 0 && trainee != 1) ||
        world_base < 0 || (ext == nullptr && tick_base == nullptr))
        return (int)cudaErrorInvalidValue;
#define MBB_BP_PROBE(PR)                                                     \
    launch<PR>(p, sf, si, obs, pol, fpol, ext, traj, partials, W, T, trainee, \
               use_frozen, k0, k1, tick_base, world_base, stream)
    switch (probe) {
        case PROBE_SIM_ONLY: return MBB_BP_PROBE(PROBE_SIM_ONLY);
        case PROBE_POLICY_ONLY: return MBB_BP_PROBE(PROBE_POLICY_ONLY);
        case PROBE_NO_PRNG: return MBB_BP_PROBE(PROBE_NO_PRNG);
        case PROBE_NO_TRAJ: return MBB_BP_PROBE(PROBE_NO_TRAJ);
        default: return (int)cudaErrorInvalidValue;
    }
#undef MBB_BP_PROBE
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
