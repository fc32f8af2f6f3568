// Kernel F: K simulation ticks for every world in one launch, no policy.
//
// Replaces the Pallas kernel make_fused_multistep
// (madrona_basketball_tpu/ops/fused_step.py:1134, pallas_call :1274).  One
// thread per world loads its 131 state fields once, runs K ticks of the
// shared device body in registers (multistep_world, sim_world.cuh) and
// stores the state once; kernel A loads and stores every tick.  Noise is
// in-kernel Philox (mbb_fused_multistep; kernel B's counter scheme, so a
// K-tick launch equals K one-tick launches with tick_base advanced) or an
// external (K * 16, W) matrix (mbb_fused_multistep_ext, tests and parity).
// Two instances: obs written every tick (bench.py's headline workload) or
// once, from the final state (held actions, eval bursts).  The TPU
// kernel's (8, W/8) tiles and VMEM block limits have no counterpart: rows
// stay (rows, W) and any W is taken.
//
// Bound: operations.  Per world the state is read once and written once
// and the obs written once (2,072 bytes), against a few thousand flops per
// tick; the every-tick instance also rewrites the 8.4 MB obs buffer of
// 8192 worlds each tick, which can stay in the 50 MB L2.  One thread per
// world gives 8192 worlds only two warps per SM, so the dependent chains
// of one tick set the pace.
//
// Built by madrona_basketball_tpu_torch/_build.py; called through ctypes
// from ops/fused_step.py::fused_multistep.

#include <cstdint>

#include <cuda_runtime.h>

#include "sim_world.cuh"

using namespace mbb;

namespace {

constexpr int BLOCK = 64;

template <bool OBS_EVERY_TICK>
__global__ void __launch_bounds__(BLOCK)
fused_multistep_kernel(SimParams p, const float *__restrict__ ext,
                       const float *__restrict__ sf,
                       const int *__restrict__ si, float *__restrict__ sf_out,
                       int *__restrict__ si_out, float *__restrict__ obs,
                       int W, int K, int tick_base, uint32_t k0, uint32_t k1,
                       int blank_agent) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    World s;
    load_world(s, sf, si, W, w);
    multistep_world<OBS_EVERY_TICK>(p, s, ext, K, tick_base, k0, k1,
                                    blank_agent, obs, W, w);
    store_world(s, sf_out, si_out, W, w);
}

int launch(SimParams p, const float *ext, const float *sf, const int *si,
           float *sf_out, int *si_out, float *obs, int W, int K,
           int tick_base, uint32_t k0, uint32_t k1, int obs_every_tick,
           int blank_agent, cudaStream_t stream) {
    const int grid = (W + BLOCK - 1) / BLOCK;
    if (obs_every_tick)
        fused_multistep_kernel<true><<<grid, BLOCK, 0, stream>>>(
            p, ext, sf, si, sf_out, si_out, obs, W, K, tick_base, k0, k1,
            blank_agent);
    else
        fused_multistep_kernel<false><<<grid, BLOCK, 0, stream>>>(
            p, ext, sf, si, sf_out, si_out, obs, W, K, tick_base, k0, k1,
            blank_agent);
    return (int)cudaGetLastError();
}

}  // namespace

// In-kernel Philox noise, key (k0, k1), ticks tick_base .. tick_base + K - 1.
extern "C" int mbb_fused_multistep(SimParams p, const float *sf,
                                   const int *si, float *sf_out, int *si_out,
                                   float *obs, int W, int K, int tick_base,
                                   uint32_t k0, uint32_t k1,
                                   int obs_every_tick, int blank_agent,
                                   cudaStream_t stream) {
    return launch(p, nullptr, sf, si, sf_out, si_out, obs, W, K, tick_base,
                  k0, k1, obs_every_tick, blank_agent, stream);
}

// External noise: (K * 16, W), rows 0-8 of each 16-row chunk used.
extern "C" int mbb_fused_multistep_ext(SimParams p, const float *noise,
                                       const float *sf, const int *si,
                                       float *sf_out, int *si_out, float *obs,
                                       int W, int K, int obs_every_tick,
                                       int blank_agent, cudaStream_t stream) {
    return launch(p, noise, sf, si, sf_out, si_out, obs, W, K, 0, 0u, 0u,
                  obs_every_tick, blank_agent, stream);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
