// Kernel A: one simulation tick for every world.
//
// Replaces the Pallas kernel make_fused_step
// (madrona_basketball_tpu/ops/fused_step.py:1034, pallas_call :1060).  One
// thread per world: load the world's 131 state fields, run the shared
// device body step_world (sim_world.cuh), which writes the 256 obs rows
// straight to global memory, and store the state.  Every row access is
// coalesced: consecutive threads touch consecutive worlds of one row.
//
// Bound: bytes.  Per world 9 noise + 131 state rows in, 131 state + 256 obs
// rows out (1,932 bytes); the arithmetic is a few thousand flops.
//
// Built by madrona_basketball_tpu_torch/_build.py; called through ctypes
// from ops/fused_step.py::fused_step.

#include <cuda_runtime.h>

#include "sim_world.cuh"

using namespace mbb;

namespace {

constexpr int BLOCK = 64;

__global__ void __launch_bounds__(BLOCK)
fused_step_kernel(SimParams p, const float *__restrict__ noise,
                  const float *__restrict__ sf, const int *__restrict__ si,
                  float *__restrict__ sf_out, int *__restrict__ si_out,
                  float *__restrict__ obs, int W) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    World s;
    load_world(s, sf, si, W, w);
    float nz[N_NOISE_ROWS];
#pragma unroll
    for (int r = 0; r < N_NOISE_ROWS; ++r) nz[r] = noise[(size_t)r * W + w];
    step_world(p, s, nz, obs, W, w);
    store_world(s, sf_out, si_out, W, w);
}

}  // namespace

extern "C" int mbb_fused_step(SimParams p, const float *noise,
                              const float *sf, const int *si, float *sf_out,
                              int *si_out, float *obs, int W,
                              cudaStream_t stream) {
    const int grid = (W + BLOCK - 1) / BLOCK;
    fused_step_kernel<<<grid, BLOCK, 0, stream>>>(p, noise, sf, si, sf_out,
                                                  si_out, obs, W);
    return (int)cudaGetLastError();
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
