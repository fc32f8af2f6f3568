// Kernel E: per-feature (mean, M2, n) of the trajectory's used obs rows.
//
// Replaces the Pallas kernel make_obs_moments
// (madrona_basketball_tpu/ops/fused_gae.py:251, pallas_call :281), which
// streams (used, gb) tiles of the (T, rows, W) trajectory through one
// sequential Chan fold.  Here the grid runs in parallel, so the reduction
// is a tree with a fixed shape instead of a fold:
//
//   1. obs_moment_partial_kernel: one CTA per (feature, chunk of CHUNK
//      consecutive worlds), one thread per world.  Each thread takes its
//      world's T values (a two-pass mean and M2, the second pass re-reading
//      what the first left in L1), then the CTA merges the equal-count
//      thread pairs in shared memory, halving each round, into the chunk's
//      (mean, M2), written as a partial.
//   2. obs_moment_combine_kernel: one thread per feature merges that
//      feature's equal-count chunk partials in chunk order (Chan's closed
//      form) into out[f] = [mean, M2, n, 0, 0, 0, 0, 0].
//
// No float atomics: a relaunch repeats its bits.  The tree rounds
// differently from the fold (ops/fused_gae.py::obs_moments_plain), ~1e-6
// relative.
//
// The bf16 branch (make_obs_moments(traj_dtype=bfloat16), fused_gae.py:252,
// :271-273; --data-parallel --bf16-traj): the partial kernel reads bf16
// bits (template TT = uint16_t) and upcasts each value on load; the rest
// is the float32 kernel's, so it equals that kernel on the upcast
// trajectory bit for bit.
//
// Bound: bytes.  It reads T * used * W floats once (108 MB at the flagship
// 32 x 103 x 8192, 0.032 ms at 3.35 TB/s; half that in bf16) for ~4
// operations a value; loads are coalesced (consecutive threads on
// consecutive worlds).

#include <cstdint>

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

template <class TT>
__global__ void obs_moment_partial_kernel(const TT *__restrict__ traj,
                                          float *__restrict__ partials,
                                          int T, int rows, int W) {
    extern __shared__ float sm[];  // mean[blockDim] | m2[blockDim]
    float *sm_mean = sm;
    float *sm_m2 = sm + blockDim.x;
    const int f = blockIdx.x;
    const int c = blockIdx.y;
    const int w = c * blockDim.x + threadIdx.x;
    const TT *x = traj + (size_t)f * W + w;
    const size_t stride = (size_t)rows * W;
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += mbb::from_traj(x[t * stride]);
    const float mean = s / (float)T;
    float m2 = 0.0f;
    for (int t = 0; t < T; ++t) {
        const float d = mbb::from_traj(x[t * stride]) - mean;
        m2 += d * d;
    }
    sm_mean[threadIdx.x] = mean;
    sm_m2[threadIdx.x] = m2;
    __syncthreads();
    // equal-count pairs: n values each side, merged n -> 2n
    float n = (float)T;
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) {
            const float ma = sm_mean[threadIdx.x];
            const float mb = sm_mean[threadIdx.x + half];
            const float delta = mb - ma;
            sm_mean[threadIdx.x] = ma + delta * 0.5f;
            sm_m2[threadIdx.x] = sm_m2[threadIdx.x] + sm_m2[threadIdx.x + half] +
                                 delta * delta * (n * 0.5f);
        }
        n *= 2.0f;
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        const size_t o = ((size_t)f * gridDim.y + c) * 2;
        partials[o] = sm_mean[0];
        partials[o + 1] = sm_m2[0];
    }
}

__global__ void obs_moment_combine_kernel(const float *__restrict__ partials,
                                          float *__restrict__ out, int used,
                                          int n_chunks, float n_per) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= used) return;
    const float *p = partials + (size_t)f * n_chunks * 2;
    float s = 0.0f, m2 = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
        s += p[2 * c];
        m2 += p[2 * c + 1];
    }
    const float mean = s / (float)n_chunks;
    float between = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
        const float d = p[2 * c] - mean;
        between += d * d;
    }
    float *o = out + (size_t)f * 8;
    o[0] = mean;
    o[1] = m2 + n_per * between;
    o[2] = n_per * (float)n_chunks;
#pragma unroll
    for (int k = 3; k < 8; ++k) o[k] = 0.0f;
}

template <class TT>
int launch(const TT *traj, float *partials, float *out, int T, int rows,
           int W, int used, int chunk, cudaStream_t stream) {
    if (T < 1 || used < 1 || used > rows || chunk < 32 || chunk > 1024 ||
        (chunk & (chunk - 1)) != 0 || W % chunk != 0)
        return (int)cudaErrorInvalidValue;
    const int n_chunks = W / chunk;
    obs_moment_partial_kernel<TT><<<dim3(used, n_chunks), chunk,
                                2 * chunk * sizeof(float), stream>>>(
        traj, partials, T, rows, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    obs_moment_combine_kernel<<<(used + 127) / 128, 128, 0, stream>>>(
        partials, out, used, n_chunks, (float)T * (float)chunk);
    return (int)cudaGetLastError();
}

}  // namespace

// traj (T, rows, W) float32; partials (used, W / chunk, 2) scratch;
// out (used, 8).  chunk: threads (worlds) per CTA, a power of two from 32
// to 1024 dividing W.
extern "C" int mbb_obs_moments(const float *traj, float *partials,
                               float *out, int T, int rows, int W, int used,
                               int chunk, cudaStream_t stream) {
    return launch(traj, partials, out, T, rows, W, used, chunk, stream);
}

// mbb_obs_moments on a trajectory of bf16 bits (uint16_t).
extern "C" int mbb_obs_moments_bf16(const uint16_t *traj, float *partials,
                                    float *out, int T, int rows, int W,
                                    int used, int chunk,
                                    cudaStream_t stream) {
    return launch(traj, partials, out, T, rows, W, used, chunk, stream);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
