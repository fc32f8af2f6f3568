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
//   2. obs_moment_combine_kernel: one CTA per feature stages that
//      feature's equal-count chunk partials in shared memory (all loads in
//      flight at once), then one thread merges them in chunk order (Chan's
//      closed form) into out[f] = [mean, M2, n, 0, 0, 0, 0, 0].
//
// No float atomics: a relaunch repeats its bits.  The tree rounds
// differently from the fold (ops/fused_gae.py::obs_moments_plain), ~1e-6
// relative.
//
// The bf16 branch (make_obs_moments(traj_dtype=bfloat16), fused_gae.py:252,
// :271-273; --data-parallel --bf16-traj): obs_moment_partial_bf16_kernel
// reads bf16 bits and upcasts each value on load.  One thread a world
// would load 2 bytes (64 bytes a warp) a load, too few in flight to
// reach HBM's rate (46 % of the bound, PERF.md); so a thread takes VW = 8
// consecutive worlds of the chunk, each (feature, tick) one 16-byte
// vector copied by cp.async into a shared-memory stage of SLAB ticks
// (all of a thread's copies in flight at once, in NG groups so that the
// first pass sums each group as it lands), then runs each world's two
// passes from the stage.  Its grid runs the chunk fastest, so the CTAs
// resident together read contiguous rows.  The chunk (worlds a
// partial), each world's sums over t in ascending order, each world's
// (mean, M2) in its own shared slot and the equal-count pairwise tree
// over the slots are the float32 kernel's, and the combine is shared, so
// it equals that kernel on the upcast trajectory bit for bit.
//
// Bound: bytes.  It reads T * used * W floats once (108 MB at the flagship
// 32 x 103 x 8192, 0.032 ms at 3.35 TB/s; half that in bf16) for ~4
// operations a value; loads are coalesced (consecutive threads on
// consecutive worlds).

#include <cstdint>

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

__global__ void obs_moment_partial_kernel(const float *__restrict__ traj,
                                          float *__restrict__ partials,
                                          int T, int rows, int W) {
    extern __shared__ float sm[];  // mean[blockDim] | m2[blockDim]
    float *sm_mean = sm;
    float *sm_m2 = sm + blockDim.x;
    const int f = blockIdx.x;
    const int c = blockIdx.y;
    const int w = c * blockDim.x + threadIdx.x;
    const float *x = traj + (size_t)f * W + w;
    const size_t stride = (size_t)rows * W;
    float s = 0.0f;
    for (int t = 0; t < T; ++t) s += x[t * stride];
    const float mean = s / (float)T;
    float m2 = 0.0f;
    for (int t = 0; t < T; ++t) {
        const float d = x[t * stride] - mean;
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

constexpr int VW = 8;     // bf16 worlds a thread: one 16-byte vector
constexpr int SLAB = 32;  // ticks staged in shared memory at once
constexpr int NG = 4;     // cp.async groups a slab (SLAB / NG ticks each)

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(smem)),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `left` (0..3) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait(int left) {
    if (left >= 3)
        asm volatile("cp.async.wait_group 3;\n" ::: "memory");
    else if (left == 2)
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    else if (left == 1)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The 8 bf16 values of a 16-byte vector as float32 (bf16.cuh's upcast)
__device__ __forceinline__ void unpack8(const uint4 &v, float x[VW]) {
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        x[2 * i] = mbb::bf16_to_f32((uint16_t)(q[i] & 0xffffu));
        x[2 * i + 1] = mbb::bf16_to_f32((uint16_t)(q[i] >> 16));
    }
}

// Stage the ticks [t0, t0 + n) of this thread's 8 worlds: NG commit
// groups of SLAB / NG ticks (empty ones past n), so the first ticks can
// be summed while the later ones are in flight.
__device__ __forceinline__ void stage_slab(uint4 *stage, const uint16_t *x,
                                           size_t stride, int t0, int n,
                                           int nt, int tid) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
        for (int j = g * (SLAB / NG); j < min(n, (g + 1) * (SLAB / NG)); ++j)
            cp_async16(&stage[j * nt + tid], x + (size_t)(t0 + j) * stride);
        cp_async_commit();
    }
}

// The bf16 partial kernel: one CTA per (chunk, feature) - the chunk
// fastest, so CTAs that run together read one feature's contiguous row -
// blockDim.x = chunk / VW threads; dynamic shared memory: mean[chunk] |
// m2[chunk] | stage[SLAB][blockDim.x] 16-byte vectors.  Each thread
// stages its own vectors (so cp.async waits and no barrier), sums each
// group of ticks as it lands, and after the mean reads them again for M2
// (from the stage when T <= SLAB, else staged anew).  The partial of
// (feature f, chunk c) lands where the float32 kernel puts it.
__global__ void obs_moment_partial_bf16_kernel(
    const uint16_t *__restrict__ traj, float *__restrict__ partials, int T,
    int rows, int W) {
    extern __shared__ __align__(16) float smb[];
    const int nt = blockDim.x, chunk = nt * VW, tid = threadIdx.x;
    float *sm_mean = smb;
    float *sm_m2 = smb + chunk;
    uint4 *stage = reinterpret_cast<uint4 *>(smb + 2 * chunk);
    const int c = blockIdx.x;
    const int f = blockIdx.y;
    const uint16_t *x = traj + (size_t)f * W + (size_t)c * chunk + tid * VW;
    const size_t stride = (size_t)rows * W;
    float s[VW], m2[VW], mean[VW], v[VW];
#pragma unroll
    for (int q = 0; q < VW; ++q) s[q] = m2[q] = 0.0f;
    for (int t0 = 0; t0 < T; t0 += SLAB) {
        const int n = min(SLAB, T - t0);
        stage_slab(stage, x, stride, t0, n, nt, tid);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            cp_async_wait(NG - 1 - g);
#pragma unroll 4
            for (int j = g * (SLAB / NG); j < min(n, (g + 1) * (SLAB / NG));
                 ++j) {
                unpack8(stage[j * nt + tid], v);
#pragma unroll
                for (int q = 0; q < VW; ++q) s[q] += v[q];
            }
        }
    }
#pragma unroll
    for (int q = 0; q < VW; ++q) mean[q] = s[q] / (float)T;
    for (int t0 = 0; t0 < T; t0 += SLAB) {
        const int n = min(SLAB, T - t0);
        if (T > SLAB) {
            stage_slab(stage, x, stride, t0, n, nt, tid);
            cp_async_wait(0);
        }
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
            unpack8(stage[j * nt + tid], v);
#pragma unroll
            for (int q = 0; q < VW; ++q) {
                const float d = v[q] - mean[q];
                m2[q] += d * d;
            }
        }
    }
#pragma unroll
    for (int q = 0; q < VW; ++q) {
        sm_mean[tid * VW + q] = mean[q];
        sm_m2[tid * VW + q] = m2[q];
    }
    __syncthreads();
    // the float32 kernel's tree: equal-count pairs, n values each side,
    // merged n -> 2n; a round's merges spread over the threads
    float n = (float)T;
    for (int half = chunk / 2; half > 0; half >>= 1) {
        for (int i = tid; i < half; i += nt) {
            const float ma = sm_mean[i];
            const float mb = sm_mean[i + half];
            const float delta = mb - ma;
            sm_mean[i] = ma + delta * 0.5f;
            sm_m2[i] =
                sm_m2[i] + sm_m2[i + half] + delta * delta * (n * 0.5f);
        }
        n *= 2.0f;
        __syncthreads();
    }
    if (tid == 0) {
        const size_t o = ((size_t)f * gridDim.x + c) * 2;
        partials[o] = sm_mean[0];
        partials[o + 1] = sm_m2[0];
    }
}

// The combine: a CTA of 32 threads per feature copies the feature's
// chunk partials into shared memory (dynamic: 2 * n_chunks floats) with
// every load in flight at once; thread 0 then merges them in chunk order
// (Chan's closed form) into out[f] = [mean, M2, n, 0, 0, 0, 0, 0].
__global__ void obs_moment_combine_kernel(const float *__restrict__ partials,
                                          float *__restrict__ out,
                                          int n_chunks, float n_per) {
    extern __shared__ float pv[];
    const int f = blockIdx.x;
    const float *src = partials + (size_t)f * n_chunks * 2;
    for (int i = threadIdx.x; i < 2 * n_chunks; i += blockDim.x)
        pv[i] = src[i];
    __syncthreads();
    if (threadIdx.x != 0) return;
    const float *p = pv;
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

int launch_combine(const float *partials, float *out, int used, int n_chunks,
                   float n_per, cudaStream_t stream) {
    const size_t smem = 2 * (size_t)n_chunks * sizeof(float);
    if (smem > 48 * 1024) {  // past the default: W / chunk > 6144
        const cudaError_t err = cudaFuncSetAttribute(
            obs_moment_combine_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    obs_moment_combine_kernel<<<used, 32, smem, stream>>>(partials, out,
                                                          n_chunks, n_per);
    return (int)cudaGetLastError();
}

int launch_instance(const float *traj, float *partials, float *out, int T,
                    int rows, int W, int used, int chunk,
                    cudaStream_t stream) {
    obs_moment_partial_kernel<<<dim3(used, W / chunk), chunk,
                                2 * chunk * sizeof(float), stream>>>(
        traj, partials, T, rows, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_combine(partials, out, used, W / chunk,
                          (float)T * (float)chunk, stream);
}

int launch_instance(const uint16_t *traj, float *partials, float *out,
                    int T, int rows, int W, int used, int chunk,
                    cudaStream_t stream) {
    if (reinterpret_cast<uintptr_t>(traj) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;  // 16-byte vector loads
    const int nt = chunk / VW;
    const size_t smem =
        2 * chunk * sizeof(float) + (size_t)SLAB * nt * sizeof(uint4);
    cudaError_t err = cudaFuncSetAttribute(
        obs_moment_partial_bf16_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    obs_moment_partial_bf16_kernel<<<dim3(W / chunk, used), nt, smem,
                                     stream>>>(traj, partials, T, rows, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_combine(partials, out, used, W / chunk,
                          (float)T * (float)chunk, stream);
}

template <class TT>
int launch(const TT *traj, float *partials, float *out, int T, int rows,
           int W, int used, int chunk, cudaStream_t stream) {
    if (T < 1 || used < 1 || used > rows || chunk < 32 || chunk > 1024 ||
        (chunk & (chunk - 1)) != 0 || W % chunk != 0)
        return (int)cudaErrorInvalidValue;
    return launch_instance(traj, partials, out, T, rows, W, used, chunk,
                           stream);
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
