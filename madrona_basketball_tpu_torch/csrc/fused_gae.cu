// Kernel C: GAE, the raw side array, the value / advantage / return block
// moments and the episode-stat carry, in one pass over the trajectory.
//
// Replaces the Pallas kernel make_fused_gae
// (madrona_basketball_tpu/ops/fused_gae.py:58, pallas_call :178).  On the
// TPU the grid walks world blocks of gb worlds in order; here each block
// is a thread-block cluster of gb / 32 CTAs (gb = pick_gae_block(W) <= 128,
// so 4 CTAs at 8192 worlds: 256 CTAs, every SM busy), a CTA of 256
// threads owning 32 worlds:
//   * all threads stage the tile's value / reward / done rows of every
//     tick into shared memory with 16-byte loads (no load on a recursion's
//     chain);
//   * warp 0 runs each world's reverse GAE recursion (gae_tile.cuh) into a
//     shared (3, T, 32) side tile while warp 1 runs the episode-stat carry
//     forward;
//   * two-pass block moments: per-CTA sums (lane order), exchanged over
//     distributed shared memory and added in rank order, give the block
//     means, every CTA the same; a second pass over the side tile gives
//     the centred M2, summed the same way (no E[x^2] - mean^2
//     cancellation); rank 0 writes the block's row of `moments`;
//   * the per-(block, tick) sums of [done, curr * done, lens * done] go
//     the same way into `ticks`;
//   * all threads write the (T, 8, 32) side rows with 16-byte stores.
//
// The bf16 branch (make_fused_gae(traj_dtype=bfloat16), fused_gae.py:61,
// :88-93; --bf16-traj): the same kernel on a trajectory of bf16 bits
// (template TT = uint16_t), which the staging loop reads 8 bytes (4
// values) a thread and upcasts to float32 on load; everything after the
// load is the float32 kernel's, so it equals that kernel run on the
// upcast trajectory bit for bit.
//
// Bound: bytes (3 T + 3 floats read and 8 T + 2 written per world).  The
// outputs' block partition (`moments` one row per gb-world block, `ticks`
// (nb, T, 8)) is the glue's (ops/fused_gae.py); host_gae.cpp runs the same
// steps in the same order on the CPU.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bf16.cuh"
#include "gae_tile.cuh"

namespace cg = cooperative_groups;
using namespace mbb::gae;

namespace {

constexpr int NT = 256;   // threads per CTA
constexpr int MAX_CL = 4;  // CTAs per world block: pick_gae_block's cap / 32

// 4 consecutive trajectory values (q-th group of 4 from src) as float32:
// one 16-byte load of float32, one 8-byte load of bf16 bits
__device__ __forceinline__ float4 load4(const float *src, int q) {
    return reinterpret_cast<const float4 *>(src)[q];
}
__device__ __forceinline__ float4 load4(const uint16_t *src, int q) {
    const uint2 v = reinterpret_cast<const uint2 *>(src)[q];
    return make_float4(mbb::bf16_to_f32((uint16_t)(v.x & 0xffffu)),
                       mbb::bf16_to_f32((uint16_t)(v.x >> 16)),
                       mbb::bf16_to_f32((uint16_t)(v.y & 0xffffu)),
                       mbb::bf16_to_f32((uint16_t)(v.y >> 16)));
}

// shared floats: staged rows 3 T | side 3 T | carry products 2 T (rows of
// GAE_TILE), per-world sums 3 x GAE_TILE and M2 3 x GAE_TILE, the CTA's
// partials read by the cluster (sums 3, M2 3, ticks 3 T)
__host__ __device__ constexpr size_t smem_floats(int T) {
    return (size_t)8 * T * GAE_TILE + 6 * GAE_TILE + 6 + 3 * T;
}

template <class TT>
__global__ void __launch_bounds__(NT)
fused_gae_kernel(const TT *__restrict__ traj,
                 const float *__restrict__ carry,
                 const float *__restrict__ next_value,
                 const float *__restrict__ vstats, float *__restrict__ side,
                 float *__restrict__ moments, float *__restrict__ carry_out,
                 float *__restrict__ ticks, int T, int rows, int W,
                 int r_value, int r_rew, int r_done, float gamma,
                 float gamma_lam) {
    extern __shared__ __align__(16) float shm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int ncl = (int)cluster.num_blocks();
    const int n = T * GAE_TILE;
    float *sv = shm, *sr = sv + n, *sd = sr + n;
    float *side3 = sd + n;                 // (3, T, GAE_TILE)
    float *cd = side3 + 3 * n, *ld = cd + n;
    float *wsum = ld + n;                  // (3, GAE_TILE)
    float *wm2 = wsum + 3 * GAE_TILE;      // (3, GAE_TILE)
    float *part = wm2 + 3 * GAE_TILE;      // sums 3 | M2 3 | ticks (T, 3)
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int w0 = blockIdx.x * GAE_TILE;
    const int block = blockIdx.x / ncl;

    // ---- stage the three input rows of every tick, 4 values a thread
    constexpr int V4 = GAE_TILE / 4;
    for (int i = tid; i < 3 * T * V4; i += NT) {
        const int q = i % V4, row = i / V4, t = row % T, k = row / T;
        const int r = k == 0 ? r_value : (k == 1 ? r_rew : r_done);
        reinterpret_cast<float4 *>(shm)[row * V4 + q] =
            load4(traj + ((size_t)t * rows + r) * W + w0, q);
    }
    __syncthreads();

    // ---- warp 0: reverse GAE; warp 1: the episode-stat carry
    const float vmean = vstats[0], vsig = vstats[1];
    if (warp == 0) {
        float sums[3];
        gae_reverse(sv, sr, sd, T, lane, next_value[w0 + lane], vmean, vsig,
                    gamma, gamma_lam, side3, sums);
        for (int k = 0; k < 3; ++k) wsum[k * GAE_TILE + lane] = sums[k];
    } else if (warp == 1) {
        float curr = carry[w0 + lane], lens = carry[W + w0 + lane];
        carry_forward(sr, sd, T, lane, curr, lens, cd, ld);
        carry_out[w0 + lane] = curr;
        carry_out[W + w0 + lane] = lens;
    }
    __syncthreads();

    // ---- the CTA's partials: value / adv / ret sums, per-tick stat sums
    if (tid < 3) part[tid] = sum_lanes(wsum + tid * GAE_TILE);
    for (int i = tid; i < 3 * T; i += NT) {
        const int t = i / 3, k = i % 3;
        const float *x = (k == 0 ? sd : (k == 1 ? cd : ld)) + t * GAE_TILE;
        part[6 + i] = sum_lanes(x);
    }
    // ---- the side rows, 16 bytes a thread (rows 3-7 are zeros)
    for (int i = tid; i < T * SIDE_ROWS * V4; i += NT) {
        const int q = i % V4, row = i / V4, t = row / SIDE_ROWS,
                  k = row % SIDE_ROWS;
        const float4 v = k < 3 ? reinterpret_cast<const float4 *>(
                                     side3 + k * n + t * GAE_TILE)[q]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        reinterpret_cast<float4 *>(side + ((size_t)t * SIDE_ROWS + k) * W +
                                   w0)[q] = v;
    }
    cluster.sync();

    // ---- block means (every CTA the same), then the M2 pass
    const float inv_n = 1.0f / (float)(T * GAE_TILE * ncl);
    float mean[3];
    for (int k = 0; k < 3; ++k) {
        float s = 0.0f;
        for (int c = 0; c < ncl; ++c) s = s + cluster.map_shared_rank(part, c)[k];
        mean[k] = s * inv_n;
    }
    if (warp == 0) {
        float m2[3];
        m2_world(side3, T, lane, mean, m2);
        for (int k = 0; k < 3; ++k) wm2[k * GAE_TILE + lane] = m2[k];
    }
    __syncthreads();
    if (tid < 3) part[3 + tid] = sum_lanes(wm2 + tid * GAE_TILE);
    cluster.sync();

    // ---- rank 0 writes the block's moments and per-tick sums
    if (rank == 0) {
        if (tid < 3) {
            float s = 0.0f;
            for (int c = 0; c < ncl; ++c)
                s = s + cluster.map_shared_rank(part, c)[3 + tid];
            moments[(size_t)block * 8 + 2 * tid] = mean[tid];
            moments[(size_t)block * 8 + 2 * tid + 1] = s;
        } else if (tid < 5) {
            moments[(size_t)block * 8 + 3 + tid] = 0.0f;
        }
        for (int i = tid; i < 8 * T; i += NT) {
            const int t = i / 8, k = i % 8;
            float s = 0.0f;
            if (k < 3)
                for (int c = 0; c < ncl; ++c)
                    s = s + cluster.map_shared_rank(part, c)[6 + 3 * t + k];
            ticks[((size_t)block * T + t) * 8 + k] = s;
        }
    }
    cluster.sync();  // the other CTAs' partials are read until here
}

template <class TT>
int launch(const TT *traj, const float *carry, const float *next_value,
           const float *vstats, float *side, float *moments, float *carry_out,
           float *ticks, int T, int rows, int W, int gb, int r_value,
           int r_rew, int r_done, float gamma, float gamma_lam,
           cudaStream_t stream) {
    const size_t smem = smem_floats(T) * sizeof(float);
    if (gb % GAE_TILE != 0 || gb / GAE_TILE > MAX_CL || W % gb != 0 ||
        T < 1 || smem > 227 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fused_gae_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(W / GAE_TILE);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = gb / GAE_TILE;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fused_gae_kernel<TT>, traj, carry,
                             next_value, vstats, side, moments, carry_out,
                             ticks, T, rows, W, r_value, r_rew, r_done, gamma,
                             gamma_lam);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mbb_fused_gae(const float *traj, const float *carry,
                             const float *next_value, const float *vstats,
                             float *side, float *moments, float *carry_out,
                             float *ticks, int T, int rows, int W, int gb,
                             int r_value, int r_rew, int r_done, float gamma,
                             float gamma_lam, cudaStream_t stream) {
    return launch(traj, carry, next_value, vstats, side, moments, carry_out,
                  ticks, T, rows, W, gb, r_value, r_rew, r_done, gamma,
                  gamma_lam, stream);
}

// mbb_fused_gae on a trajectory of bf16 bits (uint16_t).
extern "C" int mbb_fused_gae_bf16(const uint16_t *traj, const float *carry,
                                  const float *next_value,
                                  const float *vstats, float *side,
                                  float *moments, float *carry_out,
                                  float *ticks, int T, int rows, int W, int gb,
                                  int r_value, int r_rew, int r_done,
                                  float gamma, float gamma_lam,
                                  cudaStream_t stream) {
    return launch(traj, carry, next_value, vstats, side, moments, carry_out,
                  ticks, T, rows, W, gb, r_value, r_rew, r_done, gamma,
                  gamma_lam, stream);
}

// Resident CTAs per SM, threads per CTA and dynamic shared memory at T
// ticks (out[0..2]).
extern "C" int mbb_fused_gae_occupancy(int T, int *out) {
    const size_t smem = smem_floats(T) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_gae_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    out[1] = NT;
    out[2] = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, fused_gae_kernel<float>, NT, smem);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
