// Kernel C: GAE, the raw side array, the value / advantage / return block
// moments and the episode-stat carry, in one pass over the trajectory.
//
// Replaces the Pallas kernel make_fused_gae
// (madrona_basketball_tpu/ops/fused_gae.py:58, pallas_call :178).  On the
// TPU the grid walks world blocks in order; here each CUDA block of gb
// threads (gb worlds) is independent:
//   * each thread runs its world's reverse GAE recursion (t == T-1 pairs
//     the bootstrap value with not_done[T-1], fused_gae.py:118-121) and
//     writes side[t] = [value_un, adv, ret, 0 x 5];
//   * two-pass block moments: the block sums of value_un / adv / ret give
//     the means, a second pass over the side rows this thread just wrote
//     gives the centred M2 (no E[x^2] - mean^2 cancellation);
//   * the episode-stat carry runs forward over T; per tick, the warp sums
//     of [done, curr * done, lens * done] go to shared memory and are
//     summed over warps at the end -> ticks[block, t].
//
// Bound: bytes (3 T + 3 floats read and 8 T + 2 written per world).

#include <cuda_runtime.h>

namespace {

constexpr int SIDE_ROWS = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// Block-wide sum of three values; every thread gets the totals.
// `red` holds 3 * nwarps floats.
__device__ __forceinline__ void block_sum3(float v[3], float *red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float s = warp_sum(v[c]);
        if (lane == 0) red[c * nw + wid] = s;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float s = 0.0f;
        for (int k = 0; k < nw; ++k) s = s + red[c * nw + k];
        v[c] = s;
    }
    __syncthreads();
}

__global__ void fused_gae_kernel(const float *__restrict__ traj,
                                 const float *__restrict__ carry,
                                 const float *__restrict__ next_value,
                                 const float *__restrict__ vstats,
                                 float *__restrict__ side,
                                 float *__restrict__ moments,
                                 float *__restrict__ carry_out,
                                 float *__restrict__ ticks, int T, int rows,
                                 int W, int r_value, int r_rew, int r_done,
                                 float gamma, float gamma_lam) {
    extern __shared__ float shm[];
    const int nw = blockDim.x >> 5;
    float *red = shm;             // 3 * nw
    float *tick_part = shm + 3 * nw;  // T * 3 * nw
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const float vmean = vstats[0], vsig = vstats[1];
    auto at = [&](int t, int r) { return traj[((size_t)t * rows + r) * W + w]; };
    auto side_at = [&](int t, int c) -> float & {
        return side[((size_t)t * SIDE_ROWS + c) * W + w];
    };

    // ---- reverse GAE
    float v_up = vmean + vsig * clampf(next_value[w], -5.0f, 5.0f);
    float nd_up = 1.0f - at(T - 1, r_done);
    float lastgae = 0.0f;
    float sums[3] = {0.0f, 0.0f, 0.0f};
    for (int t = T - 1; t >= 0; --t) {
        const float v = vmean + vsig * clampf(at(t, r_value), -5.0f, 5.0f);
        const float rew = at(t, r_rew);
        const float nd = 1.0f - at(t, r_done);
        const float delta = rew + gamma * v_up * nd_up - v;
        lastgae = delta + gamma_lam * nd_up * lastgae;
        const float ret = lastgae + v;
        side_at(t, 0) = v;
        side_at(t, 1) = lastgae;
        side_at(t, 2) = ret;
#pragma unroll
        for (int c = 3; c < SIDE_ROWS; ++c) side_at(t, c) = 0.0f;
        sums[0] = sums[0] + v;
        sums[1] = sums[1] + lastgae;
        sums[2] = sums[2] + ret;
        v_up = v;
        nd_up = nd;
    }

    // ---- two-pass block moments of value_un / adv / ret
    const float inv_n = 1.0f / (float)(T * blockDim.x);
    block_sum3(sums, red);
    float mean[3], m2[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 3; ++c) mean[c] = sums[c] * inv_n;
    for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float d = side_at(t, c) - mean[c];
            m2[c] = m2[c] + d * d;
        }
    }
    block_sum3(m2, red);
    if (threadIdx.x == 0) {
        float *mo = moments + (size_t)blockIdx.x * 8;
        mo[0] = mean[0];
        mo[1] = m2[0];
        mo[2] = mean[1];
        mo[3] = m2[1];
        mo[4] = mean[2];
        mo[5] = m2[2];
        mo[6] = 0.0f;
        mo[7] = 0.0f;
    }

    // ---- episode-stat carry, per-(block, tick) partial sums
    float curr = carry[w], lens = carry[W + w];
    for (int t = 0; t < T; ++t) {
        const float d = at(t, r_done);
        curr = curr + at(t, r_rew);
        lens = lens + 1.0f;
        const float c0 = warp_sum(d);
        const float c1 = warp_sum(curr * d);
        const float c2 = warp_sum(lens * d);
        if (lane == 0) {
            tick_part[(t * 3 + 0) * nw + wid] = c0;
            tick_part[(t * 3 + 1) * nw + wid] = c1;
            tick_part[(t * 3 + 2) * nw + wid] = c2;
        }
        curr = curr * (1.0f - d);
        lens = lens * (1.0f - d);
    }
    carry_out[w] = curr;
    carry_out[W + w] = lens;
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        float *tk = ticks + ((size_t)blockIdx.x * T + t) * 8;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float s = 0.0f;
            for (int k = 0; k < nw; ++k) s = s + tick_part[(t * 3 + c) * nw + k];
            tk[c] = s;
        }
#pragma unroll
        for (int c = 3; c < 8; ++c) tk[c] = 0.0f;
    }
}

}  // namespace

extern "C" int mbb_fused_gae(const float *traj, const float *carry,
                             const float *next_value, const float *vstats,
                             float *side, float *moments, float *carry_out,
                             float *ticks, int T, int rows, int W, int gb,
                             int r_value, int r_rew, int r_done, float gamma,
                             float gamma_lam, cudaStream_t stream) {
    if (gb % 32 != 0 || gb > 1024 || W % gb != 0 || T < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)3 * (gb / 32) * (T + 1) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_gae_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_gae_kernel<<<W / gb, gb, smem, stream>>>(
        traj, carry, next_value, vstats, side, moments, carry_out, ticks, T,
        rows, W, r_value, r_rew, r_done, gamma, gamma_lam);
    return (int)cudaGetLastError();
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
