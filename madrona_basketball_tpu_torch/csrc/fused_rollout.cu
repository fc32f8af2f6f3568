// Kernel B: T PPO ticks with the policy in the loop, in one launch.
//
// Replaces the Pallas kernel make_fused_rollout
// (madrona_basketball_tpu/ops/fused_rollout.py:239, pallas_call :486).  One
// thread per world keeps its world in registers / local memory for all T
// ticks.  Each tick:
//   1. read the trainee's pre-tick obs (128 rows), normalize (clamp +-5),
//      copy the 103 used rows into the trajectory, and fold them into this
//      warp's (mean, M2) obs-moment partial;
//   2. MLP 128 -> 32 -> LN -> ReLU -> 32 -> LN -> ReLU -> 19 logits + value
//      as a per-thread matvec on the policy in shared memory;
//   3. Gumbel-max per action bucket (strict >, so ties keep the first
//      index; u clamped at 1e-20), summed log-prob;
//   4. write the actions into the world (and the frozen policy's actions
//      for the other agent when there is one);
//   5. step_world (sim_world.cuh, the body kernel A runs);
//   6. write the trajectory rows: 103 obs, 6 actions, logp, value, reward,
//      done, zeros in the pad rows.
//
// Noise: external ((T * 56, W), the pack_rollout_noise layout) or in-kernel
// Philox4x32-10 (sim_world.cuh) with key (seed lo, seed hi) and counter
// (world, tick_base + t, draw group, 0); draw n is word n % 4 of group n / 4.
// The counter does not depend on T, so one T-tick launch equals T one-tick
// launches.  ops/fused_rollout.py::philox_noise is the plain twin.
//
// Bound: bytes.  The (T, 128, W) trajectory write dominates (16 KB per
// world at T = 32); the MLP is ~12 kflop per world-tick.  A policy is
// 6,272 floats (25 KB); two (frozen opponent) exceed the 48 KB static limit,
// so the policies live in dynamic shared memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_common.cuh"

using namespace mbb;
using namespace mbb::rollout;

namespace {

constexpr int BLOCK = 64;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void layer_norm_relu(float h[H],
                                                const float *__restrict__ b,
                                                int scale_col, int bias_col) {
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
        s = s + h[j];
        s2 = s2 + h[j] * h[j];
    }
    const float mu = s / (float)H;
    const float mu2 = s2 / (float)H;
    const float r = rsqrtf(fmaxf(mu2 - mu * mu, 0.0f) + 1e-6f);
#pragma unroll
    for (int j = 0; j < H; ++j)
        h[j] = fmaxf((h[j] - mu) * r * b[j * 8 + scale_col] +
                         b[j * 8 + bias_col],
                     0.0f);
}

// Policy forward on obs rows [lo, lo + 128) of world w -> out[0..18]
// logits, out[19] value.  With traj_t set (the trainee), also copies the
// 103 used obs rows into the trajectory and writes this warp's obs-moment
// partial (mean, M2) per feature to part[k * 2 + {0, 1}] (lane 0).
__device__ __forceinline__ void policy_forward(
    const float *__restrict__ P, const float *__restrict__ obs, int lo,
    int W, int w, float out[NL + 1], float *__restrict__ traj_t,
    float *__restrict__ part, int lane) {
    float h[H];
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < OBS; ++k) {
        const float raw = obs[(size_t)(lo + k) * W + w];
        if (traj_t != nullptr && k < ROLL_OBS) {
            traj_t[(size_t)k * W + w] = raw;
            const float m = warp_sum(raw) * (1.0f / 32.0f);
            const float d = raw - m;
            const float m2 = warp_sum(d * d);
            if (lane == 0) {
                part[k * 2 + 0] = m;
                part[k * 2 + 1] = m2;
            }
        }
        const float x =
            clampf((raw - P[P_NRM + 2 * k]) * P[P_NRM + 2 * k + 1], -5.0f,
                   5.0f);
#pragma unroll
        for (int j = 0; j < H; ++j) h[j] = h[j] + P[P_W1 + j * OBS + k] * x;
    }
    const float *b = P + P_B;
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = h[j] + b[j * 8 + 0];
    layer_norm_relu(h, b, 1, 2);
    float h2[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < H; ++k) acc = acc + P[P_W2 + j * H + k] * h[k];
        h2[j] = acc + b[j * 8 + 3];
    }
    layer_norm_relu(h2, b, 4, 5);
#pragma unroll
    for (int r = 0; r < NL + 1; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < H; ++k) acc = acc + P[P_WH + r * H + k] * h2[k];
        out[r] = acc + b[r * 8 + 6];
    }
}

template <int TI, bool FROZEN>
__global__ void __launch_bounds__(BLOCK)
fused_rollout_kernel(SimParams p, float *__restrict__ sf,
                     int *__restrict__ si, float *__restrict__ obs,
                     const float *__restrict__ pol,
                     const float *__restrict__ fpol,
                     const float *__restrict__ ext, float *__restrict__ traj,
                     float *__restrict__ partials, int W, int T, uint32_t k0,
                     uint32_t k1, int tick_base) {
    extern __shared__ float smem[];
    for (int i = threadIdx.x; i < POL; i += blockDim.x) {
        smem[i] = pol[i];
        if (FROZEN) smem[POL + i] = fpol[i];
    }
    __syncthreads();
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;  // W % 32 == 0: whole warps leave together
    const int lane = threadIdx.x & 31;
    const int group = w >> 5;
    const int G = W >> 5;
    constexpr int FI = 1 - TI;

    World s;
    load_world(s, sf, si, W, w);
    for (int t = 0; t < T; ++t) {
        float nz[N_NOISE_ROWS], ut[NL], uf[NL];
        if (ext != nullptr) {
            const float *e = ext + (size_t)t * EXT_CHUNK * W + w;
#pragma unroll
            for (int r = 0; r < N_NOISE_ROWS; ++r) nz[r] = e[(size_t)r * W];
#pragma unroll
            for (int r = 0; r < NL; ++r) {
                ut[r] = e[(size_t)(EXT_TU + r) * W];
                if (FROZEN) uf[r] = e[(size_t)(EXT_FU + r) * W];
            }
        } else {
            float u[4 * ((N_DRAWS + 3) / 4)];
#pragma unroll
            for (int g = 0; g < (N_DRAWS + 3) / 4; ++g) {
                uint32_t c[4] = {(uint32_t)w, (uint32_t)(tick_base + t),
                                 (uint32_t)g, 0u};
                philox4x32_10(c, k0, k1);
#pragma unroll
                for (int q = 0; q < 4; ++q) u[4 * g + q] = bits_to_unit(c[q]);
            }
#pragma unroll
            for (int r = 0; r < N_NOISE_ROWS - 1; ++r)
                nz[r] = 2.0f * u[r] - 1.0f;
            nz[N_NOISE_ROWS - 1] = u[N_NOISE_ROWS - 1];
#pragma unroll
            for (int r = 0; r < NL; ++r) {
                ut[r] = u[N_NOISE_ROWS + r];
                uf[r] = u[N_NOISE_ROWS + NL + r];
            }
        }

        float *tr = traj + (size_t)t * ROLL_ROWS * W;
        float out[NL + 1];
        policy_forward(smem, obs, TI * OBS, W, w, out, tr,
                       partials + ((size_t)t * G + group) * ROLL_OBS * 2,
                       lane);
        int act[6];
        const float logp = sample(out, ut, act);
        set_actions(s.ag[TI], act);
        if (FROZEN) {
            float fout[NL + 1];
            policy_forward(smem + POL, obs, FI * OBS, W, w, fout, nullptr,
                           nullptr, lane);
            int fact[6];
            sample(fout, uf, fact);
            set_actions(s.ag[FI], fact);
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) tr[(size_t)(R_ACT + j) * W + w] = (float)act[j];
        tr[(size_t)R_LOGP * W + w] = logp;
        tr[(size_t)(R_LOGP + 1) * W + w] = 0.0f;
        tr[(size_t)(R_LOGP + 2) * W + w] = 0.0f;
        tr[(size_t)R_VALUE * W + w] = out[NL];

        step_world(p, s, nz, obs, W, w);

        tr[(size_t)R_REW * W + w] = s.ag[TI].reward;
        tr[(size_t)R_DONE * W + w] = s.ag[TI].done;
        for (int r = R_DONE + 1; r < ROLL_ROWS; ++r)
            tr[(size_t)r * W + w] = 0.0f;
    }
    store_world(s, sf, si, W, w);
}

template <int TI, bool FROZEN>
int launch(SimParams p, float *sf, int *si, float *obs, const float *pol,
           const float *fpol, const float *ext, float *traj, float *partials,
           int W, int T, uint32_t k0, uint32_t k1, int tick_base,
           cudaStream_t stream) {
    const size_t smem = (FROZEN ? 2 : 1) * POL * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_rollout_kernel<TI, FROZEN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (W + BLOCK - 1) / BLOCK;
    fused_rollout_kernel<TI, FROZEN><<<grid, BLOCK, smem, stream>>>(
        p, sf, si, obs, pol, fpol, ext, traj, partials, W, T, k0, k1,
        tick_base);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mbb_fused_rollout(SimParams p, float *sf, int *si, float *obs,
                                 const float *pol, const float *fpol,
                                 const float *ext, float *traj,
                                 float *partials, int W, int T, int trainee,
                                 int use_frozen, uint32_t k0, uint32_t k1,
                                 int tick_base, cudaStream_t stream) {
    if (W % 32 != 0 || T < 1 || (trainee != 0 && trainee != 1))
        return (int)cudaErrorInvalidValue;
    if (trainee == 0)
        return use_frozen ? launch<0, true>(p, sf, si, obs, pol, fpol, ext,
                                            traj, partials, W, T, k0, k1,
                                            tick_base, stream)
                          : launch<0, false>(p, sf, si, obs, pol, fpol, ext,
                                             traj, partials, W, T, k0, k1,
                                             tick_base, stream);
    return use_frozen ? launch<1, true>(p, sf, si, obs, pol, fpol, ext, traj,
                                        partials, W, T, k0, k1, tick_base,
                                        stream)
                      : launch<1, false>(p, sf, si, obs, pol, fpol, ext, traj,
                                         partials, W, T, k0, k1, tick_base,
                                         stream);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
