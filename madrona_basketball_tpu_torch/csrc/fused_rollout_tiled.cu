// Kernel I: kernel B's T-tick rollout with the policy run per tile of
// worlds instead of per world.
//
// Replaces the Pallas kernel make_fused_rollout_tiled
// (madrona_basketball_tpu/ops/fused_rollout.py:502, pallas_call :664), the
// TPU variant that runs the whole tick on (8, blk/8) tiles and each Dense
// layer as one product over the tile.  It keeps kernel B's contract
// (ops/fused_rollout.py) without the obs-moment output: kernel E computes
// those from the trajectory afterwards.
//
// Mapping.  A CTA of NT = 256 threads owns a tile of TILE = 64 worlds.
//   * The sim runs one thread per world (threads 0..63) through the shared
//     device body step_world (sim_world.cuh), as kernels A, B and F do; the
//     world stays in registers for all T ticks.
//   * The obs of the tile stay in shared memory (256 x TILE): step_world
//     writes them there, the policy reads them there, and only the final
//     obs go back to global memory.
//   * The policy is CTA-cooperative: the trainee's obs are normalized into
//     a (128, TILE) tile; each Dense layer is a tile product split over
//     (output unit, world) pairs, thread (g, c) = (tid / TILE, tid % TILE)
//     taking units [g * J, (g + 1) * J) of world c, with the weights in
//     shared memory (a warp reads one weight at a time: a broadcast) and
//     consecutive threads on consecutive worlds of the activation tile.
//     LayerNorm statistics run per world (threads 0..63), then ReLU over
//     the tile.  Each (unit, world) sum runs over k in ascending order,
//     one multiply-add a term, as kernel B's per-thread matvec does.
//   * Each sim thread samples its own world's 6 buckets (strict >, first
//     maximum wins) from the logits tile, as kernel B.
// Per tick, in the JAX kernel's order: policy on the pre-tick obs,
// sampling, actions into the world (and the frozen policy's for the other
// agent), the trajectory rows (103 obs, 6 actions, logp, value, zeros),
// the sim tick, then reward and done.
//
// Why: kernel B keeps the MLP's activations in each thread beside the
// 131-field world (255 registers and ~2 KB of spills a thread); here the
// activations live in shared memory and the policy's arithmetic is spread
// over four times as many threads.
//
// Noise: external ((T * 56, W), the pack_rollout_noise layout) or kernel
// B's Philox4x32-10 stream (key = seed, counter (world, tick_base + t,
// group, 0)), drawn where it is used; so one T-tick launch equals T
// one-tick launches, and on the same seed kernel I draws what kernel B
// draws.  ops/fused_rollout.py::philox_noise is the plain twin.
//
// Shared memory (floats): policy 6,272 (x2 with the frozen policy) | obs
// 256 x 64 | normalized obs 128 x 64 | two hidden tiles 32 x 64 | head
// 20 x 64 | LayerNorm statistics 2 x 64: 142 KB, or 167 KB with the frozen
// policy, above the 48 KB static limit, so dynamic.
//
// Bound: operations, as kernel B (the MLP's ~12 kflop per world-tick and
// the tick); bytes are B's without the moment partials.

#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_common.cuh"

using namespace mbb;
using namespace mbb::rollout;

namespace {

constexpr int TILE = 64;         // worlds per CTA
constexpr int NT = 256;          // threads per CTA
constexpr int G = NT / TILE;     // thread groups over the output units
static_assert(H % G == 0 && (NL + 1) % G == 0, "units split over G groups");

// shared-memory offsets (floats) after the policy matrices
constexpr int S_OBS = 0;
constexpr int S_XN = S_OBS + N_OBS_ROWS * TILE;
constexpr int S_H1 = S_XN + OBS * TILE;
constexpr int S_H2 = S_H1 + H * TILE;
constexpr int S_OUT = S_H2 + H * TILE;
constexpr int S_ST = S_OUT + (NL + 1) * TILE;
constexpr int S_END = S_ST + 2 * TILE;

// Draws [LO, LO + N) of (world, tick): draw n is word n % 4 of Philox
// group n / 4 (kernel B's numbering).
template <int LO, int N>
__device__ __forceinline__ void philox_draws(float *u, uint32_t w,
                                             uint32_t tick, uint32_t k0,
                                             uint32_t k1) {
#pragma unroll
    for (int g = LO / 4; g <= (LO + N - 1) / 4; ++g) {
        uint32_t c[4] = {w, tick, (uint32_t)g, 0u};
        philox4x32_10(c, k0, k1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int n = 4 * g + q - LO;
            if (n >= 0 && n < N) u[n] = bits_to_unit(c[q]);
        }
    }
}

// y[(g J + q), c] = sum_k Wt[(g J + q), k] x[k, c] + bias column bc, for
// this thread's J units; tiles are (rows, TILE) row-major.
template <int K, int J>
__device__ __forceinline__ void dense(const float *__restrict__ wt,
                                      const float *__restrict__ x,
                                      float *__restrict__ y,
                                      const float *__restrict__ b, int bc,
                                      int g, int c) {
    float acc[J];
#pragma unroll
    for (int q = 0; q < J; ++q) acc[q] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        const float xv = x[k * TILE + c];
#pragma unroll
        for (int q = 0; q < J; ++q)
            acc[q] = acc[q] + wt[(g * J + q) * K + k] * xv;
    }
#pragma unroll
    for (int q = 0; q < J; ++q)
        y[(g * J + q) * TILE + c] = acc[q] + b[(g * J + q) * 8 + bc];
}

// LayerNorm (flax fast variance, eps 1e-6) + ReLU over the H units of each
// world of the tile h (H, TILE), in place; kernel B's arithmetic.
__device__ __forceinline__ void layer_norm_relu(float *__restrict__ h,
                                                const float *__restrict__ b,
                                                int sc, int bc,
                                                float *__restrict__ st,
                                                int tid, int g, int c) {
    if (tid < TILE) {
        float s = 0.0f, s2 = 0.0f;
#pragma unroll 8
        for (int j = 0; j < H; ++j) {
            const float v = h[j * TILE + tid];
            s = s + v;
            s2 = s2 + v * v;
        }
        const float mu = s / (float)H;
        const float mu2 = s2 / (float)H;
        st[tid] = mu;
        st[TILE + tid] = rsqrtf(fmaxf(mu2 - mu * mu, 0.0f) + 1e-6f);
    }
    __syncthreads();
    constexpr int J = H / G;
    const float mu = st[c], r = st[TILE + c];
#pragma unroll
    for (int q = 0; q < J; ++q) {
        const int j = g * J + q;
        h[j * TILE + c] =
            fmaxf((h[j * TILE + c] - mu) * r * b[j * 8 + sc] + b[j * 8 + bc],
                  0.0f);
    }
    __syncthreads();
}

// The policy on the obs block ob (128, TILE) of the tile: logits and value
// into sm[S_OUT] (20, TILE).  All NT threads; ends synchronized.
__device__ __forceinline__ void policy_tile(const float *__restrict__ P,
                                            const float *__restrict__ ob,
                                            float *__restrict__ sm, int tid) {
    const int g = tid / TILE, c = tid % TILE;
    float *xn = sm + S_XN, *h1 = sm + S_H1, *h2 = sm + S_H2;
    float *st = sm + S_ST;
    const float *b = P + P_B;
    for (int i = tid; i < OBS * TILE; i += NT) {
        const int k = i / TILE;
        xn[i] = clampf((ob[i] - P[P_NRM + 2 * k]) * P[P_NRM + 2 * k + 1],
                       -5.0f, 5.0f);
    }
    __syncthreads();
    dense<OBS, H / G>(P + P_W1, xn, h1, b, 0, g, c);
    __syncthreads();
    layer_norm_relu(h1, b, 1, 2, st, tid, g, c);
    dense<H, H / G>(P + P_W2, h1, h2, b, 3, g, c);
    __syncthreads();
    layer_norm_relu(h2, b, 4, 5, st, tid, g, c);
    dense<H, (NL + 1) / G>(P + P_WH, h2, sm + S_OUT, b, 6, g, c);
    __syncthreads();
}

// One sim thread's sampling from the logits tile on uniforms u.
__device__ __forceinline__ float sample_tile(const float *__restrict__ out,
                                             const float u[NL], int tid,
                                             int act[6]) {
    float lg[NL];
#pragma unroll
    for (int r = 0; r < NL; ++r) lg[r] = out[r * TILE + tid];
    return sample(lg, u, act);
}

template <int TI, bool FROZEN>
__global__ void __launch_bounds__(NT, 1)
fused_rollout_tiled_kernel(SimParams p, float *__restrict__ sf,
                           int *__restrict__ si, float *__restrict__ obs,
                           const float *__restrict__ pol,
                           const float *__restrict__ fpol,
                           const float *__restrict__ ext,
                           float *__restrict__ traj, int W, int T,
                           uint32_t k0, uint32_t k1, int tick_base) {
    extern __shared__ float smem[];
    constexpr int FI = 1 - TI;
    float *sp = smem;
    float *sfp = smem + POL;
    float *sm = smem + (FROZEN ? 2 : 1) * POL;
    float *so = sm + S_OBS;
    const int tid = threadIdx.x;
    const int w0 = blockIdx.x * TILE;
    for (int i = tid; i < POL; i += NT) {
        sp[i] = pol[i];
        if (FROZEN) sfp[i] = fpol[i];
    }
    for (int i = tid; i < N_OBS_ROWS * TILE; i += NT)
        so[i] = obs[(size_t)(i / TILE) * W + w0 + i % TILE];
    const bool sim = tid < TILE;
    const int w = w0 + tid;
    World s;
    if (sim) load_world(s, sf, si, W, w);
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        const uint32_t tick = (uint32_t)(tick_base + t);
        const float *e =
            ext != nullptr ? ext + (size_t)t * EXT_CHUNK * W + w : nullptr;
        float *tr = traj + (size_t)t * ROLL_ROWS * W;

        policy_tile(sp, so + TI * OBS * TILE, sm, tid);
        if (sim) {
            float u[NL];
            if (e != nullptr) {
#pragma unroll
                for (int r = 0; r < NL; ++r) u[r] = e[(size_t)(EXT_TU + r) * W];
            } else {
                philox_draws<N_NOISE_ROWS, NL>(u, (uint32_t)w, tick, k0, k1);
            }
            int act[6];
            const float logp = sample_tile(sm + S_OUT, u, tid, act);
            set_actions(s.ag[TI], act);
#pragma unroll
            for (int j = 0; j < 6; ++j)
                tr[(size_t)(R_ACT + j) * W + w] = (float)act[j];
            tr[(size_t)R_LOGP * W + w] = logp;
            tr[(size_t)(R_LOGP + 1) * W + w] = 0.0f;
            tr[(size_t)(R_LOGP + 2) * W + w] = 0.0f;
            tr[(size_t)R_VALUE * W + w] = sm[S_OUT + NL * TILE + tid];
        }
        if (FROZEN) {
            __syncthreads();  // the logits tile is read before it is reused
            policy_tile(sfp, so + FI * OBS * TILE, sm, tid);
            if (sim) {
                float u[NL];
                if (e != nullptr) {
#pragma unroll
                    for (int r = 0; r < NL; ++r)
                        u[r] = e[(size_t)(EXT_FU + r) * W];
                } else {
                    philox_draws<N_NOISE_ROWS + NL, NL>(u, (uint32_t)w, tick,
                                                        k0, k1);
                }
                int act[6];
                sample_tile(sm + S_OUT, u, tid, act);
                set_actions(s.ag[FI], act);
            }
        }
        // the trainee's pre-tick obs rows, coalesced over the tile
        for (int i = tid; i < ROLL_OBS * TILE; i += NT)
            tr[(size_t)(i / TILE) * W + w0 + i % TILE] =
                so[TI * OBS * TILE + i];
        __syncthreads();  // the obs tile is read before the tick rewrites it

        if (sim) {
            float nz[N_NOISE_ROWS];
            if (e != nullptr) {
#pragma unroll
                for (int r = 0; r < N_NOISE_ROWS; ++r) nz[r] = e[(size_t)r * W];
            } else {
                float u[N_NOISE_ROWS];
                philox_draws<0, N_NOISE_ROWS>(u, (uint32_t)w, tick, k0, k1);
#pragma unroll
                for (int r = 0; r < N_NOISE_ROWS - 1; ++r)
                    nz[r] = 2.0f * u[r] - 1.0f;
                nz[N_NOISE_ROWS - 1] = u[N_NOISE_ROWS - 1];
            }
            step_world(p, s, nz, so, TILE, tid);
            tr[(size_t)R_REW * W + w] = s.ag[TI].reward;
            tr[(size_t)R_DONE * W + w] = s.ag[TI].done;
            for (int r = R_DONE + 1; r < ROLL_ROWS; ++r)
                tr[(size_t)r * W + w] = 0.0f;
        }
        __syncthreads();  // the new obs tile, before the next tick's policy
    }
    if (sim) store_world(s, sf, si, W, w);
    for (int i = tid; i < N_OBS_ROWS * TILE; i += NT)
        obs[(size_t)(i / TILE) * W + w0 + i % TILE] = so[i];
}

template <int TI, bool FROZEN>
int launch(SimParams p, float *sf, int *si, float *obs, const float *pol,
           const float *fpol, const float *ext, float *traj, int W, int T,
           uint32_t k0, uint32_t k1, int tick_base, cudaStream_t stream) {
    const size_t smem = ((FROZEN ? 2 : 1) * POL + S_END) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_rollout_tiled_kernel<TI, FROZEN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_rollout_tiled_kernel<TI, FROZEN><<<W / TILE, NT, smem, stream>>>(
        p, sf, si, obs, pol, fpol, ext, traj, W, T, k0, k1, tick_base);
    return (int)cudaGetLastError();
}

}  // namespace

// sf (72, W), si (59, W), obs (256, W) updated in place; traj (T, 128, W);
// ext (T * 56, W) or null for in-kernel Philox.  W % 1024 == 0, the JAX
// kernel's contract (any multiple of TILE would do here).
extern "C" int mbb_fused_rollout_tiled(SimParams p, float *sf, int *si,
                                       float *obs, const float *pol,
                                       const float *fpol, const float *ext,
                                       float *traj, int W, int T, int trainee,
                                       int use_frozen, uint32_t k0,
                                       uint32_t k1, int tick_base,
                                       cudaStream_t stream) {
    if (W % 1024 != 0 || T < 1 || (trainee != 0 && trainee != 1))
        return (int)cudaErrorInvalidValue;
    if (trainee == 0)
        return use_frozen
                   ? launch<0, true>(p, sf, si, obs, pol, fpol, ext, traj, W,
                                     T, k0, k1, tick_base, stream)
                   : launch<0, false>(p, sf, si, obs, pol, fpol, ext, traj, W,
                                      T, k0, k1, tick_base, stream);
    return use_frozen ? launch<1, true>(p, sf, si, obs, pol, fpol, ext, traj,
                                        W, T, k0, k1, tick_base, stream)
                      : launch<1, false>(p, sf, si, obs, pol, fpol, ext, traj,
                                         W, T, k0, k1, tick_base, stream);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
