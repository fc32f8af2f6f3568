// The rollout kernels' shared body: kernel B (fused_rollout.cu) and
// kernel I (fused_rollout_tiled.cu) run the same tile of worlds
// (rollout_tile below) and so write the same trajectory rows bit for bit;
// B also folds each tick's obs into per-32-world (mean, M2) partials
// (FOLD).  Constants mirror ops/fused_rollout.py.
//
// Mapping.  A CTA of NT = 256 threads owns a tile of TILE = 64 worlds
// (the last tile of kernel B may hold 32).
//   * The sim runs one thread per world (threads 0..63) through the shared
//     device body step_world (sim_world.cuh), as kernels A and F do; the
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
//     one multiply-add a term.
//   * Each sim thread samples its own world's 6 buckets (strict >, first
//     maximum wins) from the logits tile.
//   * FOLD: while warps 0-1 step the worlds, warps 2-7 take (feature,
//     32-world group) pairs of the trainee's pre-tick obs (the rows just
//     written to the trajectory), one world a lane, and reduce them with
//     the xor butterfly: mean = sum / 32, then M2 = sum of squared
//     deviations.
//
// Storage and policy types (template parameters TT and PBF; the float32
// instance, TT = float and PBF = false, is the flagship's):
//   * TT = uint16_t stores every trajectory row in bf16 (bf16.cuh, round
//     to nearest even on store; the JAX kernel's traj_dtype=bfloat16):
//     the same rows, including the zero rows, each the float32 instance's
//     value rounded.  State, obs and the fold stay float32: the fold
//     reads the pre-tick obs that the policy saw, not the rounded rows,
//     from a float32 copy of the tile's 103 trainee obs rows that the
//     row stores write into the normalized-obs tile (free from the end of
//     the policy to the next tick's, so no more shared memory).  The cost:
//     6,592 shared stores a tick, and the fold reads shared memory where
//     the float32 instance reads L2.
//   * PBF runs the three Dense layers on the tensor cores with bf16
//     operands (the JAX kernel's policy_bf16, fused_rollout.py:140-155):
//     the weights are rounded to bf16 once, as they enter shared memory,
//     and stored as bf16 in place of their float32 copies; the normalized
//     and clipped obs and the LayerNorm-ReLU outputs are rounded as they
//     are written, into bf16 tiles in the normalized-obs tile's space.
//     Each layer is a (units x worlds) product of mma.sync m16n8k16 tiles
//     with float32 sums (dense_mma below); biases, LayerNorm and sampling
//     stay float32.  The frozen policy's forward does the same.
//
// Timing probes (template parameter PROBE, the JAX kernel's `probe`,
// fused_rollout.py:247, :285-296; fused_rollout_probe.cu builds them on
// the float32 instance): PROBE_SIM_ONLY runs neither policy nor sampling
// (action, logp and value rows 0; the tick runs on the actions the world
// holds), PROBE_POLICY_ONLY skips the tick (reward and done rows 0),
// PROBE_NO_PRNG draws constants in place of Philox (sim noise 0.0,
// uniforms 0.5; external noise is read as usual), PROBE_NO_TRAJ writes
// no row but a zero block at the start (the trajectory is (1, 128, W))
// and folds from a float32 copy of the obs rows in shared memory, as the
// bf16-storage instance does.  The fold runs in every probe.
// Per tick, in the JAX kernel's order: policy on the pre-tick obs,
// sampling, actions into the world (and the frozen policy's for the other
// agent), the trajectory rows (103 obs, 6 actions, logp, value, zeros),
// the sim tick (and the fold beside it), then reward and done.
//
// Noise: external ((T * 56, W), the pack_rollout_noise layout) or in-kernel
// Philox4x32-10 (sim_world.cuh) with key (seed lo, seed hi) and counter
// (world_base + world, tick_base + t, draw group, 0): the world's index in
// the whole fleet, so a launch on the columns [world_base, world_base + W)
// of a fleet draws what a launch on the whole fleet draws for them (one
// rank's shard of a data-parallel run); draw n is word n % 4 of group
// n / 4, drawn where it is used.  The counter does not depend on T, so one
// T-tick launch equals T one-tick launches.  tick_base is read from device
// memory (an int the wrapper writes, or the trainer's iteration counter
// times T), so a CUDA graph that replays the launch draws each replay's
// ticks; it is not read with external noise.
// ops/fused_rollout.py::philox_noise is the plain twin.
//
// Shared memory (floats): policy 6,272 (x2 with the frozen policy) | obs
// 256 x 64 | normalized obs 128 x 64 | two hidden tiles 32 x 64 | head
// 20 x 64 | LayerNorm statistics 2 x 64: 142 KB, or 167 KB with the frozen
// policy, above the 48 KB static limit, so dynamic.

#pragma once

#include "bf16.cuh"
#include "sim_world.cuh"

namespace mbb {
namespace rollout {

constexpr int OBS = OBS_SIZE;
constexpr int H = 32;
constexpr int NL = 19;
constexpr int ROLL_OBS = OBS_USED;  // 103
constexpr int R_ACT = ROLL_OBS;     // 103
constexpr int R_LOGP = R_ACT + 6;   // 109
constexpr int R_VALUE = 112;
constexpr int R_REW = 113;
constexpr int R_DONE = 114;
constexpr int ROLL_ROWS = 128;
constexpr int EXT_CHUNK = 56;
constexpr int EXT_TU = 16;
constexpr int EXT_FU = EXT_TU + NL;
constexpr int N_DRAWS = N_NOISE_ROWS + 2 * NL;  // 47
// packed policy: nrm (128,2) | w1t (32,128) | w2t (32,32) | wht (20,32) |
// bias (32,8)
constexpr int P_NRM = 0;
constexpr int P_W1 = P_NRM + OBS * 2;
constexpr int P_W2 = P_W1 + H * OBS;
constexpr int P_WH = P_W2 + H * H;
constexpr int P_B = P_WH + (NL + 1) * H;
constexpr int POL = P_B + H * 8;  // 6272

// Gumbel-max per bucket on uniforms u[0..18]; returns the summed log-prob.
__device__ __forceinline__ float sample(const float logits[NL],
                                        const float u[NL], int act[6]) {
    float total = 0.0f;
    int off = 0;
#pragma unroll
    for (int bkt = 0; bkt < 6; ++bkt) {
        // buckets [2, 8, 3, 2, 2, 2] (constants.ACTION_BUCKETS)
        const int n = bkt == 1 ? 8 : (bkt == 2 ? 3 : 2);
        float g = -logf(-logf(fmaxf(u[off], 1e-20f)));
        float best_noisy = logits[off] + g;
        float sel = logits[off];
        float m = logits[off];
        int idx = 0;
#pragma unroll
        for (int r = 1; r < n; ++r) {
            g = -logf(-logf(fmaxf(u[off + r], 1e-20f)));
            const float noisy = logits[off + r] + g;
            if (noisy > best_noisy) {
                best_noisy = noisy;
                idx = r;
                sel = logits[off + r];
            }
            m = fmaxf(m, logits[off + r]);
        }
        float sumexp = 0.0f;
#pragma unroll
        for (int r = 0; r < n; ++r) sumexp = sumexp + expf(logits[off + r] - m);
        const float lp = sel - m - logf(sumexp);
        total = bkt == 0 ? lp : total + lp;
        act[bkt] = idx;
        off += n;
    }
    return total;
}

__device__ __forceinline__ void set_actions(Agent &a, const int act[6]) {
    a.a_move = act[0];
    a.a_angle = act[1];
    a.a_rotate = act[2];
    a.a_grab = act[3];
    a.a_pass = act[4];
    a.a_shoot = act[5];
}

constexpr int TILE = 64;         // worlds per CTA
constexpr int NT = 256;          // threads per CTA
constexpr int G = NT / TILE;     // thread groups over the output units
static_assert(H % G == 0 && (NL + 1) % G == 0, "units split over G groups");

// rollout_tile's PROBE (ops/fused_rollout.py's PROBE_CODES)
constexpr int PROBE_NONE = 0;
constexpr int PROBE_SIM_ONLY = 1;
constexpr int PROBE_POLICY_ONLY = 2;
constexpr int PROBE_NO_PRNG = 3;
constexpr int PROBE_NO_TRAJ = 4;

// PBF's bf16 tiles (row strides in bf16 values, each 16 bytes past a
// multiple of 128, so that the 8 rows an ldmatrix reads fall in 8
// different bank groups): activations (K, TILE) at XS, the weights
// w1t (32, 128) at W1S, w2t and wht (zero-padded to 32 units) at HS.
constexpr int XS = TILE + 8;
constexpr int W1S = OBS + 8;
constexpr int HS = H + 8;
static_assert(H * W1S + 2 * H * HS <= 2 * (P_B - P_W1),
              "the bf16 weights fit where the float32 weights were");
static_assert((OBS + 2 * H) * XS <= 2 * OBS * TILE,
              "the bf16 activation tiles fit in the normalized-obs tile");
static_assert(NT / 32 == 2 * (TILE / 16), "a warp per (16 units, 16 worlds)");

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

// PBF's tensor-core product.  ldmatrix: 4 (x4) 8 x 8 tiles of 16-bit
// values, one 16-byte row address a lane; .trans hands each lane a column
// pair in place of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void *p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"((uint32_t)__cvta_generic_to_shared(p))
        : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void *p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"((uint32_t)__cvta_generic_to_shared(p))
        : "memory");
}

// d (16 x 8, float32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y[u, c] = sum_k wb[u, k] xb[k, c] + bias column bc, for the units u <
// MOUT, on the tensor cores: wb (units, K) bf16 at row stride WS (32 units,
// zero rows past MOUT), xb (K, TILE) bf16 at row stride XS, y (units,
// TILE) float32.  Warp w takes units 16 (w % 2) .. + 16 and worlds
// 16 (w / 2) .. + 16 (two n8 tiles): per 16-deep k step one ldmatrix of
// the weights (A, row-major), one transposed ldmatrix of the activations
// (B, k-major rows) and two mma.sync; the float32 sums stay in registers
// and the bias is added as they are stored.
template <int K, int WS, int MOUT>
__device__ __forceinline__ void dense_mma(const uint16_t *__restrict__ wb,
                                          const uint16_t *__restrict__ xb,
                                          float *__restrict__ y,
                                          const float *__restrict__ b, int bc,
                                          int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    const int m0 = 16 * (warp & 1), n0 = 16 * (warp >> 1);
    const uint16_t *pa = wb + (m0 + (lane & 15)) * WS + 8 * (lane >> 4);
    const uint16_t *pb = xb + (lane & 15) * XS + n0 + 8 * (lane >> 4);
    float acc[2][4] = {};
#pragma unroll
    for (int k = 0; k < K; k += 16) {
        uint32_t a[4], bq[4];
        ldsm_x4(a, pa + k);
        ldsm_x4_trans(bq, pb + k * XS);
        mma_bf16(acc[0], a, bq[0], bq[1]);
        mma_bf16(acc[1], a, bq[2], bq[3]);
    }
    // accumulator (row lane / 4 (+ 8), columns 2 (lane % 4), + 1)
    const int u0 = m0 + (lane >> 2), c0 = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int u = u0 + 8 * hh;
            if (MOUT >= H || u < MOUT) {
                const float bias = b[u * 8 + bc];
                y[u * TILE + c0 + 8 * j] = acc[j][2 * hh] + bias;
                y[u * TILE + c0 + 8 * j + 1] = acc[j][2 * hh + 1] + bias;
            }
        }
}

// PBF: the policy P's Dense weights as bf16 tiles (w1t at W1S, w2t and wht
// at HS, wht's rows past NL + 1 zero) where its float32 weights were; the
// normalizer and the biases stay float32.
__device__ __forceinline__ void stage_policy_bf16(
    float *__restrict__ P, const float *__restrict__ pol, int tid) {
    for (int i = tid; i < POL; i += NT)
        if (i < P_W1 || i >= P_B) P[i] = pol[i];
    uint16_t *wb = reinterpret_cast<uint16_t *>(P + P_W1);
    for (int i = tid; i < H * OBS; i += NT)
        wb[(i / OBS) * W1S + i % OBS] = f32_to_bf16(pol[P_W1 + i]);
    wb += H * W1S;
    for (int i = tid; i < H * H; i += NT)
        wb[(i / H) * HS + i % H] = f32_to_bf16(pol[P_W2 + i]);
    wb += H * HS;
    for (int i = tid; i < H * H; i += NT)
        wb[(i / H) * HS + i % H] =
            i / H < NL + 1 ? f32_to_bf16(pol[P_WH + i]) : (uint16_t)0;
}

// LayerNorm (flax fast variance, eps 1e-6) + ReLU over the H units of each
// world of the tile h (H, TILE), in place; kernel B's arithmetic.  PBF:
// the outputs rounded to bf16 into hb (H, TILE) at row stride XS (the
// next Dense layer's operand).
template <bool PBF>
__device__ __forceinline__ void layer_norm_relu(float *__restrict__ h,
                                                const float *__restrict__ b,
                                                int sc, int bc,
                                                float *__restrict__ st,
                                                int tid, int g, int c,
                                                uint16_t *__restrict__ hb =
                                                    nullptr) {
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
        const float y =
            fmaxf((h[j * TILE + c] - mu) * r * b[j * 8 + sc] + b[j * 8 + bc],
                  0.0f);
        if constexpr (PBF)
            hb[j * XS + c] = f32_to_bf16(y);
        else
            h[j * TILE + c] = y;
    }
    __syncthreads();
}

// The policy on the obs block ob (128, TILE) of the tile: logits and value
// into sm[S_OUT] (20, TILE).  All NT threads; ends synchronized.  PBF: the
// Dense layers on the tensor cores, their activation operands rounded to
// bf16 into bf16 tiles in the normalized-obs tile's space (P holds the
// bf16 weights, stage_policy_bf16).
template <bool PBF>
__device__ __forceinline__ void policy_tile(const float *__restrict__ P,
                                            const float *__restrict__ ob,
                                            float *__restrict__ sm, int tid) {
    const int g = tid / TILE, c = tid % TILE;
    float *xn = sm + S_XN, *h1 = sm + S_H1, *h2 = sm + S_H2;
    float *st = sm + S_ST;
    const float *b = P + P_B;
    if constexpr (PBF) {
        uint16_t *xb = reinterpret_cast<uint16_t *>(xn);
        uint16_t *hb1 = xb + OBS * XS, *hb2 = hb1 + H * XS;
        const uint16_t *wb = reinterpret_cast<const uint16_t *>(P + P_W1);
        for (int i = tid; i < OBS * TILE; i += NT) {
            const int k = i / TILE;
            xb[k * XS + i % TILE] = f32_to_bf16(clampf(
                (ob[i] - P[P_NRM + 2 * k]) * P[P_NRM + 2 * k + 1], -5.0f,
                5.0f));
        }
        __syncthreads();
        dense_mma<OBS, W1S, H>(wb, xb, h1, b, 0, tid);
        __syncthreads();
        layer_norm_relu<true>(h1, b, 1, 2, st, tid, g, c, hb1);
        dense_mma<H, HS, H>(wb + H * W1S, hb1, h2, b, 3, tid);
        __syncthreads();
        layer_norm_relu<true>(h2, b, 4, 5, st, tid, g, c, hb2);
        dense_mma<H, HS, NL + 1>(wb + H * W1S + H * HS, hb2, sm + S_OUT, b,
                                 6, tid);
        __syncthreads();
    } else {
        for (int i = tid; i < OBS * TILE; i += NT) {
            const int k = i / TILE;
            xn[i] = clampf((ob[i] - P[P_NRM + 2 * k]) * P[P_NRM + 2 * k + 1],
                           -5.0f, 5.0f);
        }
        __syncthreads();
        dense<OBS, H / G>(P + P_W1, xn, h1, b, 0, g, c);
        __syncthreads();
        layer_norm_relu<false>(h1, b, 1, 2, st, tid, g, c);
        dense<H, H / G>(P + P_W2, h1, h2, b, 3, g, c);
        __syncthreads();
        layer_norm_relu<false>(h2, b, 4, 5, st, tid, g, c);
        dense<H, (NL + 1) / G>(P + P_WH, h2, sm + S_OUT, b, 6, g, c);
        __syncthreads();
    }
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

// FOLD: (feature, 32-world group) pairs of one tick's trainee obs rows
// (tr, rows 0..102 at worlds w0.. of the float32 trajectory; SMEM: the
// tile's float32 copy in shared memory, row stride TILE) over the warps of
// threads TILE..NT-1,
// FOLD_ILP pairs at a time so that their butterflies interleave; each
// pair: mean = butterfly sum / 32, M2 = butterfly sum of squared
// deviations, lane 0 writes pt[(g, k, 0..1)].
constexpr int FOLD_ILP = 6;

template <bool SMEM>
__device__ __forceinline__ void fold_tick(const float *tr,
                                          float *__restrict__ pt, int W,
                                          int w0, int ng, int tid) {
    constexpr int NW = (NT - TILE) / 32;
    const int lane = tid & 31, warp = (tid - TILE) >> 5;
    const int npairs = ROLL_OBS * ng;
    for (int p0 = warp * FOLD_ILP; p0 < npairs; p0 += NW * FOLD_ILP) {
        float raw[FOLD_ILP], v[FOLD_ILP];
#pragma unroll
        for (int j = 0; j < FOLD_ILP; ++j) {
            const int pr = min(p0 + j, npairs - 1);
            if (SMEM)
                raw[j] = tr[(pr / ng) * TILE + 32 * (pr % ng) + lane];
            else  // L2 reads: the rows were written by this CTA this tick
                raw[j] = __ldcg(tr + (size_t)(pr / ng) * W + w0 +
                                32 * (pr % ng) + lane);
            v[j] = raw[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int j = 0; j < FOLD_ILP; ++j)
                v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
        float m[FOLD_ILP];
#pragma unroll
        for (int j = 0; j < FOLD_ILP; ++j) {
            m[j] = v[j] * (1.0f / 32.0f);
            const float d = raw[j] - m[j];
            v[j] = d * d;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int j = 0; j < FOLD_ILP; ++j)
                v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
        if (lane == 0) {
#pragma unroll
            for (int j = 0; j < FOLD_ILP; ++j) {
                const int pr = p0 + j;
                if (pr < npairs) {
                    float *q = pt + ((pr % ng) * ROLL_OBS + pr / ng) * 2;
                    q[0] = m[j];
                    q[1] = v[j];
                }
            }
        }
    }
}

// The T ticks of the tile of worlds [blockIdx.x * TILE, + TILE) (fewer in
// a last tile of W % TILE == 32 worlds).  FOLD: partials (T, W / 32,
// ROLL_OBS, 2) receive each tick's per-group (mean, M2) of the trainee's
// pre-tick obs.  TT: the trajectory's storage type; PBF: the bf16
// tensor-core policy; PROBE: a timing probe (see the header; with
// PROBE_NO_TRAJ, traj is (1, ROLL_ROWS, W)).
template <int TI, bool FROZEN, bool FOLD, class TT = float, bool PBF = false,
          int PROBE = PROBE_NONE>
__device__ __forceinline__ void rollout_tile(
    SimParams p, float *__restrict__ sf, int *__restrict__ si,
    float *__restrict__ obs, const float *__restrict__ pol,
    const float *__restrict__ fpol, const float *__restrict__ ext,
    TT *__restrict__ traj, float *__restrict__ partials, int W, int T,
    uint32_t k0, uint32_t k1, const int *__restrict__ tick_base,
    int world_base) {
    extern __shared__ float smem[];
    constexpr int FI = 1 - TI;
    constexpr bool F32T = sizeof(TT) == sizeof(float);
    // the fold reads a float32 copy of the obs rows in shared memory where
    // the trajectory holds no float32 rows of this tick
    constexpr bool SMEM_FOLD = !F32T || PROBE == PROBE_NO_TRAJ;
    float *sp = smem;
    float *sfp = smem + POL;
    float *sm = smem + (FROZEN ? 2 : 1) * POL;
    float *so = sm + S_OBS;
    const int tid = threadIdx.x;
    const int w0 = blockIdx.x * TILE;
    const int nw = min(TILE, W - w0);
    if constexpr (PBF) {
        // the Dense weights w1t | w2t | wht rounded to bf16 once
        stage_policy_bf16(sp, pol, tid);
        if (FROZEN) stage_policy_bf16(sfp, fpol, tid);
    } else {
        for (int i = tid; i < POL; i += NT) {
            sp[i] = pol[i];
            if (FROZEN) sfp[i] = fpol[i];
        }
    }
    if constexpr (PROBE == PROBE_NO_TRAJ)  // the one zero block, written once
        for (int i = tid; i < ROLL_ROWS * TILE; i += NT)
            if (i % TILE < nw)
                traj[(size_t)(i / TILE) * W + w0 + i % TILE] =
                    to_traj<TT>(0.0f);
    for (int i = tid; i < N_OBS_ROWS * TILE; i += NT)
        so[i] = i % TILE < nw ? obs[(size_t)(i / TILE) * W + w0 + i % TILE]
                              : 0.0f;
    const bool sim = tid < nw;
    const int w = w0 + tid;
    const uint32_t gw = (uint32_t)(world_base + w);  // Philox's world
    const int tb = ext == nullptr ? *tick_base : 0;
    World s;
    if (sim) load_world(s, sf, si, W, w);
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        const uint32_t tick = (uint32_t)(tb + t);
        const float *e =
            ext != nullptr ? ext + (size_t)t * EXT_CHUNK * W + w : nullptr;
        TT *tr =
            traj + (size_t)(PROBE == PROBE_NO_TRAJ ? 0 : t) * ROLL_ROWS * W;

        if constexpr (PROBE != PROBE_SIM_ONLY)
            policy_tile<PBF>(sp, so + TI * OBS * TILE, sm, tid);
        if constexpr (PROBE == PROBE_SIM_ONLY) {
            // no policy, no sampling: the action, logp, pad and value rows
            // 0; the tick runs on the actions the world holds
            if (sim) {
#pragma unroll
                for (int r = R_ACT; r <= R_VALUE; ++r)
                    tr[(size_t)r * W + w] = to_traj<TT>(0.0f);
            }
        } else if (sim) {
            float u[NL];
            if (e != nullptr) {
#pragma unroll
                for (int r = 0; r < NL; ++r) u[r] = e[(size_t)(EXT_TU + r) * W];
            } else {
                if constexpr (PROBE == PROBE_NO_PRNG) {
#pragma unroll
                    for (int r = 0; r < NL; ++r) u[r] = 0.5f;
                } else {
                    philox_draws<N_NOISE_ROWS, NL>(u, gw, tick, k0, k1);
                }
            }
            int act[6];
            const float logp = sample_tile(sm + S_OUT, u, tid, act);
            set_actions(s.ag[TI], act);
            if constexpr (PROBE != PROBE_NO_TRAJ) {
#pragma unroll
                for (int j = 0; j < 6; ++j)
                    tr[(size_t)(R_ACT + j) * W + w] =
                        to_traj<TT>((float)act[j]);
                tr[(size_t)R_LOGP * W + w] = to_traj<TT>(logp);
                tr[(size_t)(R_LOGP + 1) * W + w] = to_traj<TT>(0.0f);
                tr[(size_t)(R_LOGP + 2) * W + w] = to_traj<TT>(0.0f);
                tr[(size_t)R_VALUE * W + w] =
                    to_traj<TT>(sm[S_OUT + NL * TILE + tid]);
            }
        }
        if (FROZEN && PROBE != PROBE_SIM_ONLY) {
            __syncthreads();  // the logits tile is read before it is reused
            policy_tile<PBF>(sfp, so + FI * OBS * TILE, sm, tid);
            if (sim) {
                float u[NL];
                if (e != nullptr) {
#pragma unroll
                    for (int r = 0; r < NL; ++r)
                        u[r] = e[(size_t)(EXT_FU + r) * W];
                } else {
                    if constexpr (PROBE == PROBE_NO_PRNG) {
#pragma unroll
                        for (int r = 0; r < NL; ++r) u[r] = 0.5f;
                    } else {
                        philox_draws<N_NOISE_ROWS + NL, NL>(u, gw, tick,
                                                            k0, k1);
                    }
                }
                int act[6];
                sample_tile(sm + S_OUT, u, tid, act);
                set_actions(s.ag[FI], act);
            }
        }
        // the trainee's pre-tick obs rows, coalesced over the tile (bf16
        // storage with the fold: and their float32 copy into the free
        // normalized-obs tile, which the fold reads)
        const float *to = so + TI * OBS * TILE;
        float *xs = sm + S_XN;
        for (int i = tid; i < ROLL_OBS * TILE; i += NT)
            if (i % TILE < nw) {
                if constexpr (PROBE != PROBE_NO_TRAJ)
                    tr[(size_t)(i / TILE) * W + w0 + i % TILE] =
                        to_traj<TT>(to[i]);
                if (FOLD && SMEM_FOLD) xs[i] = to[i];
            }
        __syncthreads();  // the obs tile is read before the tick rewrites it

        // the warps that run no sim fold the tick's obs rows (just
        // written to the trajectory) while warps 0-1 step the worlds
        if (FOLD && tid >= TILE) {
            float *pt = partials +
                        ((size_t)t * (W >> 5) + (w0 >> 5)) * ROLL_OBS * 2;
            if (!SMEM_FOLD)
                fold_tick<false>(reinterpret_cast<const float *>(tr), pt, W,
                                 w0, nw >> 5, tid);
            else
                fold_tick<true>(xs, pt, W, w0, nw >> 5, tid);
        }
        if (sim) {
            if constexpr (PROBE != PROBE_POLICY_ONLY) {
                float nz[N_NOISE_ROWS];
                if (e != nullptr) {
#pragma unroll
                    for (int r = 0; r < N_NOISE_ROWS; ++r)
                        nz[r] = e[(size_t)r * W];
                } else {
                    if constexpr (PROBE == PROBE_NO_PRNG) {
#pragma unroll
                        for (int r = 0; r < N_NOISE_ROWS; ++r) nz[r] = 0.0f;
                    } else {
                        float u[N_NOISE_ROWS];
                        philox_draws<0, N_NOISE_ROWS>(u, gw, tick, k0, k1);
#pragma unroll
                        for (int r = 0; r < N_NOISE_ROWS - 1; ++r)
                            nz[r] = 2.0f * u[r] - 1.0f;
                        nz[N_NOISE_ROWS - 1] = u[N_NOISE_ROWS - 1];
                    }
                }
                step_world(p, s, nz, so, TILE, tid);
            }
            if constexpr (PROBE != PROBE_NO_TRAJ) {
                const bool tick_ran = PROBE != PROBE_POLICY_ONLY;
                tr[(size_t)R_REW * W + w] =
                    to_traj<TT>(tick_ran ? s.ag[TI].reward : 0.0f);
                tr[(size_t)R_DONE * W + w] =
                    to_traj<TT>(tick_ran ? s.ag[TI].done : 0.0f);
                for (int r = R_DONE + 1; r < ROLL_ROWS; ++r)
                    tr[(size_t)r * W + w] = to_traj<TT>(0.0f);
            }
        }
        __syncthreads();  // the new obs tile, before the next tick's policy
    }
    if (sim) store_world(s, sf, si, W, w);
    for (int i = tid; i < N_OBS_ROWS * TILE; i += NT)
        if (i % TILE < nw)
            obs[(size_t)(i / TILE) * W + w0 + i % TILE] = so[i];
}

// Launch KERNEL (a __global__ wrapper of rollout_tile) on W / TILE tiles.
template <bool FROZEN, class Kernel, class TT>
int launch_tiles(Kernel kernel, SimParams p, float *sf, int *si, float *obs,
                 const float *pol, const float *fpol, const float *ext,
                 TT *traj, float *partials, int W, int T, uint32_t k0,
                 uint32_t k1, const int *tick_base, int world_base,
                 cudaStream_t stream) {
    const size_t smem = ((FROZEN ? 2 : 1) * POL + S_END) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(W + TILE - 1) / TILE, NT, smem, stream>>>(
        p, sf, si, obs, pol, fpol, ext, traj, partials, W, T, k0, k1,
        tick_base, world_base);
    return (int)cudaGetLastError();
}

// Resident CTAs per SM of a tile kernel: out[0], its threads out[1] and
// dynamic shared memory out[2].
template <bool FROZEN, class Kernel>
int tile_occupancy(Kernel kernel, int *out) {
    const size_t smem = ((FROZEN ? 2 : 1) * POL + S_END) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    out[1] = NT;
    out[2] = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                              NT, smem);
}

}  // namespace rollout
}  // namespace mbb
