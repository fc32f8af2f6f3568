// The update kernels' per-tile arithmetic (kernels D, G and H,
// fused_update.cu), written once for nvcc and for g++ (host_update.cpp,
// tests/test_torch_update_tiles.py), as sim_world.cuh is for the sim.
//
// A tile is S = 64 samples of one minibatch.  Every activation lives in
// shared memory feature-major, row f at f * SP (SP = S + 4: a row is a
// whole number of 16-byte quads and the quad stride 17 is odd, so rows
// that differ by 1..7 start in different quad banks).  A CTA of NT = 256
// threads (8 warps) runs the tile as N_STAGES stages.  Warp w owns the
// tile's samples 8 w .. 8 w + 7 from their load to the end of the
// backward pass: stages 0..15 read and write only the warp's own sample
// columns, so a warp-wide barrier ends each; only the weight gradient
// (stage 16) reads every sample, between two CTA-wide barriers
// (CTA_BARRIERS, WARP_BARRIERS).  Every stage reads what it needs before
// it stores (a shared-memory store between two reads keeps the compiler
// from issuing the reads together: they may alias).  A stage never reads what another thread
// writes in the same stage, so the host build runs each stage for thread
// 0, 1, ... in turn and gets the card's bits up to libm and FMA
// contraction.
//
//   prep        normalize the obs rows (clamp +-5), a ones row for the
//               first layer's bias, the side rows from ustats
//   fwd1/fwd2   Z = W X + b as a register-blocked tile product, each
//               output one FMA chain over k (the plain product's order):
//               a lane 4 units x 2 samples, one float4 of weights and one
//               float2 of activations per k (8 FMAs); a warp's lanes 8
//               unit groups x its 4 sample pairs
//   ln stats    lane 4 s + q of a warp: quarter q (units 8q..8q+7) of
//   ln apply    the warp's sample s; partial sums in shared memory,
//               combined in quarter order -> hhat, ReLU.  A quarter walks
//               its units rotated by 2q (qunit), so the warp's four
//               quarters of a sample hit four bank octets; the sums still
//               run in unit order (load_quarter)
//   heads       the 19 logits + value
//   loss1/2     the four lanes of a sample split its 6 action buckets:
//               softmax shifted by the global max, log p, entropy (the
//               sums in bucket order); then its 19 logits, 5 a lane, for
//               the PPO cotangents (the selected log-prob summed in
//               bucket order)
//   bwd         dA2 = Wh^T dO, the LayerNorm / ReLU backward as above,
//               dA1 = W2^T dZ2
//   wgrad       the weight gradients dW1 = dZ1 X^T (its ones row gives
//               the first bias), dW2 = dZ2 A1^T, dWh = dO A2^T as 312
//               4 x 4 tiles over the samples, four samples a step (eight
//               float4 loads feed 64 FMAs); a tile owns rows r + (R/4) i
//               and columns c + (C/4) j, so a warp's loads hit distinct
//               quad banks.  Every thread owns one tile, threads 0..223
//               a sample quarter of one of the other 56, threads 0..179
//               one of the 180 column sums of the LayerNorm and bias
//               gradients.  The sums live in the thread's registers
//               across all the CTA's tiles (struct GradAcc).
//
// Every sum runs in a fixed order; nothing uses atomics on floats.

#pragma once

#if defined(__CUDACC__)
#define MBU_HD __device__ __forceinline__
#define MBU_HHD __host__ __device__ __forceinline__
#define MBU_UNROLL _Pragma("unroll")
#else
#include <cmath>
#define MBU_HD inline
#define MBU_HHD inline
#define MBU_UNROLL
#endif

namespace mbb {
namespace update {

constexpr int D = 103;              // packed obs slots
constexpr int NB = 6;               // action buckets
constexpr int H = 32;               // hidden width
constexpr int NL = 19;              // logits
constexpr int NOUT = NL + 1;        // logits + value
constexpr int NBCOL = 8;
constexpr int R_ACT = D;            // trajectory rows: obs | actions | logp
constexpr int R_LOGP = D + NB;
constexpr int SIDE_ROWS = 8;
constexpr int OW1 = 0;              // flat parameter layout
constexpr int OW2 = OW1 + H * D;
constexpr int OWH = OW2 + H * H;
constexpr int OB = OWH + NOUT * H;
constexpr int P = OB + H * NBCOL;   // 5216

constexpr int S = 64;               // samples per tile
constexpr int NT = 256;             // threads per CTA
constexpr int NW = NT / 32;         // warps per CTA
constexpr int SW = S / NW;          // samples a warp owns: 8
constexpr int SP = S + 4;           // row stride of every activation tile
constexpr int DX = D + 1;           // obs rows + the ones row
constexpr int NEXTRA = NB + 4;      // actions | logp | value | adv | ret
// rows of one input buffer: obs (0..102), ones (103), extras (104..113)
constexpr int EX_ACT = DX, EX_LP = EX_ACT + NB, EX_V = EX_LP + 1,
              EX_ADV = EX_V + 1, EX_RET = EX_ADV + 1;
constexpr int IN_ROWS = DX + NEXTRA;  // 114

constexpr float LN_EPS = 1e-6f;
constexpr float ADAM_B1 = 0.9f, ADAM_B2 = 0.999f, ADAM_EPS = 1e-8f;
constexpr float OM_B1 = (float)(1.0 - 0.9), OM_B2 = (float)(1.0 - 0.999);

// ACTION_BUCKETS = (2, 8, 3, 2, 2, 2)
MBU_HD constexpr int bucket_n(int b) {
    return b == 1 ? 8 : (b == 2 ? 3 : 2);
}
MBU_HD constexpr int bucket_base(int b) {
    return b == 0 ? 0 : (b == 1 ? 2 : (b == 2 ? 10 : 11 + 2 * (b - 2)));
}
// the buckets of quarter q of a sample's lanes, the larger first: {1},
// {2, 0}, {3, 4}, {5}
MBU_HD constexpr int quarter_bucket(int q, int i) {
    return q == 0 ? (i == 0 ? 1 : -1)
         : q == 1 ? (i == 0 ? 2 : 0)
         : q == 2 ? 3 + i
                  : (i == 0 ? 5 : -1);
}

// ---- shared memory, in floats
// weights: w1 k-major (D, H) | w2 k-major (H, H) = w2t^T | w2t (H, H) |
// wh k-major (H, NOUT) = wht^T | wht (NOUT, H) | bias (H, NBCOL) | nrm
constexpr int SW_W1K = 0;
constexpr int SW_W2K = SW_W1K + D * H;
constexpr int SW_W2 = SW_W2K + H * H;
constexpr int SW_WHK = SW_W2 + H * H;
constexpr int SW_WH = SW_WHK + H * NOUT;
constexpr int SW_B = SW_WH + NOUT * H;
constexpr int SW_NRM = SW_B + H * NBCOL;
constexpr int SW_END = SW_NRM + 2 * D + 2;   // 16-byte multiple
// activation tiles (rows x SP)
constexpr int SA_H1 = SW_END;            // z1, then hhat1
constexpr int SA_A1 = SA_H1 + H * SP;    // relu(ln1)
constexpr int SA_H2 = SA_A1 + H * SP;    // z2, then hhat2
constexpr int SA_A2 = SA_H2 + H * SP;    // relu(ln2)
constexpr int SA_DO = SA_A2 + H * SP;    // logits + value, then dO
constexpr int SA_DY2 = SA_DO + NOUT * SP;  // dA2, then dY2 (ReLU'd)
constexpr int SA_DZ2 = SA_DY2 + H * SP;
constexpr int SA_DY1 = SA_DZ2 + H * SP;    // dA1, then dY1
constexpr int SA_DZ1 = SA_DY1 + H * SP;
// per-sample scratch
constexpr int SS_PART = SA_DZ1 + H * SP;   // (4 quarters, 2, S)
constexpr int SS_RSTD1 = SS_PART + 8 * S;
constexpr int SS_RSTD2 = SS_RSTD1 + S;
constexpr int SS_P = SS_RSTD2 + S;         // (NL, S) probabilities
constexpr int SS_HB = SS_P + NL * S;       // (NB, S) -entropy sums
constexpr int SS_LPB = SS_HB + NB * S;     // (NB, S) selected log p
constexpr int SS_LNP = SS_LPB + NB * S;    // (NL, S) log p
constexpr int SS_END = SS_LNP + NL * S;
// two input buffers (IN_ROWS x SP): the tile and the next one's loads
constexpr int SI_IN = SS_END;
constexpr int SM_FLOATS = SI_IN + 2 * IN_ROWS * SP;
static_assert(SW_END % 4 == 0 && SA_H1 % 4 == 0 && SI_IN % 4 == 0 &&
                  (IN_ROWS * SP) % 4 == 0, "16-byte aligned tiles");

// ---- weight-gradient tiles: 208 of dW1 (32 x 104), 64 of dW2 (32 x
// 32), 40 of dWh (20 x 32).  Thread t owns tile t over all samples; the
// 56 tiles after the first 256 are split in sample quarters over threads
// 0..223 (thread 4 e + q: quarter q of tile 256 + e), so every warp
// carries the same load; threads 0..179 also own one column sum, threads
// 180..223 write the 44 bias entries that are always zero.
constexpr int WT_W1 = 8 * 26, WT_W2 = 8 * 8, WT_WH = 5 * 8;
constexpr int N_WTILES = WT_W1 + WT_W2 + WT_WH;  // 312
constexpr int N_EXTRA = N_WTILES - NT;           // 56 tiles in quarters
constexpr int N_QUARTER = 4 * N_EXTRA;           // 224 threads
constexpr int N_COLSUMS = 5 * H + NOUT;          // 180
constexpr int N_ZEROS = (H - NOUT) + H;          // bias col 6 tail, col 7
static_assert(N_QUARTER <= NT && N_COLSUMS + N_ZEROS == N_QUARTER,
              "the zero entries after the column sums, within the quarter "
              "threads");

struct LossHp {
    float clip, vf_coef, ent_coef, inv_mb;
    int clip_vloss;
};

// A thread's gradient sums, kept across the CTA's tiles: its tile, its
// quarter of an extra tile, its column sum.
struct GradAcc {
    float t[16], q[16];
    float col;
};

struct F4 {
    float x, y, z, w;
};
struct F2 {
    float x, y;
};

MBU_HD F4 ld4(const float *p) {
#if defined(__CUDACC__)
    const float4 v = *reinterpret_cast<const float4 *>(p);
    return {v.x, v.y, v.z, v.w};
#else
    return {p[0], p[1], p[2], p[3]};
#endif
}

MBU_HD F2 ld2(const float *p) {
#if defined(__CUDACC__)
    const float2 v = *reinterpret_cast<const float2 *>(p);
    return {v.x, v.y};
#else
    return {p[0], p[1]};
#endif
}

MBU_HD void st2(float *p, float a, float b) {
#if defined(__CUDACC__)
    *reinterpret_cast<float2 *>(p) = make_float2(a, b);
#else
    p[0] = a;
    p[1] = b;
#endif
}

MBU_HD float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// a product rounded on its own, never contracted into an FMA (the host
// build is compiled with -ffp-contract=off)
MBU_HD float mul_rn(float a, float b) {
#if defined(__CUDACC__)
    return __fmul_rn(a, b);
#else
    return a * b;
#endif
}

MBU_HD float rsqrt_(float x) {
#if defined(__CUDACC__)
    return rsqrtf(x);
#else
    return 1.0f / sqrtf(x);
#endif
}

// ---- the weights into shared memory (for i = tid; i < n; i += NT)
MBU_HD void load_weights(float *sm, const float *params, const float *nrm,
                         int tid) {
    for (int i = tid; i < H * D; i += NT) {      // w1t (H, D) -> (D, H)
        const int k = i / H, u = i % H;
        sm[SW_W1K + i] = params[OW1 + u * D + k];
    }
    for (int i = tid; i < H * H; i += NT) {
        const int a = i / H, b = i % H;
        sm[SW_W2K + i] = params[OW2 + b * H + a];  // [u][j] = w2t[j][u]
        sm[SW_W2 + i] = params[OW2 + i];
    }
    for (int i = tid; i < H * NOUT; i += NT) {
        const int j = i / NOUT, o = i % NOUT;
        sm[SW_WHK + i] = params[OWH + o * H + j];  // [j][o] = wht[o][j]
        sm[SW_WH + i] = params[OWH + i];
    }
    for (int i = tid; i < H * NBCOL; i += NT) sm[SW_B + i] = params[OB + i];
    for (int i = tid; i < 2 * D; i += NT) sm[SW_NRM + i] = nrm[i];
}

MBU_HD void zero_acc(GradAcc &a) {
    for (int j = 0; j < 16; ++j) a.t[j] = a.q[j] = 0.0f;
    a.col = 0.0f;
}

// ---- the thread map of stages 0..15: warp w's samples SW w .. SW w + 7;
// in the row-wise stages lane 4 s + q is quarter q of the warp's sample s
MBU_HD int warp_sample0(int tid) { return SW * (tid >> 5); }
MBU_HD int row_sample(int tid) { return warp_sample0(tid) + ((tid & 31) >> 2); }
MBU_HD int row_quarter(int tid) { return tid & 3; }

// the unit quarter q visits at step t: its 8 units rotated by 2q, so that
// at every step the four quarters of a sample read rows 4 apart mod 8,
// in four different bank octets (row u starts at bank 4u mod 32)
MBU_HD int qunit(int q, int t) { return 8 * q + ((t + 2 * q) & 7); }

// v[j] = p[(8q + j) * SP], j = 0..7: loaded in qunit order, then rotated
// back (by 2 where q is odd, by 4 where q >= 2) with selects
MBU_HD void unrotate(float (&r)[8], int q) {
    float t[8];
    for (int j = 0; j < 8; ++j) t[j] = (q & 1) ? r[(j + 6) & 7] : r[j];
    for (int j = 0; j < 8; ++j) r[j] = (q & 2) ? t[(j + 4) & 7] : t[j];
}

MBU_HD void load_quarter(const float *p, int q, float (&v)[8]) {
    for (int t = 0; t < 8; ++t) v[t] = p[qunit(q, t) * SP];
    unrotate(v, q);
}

// ---- stage 0: normalize the warp's columns of the tile in buffer `in`
// (raw rows loaded, the samples >= n zero-filled); lane 8 g + c takes
// sample c at rows 8 (j / 2) + 2 g + j % 2, so a step's four rows sit in
// four bank octets
MBU_HD int prep_row(int j, int g) { return 8 * (j >> 1) + 2 * g + (j & 1); }

MBU_HD void stage_prep(float *sm, float *in, int n, const float *ustats,
                       int tid) {
    const float *mean = sm + SW_NRM, *rstd = sm + SW_NRM + D;
    const int lane = tid & 31, g = lane >> 3;
    const int s = warp_sample0(tid) + (lane & 7);
    constexpr int NJ = 2 * ((D + 7) / 8);   // 26 steps of 4 rows: 0..103
    float x[NJ], m[NJ], r[NJ];
    MBU_UNROLL
    for (int j = 0; j < NJ; ++j) {
        const int k = prep_row(j, g);
        x[j] = m[j] = r[j] = 0.0f;
        if (k < D) {
            x[j] = in[k * SP + s];
            m[j] = mean[k];
            r[j] = rstd[k];
        }
    }
    MBU_UNROLL
    for (int j = 0; j < NJ; ++j) {
        const int k = prep_row(j, g);
        if (k < D)
            in[k * SP + s] =
                s < n ? clampf((x[j] - m[j]) * r[j], -5.0f, 5.0f) : 0.0f;
    }
    if (g == 0) {
        in[D * SP + s] = s < n ? 1.0f : 0.0f;
        if (ustats != nullptr && s < n) {
            const float vm = ustats[0], vr = ustats[1];
            const float am = ustats[2], ar = ustats[3];
            float *v = in + EX_V * SP + s, *a = in + EX_ADV * SP + s,
                  *r = in + EX_RET * SP + s;
            const float v0 = *v, a0 = *a, r0 = *r;
            *v = clampf((v0 - vm) * vr, -5.0f, 5.0f);
            *a = (a0 - am) * ar;
            *r = clampf((r0 - vm) * vr, -5.0f, 5.0f);
        }
    }
}

// ---- tile product Y[m][s] = sum_k Wk[k][m] X[k][s] (+ bias column bc)
// in float32: each output one FMA chain over k in ascending order from 0,
// then the bias, as the plain version's matrix product computes it.  The
// forward products feed LayerNorms, whose hhat = (z - mean) * rstd turns
// z's absolute rounding into the error of a unit near its mean, where the
// ReLU decides; keeping the plain chain keeps those decisions equal.  A
// thread owns 4 consecutive outputs m x 2 consecutive samples (one float4
// of weights, one float2 of activations, 8 FMAs per k); a warp covers its
// own 4 sample pairs x all 8 output groups (each k: 8 float4 of weights
// in one 128-byte row segment, 4 float2 of activations broadcast).
template <int K, int M>
MBU_HD void tile_product(const float *wk, const float *x, float *y,
                         const float *bias, int bc, int tid) {
    const int lane = tid & 31;
    const int ug = lane >> 2;                        // 0..7
    const int sg = warp_sample0(tid) / 2 + (lane & 3);  // 0..31
    if (4 * ug >= M) return;
    float acc[4][2];
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.0f;
#if defined(__CUDACC__)
#pragma unroll 8
#endif
    for (int k = 0; k < K; ++k) {
        const F4 w = ld4(wk + k * M + 4 * ug);
        const F2 v = ld2(x + k * SP + 2 * sg);
        acc[0][0] += w.x * v.x;
        acc[0][1] += w.x * v.y;
        acc[1][0] += w.y * v.x;
        acc[1][1] += w.y * v.y;
        acc[2][0] += w.z * v.x;
        acc[2][1] += w.z * v.y;
        acc[3][0] += w.w * v.x;
        acc[3][1] += w.w * v.y;
    }
    for (int i = 0; i < 4; ++i) {
        const int m = 4 * ug + i;
        const float b = bias != nullptr ? bias[m * NBCOL + bc] : 0.0f;
        st2(y + m * SP + 2 * sg, acc[i][0] + b, acc[i][1] + b);
    }
}

// ---- LayerNorm forward: 4 lanes a sample, units 8q..8q+7.  Every
// product rounds on its own and the sums run in this unit order, as the
// plain version's (fused_update.py `_ln_fwd`: z * z, mu * mu and hhat * g
// each rounded): hhat = (z - mean) * rstd turns an ulp of the layer's
// inputs into the error of a unit near its mean, where the ReLU decides,
// so an FMA in layer 1's output, or in the statistics, moves layer 2's
// ReLU sides by far more than the last bit.
MBU_HD void stage_ln_stats(float *sm, const float *z, int tid) {
    const int s = row_sample(tid), q = row_quarter(tid);
    float v[8];
    load_quarter(z + s, q, v);
    float s1 = 0.0f, s2 = 0.0f;
    for (int j = 0; j < 8; ++j) {
        s1 += v[j];
        s2 += mul_rn(v[j], v[j]);
    }
    sm[SS_PART + (2 * q) * S + s] = s1;
    sm[SS_PART + (2 * q + 1) * S + s] = s2;
}

MBU_HD void quarter_sums(const float *sm, int s, float &a, float &b) {
    a = sm[SS_PART + 0 * S + s];
    b = sm[SS_PART + 1 * S + s];
    for (int q = 1; q < 4; ++q) {
        a += sm[SS_PART + (2 * q) * S + s];
        b += sm[SS_PART + (2 * q + 1) * S + s];
    }
}

// the quarter's 8 units of column p (rows at stride SP) and of bias
// columns c0, c1 (or only c0 where b is null), in qunit order
MBU_HD void load_units(const float *sm, const float *p, int q, int c0,
                       float (&x)[8], float (&g)[8], float *b) {
    const float *bias = sm + SW_B;
    for (int t = 0; t < 8; ++t) {
        const int u = qunit(q, t);
        x[t] = p[u * SP];
        g[t] = bias[u * NBCOL + c0];
        if (b != nullptr) b[t] = bias[u * NBCOL + c0 + 1];
    }
}

// z -> hhat in place, a = relu(hhat * scale + bias); rstd per sample
MBU_HD void stage_ln_apply(float *sm, float *h, float *a, int sc,
                           float *rstd_out, int tid) {
    const int s = row_sample(tid), q = row_quarter(tid);
    float s1, s2;
    quarter_sums(sm, s, s1, s2);
    float zv[8], gv[8], bv[8];
    load_units(sm, h + s, q, sc, zv, gv, bv);
    const float mu = s1 * (1.0f / H), mu2 = s2 * (1.0f / H);
    const float rstd = rsqrt_(fmaxf(mu2 - mul_rn(mu, mu), 0.0f) + LN_EPS);
    for (int t = 0; t < 8; ++t) {
        const int u = qunit(q, t);
        const float hh = (zv[t] - mu) * rstd;
        h[u * SP + s] = hh;
        a[u * SP + s] = fmaxf(mul_rn(hh, gv[t]) + bv[t], 0.0f);
    }
    if (q == 0) rstd_out[s] = rstd;
}

// ---- the loss.  The four lanes of a sample split its 6 action buckets
// (quarter_bucket) for part 1, whose sums run in bucket order (the
// denominators, the entropies), and its 19 logits as slots i = q + 4 j
// (j = 0..4) for part 2's cotangents.  Each value is the expression the
// plain version computes, over the same operands in the same order.
constexpr int N_SLOTS = (NL + 3) / 4;   // logit slots a lane: 5

MBU_HD int slot_logit(int q, int j) { return q + 4 * j; }

MBU_HD int bucket_of(int i) {
    return i < 2 ? 0 : (i < 10 ? 1 : (i < 13 ? 2 : (i < 15 ? 3
                                                   : (i < 17 ? 4 : 5))));
}

// a lane's buckets: bucket A (quarter_bucket(q, 0)) of up to 8 logits,
// and bucket B (quarter_bucket(q, 1)) of up to 2, or none (n_b 0)
constexpr int NB_A = 8, NB_B = 2;

struct LaneBuckets {
    int a, base_a, n_a, b, base_b, n_b;
};

MBU_HD LaneBuckets lane_buckets(int q) {
    LaneBuckets k;
    k.a = quarter_bucket(q, 0);
    k.base_a = bucket_base(k.a);
    k.n_a = bucket_n(k.a);
    k.b = quarter_bucket(q, 1);
    k.base_b = k.b < 0 ? 0 : bucket_base(k.b);
    k.n_b = k.b < 0 ? 0 : bucket_n(k.b);
    return k;
}

// ---- loss, part 1 in one stage: each lane its buckets (lane_buckets),
// straight-line with the absent logits predicated off: the global max
// over the logits, e = exp(logit - max), the bucket's sum of e (in
// order), log-normalizer log(sum) + max, p = e / sum, log p = logit -
// log-normalizer, the -entropy sum of p log p (in order) and the selected
// log p
MBU_HD void stage_loss1(float *sm, const float *in, int tid) {
    const int s = row_sample(tid), q = row_quarter(tid);
    const float *o = sm + SA_DO;
    const LaneBuckets k = lane_buckets(q);
    // every logit for the max, and the lane's buckets' logits again (a
    // register array takes no index known only at run time)
    float ov[NL], oa[NB_A], ob[NB_B];
    for (int i = 0; i < NL; ++i) ov[i] = o[i * SP + s];
    for (int r = 0; r < NB_A; ++r)
        oa[r] = r < k.n_a ? o[(k.base_a + r) * SP + s] : 0.0f;
    for (int r = 0; r < NB_B; ++r)
        ob[r] = r < k.n_b ? o[(k.base_b + r) * SP + s] : 0.0f;
    const float ta = (float)k.base_a + in[(EX_ACT + k.a) * SP + s];
    const float tb = k.n_b > 0
        ? (float)k.base_b + in[(EX_ACT + k.b) * SP + s] : -1.0f;
    float M = ov[0];
    for (int i = 1; i < NL; ++i) M = fmaxf(M, ov[i]);
    float ea[NB_A], eb[NB_B], sa = 0.0f, sb = 0.0f;
    for (int r = 0; r < NB_A; ++r) {
        ea[r] = expf(oa[r] - M);
        if (r < k.n_a) sa += ea[r];
    }
    for (int r = 0; r < NB_B; ++r) {
        eb[r] = expf(ob[r] - M);
        if (r < k.n_b) sb += eb[r];
    }
    const float za = logf(sa) + M, zb = logf(k.n_b > 0 ? sb : 1.0f) + M;
    float ha = 0.0f, lpa = 0.0f, hb = 0.0f, lpb = 0.0f;
    float pa[NB_A], la[NB_A], pb[NB_B], lb[NB_B];
    for (int r = 0; r < NB_A; ++r) {
        pa[r] = ea[r] / sa;
        la[r] = oa[r] - za;
        if (r < k.n_a) {
            if ((float)(k.base_a + r) == ta) lpa = la[r];
            ha += pa[r] * la[r];
        }
    }
    for (int r = 0; r < NB_B; ++r) {
        pb[r] = eb[r] / (k.n_b > 0 ? sb : 1.0f);
        lb[r] = ob[r] - zb;
        if (r < k.n_b) {
            if ((float)(k.base_b + r) == tb) lpb = lb[r];
            hb += pb[r] * lb[r];
        }
    }
    for (int r = 0; r < NB_A; ++r)
        if (r < k.n_a) {
            sm[SS_P + (k.base_a + r) * S + s] = pa[r];
            sm[SS_LNP + (k.base_a + r) * S + s] = la[r];
        }
    for (int r = 0; r < NB_B; ++r)
        if (r < k.n_b) {
            sm[SS_P + (k.base_b + r) * S + s] = pb[r];
            sm[SS_LNP + (k.base_b + r) * S + s] = lb[r];
        }
    sm[SS_HB + k.a * S + s] = -ha;
    sm[SS_LPB + k.a * S + s] = lpa;
    if (k.n_b > 0) {
        sm[SS_HB + k.b * S + s] = -hb;
        sm[SS_LPB + k.b * S + s] = lpb;
    }
}

// ---- loss, part 2: the clipped-surrogate, value and entropy cotangents
// into SA_DO for the lane's slots (zero for the samples >= n; ties route
// to the first operand)
MBU_HD void stage_loss2(float *sm, const float *in, int n, LossHp hp,
                        int tid) {
    const int s = row_sample(tid), q = row_quarter(tid);
    float *o = sm + SA_DO;
    const bool valid = s < n;
    float lpb[NB];
    for (int b = 0; b < NB; ++b) lpb[b] = sm[SS_LPB + b * S + s];
    const float lp_old = in[EX_LP * SP + s], adv = in[EX_ADV * SP + s];
    float tv[N_SLOTS], hv[N_SLOTS], pv[N_SLOTS], lv[N_SLOTS];
    for (int j = 0; j < N_SLOTS; ++j) {
        const int i = slot_logit(q, j);
        tv[j] = hv[j] = pv[j] = lv[j] = 0.0f;
        if (i < NL) {
            const int b = bucket_of(i);
            tv[j] = (float)bucket_base(b) + in[(EX_ACT + b) * SP + s];
            hv[j] = sm[SS_HB + b * S + s];
            pv[j] = sm[SS_P + i * S + s];
            lv[j] = sm[SS_LNP + i * S + s];
        }
    }
    float logp_new = 0.0f;
    for (int b = 0; b < NB; ++b) logp_new += lpb[b];
    const float c = hp.clip;
    const float ratio = expf(logp_new - lp_old);
    const float surr1 = -adv * ratio;
    const float surr2 = -adv * clampf(ratio, 1.0f - c, 1.0f + c);
    const bool inb = (ratio >= 1.0f - c) && (ratio <= 1.0f + c);
    const float dratio = (surr1 >= surr2) ? -adv : (inb ? -adv : 0.0f);
    const float dlogp = dratio * ratio * hp.inv_mb;
    const float ec = hp.ent_coef * hp.inv_mb;
    float value = 0.0f, v_old = 0.0f, ret = 0.0f;
    if (q == 3) {
        value = o[NL * SP + s];
        v_old = in[EX_V * SP + s];
        ret = in[EX_RET * SP + s];
    }
    for (int j = 0; j < N_SLOTS; ++j) {
        const int i = slot_logit(q, j);
        if (i >= NL) continue;
        const float p = pv[j];
        const float oh = ((float)i == tv[j]) ? 1.0f : 0.0f;
        const float g = dlogp * (oh - p) + (ec * p) * (lv[j] + hv[j]);
        o[i * SP + s] = valid ? g : 0.0f;
    }
    if (q == 3) {
        float dvalue;
        if (hp.clip_vloss) {
            const float vf = (value - ret) * (value - ret);
            const float dv = value - v_old;
            const bool dv_in = (dv >= -c) && (dv <= c);
            const float vclip = v_old + clampf(dv, -c, c);
            const float vfc = (vclip - ret) * (vclip - ret);
            dvalue = (vf >= vfc) ? value - ret : (dv_in ? vclip - ret : 0.0f);
            dvalue = dvalue * (hp.vf_coef * hp.inv_mb);
        } else {
            dvalue = (value - ret) * (hp.vf_coef * hp.inv_mb);
        }
        o[NL * SP + s] = valid ? dvalue : 0.0f;
    }
}

// ---- LayerNorm + ReLU backward: da (in dy) -> dy = da where the ReLU
// passed (in qunit order), partial sums of dhhat and dhhat * hhat (in
// unit order)
MBU_HD void stage_ln_bwd_stats(float *sm, float *dy, const float *h, int sc,
                               int tid) {
    const int s = row_sample(tid), q = row_quarter(tid);
    float hv[8], gv[8], bv[8], dv[8];
    load_units(sm, h + s, q, sc, hv, gv, bv);
    for (int t = 0; t < 8; ++t) dv[t] = dy[qunit(q, t) * SP + s];
    for (int t = 0; t < 8; ++t) {
        const float y = mul_rn(hv[t], gv[t]) + bv[t];
        dv[t] = (y > 0.0f) ? dv[t] : 0.0f;
        dy[qunit(q, t) * SP + s] = dv[t];
    }
    unrotate(hv, q);
    unrotate(gv, q);
    unrotate(dv, q);
    float m1 = 0.0f, m2 = 0.0f;
    for (int j = 0; j < 8; ++j) {
        const float dh = dv[j] * gv[j];
        m1 += dh;
        m2 += dh * hv[j];
    }
    sm[SS_PART + (2 * q) * S + s] = m1;
    sm[SS_PART + (2 * q + 1) * S + s] = m2;
}

MBU_HD void stage_ln_bwd_apply(float *sm, const float *dy, const float *h,
                               float *dz, int sc, const float *rstd_in,
                               int tid) {
    const int s = row_sample(tid), q = row_quarter(tid);
    float m1, m2;
    quarter_sums(sm, s, m1, m2);
    const float rstd = rstd_in[s];
    float dv[8], gv[8], hv[8];
    load_units(sm, dy + s, q, sc, dv, gv, nullptr);
    for (int t = 0; t < 8; ++t) hv[t] = h[qunit(q, t) * SP + s];
    m1 *= (1.0f / H);
    m2 *= (1.0f / H);
    for (int t = 0; t < 8; ++t) {
        const float dh = dv[t] * gv[t];
        dz[qunit(q, t) * SP + s] = rstd * (dh - m1 - hv[t] * m2);
    }
}

// ---- weight gradients: tile w of the 312 -> (rows, cols, row group,
// column group, row step, column step) of its product
struct WTile {
    const float *a, *b;
    int r, c, rs, cs, mat;   // mat 0 dW1, 1 dW2, 2 dWh
};

MBU_HD WTile wtile(const float *sm, const float *in, int w) {
    WTile t;
    if (w < WT_W1) {
        t = {sm + SA_DZ1, in, w % 8, w / 8, 8, 26, 0};
    } else if (w < WT_W1 + WT_W2) {
        w -= WT_W1;
        t = {sm + SA_DZ2, sm + SA_A1, w % 8, w / 8, 8, 8, 1};
    } else {
        w -= WT_W1 + WT_W2;
        t = {sm + SA_DO, sm + SA_A2, w % 5, w / 5, 5, 8, 2};
    }
    return t;
}

// the flat parameter index of entry (row, col) of product `mat`
MBU_HD int wtile_param(int mat, int row, int col) {
    if (mat == 0) return col < D ? OW1 + row * D + col : OB + row * NBCOL;
    if (mat == 1) return OW2 + row * H + col;
    return OWH + row * H + col;
}

// samples [s0, s1) of tile t into acc, four samples a step
MBU_HD void wtile_accumulate(const WTile &t, float (&acc)[16], int s0,
                             int s1) {
#if defined(__CUDACC__)
#pragma unroll 2
#endif
    for (int s = s0; s < s1; s += 4) {
        F4 a[4], b[4];
        for (int i = 0; i < 4; ++i) a[i] = ld4(t.a + (t.r + t.rs * i) * SP + s);
        for (int j = 0; j < 4; ++j) b[j] = ld4(t.b + (t.c + t.cs * j) * SP + s);
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) {
                float &x = acc[4 * i + j];
                x += a[i].x * b[j].x;
                x += a[i].y * b[j].y;
                x += a[i].z * b[j].z;
                x += a[i].w * b[j].w;
            }
    }
}

// column sum e of the 180: (two rows to multiply, or one to sum, and
// the bias entry it belongs to)
MBU_HD void colsum_rows(const float *sm, int e, const float *&x,
                        const float *&y, int &param) {
    const int u = e % H, k = e / H;   // k: 0 dg1, 1 dbe1, 2 db2, 3 dg2, 4 dbe2
    y = nullptr;
    if (k == 0) {
        x = sm + SA_DY1 + u * SP;
        y = sm + SA_H1 + u * SP;
        param = OB + u * NBCOL + 1;
    } else if (k == 1) {
        x = sm + SA_DY1 + u * SP;
        param = OB + u * NBCOL + 2;
    } else if (k == 2) {
        x = sm + SA_DZ2 + u * SP;
        param = OB + u * NBCOL + 3;
    } else if (k == 3) {
        x = sm + SA_DY2 + u * SP;
        y = sm + SA_H2 + u * SP;
        param = OB + u * NBCOL + 4;
    } else if (k == 4) {
        x = sm + SA_DY2 + u * SP;
        param = OB + u * NBCOL + 5;
    } else {                          // dbh, e - 160 < NOUT
        x = sm + SA_DO + (e - 5 * H) * SP;
        param = OB + (e - 5 * H) * NBCOL + 6;
    }
}

MBU_HD void stage_wgrad(const float *sm, const float *in, GradAcc &acc,
                        int tid) {
    wtile_accumulate(wtile(sm, in, tid), acc.t, 0, S);
    if (tid < N_QUARTER) {
        const int q = tid % 4;
        wtile_accumulate(wtile(sm, in, NT + tid / 4), acc.q, q * (S / 4),
                         (q + 1) * (S / 4));
    }
    if (tid < N_COLSUMS) {
        const float *x, *y;
        int param;
        colsum_rows(sm, tid, x, y, param);
        float c = acc.col;
        for (int s = 0; s < S; s += 4) {
            const F4 a = ld4(x + s);
            if (y != nullptr) {
                const F4 b = ld4(y + s);
                c += a.x * b.x;
                c += a.y * b.y;
                c += a.z * b.z;
                c += a.w * b.w;
            } else {
                c += a.x;
                c += a.y;
                c += a.z;
                c += a.w;
            }
        }
        acc.col = c;
    }
}

// The thread's sums into its CTA's row of the partials (every one of the
// P entries is written by exactly one thread), in two steps with a
// barrier between: 1. each thread its tile, column sum or zeros, and its
// quarter sums into shared memory (over the activation tiles, whose last
// tile is done); 2. threads 0..55 add their extra tile's four quarters
// in quarter order.
constexpr int SQ_QUARTERS = SA_H1;
static_assert(N_QUARTER * 16 <= SS_PART - SA_H1, "quarters fit");

MBU_HD void write_partials(float *sm, const GradAcc &acc, float *out,
                           int tid, int step) {
    if (step == 0) {
        const WTile t = wtile(sm, nullptr, tid);
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j)
                out[wtile_param(t.mat, t.r + t.rs * i, t.c + t.cs * j)] =
                    acc.t[4 * i + j];
        if (tid < N_COLSUMS) {
            const float *x, *y;
            int param;
            colsum_rows(sm, tid, x, y, param);
            out[param] = acc.col;
        } else if (tid < N_QUARTER) {
            const int z = tid - N_COLSUMS;
            const int row = z < H - NOUT ? NOUT + z : z - (H - NOUT);
            out[OB + row * NBCOL + (z < H - NOUT ? 6 : 7)] = 0.0f;
        }
        if (tid < N_QUARTER)
            for (int k = 0; k < 16; ++k)
                sm[SQ_QUARTERS + tid * 16 + k] = acc.q[k];
    } else if (tid < N_EXTRA) {
        const WTile t = wtile(sm, nullptr, NT + tid);
        const float *qs = sm + SQ_QUARTERS + 4 * tid * 16;
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) {
                const int k = 4 * i + j;
                out[wtile_param(t.mat, t.r + t.rs * i, t.c + t.cs * j)] =
                    ((qs[k] + qs[16 + k]) + qs[32 + k]) + qs[48 + k];
            }
    }
}

// ---- one tile: the stages after the input buffer is loaded; the caller
// puts a barrier after each, CTA-wide where cta_barrier_after (the host
// build runs each stage for every thread in turn)
constexpr int N_STAGES = 17;
constexpr int WGRAD_STAGE = N_STAGES - 1;

// the barrier after stage st: CTA-wide after the last warp-scoped stage
// (every warp's samples ready for the weight gradient) and after the
// weight gradient (the next tile overwrites what it read), warp-wide after
// the others
MBU_HHD constexpr bool cta_barrier_after(int st) {
    return st >= WGRAD_STAGE - 1;
}

constexpr int count_cta_barriers() {
    int n = 0;
    for (int st = 0; st < N_STAGES; ++st) n += cta_barrier_after(st) ? 1 : 0;
    return n;
}

// barriers a tile: CTA-wide; warp-wide (the 15 after stages 0..14 and the
// arrival of the warp's input columns; the bf16 instances one more after
// the upcast of its staging columns)
constexpr int CTA_BARRIERS = count_cta_barriers();
constexpr int WARP_BARRIERS = N_STAGES - CTA_BARRIERS + 1;
constexpr int WARP_BARRIERS_BF16 = WARP_BARRIERS + 1;
static_assert(CTA_BARRIERS == 2 && WARP_BARRIERS == 16,
              "two CTA-wide barriers a tile, around the weight gradient");

MBU_HD void tile_stage(int stage, float *sm, float *in, int n,
                       const float *ustats, LossHp hp, GradAcc &acc,
                       int tid) {
    switch (stage) {
    case 0: stage_prep(sm, in, n, ustats, tid); break;
    case 1:
        tile_product<D, H>(sm + SW_W1K, in, sm + SA_H1, sm + SW_B, 0, tid);
        break;
    case 2: stage_ln_stats(sm, sm + SA_H1, tid); break;
    case 3:
        stage_ln_apply(sm, sm + SA_H1, sm + SA_A1, 1, sm + SS_RSTD1, tid);
        break;
    case 4:
        tile_product<H, H>(sm + SW_W2K, sm + SA_A1, sm + SA_H2, sm + SW_B, 3,
                           tid);
        break;
    case 5: stage_ln_stats(sm, sm + SA_H2, tid); break;
    case 6:
        stage_ln_apply(sm, sm + SA_H2, sm + SA_A2, 4, sm + SS_RSTD2, tid);
        break;
    case 7:
        tile_product<H, NOUT>(sm + SW_WHK, sm + SA_A2, sm + SA_DO, sm + SW_B,
                              6, tid);
        break;
    case 8: stage_loss1(sm, in, tid); break;
    case 9: stage_loss2(sm, in, n, hp, tid); break;
    case 10:
        tile_product<NOUT, H>(sm + SW_WH, sm + SA_DO, sm + SA_DY2, nullptr, 0,
                              tid);
        break;
    case 11: stage_ln_bwd_stats(sm, sm + SA_DY2, sm + SA_H2, 4, tid); break;
    case 12:
        stage_ln_bwd_apply(sm, sm + SA_DY2, sm + SA_H2, sm + SA_DZ2, 4,
                           sm + SS_RSTD2, tid);
        break;
    case 13:
        tile_product<H, H>(sm + SW_W2, sm + SA_DZ2, sm + SA_DY1, nullptr, 0,
                           tid);
        break;
    case 14: stage_ln_bwd_stats(sm, sm + SA_DY1, sm + SA_H1, 1, tid); break;
    case 15:
        stage_ln_bwd_apply(sm, sm + SA_DY1, sm + SA_H1, sm + SA_DZ1, 1,
                           sm + SS_RSTD1, tid);
        break;
    default: stage_wgrad(sm, in, acc, tid); break;   // WGRAD_STAGE
    }
}

// ---- the reduce: CTA c owns parameters [32 c, 32 c + 32); thread (p, ch)
// = (tid % 32, tid / 32) sums the partial rows ch, ch + 8, ... in order,
// then the 8 chunk sums are added in chunk order
constexpr int RED_NT = 1024;
constexpr int RED_CH = RED_NT / 32;
constexpr int RED_CTAS = (P + 31) / 32;   // 163

MBU_HD float chunk_sum(const float *partials, int nparts, int p, int ch) {
    float g = 0.0f;
    int c = ch;
    for (; c + 3 * RED_CH < nparts; c += 4 * RED_CH) {
        const float v0 = partials[(size_t)c * P + p];
        const float v1 = partials[(size_t)(c + RED_CH) * P + p];
        const float v2 = partials[(size_t)(c + 2 * RED_CH) * P + p];
        const float v3 = partials[(size_t)(c + 3 * RED_CH) * P + p];
        g += v0;
        g += v1;
        g += v2;
        g += v3;
    }
    for (; c < nparts; c += RED_CH) g += partials[(size_t)c * P + p];
    return g;
}

// the sum of 32 values v[0..32) in the order of a butterfly over a warp
// (xor 16, 8, 4, 2, 1), as lane 0 holds it
MBU_HD float butterfly32(float (&v)[32]) {
    for (int o = 16; o > 0; o >>= 1)
        for (int l = 0; l < o; ++l) v[l] = v[l] + v[l + o];
    return v[0];
}

// lane l's share of the slices' sums of squares: slices l, l + 32, ...
// in order (then a butterfly over the lanes gives the total)
MBU_HD float lane_slices(const float *sq, int n, int l) {
    float v = 0.0f;
    for (int c = l; c < n; c += 32) v += sq[c];
    return v;
}

// clip + Adam of one parameter, norm gn, bias corrections bc1, bc2
MBU_HD void adam_one(float g, float gn, float max_norm, float lr,
                     float bc1, float bc2, float &param, float &m_,
                     float &v_) {
    const bool small = gn < max_norm;
    const float u = small ? g : (g / gn) * max_norm;
    const float m = OM_B1 * u + ADAM_B1 * m_;
    const float v = OM_B2 * (u * u) + ADAM_B2 * v_;
    m_ = m;
    v_ = v;
    param = param - lr * ((m / bc1) / (sqrtf(v / bc2) + ADAM_EPS));
}

MBU_HD float bias_correction(float b, int t) {
    return 1.0f - powf(b, (float)t);
}

}  // namespace update
}  // namespace mbb
