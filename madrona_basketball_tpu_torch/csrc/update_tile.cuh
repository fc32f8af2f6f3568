// The update kernels' per-tile arithmetic (kernels D, G and H,
// fused_update.cu), written once for nvcc and for g++ (host_update.cpp,
// tests/test_torch_update_tiles.py), as sim_world.cuh is for the sim.
//
// A tile is S = 64 samples of one minibatch.  Every activation lives in
// shared memory feature-major, row f at f * SP (SP = S + 4: a row is a
// whole number of 16-byte quads and the quad stride 17 is odd, so rows
// that differ by 1..7 start in different quad banks).  A CTA of NT = 256
// threads runs the tile as N_STAGES stages separated by barriers; a stage
// never reads what another thread writes in the same stage, so the host
// build runs each stage for thread 0, 1, ... in turn and gets the card's
// bits up to libm and FMA contraction.
//
//   prep        normalize the obs rows (clamp +-5), a ones row for the
//               first layer's bias, the side rows from ustats
//   fwd1/fwd2   Z = W X + b as a register-blocked tile product, each
//               output one FMA chain over k (the plain product's order):
//               a thread 4 units x 2 samples, one float4 of weights and
//               one float2 of activations per k (8 FMAs)
//   ln stats    4 threads per sample, 8 units each, partial sums in
//   ln apply    shared memory, combined in quarter order -> hhat, ReLU
//   heads       the 19 logits + value
//   loss1/2     4 threads per sample split the 6 action buckets: softmax
//               shifted by the global max, log p, entropy, then the PPO
//               cotangents (the selected log-prob summed in bucket order)
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
#else
#include <cmath>
#define MBU_HD inline
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
// the buckets of quarter q of a sample's threads: {1}, {0, 2}, {3, 4}, {5}
MBU_HD constexpr int quarter_bucket(int q, int i) {
    return q == 0 ? (i == 0 ? 1 : -1)
         : q == 1 ? (i == 0 ? 0 : 2)
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

// ---- stage 0: normalize the tile in buffer `in` (raw rows loaded, the
// samples >= n zero-filled)
MBU_HD void stage_prep(float *sm, float *in, int n, const float *ustats,
                       int tid) {
    const float *mean = sm + SW_NRM, *rstd = sm + SW_NRM + D;
    for (int i = tid; i < D * S; i += NT) {
        const int k = i / S, s = i % S;
        float *x = in + k * SP + s;
        *x = s < n ? clampf((*x - mean[k]) * rstd[k], -5.0f, 5.0f) : 0.0f;
    }
    if (tid < S) {
        const int s = tid;
        in[D * SP + s] = s < n ? 1.0f : 0.0f;
        if (ustats != nullptr && s < n) {
            const float vm = ustats[0], vr = ustats[1];
            const float am = ustats[2], ar = ustats[3];
            float *v = in + EX_V * SP + s, *a = in + EX_ADV * SP + s,
                  *r = in + EX_RET * SP + s;
            *v = clampf((*v - vm) * vr, -5.0f, 5.0f);
            *a = (*a - am) * ar;
            *r = clampf((*r - vm) * vr, -5.0f, 5.0f);
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
// of weights, one float2 of activations, 8 FMAs per k); a warp covers 2
// output groups x 16 sample pairs (weights broadcast, activations one
// 128-byte row segment).
template <int K, int M>
MBU_HD void tile_product(const float *wk, const float *x, float *y,
                         const float *bias, int bc, int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    const int ug = (warp & 3) * 2 + (lane >> 4);     // 0..7
    const int sg = (warp >> 2) * 16 + (lane & 15);   // 0..31
    if (4 * ug >= M) return;
    float acc[4][2];
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.0f;
#if defined(__CUDACC__)
#pragma unroll 4
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

// ---- LayerNorm forward: 4 threads a sample, units 8q..8q+7.  Every
// product rounds on its own and the sums run in this unit order, as the
// plain version's (fused_update.py `_ln_fwd`: z * z, mu * mu and hhat * g
// each rounded): hhat = (z - mean) * rstd turns an ulp of the layer's
// inputs into the error of a unit near its mean, where the ReLU decides,
// so an FMA in layer 1's output, or in the statistics, moves layer 2's
// ReLU sides by far more than the last bit.
MBU_HD void stage_ln_stats(float *sm, const float *z, int tid) {
    const int s = tid & (S - 1), q = tid / S;
    float s1 = 0.0f, s2 = 0.0f;
    for (int u = 8 * q; u < 8 * q + 8; ++u) {
        const float v = z[u * SP + s];
        s1 += v;
        s2 += mul_rn(v, v);
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

// z -> hhat in place, a = relu(hhat * scale + bias); rstd per sample
MBU_HD void stage_ln_apply(float *sm, float *h, float *a, int sc,
                           float *rstd_out, int tid) {
    const int s = tid & (S - 1), q = tid / S;
    float s1, s2;
    quarter_sums(sm, s, s1, s2);
    const float mu = s1 * (1.0f / H), mu2 = s2 * (1.0f / H);
    const float rstd = rsqrt_(fmaxf(mu2 - mul_rn(mu, mu), 0.0f) + LN_EPS);
    const float *bias = sm + SW_B;
    for (int u = 8 * q; u < 8 * q + 8; ++u) {
        const float hh = (h[u * SP + s] - mu) * rstd;
        h[u * SP + s] = hh;
        a[u * SP + s] = fmaxf(
            mul_rn(hh, bias[u * NBCOL + sc]) + bias[u * NBCOL + sc + 1],
            0.0f);
    }
    if (q == 0) rstd_out[s] = rstd;
}

// ---- loss, part 1: per bucket softmax shifted by the global max over the
// logits: probabilities, log p, -entropy, selected log p
MBU_HD void stage_loss1(float *sm, const float *in, int tid) {
    const int s = tid & (S - 1), q = tid / S;
    const float *o = sm + SA_DO;
    float M = o[s];
    for (int i = 1; i < NL; ++i) M = fmaxf(M, o[i * SP + s]);
    for (int bi = 0; bi < 2; ++bi) {
        const int b = quarter_bucket(q, bi);
        if (b < 0) continue;
        const int base = bucket_base(b), nb = bucket_n(b);
        const float target = (float)base + in[(EX_ACT + b) * SP + s];
        float Sb = 0.0f;
        for (int r = 0; r < nb; ++r) {
            const float e = expf(o[(base + r) * SP + s] - M);
            sm[SS_P + (base + r) * S + s] = e;
            Sb += e;
        }
        const float logz = logf(Sb) + M;
        float hb = 0.0f, lpt = 0.0f;
        for (int r = 0; r < nb; ++r) {
            const int i = base + r;
            const float p = sm[SS_P + i * S + s] / Sb;
            const float l = o[i * SP + s] - logz;
            sm[SS_P + i * S + s] = p;
            sm[SS_LNP + i * S + s] = l;
            if ((float)i == target) lpt = l;
            hb += p * l;
        }
        sm[SS_HB + b * S + s] = -hb;
        sm[SS_LPB + b * S + s] = lpt;
    }
}

// ---- loss, part 2: the clipped-surrogate, value and entropy cotangents
// into SA_DO (zero for the samples >= n; ties route to the first operand)
MBU_HD void stage_loss2(float *sm, const float *in, int n, LossHp hp,
                        int tid) {
    const int s = tid & (S - 1), q = tid / S;
    float *o = sm + SA_DO;
    const bool valid = s < n;
    float logp_new = 0.0f;
    for (int b = 0; b < NB; ++b) logp_new += sm[SS_LPB + b * S + s];
    const float lp_old = in[EX_LP * SP + s], adv = in[EX_ADV * SP + s];
    const float c = hp.clip;
    const float ratio = expf(logp_new - lp_old);
    const float surr1 = -adv * ratio;
    const float surr2 = -adv * clampf(ratio, 1.0f - c, 1.0f + c);
    const bool inb = (ratio >= 1.0f - c) && (ratio <= 1.0f + c);
    const float dratio = (surr1 >= surr2) ? -adv : (inb ? -adv : 0.0f);
    const float dlogp = dratio * ratio * hp.inv_mb;
    const float ec = hp.ent_coef * hp.inv_mb;
    for (int bi = 0; bi < 2; ++bi) {
        const int b = quarter_bucket(q, bi);
        if (b < 0) continue;
        const int base = bucket_base(b), nb = bucket_n(b);
        const float target = (float)base + in[(EX_ACT + b) * SP + s];
        const float HB = sm[SS_HB + b * S + s];
        for (int r = 0; r < nb; ++r) {
            const int i = base + r;
            const float p = sm[SS_P + i * S + s];
            const float oh = ((float)i == target) ? 1.0f : 0.0f;
            const float g =
                dlogp * (oh - p) + (ec * p) * (sm[SS_LNP + i * S + s] + HB);
            o[i * SP + s] = valid ? g : 0.0f;
        }
    }
    if (q == 3) {
        const float value = o[NL * SP + s];
        const float v_old = in[EX_V * SP + s], ret = in[EX_RET * SP + s];
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
// passed, partial sums of dhhat and dhhat * hhat
MBU_HD void stage_ln_bwd_stats(float *sm, float *dy, const float *h, int sc,
                               int tid) {
    const int s = tid & (S - 1), q = tid / S;
    const float *bias = sm + SW_B;
    float m1 = 0.0f, m2 = 0.0f;
    for (int u = 8 * q; u < 8 * q + 8; ++u) {
        const float hh = h[u * SP + s];
        const float g = bias[u * NBCOL + sc];
        const float y = mul_rn(hh, g) + bias[u * NBCOL + sc + 1];
        const float d = (y > 0.0f) ? dy[u * SP + s] : 0.0f;
        dy[u * SP + s] = d;
        const float dh = d * g;
        m1 += dh;
        m2 += dh * hh;
    }
    sm[SS_PART + (2 * q) * S + s] = m1;
    sm[SS_PART + (2 * q + 1) * S + s] = m2;
}

MBU_HD void stage_ln_bwd_apply(float *sm, const float *dy, const float *h,
                               float *dz, int sc, const float *rstd_in,
                               int tid) {
    const int s = tid & (S - 1), q = tid / S;
    float m1, m2;
    quarter_sums(sm, s, m1, m2);
    m1 *= (1.0f / H);
    m2 *= (1.0f / H);
    const float rstd = rstd_in[s];
    const float *bias = sm + SW_B;
    for (int u = 8 * q; u < 8 * q + 8; ++u) {
        const float dh = dy[u * SP + s] * bias[u * NBCOL + sc];
        dz[u * SP + s] = rstd * (dh - m1 - h[u * SP + s] * m2);
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
// puts a barrier after each (the host build runs each stage for every
// thread in turn)
constexpr int N_STAGES = 17;

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
    default: stage_wgrad(sm, in, acc, tid); break;
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
