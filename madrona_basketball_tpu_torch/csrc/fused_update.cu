// Kernels D, G and H: the PPO update phase, one minibatch gradient over
// permuted trajectory blocks, and one over a row-major feat matrix.
//
// Replace the Pallas kernels of madrona_basketball_tpu/ops/fused_update.py:
//   D make_fused_update_phase (:457, pallas_call :636), body _block_grads
//     (:153) plus the clip + Adam of :569-592;
//   G make_fused_minibatch_grad_prefetch (:326, :413);
//   H make_fused_minibatch_grad (:249, :287).
//
// On the TPU one grid walks every block in order and accumulates the
// gradient in VMEM.  Here a minibatch is two launches:
//   * update_grad_kernel: G <= max_parts CTAs of S = 128 threads; tile u
//     (S samples of one wb-wide block at one tick, or S feat rows) goes
//     to CTA u % G.  One thread per sample runs the forward and the
//     hand-derived backward with the weights and every activation /
//     cotangent column in shared memory (feature-major, row stride S + 1
//     so the weight-gradient loops read without bank conflicts); then the
//     CTA's threads form the 5216 weight-gradient sums over the tile's
//     samples and add them to the CTA's sums in shared memory (each entry
//     owned by one thread), written to its row of `partials` at the end.
//   * update_reduce_kernel: one CTA sums the partials in CTA order, then
//     (D) forms the global norm and applies clip + Adam in place, or
//     (G, H) writes the gradient.
// Every sum runs in a fixed order and nothing uses atomics, so a launch
// on the same inputs gives the same bits.  D issues all E x M minibatch
// pairs from one host call (mbb_fused_update_phase).
//
// Bound: operations.  ~5.0 k multiply-adds forward and ~6.6 k backward
// per sample (1 M samples per flagship phase, ~28 GFLOP) against ~113
// floats read per sample.  This first version is one sample per thread,
// 4 warps per SM (its ~179 KB of shared memory allows one CTA per SM),
// so it is latency-bound, far above that bound.  What it does about
// latency: a sample's 103 obs loads go out 16 at a time, the first
// layer's weights are read as float4s, the weight-gradient sums run four
// accumulators, and nothing but the final sums touches global memory.

#include <cuda_runtime.h>

namespace {

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
constexpr int S = 128;              // samples per tile = threads per CTA
constexpr int SP = S + 1;           // shared row stride
constexpr int NWARP = S / 32;
constexpr int NEXTRA = NB + 4;      // feat columns after the obs
constexpr int RED_THREADS = 1024;
constexpr int NPR = (P + RED_THREADS - 1) / RED_THREADS;
constexpr int KB = 16;              // obs rows loaded per batch

constexpr float LN_EPS = 1e-6f;
constexpr float ADAM_B1 = 0.9f, ADAM_B2 = 0.999f, ADAM_EPS = 1e-8f;
constexpr float OM_B1 = (float)(1.0 - 0.9), OM_B2 = (float)(1.0 - 0.999);

// ACTION_BUCKETS = (2, 8, 3, 2, 2, 2): sizes and first logits, as
// functions so that unrolled loops index registers, not local memory
__host__ __device__ constexpr int bucket_n(int b) {
    return b == 1 ? 8 : (b == 2 ? 3 : 2);
}
__host__ __device__ constexpr int bucket_base(int b) {
    return b == 0 ? 0 : (b == 1 ? 2 : (b == 2 ? 10 : 11 + 2 * (b - 2)));
}

// shared memory, in floats
constexpr int SM_W = 0;                   // params (P), w1 stored (D, H)
constexpr int SM_NRM = SM_W + P;          // (2, D)
constexpr int SM_XN = SM_NRM + 2 * D;     // (D, SP)
constexpr int SM_A1 = SM_XN + D * SP;     // (H, SP)
constexpr int SM_H1 = SM_A1 + H * SP;     // (H, SP) h1, then dz1
constexpr int SM_A2 = SM_H1 + H * SP;     // (H, SP)
constexpr int SM_H2 = SM_A2 + H * SP;     // (H, SP) h2, then dz2
constexpr int SM_DO = SM_H2 + H * SP;     // (NOUT, SP) head cotangents
constexpr int SM_WP = SM_DO + NOUT * SP;  // (NWARP, 4, H) warp sums
constexpr int SM_EX = SM_WP + NWARP * 4 * H;  // (NEXTRA, SP) feat columns
constexpr int SM_PART = SM_EX + NEXTRA * SP;  // (P) the CTA's gradient sums
constexpr int SM_FLOATS = SM_PART + P;
constexpr size_t SMEM_BYTES = (size_t)SM_FLOATS * sizeof(float);

struct LossHp {
    float clip, vf_coef, ent_coef, inv_mb;
    int clip_vloss;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// LayerNorm forward over z[H] (flax fast variance); z becomes hhat.
__device__ __forceinline__ float ln_fwd(float (&z)[H]) {
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
        s += z[j];
        s2 += z[j] * z[j];
    }
    const float mu = s * (1.0f / H), mu2 = s2 * (1.0f / H);
    const float rstd = rsqrtf(fmaxf(mu2 - mu * mu, 0.0f) + LN_EPS);
#pragma unroll
    for (int j = 0; j < H; ++j) z[j] = (z[j] - mu) * rstd;
    return rstd;
}

// Backward through ReLU(LayerNorm) of one layer.  In: da[H] (cotangent
// of the ReLU output), the layer's hhat column hcol (stride SP), and the
// bias matrix columns cs (scale) and cs + 1 (bias).  Out: dz written over
// hcol, the warp sums of dy * hhat and dy (the LayerNorm scale / bias
// gradients) into wp[0..H) and wp[H..2H).
__device__ __forceinline__ void ln_relu_bwd(float (&da)[H], float *hcol,
                                            const float *bias, int cs,
                                            float rstd, bool valid,
                                            float *wp) {
    const int lane = threadIdx.x & 31;
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
        const float h = hcol[j * SP];
        const float sc = bias[j * NBCOL + cs];
        const float y = h * sc + bias[j * NBCOL + cs + 1];
        const float dy = (y > 0.0f) ? da[j] : 0.0f;
        const float dg = warp_sum(valid ? dy * h : 0.0f);
        const float db = warp_sum(valid ? dy : 0.0f);
        if (lane == 0) {
            wp[j] = dg;
            wp[H + j] = db;
        }
        da[j] = dy * sc;                // dhhat
        m1 += da[j];
        m2 += da[j] * h;
    }
    m1 *= (1.0f / H);
    m2 *= (1.0f / H);
#pragma unroll
    for (int j = 0; j < H; ++j) {
        const float h = hcol[j * SP];
        hcol[j * SP] = rstd * (da[j] - m1 - h * m2);
    }
}

// One tile's per-sample forward + backward (thread s = sample s).  The
// xn column and the inputs are loaded; writes the a1, a2, dz1, dz2 and
// dout columns and the warp sums of the LayerNorm gradients.
__device__ void sample_grads(float *sm, bool valid, const float (&act)[NB],
                             float lp_old, float v_old, float adv, float ret,
                             const LossHp hp) {
    const int s = threadIdx.x;
    // the first layer transposed: input k's 32 weights as 8 float4s
    const float4 *w1 = reinterpret_cast<const float4 *>(sm + SM_W + OW1);
    const float *w2t = sm + SM_W + OW2;
    const float *wht = sm + SM_W + OWH, *bias = sm + SM_W + OB;
    auto bcol = [&](int c, int j) { return bias[j * NBCOL + c]; };
    const float *xs = sm + SM_XN + s;
    float *a1c = sm + SM_A1 + s, *h1c = sm + SM_H1 + s;
    float *a2c = sm + SM_A2 + s, *h2c = sm + SM_H2 + s;
    float *doc = sm + SM_DO + s;
    float *wp = sm + SM_WP + (s >> 5) * 4 * H;

    // ---- forward
    float z[H];
#pragma unroll
    for (int j = 0; j < H; ++j) z[j] = 0.0f;
    for (int k = 0; k < D; ++k) {
        const float x = xs[k * SP];
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
            const float4 w = w1[k * (H / 4) + q];
            z[4 * q] += w.x * x;
            z[4 * q + 1] += w.y * x;
            z[4 * q + 2] += w.z * x;
            z[4 * q + 3] += w.w * x;
        }
    }
#pragma unroll
    for (int j = 0; j < H; ++j) z[j] += bcol(0, j);
    const float rstd1 = ln_fwd(z);
    float a[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
        h1c[j * SP] = z[j];
        a[j] = fmaxf(z[j] * bcol(1, j) + bcol(2, j), 0.0f);
        a1c[j * SP] = a[j];
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < H; ++k) acc += w2t[j * H + k] * a[k];
        z[j] = acc + bcol(3, j);
    }
    const float rstd2 = ln_fwd(z);
#pragma unroll
    for (int j = 0; j < H; ++j) {
        h2c[j * SP] = z[j];
        a[j] = fmaxf(z[j] * bcol(4, j) + bcol(5, j), 0.0f);
        a2c[j * SP] = a[j];
    }
    float o[NOUT];
#pragma unroll
    for (int i = 0; i < NOUT; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < H; ++k) acc += wht[i * H + k] * a[k];
        o[i] = acc + bcol(6, i);
    }

    // ---- per-bucket softmax shifted by the global max, log p, entropy
    float M = o[0];
#pragma unroll
    for (int i = 1; i < NL; ++i) M = fmaxf(M, o[i]);
    float p[NL], lnp[NL], HB[NL];
    float logp_new = 0.0f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const int base = bucket_base(b), n = bucket_n(b);
        float Sb = 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            if (r >= n) break;
            p[base + r] = expf(o[base + r] - M);
            Sb += p[base + r];
        }
        const float logz = logf(Sb) + M;
        const float target = (float)base + act[b];
        float hb = 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            if (r >= n) break;
            const int i = base + r;
            p[i] = p[i] / Sb;
            lnp[i] = o[i] - logz;
            if ((float)i == target) logp_new += lnp[i];
            hb += p[i] * lnp[i];
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            if (r >= n) break;
            HB[base + r] = -hb;
        }
    }

    // ---- loss cotangents (ties route to the first operand)
    const float c = hp.clip;
    const float ratio = expf(logp_new - lp_old);
    const float surr1 = -adv * ratio;
    const float surr2 = -adv * clampf(ratio, 1.0f - c, 1.0f + c);
    const bool inb = (ratio >= 1.0f - c) && (ratio <= 1.0f + c);
    const float dratio = (surr1 >= surr2) ? -adv : (inb ? -adv : 0.0f);
    const float dlogp = dratio * ratio * hp.inv_mb;
    const float value = o[NL];
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
    const float ec = hp.ent_coef * hp.inv_mb;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const int base = bucket_base(b), n = bucket_n(b);
        const float target = (float)base + act[b];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            if (r >= n) break;
            const int i = base + r;
            const float oh = ((float)i == target) ? 1.0f : 0.0f;
            o[i] = dlogp * (oh - p[i]) + (ec * p[i]) * (lnp[i] + HB[i]);
        }
    }
    o[NL] = dvalue;
#pragma unroll
    for (int i = 0; i < NOUT; ++i) doc[i * SP] = o[i];

    // ---- backward: head, layer 2, layer 1
    float da[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NOUT; ++i) acc += wht[i * H + k] * o[i];
        da[k] = acc;
    }
    ln_relu_bwd(da, h2c, bias, 4, rstd2, valid, wp + 2 * H);
#pragma unroll
    for (int j = 0; j < H; ++j) z[j] = h2c[j * SP];      // dz2
#pragma unroll
    for (int k = 0; k < H; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < H; ++j) acc += w2t[j * H + k] * z[j];
        da[k] = acc;
    }
    ln_relu_bwd(da, h1c, bias, 1, rstd1, valid, wp);
}

// sum over s < n of a[s] * b[s], and of a[s]: four accumulators, so
// that the chain of dependent adds is four times shorter
__device__ __forceinline__ float col_dot(const float *a, const float *b,
                                         int n) {
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    int s = 0;
    for (; s + 4 <= n; s += 4) {
        c0 += a[s] * b[s];
        c1 += a[s + 1] * b[s + 1];
        c2 += a[s + 2] * b[s + 2];
        c3 += a[s + 3] * b[s + 3];
    }
    for (; s < n; ++s) c0 += a[s] * b[s];
    return (c0 + c1) + (c2 + c3);
}

__device__ __forceinline__ float col_sum(const float *a, int n) {
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    int s = 0;
    for (; s + 4 <= n; s += 4) {
        c0 += a[s];
        c1 += a[s + 1];
        c2 += a[s + 2];
        c3 += a[s + 3];
    }
    for (; s < n; ++s) c0 += a[s];
    return (c0 + c1) + (c2 + c3);
}

// The gradient output o of this tile, summed over its first n samples.
__device__ float tile_out(const float *sm, int o, int n) {
    if (o < OW2)
        return col_dot(sm + SM_H1 + (o / D) * SP,              // dz1
                       sm + SM_XN + (o % D) * SP, n);
    if (o < OWH) {
        const int q = o - OW2;
        return col_dot(sm + SM_H2 + (q / H) * SP,              // dz2
                       sm + SM_A1 + (q % H) * SP, n);
    }
    if (o < OB) {
        const int q = o - OWH;
        return col_dot(sm + SM_DO + (q / H) * SP, sm + SM_A2 + (q % H) * SP,
                       n);
    }
    const int q = o - OB, j = q / NBCOL, c = q % NBCOL;
    if (c == 0) return col_sum(sm + SM_H1 + j * SP, n);
    if (c == 3) return col_sum(sm + SM_H2 + j * SP, n);
    if (c == 6) return j < NOUT ? col_sum(sm + SM_DO + j * SP, n) : 0.0f;
    int qq = -1;                                   // warp-sum slot
    if (c == 1) qq = 0;
    else if (c == 2) qq = 1;
    else if (c == 4) qq = 2;
    else if (c == 5) qq = 3;
    if (qq < 0) return 0.0f;
    float acc = 0.0f;
    for (int w = 0; w < NWARP; ++w) acc += sm[SM_WP + (w * 4 + qq) * H + j];
    return acc;
}

// MODE 0: tiles of permuted (tick, world-block) blocks of traj / side;
// MODE 1: tiles of consecutive rows of a row-major (mb, F) feat matrix.
template <int MODE>
__global__ void __launch_bounds__(S)
update_grad_kernel(const int *__restrict__ idx,
                   const float *__restrict__ traj,
                   const float *__restrict__ side,
                   const float *__restrict__ feat,
                   const float *__restrict__ nrm,
                   const float *__restrict__ ustats,
                   const float *__restrict__ params,
                   float *__restrict__ partials, int rows, int W, int wb,
                   int n_tiles, int F, int mb, LossHp hp) {
    extern __shared__ float sm[];
    const int s = threadIdx.x;
    for (int i = s; i < OW2; i += S)           // w1t (H, D) -> (D, H)
        sm[SM_W + i] = params[(i % H) * D + i / H];
    for (int i = OW2 + s; i < P; i += S) sm[SM_W + i] = params[i];
    for (int i = s; i < 2 * D; i += S) sm[SM_NRM + i] = nrm[i];
    // this CTA's gradient sums, read and written by the owning thread only
    float *part = sm + SM_PART;
    for (int o = s; o < P; o += S) part[o] = 0.0f;
    const int tpb = (wb + S - 1) / S;
    const int wblk = W / wb;

    for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
        __syncthreads();   // params loaded / the previous tile reduced
        const float *mean = sm + SM_NRM, *rstd = sm + SM_NRM + D;
        float *xs = sm + SM_XN + s;
        float act[NB], lp_old = 0.0f, v_old = 0.0f, adv = 0.0f, ret = 0.0f;
        int n;
        if (MODE == 0) {
            const int b = idx[u / tpb], sub = u % tpb;
            const int t = b / wblk;
            n = min(S, wb - sub * S);
            const bool valid = s < n;
            const size_t w = (size_t)(b % wblk) * wb + (size_t)sub * S + s;
            const float *tc = traj + (size_t)t * rows * W + w;
            const float *sc = side + (size_t)t * SIDE_ROWS * W + w;
#pragma unroll
            for (int j = 0; j < NB; ++j)
                act[j] = valid ? tc[(size_t)(R_ACT + j) * W] : 0.0f;
            // the obs rows KB at a time, so that KB loads are in flight
            for (int k0 = 0; k0 < D; k0 += KB) {
                float v[KB];
#pragma unroll
                for (int j = 0; j < KB; ++j)
                    v[j] = valid && k0 + j < D ? tc[(size_t)(k0 + j) * W]
                                               : 0.0f;
#pragma unroll
                for (int j = 0; j < KB; ++j)
                    if (k0 + j < D)
                        xs[(k0 + j) * SP] = valid
                            ? clampf((v[j] - mean[k0 + j]) * rstd[k0 + j],
                                     -5.0f, 5.0f) : 0.0f;
            }
            if (valid) {
                lp_old = tc[(size_t)R_LOGP * W];
                v_old = sc[0];
                adv = sc[(size_t)W];
                ret = sc[(size_t)2 * W];
                if (ustats != nullptr) {
                    const float vm = ustats[0], vr = ustats[1];
                    const float am = ustats[2], ar = ustats[3];
                    v_old = clampf((v_old - vm) * vr, -5.0f, 5.0f);
                    adv = (adv - am) * ar;
                    ret = clampf((ret - vm) * vr, -5.0f, 5.0f);
                }
            }
        } else {
            const int r0 = u * S;
            n = min(S, mb - r0);
            const float *ft = feat + (size_t)r0 * F;
            float *ex = sm + SM_EX;
            for (int e = s; e < n * F; e += S) {
                const int r = e / F, c = e % F;
                const float v = ft[e];
                if (c < D)
                    sm[SM_XN + c * SP + r] =
                        clampf((v - mean[c]) * rstd[c], -5.0f, 5.0f);
                else if (c < D + NEXTRA)
                    ex[(c - D) * SP + r] = v;
            }
            if (s >= n) {
                for (int k = 0; k < D; ++k) xs[k * SP] = 0.0f;
                for (int c = 0; c < NEXTRA; ++c) ex[c * SP + s] = 0.0f;
            }
            __syncthreads();
#pragma unroll
            for (int j = 0; j < NB; ++j) act[j] = ex[j * SP + s];
            lp_old = ex[NB * SP + s];
            v_old = ex[(NB + 1) * SP + s];
            adv = ex[(NB + 2) * SP + s];
            ret = ex[(NB + 3) * SP + s];
        }
        sample_grads(sm, s < n, act, lp_old, v_old, adv, ret, hp);
        __syncthreads();
        for (int o = s; o < P; o += S) part[o] += tile_out(sm, o, n);
    }
    float *out = partials + (size_t)blockIdx.x * P;
    for (int o = s; o < P; o += S) out[o] = part[o];
}

// Sum the partials in CTA order; then clip + Adam in place (adam != 0,
// Adam step t) or write the gradient to grads.
__global__ void __launch_bounds__(RED_THREADS)
update_reduce_kernel(const float *__restrict__ partials, int nparts,
                     float *__restrict__ params, float *__restrict__ mu,
                     float *__restrict__ nu, float *__restrict__ grads,
                     int adam, int t, float lr, float max_norm) {
    __shared__ float red[RED_THREADS / 32];
    const int tid = threadIdx.x;
    float g[NPR];
#pragma unroll
    for (int i = 0; i < NPR; ++i) g[i] = 0.0f;
    // row by row, so that a thread's NPR loads of a row are in flight
#pragma unroll 4
    for (int c = 0; c < nparts; ++c) {
        const float *row = partials + (size_t)c * P;
#pragma unroll
        for (int i = 0; i < NPR; ++i) {
            const int p = tid + i * RED_THREADS;
            if (p < P) g[i] += row[p];
        }
    }
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < NPR; ++i) {
        const int p = tid + i * RED_THREADS;
        sq += g[i] * g[i];
        if (!adam && p < P) grads[p] = g[i];
    }
    if (!adam) return;
    sq = warp_sum(sq);
    if ((tid & 31) == 0) red[tid >> 5] = sq;
    __syncthreads();
    float total = 0.0f;
    for (int w = 0; w < RED_THREADS / 32; ++w) total += red[w];
    const float gn = sqrtf(total);
    const bool small = gn < max_norm;
    const float bc1 = 1.0f - powf(ADAM_B1, (float)t);
    const float bc2 = 1.0f - powf(ADAM_B2, (float)t);
#pragma unroll
    for (int i = 0; i < NPR; ++i) {
        const int p = tid + i * RED_THREADS;
        if (p >= P) continue;
        const float u = small ? g[i] : (g[i] / gn) * max_norm;
        const float m = OM_B1 * u + ADAM_B1 * mu[p];
        const float v = OM_B2 * (u * u) + ADAM_B2 * nu[p];
        mu[p] = m;
        nu[p] = v;
        params[p] = params[p] - lr * ((m / bc1) / (sqrtf(v / bc2) + ADAM_EPS));
    }
}

template <int MODE>
cudaError_t set_smem() {
    return cudaFuncSetAttribute(update_grad_kernel<MODE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)SMEM_BYTES);
}

LossHp loss_hp(float clip, float vf_coef, float ent_coef, int clip_vloss,
               int mb) {
    LossHp hp;
    hp.clip = clip;
    hp.vf_coef = vf_coef;
    hp.ent_coef = ent_coef;
    hp.inv_mb = 1.0f / (float)mb;
    hp.clip_vloss = clip_vloss;
    return hp;
}

}  // namespace

// Kernel D: the whole update phase, n_mb = E x M minibatches of bpm
// blocks each, Adam steps count + 1 .. count + n_mb; params / mu / nu
// (5216 floats each, flat) updated in place.  ustats may be null (side
// rows already normalized).  partials: max_parts x 5216 floats scratch.
extern "C" int mbb_fused_update_phase(
    const int *idx, int count, const float *traj, const float *side,
    const float *nrm, const float *ustats, float *params, float *mu,
    float *nu, float *partials, int max_parts, int rows, int W, int wb,
    int bpm, int n_mb, float clip, float vf_coef, float ent_coef,
    int clip_vloss, float lr, float max_norm, cudaStream_t stream) {
    if (wb < 1 || W % wb != 0 || bpm < 1 || n_mb < 1 || max_parts < 1 ||
        rows <= R_LOGP)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem<0>();
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = bpm * ((wb + S - 1) / S);
    const int grid = n_tiles < max_parts ? n_tiles : max_parts;
    const LossHp hp = loss_hp(clip, vf_coef, ent_coef, clip_vloss, bpm * wb);
    for (int k = 0; k < n_mb; ++k) {
        update_grad_kernel<0><<<grid, S, SMEM_BYTES, stream>>>(
            idx + (size_t)k * bpm, traj, side, nullptr, nrm, ustats, params,
            partials, rows, W, wb, n_tiles, 0, 0, hp);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        update_reduce_kernel<<<1, RED_THREADS, 0, stream>>>(
            partials, grid, params, mu, nu, nullptr, 1, count + k + 1, lr,
            max_norm);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// Kernel G: one minibatch's gradient over the bpm blocks idx[0..bpm),
// side rows already normalized; grads: 5216 floats, flat.
extern "C" int mbb_fused_minibatch_grad_prefetch(
    const int *idx, const float *traj, const float *side, const float *nrm,
    const float *params, float *grads, float *partials, int max_parts,
    int rows, int W, int wb, int bpm, float clip, float vf_coef,
    float ent_coef, int clip_vloss, cudaStream_t stream) {
    if (wb < 1 || W % wb != 0 || bpm < 1 || max_parts < 1 || rows <= R_LOGP)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem<0>();
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = bpm * ((wb + S - 1) / S);
    const int grid = n_tiles < max_parts ? n_tiles : max_parts;
    update_grad_kernel<0><<<grid, S, SMEM_BYTES, stream>>>(
        idx, traj, side, nullptr, nrm, nullptr, params, partials, rows, W, wb,
        n_tiles, 0, 0, loss_hp(clip, vf_coef, ent_coef, clip_vloss, bpm * wb));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    update_reduce_kernel<<<1, RED_THREADS, 0, stream>>>(
        partials, grid, nullptr, nullptr, nullptr, grads, 0, 0, 0.0f, 0.0f);
    return (int)cudaGetLastError();
}

// Kernel H: one minibatch's gradient over a row-major (mb, F) feat
// matrix (obs 0:103 | actions | logp | value_n | advantage | return_n).
extern "C" int mbb_fused_minibatch_grad(
    const float *feat, const float *nrm, const float *params, float *grads,
    float *partials, int max_parts, int mb, int F, float clip,
    float vf_coef, float ent_coef, int clip_vloss, cudaStream_t stream) {
    if (mb < 1 || F < D + NEXTRA || max_parts < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem<1>();
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = (mb + S - 1) / S;
    const int grid = n_tiles < max_parts ? n_tiles : max_parts;
    update_grad_kernel<1><<<grid, S, SMEM_BYTES, stream>>>(
        nullptr, nullptr, nullptr, feat, nrm, nullptr, params, partials, 0, 1,
        1, n_tiles, F, mb, loss_hp(clip, vf_coef, ent_coef, clip_vloss, mb));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    update_reduce_kernel<<<1, RED_THREADS, 0, stream>>>(
        partials, grid, nullptr, nullptr, nullptr, grads, 0, 0, 0.0f, 0.0f);
    return (int)cudaGetLastError();
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
