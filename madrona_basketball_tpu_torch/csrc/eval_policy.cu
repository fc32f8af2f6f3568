// Kernel J: the eval policies' forward and Gumbel-max sampling for every
// world, both agents in one launch a tick.
//
// Replaces no Pallas kernel: the JAX package jits its eval policy
// (madrona_basketball_tpu/infer.py:31-46) and XLA fuses it.  It was added
// because in the port's eval chunk (infer.py::EvalChunk) each policy ran as
// some 40 small torch kernels a tick (models/agent.py::act and the action
// writes), each microseconds of work: together ~0.3 ms of a 0.345 ms tick
// at 8192 worlds, for a few microseconds of arithmetic.  J computes what
// `act` computes, in float32 on the CUDA cores (no TF32, no bf16), per
// agent and world:
//   * obs normalization clamp((obs - mean) / sqrt(var + 1e-5), -5, 5) over
//     all 128 inputs;
//   * twice Linear (-> 32), LayerNorm (eps 1e-6, torch's two-pass form:
//     the mean, then the mean of squared deviations) and ReLU;
//   * the 19-logit actor head;
//   * Gumbel-max per bucket [2, 8, 3, 2, 2, 2]: the logits plus
//     -log(-log(max(u, 1e-20))) of the policy's uniforms u (logf, no fast
//     math), or plus given Gumbel values, or the plain argmax; the first
//     maximum of each bucket (strict >); the 6 actions stored as int32.
//
// Bound: bytes.  A tick of 8192 worlds x 2 agents reads the obs rows
// (8.39 MB, mostly still in L2 after kernel A) and the uniforms (1.25 MB)
// and writes the actions (0.39 MB): ~10.0 MB, 3.0 us at 3.35 TB/s.  Its
// 161.5 MFLOP take 2.4 us at 67 TFLOP/s.
//
// Mapping.  The grid is (world tile, agent): a CTA of NT = 128 threads
// (four warps) owns TILE = 64 worlds of one agent, so one launch covers
// both agents.
//   * Every load is an asynchronous copy into shared memory (cp.async), all
//     of a thread's in flight at once and none through registers, then one
//     wait: the agent's weights (~23 KB, from the live tensors: nothing is
//     packed), its obs normalizer, the tile's (64, 19) noise block
//     (contiguous, so coalesced) and the tile's obs rows.  The rows are
//     feature-major: 64 consecutive worlds of one row are 256 contiguous
//     bytes, copied 16 bytes a thread where the layout allows it (unit world
//     stride, rows and base 16-byte aligned), else 4 bytes a thread.  Then
//     each feature's 1 / std and each noise value's Gumbel value (stored
//     transposed, (19, 64)), and the obs normalized in place into a
//     (128, TILE) tile.  Loading through registers, in the batches the
//     compiler made, cost this kernel a fifth of its time.
//   * Each Dense layer is a tile product in register blocks of 4 units x 4
//     worlds a thread, four k a step: four 16-byte reads of the activation
//     tile (a row's 4 worlds) and four of the weights (a unit's 4 k, a
//     broadcast) feed 64 multiply-adds.  Blocks of 8 units x one world, 256
//     threads a CTA, took as long; weights served by L1 in place of shared
//     memory, twice as long.  Each (unit, world) sum runs over k in
//     ascending order, one multiply-add a term, then adds the bias (and, in
//     the head, the Gumbel noise).
//   * LayerNorm statistics run one thread a world; each thread then
//     normalizes and rectifies its Dense block of the tile.
//   * One thread a world takes the bucket maxima and stores its actions.
//   * A world count that is not a multiple of TILE masks the last tile.
//
// Built by madrona_basketball_tpu_torch/_build.py; called through ctypes
// from ops/eval_policy.py::eval_policy.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int OBS = 128;       // obs inputs (constants.OBS_SIZE)
constexpr int H = 32;          // hidden width
constexpr int NL = 19;         // logits (sum of the action buckets)
constexpr int N_ACT = 6;       // buckets
constexpr int TILE = 64;       // worlds per CTA
constexpr int NT = 128;        // threads per CTA
constexpr int JU = 4;          // units of a thread's Dense block
constexpr int JC = 4;          // worlds of a thread's Dense block
constexpr int WG = TILE / JC;  // world groups
static_assert(NT / WG * JU == H, "the threads' blocks cover a hidden tile");
static_assert(TILE <= NT && OBS <= NT && OBS % 4 == 0 && H % 4 == 0,
              "tile shapes");
static_assert((OBS * TILE / 4) % NT == 0 && (H * OBS) % NT == 0 &&
                  (H * H) % NT == 0,
              "whole loads a thread");

constexpr float RMS_EPS = 1e-5f;
constexpr float LN_EPS = 1e-6f;

// noise kinds (ops/eval_policy.py::NOISE_*)
constexpr int NOISE_NONE = 0;     // the argmax
constexpr int NOISE_UNIFORM = 1;  // uniforms in [0, 1), Gumbel made here
constexpr int NOISE_GUMBEL = 2;   // Gumbel values as given

// one agent's pointers, in ops/eval_policy.py's order
struct AgentArgs {
    const float *mean, *var;          // obs normalizer (OBS,)
    const float *w1, *b1, *g1, *be1;  // Linear (H, OBS), (H,); LayerNorm
    const float *w2, *b2, *g2, *be2;  // Linear (H, H), (H,); LayerNorm
    const float *wa, *ba;             // actor head (NL, H), (NL,)
    const float *obs;                 // input k of world w: obs[k sf + w sw]
    const float *noise;               // (W, NL) row-major, or null
    int *act;                         // action j of world w: act[j sj + w sw]
    int noise_kind;
};
constexpr int N_PTRS = 15;

struct Launch {
    AgentArgs a[2];
    int W;
    int obs_sw, obs_sf, act_sw, act_sj;
    int vec;  // obs rows read 16 bytes a thread
};

// shared memory (floats); the second hidden tile and the head's output
// reuse the normalized obs tile, dead after the first layer
constexpr int S_W1 = 0;
constexpr int S_W2 = S_W1 + H * OBS;
constexpr int S_WA = S_W2 + H * H;
constexpr int S_V = S_WA + NL * H;  // b1 g1 be1 b2 g2 be2 ba, H each
constexpr int S_XN = S_V + 7 * H;
constexpr int S_H1 = S_XN + OBS * TILE;
constexpr int S_U = S_H1 + H * TILE;  // Gumbel noise (NL, TILE)
constexpr int S_ST = S_U + NL * TILE;
constexpr int S_NRM = S_ST + 2 * TILE;  // mean, then 1 / std (OBS each)
constexpr int S_END = S_NRM + 2 * OBS;
constexpr int S_H2 = S_XN;
constexpr int S_OUT = S_XN + H * TILE;
static_assert(S_W2 % 4 == 0 && S_WA % 4 == 0 && S_XN % 4 == 0 &&
                  S_H1 % 4 == 0 && S_U % 4 == 0 && S_ST % 4 == 0,
              "16-byte rows");
static_assert(S_OUT + NL * TILE <= S_H1, "the head fits in the obs tile");

// an obs input normalized: r = 1 / sqrt(var + 1e-5) of its feature
__device__ __forceinline__ float normalize(float x, float m, float r) {
    return fminf(fmaxf((x - m) * r, -5.0f), 5.0f);
}

__device__ __forceinline__ float inv_std(float var) {
    return 1.0f / sqrtf(var + RMS_EPS);
}

// asynchronous copies of 4 and 16 bytes from device to shared memory
__device__ __forceinline__ void cp4(float *dst, const float *src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp16(float *dst, const float *src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ float4 ld4(const float *p) {
    return *reinterpret_cast<const float4 *>(p);
}

__device__ __forceinline__ void st4(float *p, float4 v) {
    *reinterpret_cast<float4 *>(p) = v;
}

// y[u, c] = sum_k W[u, k] x[k, c] + b[u] over thread t's block: units
// u = (t / WG) JU + q < N, worlds c = (t % WG) JC + r, with W (N, K)
// row-major and x (K, TILE); threads whose units all lie past N sit out.
// Four k a step: four 16-byte reads of x (JC worlds of a row) and JU of W
// (four k of a unit: a warp's lanes share two units, so each is a
// broadcast).  NOISE: each output also adds its world's Gumbel noise
// from nz (N, TILE).
template <int K, int N, bool NOISE>
__device__ __forceinline__ void dense(const float *__restrict__ w,
                                      const float *__restrict__ b,
                                      const float *__restrict__ x,
                                      float *__restrict__ y, int t,
                                      const float *__restrict__ nz) {
    const int u0 = (t / WG) * JU, c0 = (t % WG) * JC;
    if (u0 >= N) return;
    float acc[JU][JC];
#pragma unroll
    for (int q = 0; q < JU; ++q)
#pragma unroll
        for (int r = 0; r < JC; ++r) acc[q][r] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
        float xv[4][JC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float4 v = ld4(x + (k + i) * TILE + c0);
            xv[i][0] = v.x;
            xv[i][1] = v.y;
            xv[i][2] = v.z;
            xv[i][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < JU; ++q) {
            if (N % JU == 0 || u0 + q < N) {
                const float4 wv = ld4(w + (u0 + q) * K + k);
#pragma unroll
                for (int r = 0; r < JC; ++r) {
                    acc[q][r] = acc[q][r] + wv.x * xv[0][r];
                    acc[q][r] = acc[q][r] + wv.y * xv[1][r];
                    acc[q][r] = acc[q][r] + wv.z * xv[2][r];
                    acc[q][r] = acc[q][r] + wv.w * xv[3][r];
                }
            }
        }
    }
#pragma unroll
    for (int q = 0; q < JU; ++q) {
        const int u = u0 + q;
        if (N % JU == 0 || u < N) {
            float4 v = make_float4(acc[q][0] + b[u], acc[q][1] + b[u],
                                   acc[q][2] + b[u], acc[q][3] + b[u]);
            if (NOISE) {
                const float4 g = ld4(nz + u * TILE + c0);
                v = make_float4(v.x + g.x, v.y + g.y, v.z + g.z, v.w + g.w);
            }
            st4(y + u * TILE + c0, v);
        }
    }
}

// LayerNorm (torch's two-pass form, eps 1e-6) and ReLU over the H units of
// each world of h (H, TILE), in place: the statistics one thread a world,
// then each thread's Dense block.  All NT threads; ends synchronized.
__device__ __forceinline__ void layer_norm_relu(float *__restrict__ h,
                                                const float *__restrict__ gam,
                                                const float *__restrict__ bet,
                                                float *__restrict__ st,
                                                int t) {
    if (t < TILE) {
        float s = 0.0f;
#pragma unroll 8
        for (int j = 0; j < H; ++j) s = s + h[j * TILE + t];
        const float mu = s / (float)H;
        float s2 = 0.0f;
#pragma unroll 8
        for (int j = 0; j < H; ++j) {
            const float d = h[j * TILE + t] - mu;
            s2 = s2 + d * d;
        }
        st[t] = mu;
        st[TILE + t] = 1.0f / sqrtf(s2 / (float)H + LN_EPS);
    }
    __syncthreads();
    const int u0 = (t / WG) * JU, c0 = (t % WG) * JC;
    const float4 mu = ld4(st + c0), rs = ld4(st + TILE + c0);
#pragma unroll
    for (int q = 0; q < JU; ++q) {
        const int j = u0 + q;
        const float gj = gam[j], bj = bet[j];
        float4 v = ld4(h + j * TILE + c0);
        v.x = fmaxf((v.x - mu.x) * rs.x * gj + bj, 0.0f);
        v.y = fmaxf((v.y - mu.y) * rs.y * gj + bj, 0.0f);
        v.z = fmaxf((v.z - mu.z) * rs.z * gj + bj, 0.0f);
        v.w = fmaxf((v.w - mu.w) * rs.w * gj + bj, 0.0f);
        st4(h + j * TILE + c0, v);
    }
    __syncthreads();
}

__global__ void __launch_bounds__(NT)
eval_policy_kernel(const Launch L) {
    extern __shared__ float4 smem4[];
    float *sm = reinterpret_cast<float *>(smem4);
    const AgentArgs A = blockIdx.y == 0 ? L.a[0] : L.a[1];
    const int t = threadIdx.x;
    const int w0 = blockIdx.x * TILE;
    const int nw = min(TILE, L.W - w0);

    // every load an asynchronous copy into shared memory, then one wait
#pragma unroll
    for (int j = 0; j < H * OBS / NT; ++j)
        cp4(sm + S_W1 + t + j * NT, A.w1 + t + j * NT);
#pragma unroll
    for (int j = 0; j < H * H / NT; ++j)
        cp4(sm + S_W2 + t + j * NT, A.w2 + t + j * NT);
    for (int i = t; i < NL * H; i += NT) cp4(sm + S_WA + i, A.wa + i);
    if (t < H) {
        cp4(sm + S_V + 0 * H + t, A.b1 + t);
        cp4(sm + S_V + 1 * H + t, A.g1 + t);
        cp4(sm + S_V + 2 * H + t, A.be1 + t);
        cp4(sm + S_V + 3 * H + t, A.b2 + t);
        cp4(sm + S_V + 4 * H + t, A.g2 + t);
        cp4(sm + S_V + 5 * H + t, A.be2 + t);
        if (t < NL) cp4(sm + S_V + 6 * H + t, A.ba + t);
    }
    if (t < OBS) {
        cp4(sm + S_NRM + t, A.mean + t);
        cp4(sm + S_NRM + OBS + t, A.var + t);
    }
    float *raw = sm + S_H1;  // the noise block as read, (TILE, NL)
    if (A.noise_kind != NOISE_NONE) {
        const float *nz = A.noise + (size_t)w0 * NL;
        for (int i = t; i < nw * NL; i += NT) cp4(raw + i, nz + i);
    }
    float *xn = sm + S_XN;
    if (L.vec) {
#pragma unroll
        for (int j = 0; j < OBS * TILE / 4 / NT; ++j) {
            // row k = i / (TILE / 4), worlds 4 (i % (TILE / 4)) .. + 3
            const int i = t + j * NT;
            const int k = i / (TILE / 4), c4 = 4 * (i % (TILE / 4));
            if (c4 < nw)
                cp16(xn + k * TILE + c4,
                     A.obs + (size_t)k * L.obs_sf + w0 + c4);
            else
                st4(xn + k * TILE + c4, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
        }
    } else {
        for (int i = t; i < OBS * TILE; i += NT) {
            const int k = i / TILE, c = i % TILE;
            if (c < nw)
                cp4(xn + i, A.obs + (size_t)k * L.obs_sf +
                                (size_t)(w0 + c) * L.obs_sw);
            else
                xn[i] = 0.0f;
        }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    // each feature's 1 / std, each noise value's Gumbel value (transposed);
    // then the obs tile normalized in place
    if (t < OBS) sm[S_NRM + OBS + t] = inv_std(sm[S_NRM + OBS + t]);
    if (A.noise_kind != NOISE_NONE) {
        for (int i = t; i < nw * NL; i += NT) {
            float v = raw[i];
            if (A.noise_kind == NOISE_UNIFORM)
                v = -logf(-logf(fmaxf(v, 1e-20f)));
            sm[S_U + (i % NL) * TILE + i / NL] = v;
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OBS * TILE / 4 / NT; ++j) {
        const int i = t + j * NT;
        const int k = i / (TILE / 4), c4 = 4 * (i % (TILE / 4));
        const float m = sm[S_NRM + k], r = sm[S_NRM + OBS + k];
        const float4 v = ld4(xn + k * TILE + c4);
        st4(xn + k * TILE + c4,
            make_float4(normalize(v.x, m, r), normalize(v.y, m, r),
                        normalize(v.z, m, r), normalize(v.w, m, r)));
    }
    __syncthreads();

    const float *vecs = sm + S_V;
    dense<OBS, H, false>(sm + S_W1, vecs, xn, sm + S_H1, t, nullptr);
    __syncthreads();
    layer_norm_relu(sm + S_H1, vecs + 1 * H, vecs + 2 * H, sm + S_ST, t);
    dense<H, H, false>(sm + S_W2, vecs + 3 * H, sm + S_H1, sm + S_H2, t,
                       nullptr);
    __syncthreads();
    layer_norm_relu(sm + S_H2, vecs + 4 * H, vecs + 5 * H, sm + S_ST, t);
    if (A.noise_kind == NOISE_NONE)
        dense<H, NL, false>(sm + S_WA, vecs + 6 * H, sm + S_H2, sm + S_OUT,
                            t, nullptr);
    else
        dense<H, NL, true>(sm + S_WA, vecs + 6 * H, sm + S_H2, sm + S_OUT, t,
                           sm + S_U);
    __syncthreads();

    if (t < nw) {
        const float *out = sm + S_OUT;
        int *act = A.act + (size_t)(w0 + t) * L.act_sw;
        int off = 0;
#pragma unroll
        for (int bkt = 0; bkt < N_ACT; ++bkt) {
            // buckets [2, 8, 3, 2, 2, 2] (constants.ACTION_BUCKETS)
            const int n = bkt == 1 ? 8 : (bkt == 2 ? 3 : 2);
            float best = out[off * TILE + t];
            int idx = 0;
#pragma unroll
            for (int r = 1; r < n; ++r) {
                const float v = out[(off + r) * TILE + t];
                if (v > best) {
                    best = v;
                    idx = r;
                }
            }
            act[(size_t)bkt * L.act_sj] = idx;
            off += n;
        }
    }
}

}  // namespace

// ptrs: n_agents x 15 pointers in AgentArgs' order (ops/eval_policy.py);
// kinds: each agent's noise kind.  Both agents' obs share the strides
// (obs_sw, obs_sf) and their actions (act_sw, act_sj), in elements.
extern "C" int mbb_eval_policy(const void *const *ptrs, const int *kinds,
                               int n_agents, int W, int obs_sw, int obs_sf,
                               int act_sw, int act_sj, cudaStream_t stream) {
    if (n_agents < 1 || n_agents > 2 || W < 1)
        return (int)cudaErrorInvalidValue;
    Launch L = {};
    L.W = W;
    L.obs_sw = obs_sw;
    L.obs_sf = obs_sf;
    L.act_sw = act_sw;
    L.act_sj = act_sj;
    bool vec = obs_sw == 1 && obs_sf % 4 == 0 && W % 4 == 0;
    for (int a = 0; a < n_agents; ++a) {
        const void *const *p = ptrs + a * N_PTRS;
        AgentArgs &A = L.a[a];
        const float **f[] = {&A.mean, &A.var, &A.w1, &A.b1, &A.g1,
                             &A.be1,  &A.w2,  &A.b2, &A.g2, &A.be2,
                             &A.wa,   &A.ba,  &A.obs, &A.noise};
        for (int i = 0; i < N_PTRS - 1; ++i)
            *f[i] = static_cast<const float *>(p[i]);
        A.act = static_cast<int *>(const_cast<void *>(p[N_PTRS - 1]));
        A.noise_kind = kinds[a];
        if (A.noise_kind < NOISE_NONE || A.noise_kind > NOISE_GUMBEL ||
            (A.noise_kind != NOISE_NONE && A.noise == nullptr))
            return (int)cudaErrorInvalidValue;
        vec = vec && reinterpret_cast<uintptr_t>(A.obs) % 16 == 0;
    }
    L.vec = vec ? 1 : 0;
    const size_t smem = S_END * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        eval_policy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + TILE - 1) / TILE, n_agents);
    eval_policy_kernel<<<grid, NT, smem, stream>>>(L);
    return (int)cudaGetLastError();
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
