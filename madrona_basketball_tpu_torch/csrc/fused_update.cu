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
//   * update_grad_kernel: a persistent grid of G <= max_parts CTAs (one
//     per SM) of NT = 256 threads; tile u (S = 64 samples of one wb-wide
//     block at one tick, or 64 feat rows) goes to CTA u % G.  The tile is
//     a chain of small matrix products over its samples, register-blocked
//     from shared memory, and row-wise work (LayerNorm, softmax, the loss)
//     over 4 lanes a sample: update_tile.cuh, which the host build
//     (host_update.cpp) runs too.  Warp w owns samples 8 w .. 8 w + 7 of
//     every tile, from the arrival of its columns of the tile's 113 input
//     rows (bulk copies of whole rows, update_grad.cuh) to the end of the
//     backward pass, so those stages end in warp-wide barriers; the
//     weight gradient, which sums over all 64 samples, sits between the
//     tile's only two CTA-wide barriers.  Each thread keeps its share of the 5216 weight-gradient
//     sums in registers across the CTA's tiles and writes the CTA's row of
//     `partials` once at the end.
//   * update_reduce_kernel: 163 CTAs of 1024 threads, each owning 32
//     parameters; 32 threads a parameter sum the partial rows (row c by
//     thread c % 32, in row order), then add the 32 chunk sums in order.
//     D: each CTA writes its slice's sum of squares; the last CTA to
//     arrive (an integer counter) adds them in a fixed order (lane l the
//     slices l, l + 32, ..., then a butterfly over the lanes), forms the
//     global norm and applies clip + Adam to all parameters, then resets
//     the counter.  G, H: the gradient is written.
// Every sum runs in a fixed order and no float is added atomically, so a
// launch on the same inputs gives the same bits.  D issues all E x M
// minibatch pairs from one host call (mbb_fused_update_phase).
//
// Bound: operations.  ~5.0 k multiply-adds forward, ~1.7 k backward and
// ~5.0 k of weight gradient per sample (1 M samples per flagship phase,
// ~26 GFLOP) against ~113 floats read per sample.  The design keeps the
// FMA pipes fed: a product step is one float4 of weights and one float2
// of activations for 8 FMAs, a weight-gradient step eight float4 loads
// for 64 FMAs; all float32 on the CUDA cores (a 3xTF32 mma.sync version
// of the backward and weight-gradient products was slower and ~4x less
// accurate, see PERF.md).  ~180 KB of shared memory gives one CTA (8
// warps) per SM; the loads of the next tile overlap the current tile's
// arithmetic.

// The bf16 branches of D and G (make_fused_update_phase /
// make_fused_minibatch_grad_prefetch(traj_dtype=bfloat16), fused_update.py
// :460, :616-618 and :328, :391-394; --bf16-traj): the trajectory's 110
// rows (obs, actions, logp) are bf16 bits (TT = uint16_t), staged in
// shared memory and upcast by each warp for its own columns
// (update_grad.cuh).  So D and G in bf16 equal their float32 selves on
// the upcast trajectory bit for bit.  The side rows, weights and Adam
// moments stay float32; H keeps its float32 feat matrix.
//
// Scratch: `partials` holds max_parts + 2 rows of 5216 floats: the CTAs'
// rows, then the summed gradient, then the slices' sums of squares and
// the counter (D only).

#include <cstdint>

#include <cuda_runtime.h>

#include "update_grad.cuh"

using namespace mbb::update;

namespace {

template <int MODE, class TT>
__global__ void __launch_bounds__(NT, 1)
update_grad_kernel(const int *__restrict__ idx,
                   const TT *__restrict__ traj,
                   const float *__restrict__ side,
                   const float *__restrict__ feat,
                   const float *__restrict__ nrm,
                   const float *__restrict__ ustats,
                   const float *__restrict__ params,
                   float *__restrict__ partials, int rows, int W, int wb,
                   int n_tiles, int F, int mb, LossHp hp) {
    grad_tiles<MODE, TT, false>(idx, traj, side, feat, nrm, ustats, params,
                                partials, rows, W, wb, n_tiles, F, mb, hp,
                                nullptr, 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Sum the partials (see the header); adam != 0: clip + Adam step
// *count + k + 1 in place (the step count read from device memory, so a
// CUDA graph that replays the launch takes each replay's steps), else
// write the gradient to grads.  gsum (P), slice_sq (RED_CTAS) and
// counter are D's scratch.
__global__ void __launch_bounds__(RED_NT)
update_reduce_kernel(const float *__restrict__ partials, int nparts,
                     float *__restrict__ params, float *__restrict__ mu,
                     float *__restrict__ nu, float *__restrict__ grads,
                     float *gsum, float *slice_sq, int *counter, int adam,
                     const int *__restrict__ count, int k, float lr,
                     float max_norm) {
    __shared__ float part[RED_CH][32];
    __shared__ float sq[RED_CTAS];
    __shared__ int last;
    const int tid = threadIdx.x, pl = tid & 31, ch = tid >> 5;
    const int p = blockIdx.x * 32 + pl;
    part[ch][pl] = p < P ? chunk_sum(partials, nparts, p, ch) : 0.0f;
    __syncthreads();
    if (ch == 0) {
        float g = part[0][pl];
#pragma unroll
        for (int c = 1; c < RED_CH; ++c) g += part[c][pl];
        if (!adam) {
            if (p < P) grads[p] = g;
        } else {
            if (p < P) gsum[p] = g;
            const float s = warp_sum(g * g);
            if (pl == 0) slice_sq[blockIdx.x] = s;
        }
    }
    if (!adam) return;
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int c = tid; c < (int)gridDim.x; c += RED_NT)
        sq[c] = __ldcg(slice_sq + c);
    __syncthreads();
    if (ch == 0) {
        const float total = warp_sum(lane_slices(sq, gridDim.x, pl));
        if (pl == 0) {
            part[0][0] = total;
            *counter = 0;
        }
    }
    __syncthreads();
    const float gn = sqrtf(part[0][0]);
    const int t = *count + k + 1;
    const float bc1 = bias_correction(ADAM_B1, t);
    const float bc2 = bias_correction(ADAM_B2, t);
    for (int q = tid; q < P; q += RED_NT)
        adam_one(__ldcg(gsum + q), gn, max_norm, lr, bc1, bc2, params[q],
                 mu[q], nu[q]);
}

template <int MODE, class TT = float>
cudaError_t set_smem() {
    return set_grad_smem(update_grad_kernel<MODE, TT>, smem_bytes<TT>());
}

// the reduce's scratch after the max_parts partial rows
struct RedScratch {
    float *gsum, *slice_sq;
    int *counter;
};

RedScratch red_scratch(float *partials, int max_parts) {
    float *extra = partials + (size_t)max_parts * P;
    return {extra, extra + P, reinterpret_cast<int *>(extra + P + RED_CTAS)};
}

cudaError_t reduce(const float *partials, int nparts, int max_parts,
                   float *params, float *mu, float *nu, float *grads,
                   int adam, const int *count, int k, float lr,
                   float max_norm, cudaStream_t stream) {
    const RedScratch r = red_scratch(const_cast<float *>(partials), max_parts);
    update_reduce_kernel<<<RED_CTAS, RED_NT, 0, stream>>>(
        partials, nparts, params, mu, nu, grads, r.gsum, r.slice_sq,
        r.counter, adam, count, k, lr, max_norm);
    return cudaGetLastError();
}

template <class TT>
int update_phase(const int *idx, const int *count, const TT *traj,
                 const float *side, const float *nrm, const float *ustats,
                 float *params, float *mu, float *nu, float *partials,
                 int max_parts, int rows, int W, int wb, int bpm, int n_mb,
                 float clip, float vf_coef, float ent_coef, int clip_vloss,
                 float lr, float max_norm, cudaStream_t stream) {
    if (wb < 1 || W % wb != 0 || bpm < 1 || n_mb < 1 || max_parts < 1 ||
        rows <= R_LOGP || count == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem<0, TT>();
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(red_scratch(partials, max_parts).counter, 0,
                          sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = bpm * ((wb + S - 1) / S);
    const int grid = n_tiles < max_parts ? n_tiles : max_parts;
    const LossHp hp = loss_hp(clip, vf_coef, ent_coef, clip_vloss, bpm * wb);
    for (int k = 0; k < n_mb; ++k) {
        update_grad_kernel<0, TT><<<grid, NT, smem_bytes<TT>(), stream>>>(
            idx + (size_t)k * bpm, traj, side, nullptr, nrm, ustats, params,
            partials, rows, W, wb, n_tiles, 0, 0, hp);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        err = reduce(partials, grid, max_parts, params, mu, nu, nullptr, 1,
                     count, k, lr, max_norm, stream);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

template <class TT>
int grad_prefetch(const int *idx, const TT *traj, const float *side,
                  const float *nrm, const float *params, float *grads,
                  float *partials, int max_parts, int rows, int W, int wb,
                  int bpm, float clip, float vf_coef, float ent_coef,
                  int clip_vloss, cudaStream_t stream) {
    if (wb < 1 || W % wb != 0 || bpm < 1 || max_parts < 1 || rows <= R_LOGP)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem<0, TT>();
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = bpm * ((wb + S - 1) / S);
    const int grid = n_tiles < max_parts ? n_tiles : max_parts;
    update_grad_kernel<0, TT><<<grid, NT, smem_bytes<TT>(), stream>>>(
        idx, traj, side, nullptr, nrm, nullptr, params, partials, rows, W, wb,
        n_tiles, 0, 0, loss_hp(clip, vf_coef, ent_coef, clip_vloss, bpm * wb));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)reduce(partials, grid, max_parts, nullptr, nullptr, nullptr,
                       grads, 0, nullptr, 0, 0.0f, 0.0f, stream);
}

}  // namespace

// Kernel D: the whole update phase, n_mb = E x M minibatches of bpm
// blocks each, Adam steps *count + 1 .. *count + n_mb (count in device
// memory); params / mu / nu
// (5216 floats each, flat) updated in place.  ustats may be null (side
// rows already normalized).  partials: (max_parts + 2) x 5216 floats
// scratch.
extern "C" int mbb_fused_update_phase(
    const int *idx, const int *count, const float *traj, const float *side,
    const float *nrm, const float *ustats, float *params, float *mu,
    float *nu, float *partials, int max_parts, int rows, int W, int wb,
    int bpm, int n_mb, float clip, float vf_coef, float ent_coef,
    int clip_vloss, float lr, float max_norm, cudaStream_t stream) {
    return update_phase(idx, count, traj, side, nrm, ustats, params, mu, nu,
                        partials, max_parts, rows, W, wb, bpm, n_mb, clip,
                        vf_coef, ent_coef, clip_vloss, lr, max_norm, stream);
}

// Kernel D on a trajectory of bf16 bits (uint16_t).
extern "C" int mbb_fused_update_phase_bf16(
    const int *idx, const int *count, const uint16_t *traj,
    const float *side, const float *nrm, const float *ustats, float *params,
    float *mu, float *nu, float *partials, int max_parts, int rows, int W,
    int wb, int bpm, int n_mb, float clip, float vf_coef, float ent_coef,
    int clip_vloss, float lr, float max_norm, cudaStream_t stream) {
    return update_phase(idx, count, traj, side, nrm, ustats, params, mu, nu,
                        partials, max_parts, rows, W, wb, bpm, n_mb, clip,
                        vf_coef, ent_coef, clip_vloss, lr, max_norm, stream);
}

// Kernel G: one minibatch's gradient over the bpm blocks idx[0..bpm),
// side rows already normalized; grads: 5216 floats, flat.
extern "C" int mbb_fused_minibatch_grad_prefetch(
    const int *idx, const float *traj, const float *side, const float *nrm,
    const float *params, float *grads, float *partials, int max_parts,
    int rows, int W, int wb, int bpm, float clip, float vf_coef,
    float ent_coef, int clip_vloss, cudaStream_t stream) {
    return grad_prefetch(idx, traj, side, nrm, params, grads, partials,
                         max_parts, rows, W, wb, bpm, clip, vf_coef, ent_coef,
                         clip_vloss, stream);
}

// Kernel G on a trajectory of bf16 bits (uint16_t).
extern "C" int mbb_fused_minibatch_grad_prefetch_bf16(
    const int *idx, const uint16_t *traj, const float *side,
    const float *nrm, const float *params, float *grads, float *partials,
    int max_parts, int rows, int W, int wb, int bpm, float clip,
    float vf_coef, float ent_coef, int clip_vloss, cudaStream_t stream) {
    return grad_prefetch(idx, traj, side, nrm, params, grads, partials,
                         max_parts, rows, W, wb, bpm, clip, vf_coef, ent_coef,
                         clip_vloss, stream);
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
    update_grad_kernel<1, float><<<grid, NT, SMEM_BYTES, stream>>>(
        nullptr, nullptr, nullptr, feat, nrm, nullptr, params, partials, 0, 1,
        1, n_tiles, F, mb, loss_hp(clip, vf_coef, ent_coef, clip_vloss, mb));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)reduce(partials, grid, max_parts, nullptr, nullptr, nullptr,
                       grads, 0, nullptr, 0, 0.0f, 0.0f, stream);
}

// Resident CTAs per SM of the gradient and the reduce kernels
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and their threads and
// dynamic shared memory: out[0..5]; the gradient kernel's barriers a
// tile: CTA-wide, warp-wide, warp-wide in the bf16 instances: out[6..8].
extern "C" int mbb_update_occupancy(int *out) {
    cudaError_t err = set_smem<0>();
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], update_grad_kernel<0, float>, NT, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], update_reduce_kernel, RED_NT, 0);
    out[2] = NT;
    out[3] = RED_NT;
    out[4] = (int)SMEM_BYTES;
    out[5] = 0;
    out[6] = CTA_BARRIERS;
    out[7] = WARP_BARRIERS;
    out[8] = WARP_BARRIERS_BF16;
    return (int)err;
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
