// The update kernels' gradient launch (kernels D, G and H, fused_update.cu;
// the stage probe, fused_update_probe.cu): the loads of a tile's input
// rows into shared memory and the loop over the CTA's tiles, whose
// arithmetic is update_tile.cuh's.  nvcc only.
//
// A persistent grid of G <= max_parts CTAs (one per SM) of NT = 256
// threads; tile u (S = 64 samples of one wb-wide block at one tick, or 64
// feat rows) goes to CTA u % G.  A tile's 113 input rows (obs, actions,
// logp, side) are 64 contiguous worlds each; they are copied into one of
// two buffers while the CTA computes the previous tile: a whole tile with
// 16-byte aligned rows as one bulk copy a row that completes on the
// buffer's mbarrier (bulk_load), a ragged or unaligned one as each warp's
// own columns by cp.async.  Warp w owns the tile's samples SW w .. SW w + 7
// (update_tile.cuh): it waits for its columns (the mbarrier's phase, or
// its own cp.async group, then a warp-wide barrier) and runs stages 0..15
// on them with a warp-wide barrier after each.  A tile has two CTA-wide
// barriers, around the weight gradient, which reads every warp's
// columns; the second one also frees the buffer that the next tile's
// copies overwrite.  Each thread keeps its share of the 5216
// weight-gradient sums in registers across the CTA's tiles and writes the
// CTA's row of `partials` once at the end.
//
// bf16 (TT = uint16_t): the trajectory's 110 rows (obs, actions, logp)
// are bf16 bits.  They land in one of two bf16 staging tiles beside the
// input buffers (2 x 15.5 KB more shared memory: 207.5 KB, still one CTA
// a SM), as bulk copies of 128 bytes a row or, ragged, as each warp's
// plain loads; once they have landed, each warp upcasts its own staging
// columns into the float32 input buffer (one more warp-wide barrier) and
// runs the float32 stages.  So D and G in bf16 equal their float32 selves
// on the upcast trajectory bit for bit.  The side rows stay float32; H
// keeps its float32 feat matrix, each warp reading its own rows.
//
// STAMP (the probe's instance only): lane 0 of warps 0 and 6 of CTA 0
// write the SM clock before and after every barrier of every tile,
// STAMP_SLOTS a tile.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "update_tile.cuh"

namespace mbb {
namespace update {

constexpr size_t SMEM_BYTES = (size_t)SM_FLOATS * sizeof(float);
// the bf16 instances: a trajectory tile's rows 0..R_LOGP (obs | actions |
// logp), S bf16 values a row and 8 of padding (so that a warp's 16 bytes
// of 8 consecutive rows fall in 8 different bank quads), staged twice
// after the float32 layout
constexpr int TRAJ_ROWS = R_LOGP + 1;  // 110
constexpr int STAGE_SP = S + 8;
constexpr int STAGE_FLOATS = TRAJ_ROWS * STAGE_SP / 2;
constexpr size_t SMEM_BYTES_BF16 =
    (size_t)(SM_FLOATS + 2 * STAGE_FLOATS) * sizeof(float);
static_assert(SM_FLOATS % 4 == 0 && STAGE_FLOATS % 4 == 0 &&
                  (STAGE_SP * 2) % 16 == 0,
              "16-byte aligned staging rows");

template <class TT>
constexpr size_t smem_bytes() {
    return sizeof(TT) == sizeof(float) ? SMEM_BYTES : SMEM_BYTES_BF16;
}

// ---- the stage probe's clock stamps: per tile, slot 0 the tile's start,
// 1 before the wait for the tile's copies, 2 past the arrival's barrier,
// then for stage st: 3 + 2 st its work done, 4 + 2 st past its barrier
constexpr int STAMP_WARP0 = 0, STAMP_WARP1 = 6;
constexpr int STAMP_SLOTS = 3 + 2 * N_STAGES;

MBU_HD int stamp_slot_done(int st) { return 3 + 2 * st; }

template <bool STAMP>
__device__ __forceinline__ void stamp(long long *stamps, int max_tiles,
                                      int it, int slot) {
    if (!STAMP || blockIdx.x != 0 || (threadIdx.x & 31) != 0) return;
    const int warp = threadIdx.x >> 5;
    const int k = warp == STAMP_WARP0 ? 0 : (warp == STAMP_WARP1 ? 1 : -1);
    if (k < 0 || it >= max_tiles) return;
    long long t;
    // the clobber keeps the read where it stands among the barriers
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
    stamps[((size_t)k * max_tiles + it) * STAMP_SLOTS + slot] = t;
}

__device__ __forceinline__ void cp_async4(float *dst, const float *src) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers and bulk copies (the whole tiles' rows)
__device__ __forceinline__ void bar_init(uint64_t *bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t *bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_copy(void *dst, const void *src,
                                          uint32_t bytes, uint64_t *bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// wait for the completion of the phase of `bar` with the given parity
__device__ __forceinline__ void bar_wait(uint64_t *bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}

// where a tile of a minibatch lies: its samples' first world column of
// traj / side at its tick, and how many samples it holds
template <class TT>
struct TilePos {
    const TT *tc;
    const float *sc;
    int w, n;
};

// (sub-tile sub of the block b that the permutation names)
template <class TT>
__device__ __forceinline__ TilePos<TT> tile_at(int b, int sub,
                                               const TT *traj,
                                               const float *side, int rows,
                                               int W, int wb) {
    const int wblk = W / wb;
    const int t = b / wblk;
    const int w = (b % wblk) * wb + sub * S;
    TilePos<TT> p;
    p.tc = traj + (size_t)t * rows * W + w;
    p.sc = side + (size_t)t * SIDE_ROWS * W + w;
    p.w = w;
    p.n = min(S, wb - sub * S);
    return p;
}

// the tiles of a wb-wide block
__device__ __forceinline__ int tiles_per_block(int wb) {
    return (wb + S - 1) / S;
}

// source row of input-buffer row r (r != D, the ones row)
__device__ __forceinline__ const float *in_row(const TilePos<float> &p,
                                               int r, int W) {
    if (r < D) return p.tc + (size_t)r * W;
    if (r < EX_V) return p.tc + (size_t)(R_ACT + r - EX_ACT) * W;
    return p.sc + (size_t)(r - EX_V) * W;
}

// ---- a tile's loads: whole rows as bulk copies, or each warp its own
// columns (samples SW w .. SW w + 7)

// whether a tile's rows go as bulk copies: the tile whole and its rows
// 16-byte aligned
template <class TT>
__device__ __forceinline__ bool bulk_tile(const TilePos<TT> &p, int W) {
    constexpr int A = 16 / sizeof(TT);
    return p.n == S && W % A == 0 && p.w % A == 0;
}

// The tile's 113 rows as one bulk copy each (the copy engine computes the
// addresses; a warp's own cp.async columns, 32 bytes of each float32 row,
// took ~2.4 k cycles a tile to issue), issued by threads 0..112 (thread
// t: trajectory row t, or side row t - TRAJ_ROWS), completing on the
// mbarrier `bar` (thread 0 arms it with the bytes): float32 rows into
// `in`, bf16 trajectory rows into `stage`.  A bulk copy takes ~50-70
// cycles of its issuing thread: warps 0..3 issue them, and warps 4..7 run
// ahead into the first product meanwhile (issued by 1, 2 or 3 warps, or
// spread over all 8, the tile took longer on the card).
template <class TT>
__device__ void bulk_load(float *in, uint16_t *stage, const TilePos<TT> &p,
                          int W, uint64_t *bar, int tid) {
    constexpr uint32_t TRAJ_BYTES = TRAJ_ROWS * S * sizeof(TT);
    if (tid == 0)
        bar_expect(bar, TRAJ_BYTES + (IN_ROWS - 1 - TRAJ_ROWS) * S * 4);
    if (tid >= IN_ROWS - 1) return;
    // the buffers' last generic accesses (a tile ago, before a CTA
    // barrier) ordered before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int r = tid < D ? tid : tid + 1;   // its row of `in`
    if (tid >= TRAJ_ROWS)
        bulk_copy(in + r * SP, p.sc + (size_t)(r - EX_V) * W,
                  S * sizeof(float), bar);
    else if (sizeof(TT) == sizeof(float))
        bulk_copy(in + r * SP, p.tc + (size_t)tid * W, S * sizeof(float),
                  bar);
    else
        bulk_copy(stage + tid * STAGE_SP, p.tc + (size_t)tid * W,
                  S * sizeof(TT), bar);
}

// a ragged or unaligned tile (not bulk_tile): warp w's columns of its
// 113 rows into `in`, 4 bytes at a time, asynchronously (samples >= n
// zeroed)
__device__ void load_tile(float *in, uint16_t *, const TilePos<float> &p,
                          int W, int tid) {
    const int s0 = warp_sample0(tid), lane = tid & 31;
    for (int i = lane; i < (IN_ROWS - 1) * SW; i += 32) {
        const int rr = i / SW, s = s0 + i % SW;
        const int r = rr < D ? rr : rr + 1;
        if (s < p.n) cp_async4(in + r * SP + s, in_row(p, r, W) + s);
        else in[r * SP + s] = 0.0f;
    }
}

// bf16, a ragged or unaligned tile: the warp's columns of the trajectory
// rows 0..R_LOGP into the staging tile by plain loads and of its 3 side
// rows into `in` 4 bytes at a time, asynchronously (samples >= n zeroed)
__device__ void load_tile(float *in, uint16_t *stage,
                          const TilePos<uint16_t> &p, int W, int tid) {
    const int s0 = warp_sample0(tid), lane = tid & 31;
    for (int i = lane; i < TRAJ_ROWS * SW; i += 32) {
        const int r = i / SW, s = s0 + i % SW;
        stage[r * STAGE_SP + s] =
            s < p.n ? p.tc[(size_t)r * W + s] : (uint16_t)0;
    }
    for (int i = lane; i < 3 * SW; i += 32) {
        const int k = i / SW, s = s0 + i % SW;
        if (s < p.n)
            cp_async4(in + (EX_V + k) * SP + s, p.sc + (size_t)k * W + s);
        else
            in[(EX_V + k) * SP + s] = 0.0f;
    }
}

// a tile's copies: bulk where bulk_tile, else each warp its own columns
// with cp.async (one commit group)
template <class TT>
__device__ __forceinline__ void issue_tile(float *in, uint16_t *stage,
                                           const TilePos<TT> &p, int W,
                                           uint64_t *bar, int tid) {
    if (bulk_tile(p, W)) {
        bulk_load(in, stage, p, W, bar, tid);
        return;
    }
    load_tile(in, stage, p, W, tid);
    cp_async_commit();
}

// the bf16 values in the low and the high half of a 32-bit word (the
// earlier and the later address)
__device__ __forceinline__ float bf16_lo(uint32_t x) {
    return mbb::bf16_to_f32((uint16_t)(x & 0xffffu));
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
    return mbb::bf16_to_f32((uint16_t)(x >> 16));
}

// the warp's staging columns upcast into its columns of the input
// buffer's trajectory rows (all but the ones row and the side rows): a
// lane a row, 16 bytes in, two float4 out
__device__ __forceinline__ void upcast_stage(float *in,
                                             const uint16_t *stage,
                                             int tid) {
    const int s0 = warp_sample0(tid), lane = tid & 31;
    for (int r = lane; r < TRAJ_ROWS; r += 32) {
        const uint4 v =
            *reinterpret_cast<const uint4 *>(stage + r * STAGE_SP + s0);
        float4 *dst = reinterpret_cast<float4 *>(
            in + (r < D ? r : r + 1) * SP + s0);
        dst[0] = make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y),
                             bf16_hi(v.y));
        dst[1] = make_float4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w),
                             bf16_hi(v.w));
    }
}

// MODE 1: the warp's rows r0 + s of a row-major (mb, F) feat matrix (obs
// | actions | logp | value_n | advantage | return_n), transposed into its
// columns of `in`
__device__ void load_feat(float *in, const float *feat, int F, int r0,
                          int n, int tid) {
    constexpr int NC = D + NEXTRA;
    const int s0 = warp_sample0(tid), lane = tid & 31;
    for (int i = lane; i < SW * NC; i += 32) {
        const int s = s0 + i / NC, c = i % NC;
        in[(c < D ? c : c + 1) * SP + s] =
            s < n ? feat[(size_t)(r0 + s) * F + c] : 0.0f;
    }
}

// The gradient launch's body.  MODE 0: tiles of permuted (tick,
// world-block) blocks of traj / side; MODE 1: tiles of consecutive rows
// of a row-major (mb, F) feat matrix.  TT: the trajectory's element type
// (MODE 0), float or bf16 bits.
template <int MODE, class TT, bool STAMP>
__device__ __forceinline__ void grad_tiles(
    const int *__restrict__ idx, const TT *__restrict__ traj,
    const float *__restrict__ side, const float *__restrict__ feat,
    const float *__restrict__ nrm, const float *__restrict__ ustats,
    const float *__restrict__ params, float *__restrict__ partials,
    int rows, int W, int wb, int n_tiles, int F, int mb, LossHp hp,
    long long *stamps, int max_tiles) {
    extern __shared__ float4 smem4[];
    float *sm = reinterpret_cast<float *>(smem4);
    const int tid = threadIdx.x;
    float *bufs[2] = {sm + SI_IN, sm + SI_IN + IN_ROWS * SP};
    constexpr bool F32T = sizeof(TT) == sizeof(float);
    uint16_t *stg[2] = {
        reinterpret_cast<uint16_t *>(sm + SM_FLOATS),
        reinterpret_cast<uint16_t *>(sm + SM_FLOATS + STAGE_FLOATS)};
    GradAcc acc;
    zero_acc(acc);
    // MODE 0: the tile's position, and the permutation's entry for the
    // next one, each read a tile ahead of its use; the two buffers'
    // mbarriers and the parity of each one's next phase
    __shared__ uint64_t bars[2];
    uint32_t phases = 0;
    const int tpb = tiles_per_block(wb);
    TilePos<TT> pos{}, next{};
    int b_next = 0;
    if (MODE == 0 && tid == 0) {
        bar_init(&bars[0], 1);
        bar_init(&bars[1], 1);
        bar_fence_init();
    }
    __syncthreads();
    // the first tile's copies, then the weights
    if (MODE == 0 && blockIdx.x < n_tiles) {
        const int u0 = blockIdx.x;
        pos = tile_at(idx[u0 / tpb], u0 % tpb, traj, side, rows, W, wb);
        issue_tile(bufs[0], stg[0], pos, W, &bars[0], tid);
        if (u0 + gridDim.x < n_tiles) b_next = idx[(u0 + gridDim.x) / tpb];
    }
    load_weights(sm, params, nrm, tid);
    __syncthreads();
    int it = 0;
    for (int u = blockIdx.x; u < n_tiles; u += gridDim.x, ++it) {
        stamp<STAMP>(stamps, max_tiles, it, 0);
        float *in = bufs[it & 1];
        const int un = u + gridDim.x;
        const bool more = MODE == 0 && un < n_tiles;
        int n;
        if (MODE == 0) {
            n = pos.n;
            const int ua = un + gridDim.x;
            const int b_after = ua < n_tiles ? idx[ua / tpb] : 0;
            if (more) next = tile_at(b_next, un % tpb, traj, side, rows, W, wb);
            b_next = b_after;
            stamp<STAMP>(stamps, max_tiles, it, 1);
            // the tile's own copies
            if (bulk_tile(pos, W)) {
                bar_wait(&bars[it & 1], (phases >> (it & 1)) & 1u);
                phases ^= 1u << (it & 1);
            } else {
                cp_async_wait<0>();
            }
        } else {
            n = min(S, mb - u * S);
            load_feat(in, feat, F, u * S, n, tid);
            stamp<STAMP>(stamps, max_tiles, it, 1);
        }
        __syncwarp();   // the warp's columns have arrived
        if (MODE == 0 && !F32T) {
            upcast_stage(in, stg[it & 1], tid);
            __syncwarp();
        }
        stamp<STAMP>(stamps, max_tiles, it, 2);
        // the next tile's copies, into the buffer that the last CTA barrier
        // freed
        if (more)
            issue_tile(bufs[(it + 1) & 1], stg[(it + 1) & 1], next, W,
                       &bars[(it + 1) & 1], tid);
#pragma unroll
        for (int st = 0; st < N_STAGES; ++st) {
            tile_stage(st, sm, in, n, MODE == 0 ? ustats : nullptr, hp, acc,
                       tid);
            stamp<STAMP>(stamps, max_tiles, it, stamp_slot_done(st));
            if (cta_barrier_after(st)) __syncthreads();
            else __syncwarp();
            stamp<STAMP>(stamps, max_tiles, it, stamp_slot_done(st) + 1);
        }
        pos = next;
    }
    float *out = partials + (size_t)blockIdx.x * P;
    write_partials(sm, acc, out, tid, 0);
    __syncthreads();
    write_partials(sm, acc, out, tid, 1);
}

template <class K>
cudaError_t set_grad_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

inline LossHp loss_hp(float clip, float vf_coef, float ent_coef,
                      int clip_vloss, int mb) {
    LossHp hp;
    hp.clip = clip;
    hp.vf_coef = vf_coef;
    hp.ent_coef = ent_coef;
    hp.inv_mb = 1.0f / (float)mb;
    hp.clip_vloss = clip_vloss;
    return hp;
}

}  // namespace update
}  // namespace mbb
