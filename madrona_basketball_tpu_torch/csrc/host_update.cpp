// Host build of the update kernels' tile arithmetic (update_tile.cuh) for
// the CPU test tests/test_torch_update_tiles.py: kernel D's, G's and H's
// decomposition run in the card's order - the same CTAs (G = min(tiles,
// max_parts)), each walking tiles u, u + G, ..., every stage of a tile
// run for threads 0..255 in turn, each thread's sums kept across its
// CTA's tiles, then the reduce's chunk order, slice norms and clip +
// Adam.  The _bf16 entries read a trajectory of bf16 bits, upcast on load
// as the card's bf16 instances upcast their staging tiles.  Compiled by
// g++ with contraction off; not part of the CUDA build (_build.py
// compiles the .cu files only).

#include <cstdint>
#include <cstring>
#include <vector>

#include "bf16.cuh"
#include "update_tile.cuh"

using namespace mbb::update;

namespace {

// where the samples of tile u come from: MODE 0 traj / side blocks (traj
// float32, or bf16 bits when bf16), MODE 1 a row-major feat matrix
struct Source {
    int mode;
    const int *idx;
    const void *traj;
    const float *side, *feat;
    int rows, W, wb, F, mb;
    bool bf16;
};

// element i of a Source's trajectory as float32
float traj_at(const Source &src, size_t i) {
    return src.bf16 ? mbb::from_traj(static_cast<const uint16_t *>(src.traj)[i])
                    : static_cast<const float *>(src.traj)[i];
}

int load_input(const Source &src, int u, float *in) {
    if (src.mode == 1) {
        constexpr int NC = D + NEXTRA;
        const int n = src.mb - u * S < S ? src.mb - u * S : S;
        for (int s = 0; s < S; ++s)
            for (int c = 0; c < NC; ++c)
                in[(c < D ? c : c + 1) * SP + s] =
                    s < n ? src.feat[(size_t)(u * S + s) * src.F + c] : 0.0f;
        return n;
    }
    const int tpb = (src.wb + S - 1) / S, wblk = src.W / src.wb;
    const int b = src.idx[u / tpb], sub = u % tpb, t = b / wblk;
    const int w = (b % wblk) * src.wb + sub * S;
    const int n = src.wb - sub * S < S ? src.wb - sub * S : S;
    const size_t tc = (size_t)t * src.rows * src.W + w;
    const float *sc = src.side + (size_t)t * SIDE_ROWS * src.W + w;
    for (int r = 0; r < IN_ROWS; ++r) {
        if (r == D) continue;
        for (int s = 0; s < S; ++s) {
            float v = 0.0f;
            if (s < n && r < EX_V) {
                const int tr = r < D ? r : R_ACT + r - EX_ACT;
                v = traj_at(src, tc + (size_t)tr * src.W + s);
            } else if (s < n) {
                v = sc[(size_t)(r - EX_V) * src.W + s];
            }
            in[r * SP + s] = v;
        }
    }
    return n;
}

// one gradient launch: every CTA's row of partials; returns the grid
int grad_launch(const Source &src, int n_tiles, int max_parts,
                const float *nrm, const float *ustats, const float *params,
                LossHp hp, float *partials) {
    const int grid = n_tiles < max_parts ? n_tiles : max_parts;
    std::vector<float> smem(SM_FLOATS);
    std::vector<GradAcc> acc(NT);
    float *sm = smem.data(), *in = sm + SI_IN;
    for (int cta = 0; cta < grid; ++cta) {
        for (int tid = 0; tid < NT; ++tid) {
            load_weights(sm, params, nrm, tid);
            zero_acc(acc[tid]);
        }
        for (int u = cta; u < n_tiles; u += grid) {
            const int n = load_input(src, u, in);
            for (int st = 0; st < N_STAGES; ++st)
                for (int tid = 0; tid < NT; ++tid)
                    tile_stage(st, sm, in, n, src.mode == 0 ? ustats : nullptr,
                               hp, acc[tid], tid);
        }
        for (int step = 0; step < 2; ++step)
            for (int tid = 0; tid < NT; ++tid)
                write_partials(sm, acc[tid], partials + (size_t)cta * P, tid,
                               step);
    }
    return grid;
}

// the reduce: the summed gradient into g; the global norm
float reduce(const float *partials, int nparts, float *g) {
    for (int p = 0; p < P; ++p) {
        float c[RED_CH];
        for (int ch = 0; ch < RED_CH; ++ch)
            c[ch] = chunk_sum(partials, nparts, p, ch);
        float s = c[0];
        for (int ch = 1; ch < RED_CH; ++ch) s += c[ch];
        g[p] = s;
    }
    float sq[RED_CTAS], lanes[32];
    for (int cta = 0; cta < RED_CTAS; ++cta) {
        float v[32];
        for (int l = 0; l < 32; ++l) {
            const int p = cta * 32 + l;
            v[l] = p < P ? g[p] * g[p] : 0.0f;
        }
        sq[cta] = butterfly32(v);
    }
    for (int l = 0; l < 32; ++l) lanes[l] = lane_slices(sq, RED_CTAS, l);
    return sqrtf(butterfly32(lanes));
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

void update_phase(const int *idx, const int *count, const void *traj,
                  bool bf16, const float *side, const float *nrm,
                  const float *ustats, float *params, float *mu, float *nu,
                  int max_parts, int rows, int W, int wb, int bpm, int n_mb,
                  float clip, float vf_coef, float ent_coef, int clip_vloss,
                  float lr, float max_norm) {
    const int n_tiles = bpm * ((wb + S - 1) / S);
    const LossHp hp = loss_hp(clip, vf_coef, ent_coef, clip_vloss, bpm * wb);
    std::vector<float> partials((size_t)max_parts * P), g(P);
    for (int k = 0; k < n_mb; ++k) {
        const Source src{0, idx + (size_t)k * bpm, traj, side, nullptr,
                         rows, W, wb, 0, 0, bf16};
        const int grid = grad_launch(src, n_tiles, max_parts, nrm, ustats,
                                     params, hp, partials.data());
        const float gn = reduce(partials.data(), grid, g.data());
        const float bc1 = bias_correction(ADAM_B1, *count + k + 1);
        const float bc2 = bias_correction(ADAM_B2, *count + k + 1);
        for (int p = 0; p < P; ++p)
            adam_one(g[p], gn, max_norm, lr, bc1, bc2, params[p], mu[p],
                     nu[p]);
    }
}

void grad_prefetch(const int *idx, const void *traj, bool bf16,
                   const float *side, const float *nrm, const float *params,
                   float *grads, int max_parts, int rows, int W, int wb,
                   int bpm, float clip, float vf_coef, float ent_coef,
                   int clip_vloss) {
    const Source src{0, idx, traj, side, nullptr, rows, W, wb, 0, 0, bf16};
    std::vector<float> partials((size_t)max_parts * P);
    const int grid = grad_launch(
        src, bpm * ((wb + S - 1) / S), max_parts, nrm, nullptr, params,
        loss_hp(clip, vf_coef, ent_coef, clip_vloss, bpm * wb),
        partials.data());
    reduce(partials.data(), grid, grads);
}

}  // namespace

// The warp that owns each float of shared memory in stages 0..15 (the
// activation tiles, the per-sample scratch and the first input buffer,
// where column s belongs to warp s / SW): owner[i] its warp, -1 for a
// padding column of those rows, -2 for the rest (weights, normalizer, the
// second input buffer).
extern "C" void mbb_host_sample_owner(int *owner) {
    for (int i = 0; i < SM_FLOATS; ++i) {
        int c;
        if (i >= SA_H1 && i < SS_PART)
            c = (i - SA_H1) % SP;
        else if (i >= SS_PART && i < SS_END)
            c = (i - SS_PART) % S;
        else if (i >= SI_IN && i < SI_IN + IN_ROWS * SP)
            c = (i - SI_IN) % SP;
        else
            c = -1;
        owner[i] = c < 0 ? -2 : (c < S ? c / SW : -1);
    }
}

// Stages 0..WGRAD_STAGE-1 of one tile: shared memory (SM_FLOATS) zeroed,
// the weights and normalizer loaded, the raw tile (IN_ROWS x S, row D
// ignored) in the first input buffer; then each stage for every thread in
// turn, or, where keep >= 0, only for warp keep's 32 threads, with every
// float outside its samples in the activation, scratch and input rows
// (mbb_host_sample_owner) set to `fill` first.  sm: shared memory after
// the stages.
extern "C" void mbb_host_warp_stages(const float *params, const float *nrm,
                                     const float *ustats, const float *tile,
                                     int n, float clip, float vf_coef,
                                     float ent_coef, int clip_vloss, int mb,
                                     int keep, float fill, float *sm) {
    std::vector<int> owner(SM_FLOATS);
    mbb_host_sample_owner(owner.data());
    for (int i = 0; i < SM_FLOATS; ++i) sm[i] = 0.0f;
    for (int tid = 0; tid < NT; ++tid) load_weights(sm, params, nrm, tid);
    for (int r = 0; r < IN_ROWS; ++r)
        for (int s = 0; s < S; ++s) sm[SI_IN + r * SP + s] = tile[r * S + s];
    if (keep >= 0)
        for (int i = 0; i < SM_FLOATS; ++i)
            if (owner[i] != keep && owner[i] != -2) sm[i] = fill;
    const LossHp hp = loss_hp(clip, vf_coef, ent_coef, clip_vloss, mb);
    GradAcc acc;
    zero_acc(acc);
    const int t0 = keep >= 0 ? 32 * keep : 0, t1 = keep >= 0 ? t0 + 32 : NT;
    for (int st = 0; st < WGRAD_STAGE; ++st)
        for (int tid = t0; tid < t1; ++tid)
            tile_stage(st, sm, sm + SI_IN, n, ustats, hp, acc, tid);
}

// The tile's layout and the gradient kernel's barriers a tile: out[0..3]
// SM_FLOATS, IN_ROWS, S, SW; out[4..6] CTA-wide, warp-wide, and
// warp-wide in the bf16 instances; out[7] N_STAGES.
extern "C" void mbb_host_update_layout(int *out) {
    const int v[8] = {SM_FLOATS,     IN_ROWS,       S,
                      SW,            CTA_BARRIERS,  WARP_BARRIERS,
                      WARP_BARRIERS_BF16, N_STAGES};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// Kernel D's arguments without the stream and the scratch.
extern "C" void mbb_host_update_phase(
    const int *idx, const int *count, const float *traj, const float *side,
    const float *nrm, const float *ustats, float *params, float *mu,
    float *nu, int max_parts, int rows, int W, int wb, int bpm, int n_mb,
    float clip, float vf_coef, float ent_coef, int clip_vloss, float lr,
    float max_norm) {
    update_phase(idx, count, traj, false, side, nrm, ustats, params, mu, nu,
                 max_parts, rows, W, wb, bpm, n_mb, clip, vf_coef, ent_coef,
                 clip_vloss, lr, max_norm);
}

// Kernel D on a trajectory of bf16 bits (uint16_t).
extern "C" void mbb_host_update_phase_bf16(
    const int *idx, const int *count, const uint16_t *traj,
    const float *side, const float *nrm, const float *ustats, float *params,
    float *mu, float *nu, int max_parts, int rows, int W, int wb, int bpm,
    int n_mb, float clip, float vf_coef, float ent_coef, int clip_vloss,
    float lr, float max_norm) {
    update_phase(idx, count, traj, true, side, nrm, ustats, params, mu, nu,
                 max_parts, rows, W, wb, bpm, n_mb, clip, vf_coef, ent_coef,
                 clip_vloss, lr, max_norm);
}

// Kernel G's arguments without the stream and the scratch.
extern "C" void mbb_host_minibatch_grad_prefetch(
    const int *idx, const float *traj, const float *side, const float *nrm,
    const float *params, float *grads, int max_parts, int rows, int W,
    int wb, int bpm, float clip, float vf_coef, float ent_coef,
    int clip_vloss) {
    grad_prefetch(idx, traj, false, side, nrm, params, grads, max_parts, rows,
                  W, wb, bpm, clip, vf_coef, ent_coef, clip_vloss);
}

// Kernel G on a trajectory of bf16 bits (uint16_t).
extern "C" void mbb_host_minibatch_grad_prefetch_bf16(
    const int *idx, const uint16_t *traj, const float *side,
    const float *nrm, const float *params, float *grads, int max_parts,
    int rows, int W, int wb, int bpm, float clip, float vf_coef,
    float ent_coef, int clip_vloss) {
    grad_prefetch(idx, traj, true, side, nrm, params, grads, max_parts, rows,
                  W, wb, bpm, clip, vf_coef, ent_coef, clip_vloss);
}

// Kernel H's arguments without the stream and the scratch.
extern "C" void mbb_host_minibatch_grad(const float *feat, const float *nrm,
                                        const float *params, float *grads,
                                        int max_parts, int mb, int F,
                                        float clip, float vf_coef,
                                        float ent_coef, int clip_vloss) {
    const Source src{1, nullptr, nullptr, nullptr, feat, 0, 1, 1, F, mb,
                     false};
    std::vector<float> partials((size_t)max_parts * P);
    const int grid = grad_launch(
        src, (mb + S - 1) / S, max_parts, nrm, nullptr, params,
        loss_hp(clip, vf_coef, ent_coef, clip_vloss, mb), partials.data());
    reduce(partials.data(), grid, grads);
}
