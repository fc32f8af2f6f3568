// Kernel D's stage probe: the gradient launch of one minibatch (float32
// trajectory, raw side rows as D reads them) with clock stamps at every
// stage boundary, for the per-stage attribution in chip_smoke.py.
//
// Replaces no Pallas kernel: the TPU kernel has no counterpart, and the
// probe exists to attribute update_grad_kernel's time on the card.  The
// body is update_grad.cuh::grad_tiles with STAMP on, so it runs D's tiles
// in D's order and writes D's partial sums; lane 0 of warps 0 and 6 of
// CTA 0 write clock64() before and after every barrier of every tile
// (update_grad.cuh, STAMP_SLOTS a tile).  No trainer path launches it.
//
// Bound: as update_grad_kernel's (operations); the stamps add two global
// stores per stage to two lanes of one CTA.

#include <cstdint>

#include <cuda_runtime.h>

#include "update_grad.cuh"

using namespace mbb::update;

namespace {

__global__ void __launch_bounds__(NT, 1)
update_grad_probe_kernel(const int *__restrict__ idx,
                         const float *__restrict__ traj,
                         const float *__restrict__ side,
                         const float *__restrict__ nrm,
                         const float *__restrict__ ustats,
                         const float *__restrict__ params,
                         float *__restrict__ partials, int rows, int W,
                         int wb, int n_tiles, LossHp hp, long long *stamps,
                         int max_tiles) {
    grad_tiles<0, float, true>(idx, traj, side, nullptr, nrm, ustats, params,
                               partials, rows, W, wb, n_tiles, 0, 0, hp,
                               stamps, max_tiles);
}

}  // namespace

// One gradient launch of kernel D over the bpm blocks idx[0..bpm) (the
// partial sums into partials' first rows, no reduce), with the stamps:
// stamps holds 2 x max_tiles x STAMP_SLOTS int64, max_tiles the tiles of
// CTA 0 (ceil(tiles / grid), grid = min(tiles, max_parts)).
extern "C" int mbb_fused_update_probe(
    const int *idx, const float *traj, const float *side, const float *nrm,
    const float *ustats, const float *params, float *partials,
    long long *stamps, int max_parts, int max_tiles, int rows, int W,
    int wb, int bpm, float clip, float vf_coef, float ent_coef,
    int clip_vloss, cudaStream_t stream) {
    if (wb < 1 || W % wb != 0 || bpm < 1 || max_parts < 1 ||
        rows <= R_LOGP || stamps == nullptr)
        return (int)cudaErrorInvalidValue;
    const int n_tiles = bpm * ((wb + S - 1) / S);
    const int grid = n_tiles < max_parts ? n_tiles : max_parts;
    if (max_tiles != (n_tiles + grid - 1) / grid)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = set_grad_smem(update_grad_probe_kernel, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    update_grad_probe_kernel<<<grid, NT, SMEM_BYTES, stream>>>(
        idx, traj, side, nrm, ustats, params, partials, rows, W, wb, n_tiles,
        loss_hp(clip, vf_coef, ent_coef, clip_vloss, bpm * wb), stamps,
        max_tiles);
    return (int)cudaGetLastError();
}

// The stamps' layout: out[0] STAMP_SLOTS, out[1] N_STAGES, out[2..3] the
// stamped warps.
extern "C" int mbb_fused_update_probe_layout(int *out) {
    out[0] = STAMP_SLOTS;
    out[1] = N_STAGES;
    out[2] = STAMP_WARP0;
    out[3] = STAMP_WARP1;
    return 0;
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
