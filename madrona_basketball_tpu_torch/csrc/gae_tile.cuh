// Kernel C's per-lane arithmetic (fused_gae.cu), shared with its host
// build (host_gae.cpp, tests/test_torch_gae_tile.py): a CTA owns a tile of
// GAE_TILE = 32 worlds, lane c of a warp one world, and every array below
// is a shared-memory tile of rows of GAE_TILE floats (row t at
// x[t * GAE_TILE + c]).  The sums and their orders:
//   * per world over the ticks: the reverse GAE in t = T-1 .. 0 (the sums
//     of value_un / adv / ret in that order), the M2 pass in t = 0 .. T-1;
//   * over the tile's worlds: one running sum in lane order (sum_lanes);
//   * over the CTAs of a world block: one running sum in rank order.

#pragma once

#ifndef MBB_HD
#if defined(__CUDACC__)
#define MBB_HD __device__ __forceinline__
#else
#include <cmath>
#define MBB_HD inline
#endif
#endif

namespace mbb {
namespace gae {

constexpr int GAE_TILE = 32;
constexpr int SIDE_ROWS = 8;

MBB_HD float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// The reverse GAE recursion of world `c` (t == T-1 pairs the bootstrap
// value with not_done[T-1], madrona_basketball_tpu/ops/fused_gae.py:118-121)
// over the staged value / reward / done rows; writes value_un, adv and ret
// into the three (T, GAE_TILE) rows of `side3` and their sums into sums[3].
MBB_HD void gae_reverse(const float *sv, const float *sr, const float *sd,
                        int T, int c, float next_value, float vmean,
                        float vsig, float gamma, float gamma_lam,
                        float *side3, float sums[3]) {
    const int n = T * GAE_TILE;
    float v_up = vmean + vsig * clampf(next_value, -5.0f, 5.0f);
    float nd_up = 1.0f - sd[(T - 1) * GAE_TILE + c];
    float lastgae = 0.0f;
    sums[0] = sums[1] = sums[2] = 0.0f;
    for (int t = T - 1; t >= 0; --t) {
        const int i = t * GAE_TILE + c;
        const float v = vmean + vsig * clampf(sv[i], -5.0f, 5.0f);
        const float nd = 1.0f - sd[i];
        const float delta = sr[i] + gamma * v_up * nd_up - v;
        lastgae = delta + gamma_lam * nd_up * lastgae;
        const float ret = lastgae + v;
        side3[i] = v;
        side3[n + i] = lastgae;
        side3[2 * n + i] = ret;
        sums[0] = sums[0] + v;
        sums[1] = sums[1] + lastgae;
        sums[2] = sums[2] + ret;
        v_up = v;
        nd_up = nd;
    }
}

// The episode-stat carry of world `c`, forward over the ticks: per tick
// curr * done and lens * done into the (T, GAE_TILE) rows cd and ld;
// curr and lens carry out.
MBB_HD void carry_forward(const float *sr, const float *sd, int T, int c,
                          float &curr, float &lens, float *cd, float *ld) {
    for (int t = 0; t < T; ++t) {
        const int i = t * GAE_TILE + c;
        const float d = sd[i];
        curr = curr + sr[i];
        lens = lens + 1.0f;
        cd[i] = curr * d;
        ld[i] = lens * d;
        curr = curr * (1.0f - d);
        lens = lens * (1.0f - d);
    }
}

// Centred squared deviations of world `c`'s value_un / adv / ret rows.
MBB_HD void m2_world(const float *side3, int T, int c, const float mean[3],
                     float m2[3]) {
    const int n = T * GAE_TILE;
    m2[0] = m2[1] = m2[2] = 0.0f;
    for (int t = 0; t < T; ++t) {
        const int i = t * GAE_TILE + c;
        for (int k = 0; k < 3; ++k) {
            const float d = side3[k * n + i] - mean[k];
            m2[k] = m2[k] + d * d;
        }
    }
}

// One row of GAE_TILE values summed in lane order.
MBB_HD float sum_lanes(const float *x) {
    float s = 0.0f;
    for (int c = 0; c < GAE_TILE; ++c) s = s + x[c];
    return s;
}

}  // namespace gae
}  // namespace mbb
