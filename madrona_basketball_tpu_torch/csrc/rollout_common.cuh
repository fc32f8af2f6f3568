// The rollout kernels' shared pieces: kernel B (fused_rollout.cu, one
// thread per world) and kernel I (fused_rollout_tiled.cu, a CTA per tile
// of worlds) write the same trajectory rows, read the same packed policy
// and external-noise layout, and sample actions the same way.
// Constants mirror ops/fused_rollout.py.

#pragma once

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

}  // namespace rollout
}  // namespace mbb
