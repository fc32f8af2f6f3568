// Host build of kernel C (fused_gae.cu) for the CPU test
// tests/test_torch_gae_tile.py: each world block's cluster of gb / 32
// CTAs runs the same gae_tile.cuh steps in the card's order (stage, the
// reverse GAE and the carry, the CTA partials, the block means in rank
// order, the M2 pass, rank 0's sums), compiled by g++ with contraction off.
// mbb_host_gae_bf16 stages a trajectory of bf16 bits, upcast on load as
// the bf16 instance stages it.  Not part of the CUDA build (_build.py
// compiles the .cu files only).

#include <cstddef>
#include <cstdint>
#include <vector>

#include "bf16.cuh"
#include "gae_tile.cuh"

using namespace mbb::gae;

namespace {

template <class TT>
void host_gae(const TT *traj, const float *carry, const float *next_value,
              const float *vstats, float *side, float *moments,
              float *carry_out, float *ticks, int T, int rows, int W, int gb,
              int r_value, int r_rew, int r_done, float gamma,
              float gamma_lam) {
    const int ncl = gb / GAE_TILE, n = T * GAE_TILE;
    const float vmean = vstats[0], vsig = vstats[1];
    for (int block = 0; block < W / gb; ++block) {
        // per CTA of the cluster: staged rows, side tile, partials
        std::vector<std::vector<float>> stage(ncl), side3(ncl), part(ncl);
        for (int rank = 0; rank < ncl; ++rank) {
            const int w0 = (block * ncl + rank) * GAE_TILE;
            std::vector<float> &sh = stage[rank];
            sh.assign(5 * n, 0.0f);  // value | reward | done | cd | ld
            for (int k = 0; k < 3; ++k) {
                const int r = k == 0 ? r_value : (k == 1 ? r_rew : r_done);
                for (int t = 0; t < T; ++t)
                    for (int c = 0; c < GAE_TILE; ++c)
                        sh[k * n + t * GAE_TILE + c] = mbb::from_traj(
                            traj[((size_t)t * rows + r) * W + w0 + c]);
            }
            side3[rank].assign(3 * n, 0.0f);
            std::vector<float> wsum(3 * GAE_TILE);
            for (int c = 0; c < GAE_TILE; ++c) {  // warp 0
                float sums[3];
                gae_reverse(sh.data(), sh.data() + n, sh.data() + 2 * n, T, c,
                            next_value[w0 + c], vmean, vsig, gamma, gamma_lam,
                            side3[rank].data(), sums);
                for (int k = 0; k < 3; ++k) wsum[k * GAE_TILE + c] = sums[k];
            }
            for (int c = 0; c < GAE_TILE; ++c) {  // warp 1
                float curr = carry[w0 + c], lens = carry[W + w0 + c];
                carry_forward(sh.data() + n, sh.data() + 2 * n, T, c, curr,
                              lens, sh.data() + 3 * n, sh.data() + 4 * n);
                carry_out[w0 + c] = curr;
                carry_out[W + w0 + c] = lens;
            }
            part[rank].assign(6 + 3 * T, 0.0f);
            for (int k = 0; k < 3; ++k)
                part[rank][k] = sum_lanes(wsum.data() + k * GAE_TILE);
            for (int t = 0; t < T; ++t)
                for (int k = 0; k < 3; ++k)
                    part[rank][6 + 3 * t + k] = sum_lanes(
                        sh.data() + (k == 0 ? 2 : 2 + k) * n + t * GAE_TILE);
            for (int t = 0; t < T; ++t)
                for (int k = 0; k < SIDE_ROWS; ++k)
                    for (int c = 0; c < GAE_TILE; ++c)
                        side[((size_t)t * SIDE_ROWS + k) * W + w0 + c] =
                            k < 3 ? side3[rank][k * n + t * GAE_TILE + c]
                                  : 0.0f;
        }
        const float inv_n = 1.0f / (float)(T * GAE_TILE * ncl);
        float mean[3];
        for (int k = 0; k < 3; ++k) {
            float s = 0.0f;
            for (int rank = 0; rank < ncl; ++rank) s = s + part[rank][k];
            mean[k] = s * inv_n;
        }
        for (int rank = 0; rank < ncl; ++rank) {
            std::vector<float> wm2(3 * GAE_TILE);
            for (int c = 0; c < GAE_TILE; ++c) {
                float m2[3];
                m2_world(side3[rank].data(), T, c, mean, m2);
                for (int k = 0; k < 3; ++k) wm2[k * GAE_TILE + c] = m2[k];
            }
            for (int k = 0; k < 3; ++k)
                part[rank][3 + k] = sum_lanes(wm2.data() + k * GAE_TILE);
        }
        for (int k = 0; k < 3; ++k) {
            float s = 0.0f;
            for (int rank = 0; rank < ncl; ++rank) s = s + part[rank][3 + k];
            moments[(size_t)block * 8 + 2 * k] = mean[k];
            moments[(size_t)block * 8 + 2 * k + 1] = s;
        }
        moments[(size_t)block * 8 + 6] = moments[(size_t)block * 8 + 7] = 0.0f;
        for (int t = 0; t < T; ++t)
            for (int k = 0; k < 8; ++k) {
                float s = 0.0f;
                if (k < 3)
                    for (int rank = 0; rank < ncl; ++rank)
                        s = s + part[rank][6 + 3 * t + k];
                ticks[((size_t)block * T + t) * 8 + k] = s;
            }
    }
}

}  // namespace

extern "C" void mbb_host_gae(const float *traj, const float *carry,
                             const float *next_value, const float *vstats,
                             float *side, float *moments, float *carry_out,
                             float *ticks, int T, int rows, int W, int gb,
                             int r_value, int r_rew, int r_done, float gamma,
                             float gamma_lam) {
    host_gae(traj, carry, next_value, vstats, side, moments, carry_out, ticks,
             T, rows, W, gb, r_value, r_rew, r_done, gamma, gamma_lam);
}

extern "C" void mbb_host_gae_bf16(const uint16_t *traj, const float *carry,
                                  const float *next_value,
                                  const float *vstats, float *side,
                                  float *moments, float *carry_out,
                                  float *ticks, int T, int rows, int W, int gb,
                                  int r_value, int r_rew, int r_done,
                                  float gamma, float gamma_lam) {
    host_gae(traj, carry, next_value, vstats, side, moments, carry_out, ticks,
             T, rows, W, gb, r_value, r_rew, r_done, gamma, gamma_lam);
}
