// Host build of the per-world device body (sim_world.cuh) for the CPU
// tests (tests/test_torch_device_body.py, tests/test_torch_multistep_tile.py):
// the same step_world, compiled by g++ with contraction off, looped over
// the worlds.  Not part of the CUDA build (_build.py compiles the .cu files
// only).

#include <algorithm>
#include <vector>

#include "sim_world.cuh"

extern "C" void mbb_host_step(mbb::SimParams p, const float *noise,
                              const float *sf, const int *si, float *sf_out,
                              int *si_out, float *obs, int W) {
    for (int w = 0; w < W; ++w) {
        mbb::World s;
        mbb::load_world(s, sf, si, W, w);
        float nz[mbb::N_NOISE_ROWS];
        for (int r = 0; r < mbb::N_NOISE_ROWS; ++r)
            nz[r] = noise[(size_t)r * W + w];
        mbb::step_world(p, s, nz, obs, W, w);
        mbb::store_world(s, sf_out, si_out, W, w);
    }
}

// Kernel F's CTA on the host: each tile of MS_TILE worlds runs the warp
// roles of fused_multistep.cu in the card's order, one barrier phase after
// another (sim warp, noise warp, obs warps; the barrier), with the same
// shared ring, snapshot and obs tile.  noise null draws Philox with key
// (k0, k1) from tick_base, else reads the (K * 16, W) external matrix.
extern "C" void mbb_host_multistep(mbb::SimParams p, const float *noise,
                                   const float *sf, const int *si,
                                   float *sf_out, int *si_out, float *obs,
                                   int W, int K, int tick_base, uint32_t k0,
                                   uint32_t k1, int obs_every_tick,
                                   int blank_agent) {
    using namespace mbb;
    std::vector<float> ring(2 * MS_RING_SLOT), snap(2 * MS_SNAP_SLOT),
        tile(N_OBS_ROWS * MS_TILE);
    for (int w0 = 0; w0 < W; w0 += MS_TILE) {
        const int n = std::min(MS_TILE, W - w0);
        World s[MS_TILE];
        for (int c = 0; c < n; ++c) {
            load_world(s[c], sf, si, W, w0 + c);
            draw_tick_noise(ring.data(), c, noise, 0, tick_base, k0, k1, W,
                            w0 + c);
        }
        for (int t = 0; t < K; ++t) {
            for (int c = 0; c < n; ++c) {  // warp 0
                sim_tick(p, s[c], ring.data() + (t & 1) * MS_RING_SLOT, c,
                         blank_agent);
                if (obs_every_tick)
                    store_obs_snapshot(s[c],
                                       snap.data() + (t & 1) * MS_SNAP_SLOT, c);
            }
            for (int c = 0; c < n && t + 1 < K; ++c)  // warp 1
                draw_tick_noise(ring.data() + ((t + 1) & 1) * MS_RING_SLOT, c,
                                noise, t + 1, tick_base, k0, k1, W, w0 + c);
            for (int i = 0; i < NUM_AGENTS && obs_every_tick && t > 0; ++i)
                for (int c = 0; c < n; ++c)  // warps 2, 3
                    obs_from_snapshot(
                        p, snap.data() + ((t - 1) & 1) * MS_SNAP_SLOT, i,
                        tile.data(), c);
        }
        for (int c = 0; c < n; ++c) {
            if (obs_every_tick) {
                for (int i = 0; i < NUM_AGENTS; ++i)
                    obs_from_snapshot(
                        p, snap.data() + ((K - 1) & 1) * MS_SNAP_SLOT, i,
                        tile.data(), c);
                for (int r = 0; r < N_OBS_ROWS; ++r)
                    obs[(size_t)r * W + w0 + c] = tile[r * MS_TILE + c];
            } else {
                fill_observations(p, s[c], obs, W, w0 + c);
            }
            store_world(s[c], sf_out, si_out, W, w0 + c);
        }
    }
}
