// Host build of the per-world device body (sim_world.cuh): the same
// step_world that kernel A runs, compiled by g++ with contraction off
// (native/__init__.py::build_host_step builds it).  mbb_host_step loops it
// over the worlds, mbb_host_step_threaded splits the worlds into
// contiguous ranges, one std::thread each (the native host executor,
// native/__init__.py::NativeEngine); mbb_host_multistep is kernel F's CTA
// for the CPU tests.  Not part of the CUDA build (_build.py compiles the
// .cu files only).

#include <algorithm>
#include <functional>
#include <thread>
#include <vector>

#include "sim_world.cuh"

// Worlds [lo, hi).  Each world is loaded whole before it is stored, so
// sf_out / si_out may be sf / si (a step in place).
static void step_range(const mbb::SimParams &p, const float *noise,
                       const float *sf, const int *si, float *sf_out,
                       int *si_out, float *obs, int W, int lo, int hi) {
    for (int w = lo; w < hi; ++w) {
        mbb::World s;
        mbb::load_world(s, sf, si, W, w);
        float nz[mbb::N_NOISE_ROWS];
        for (int r = 0; r < mbb::N_NOISE_ROWS; ++r)
            nz[r] = noise[(size_t)r * W + w];
        mbb::step_world(p, s, nz, obs, W, w);
        mbb::store_world(s, sf_out, si_out, W, w);
    }
}

extern "C" void mbb_host_step(mbb::SimParams p, const float *noise,
                              const float *sf, const int *si, float *sf_out,
                              int *si_out, float *obs, int W) {
    step_range(p, noise, sf, si, sf_out, si_out, obs, W, 0, W);
}

// The worlds share no state (sim_world.cuh holds no statics), so every
// thread count gives the same bits.
extern "C" void mbb_host_step_threaded(mbb::SimParams p, const float *noise,
                                       const float *sf, const int *si,
                                       float *sf_out, int *si_out,
                                       float *obs, int W, int n_threads) {
    const int nt = std::max(1, std::min(n_threads, W));
    if (nt == 1) {
        step_range(p, noise, sf, si, sf_out, si_out, obs, W, 0, W);
        return;
    }
    const int chunk = (W + nt - 1) / nt;
    std::vector<std::thread> pool;
    for (int lo = 0; lo < W; lo += chunk)
        pool.emplace_back(step_range, std::cref(p), noise, sf, si, sf_out,
                          si_out, obs, W, lo, std::min(W, lo + chunk));
    for (auto &t : pool) t.join();
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
