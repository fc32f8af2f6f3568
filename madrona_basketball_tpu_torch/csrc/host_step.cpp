// Host build of the per-world device body (sim_world.cuh) for the CPU test
// tests/test_torch_device_body.py: the same step_world, compiled by g++
// with contraction off, looped over the worlds.  Not part of the CUDA
// build (_build.py compiles the .cu files only).

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

// Host build of kernel F's per-world loop (multistep_world): noise null
// draws Philox with key (k0, k1) from tick_base, else reads the
// (K * 16, W) external matrix.
extern "C" void mbb_host_multistep(mbb::SimParams p, const float *noise,
                                   const float *sf, const int *si,
                                   float *sf_out, int *si_out, float *obs,
                                   int W, int K, int tick_base, uint32_t k0,
                                   uint32_t k1, int obs_every_tick,
                                   int blank_agent) {
    for (int w = 0; w < W; ++w) {
        mbb::World s;
        mbb::load_world(s, sf, si, W, w);
        if (obs_every_tick)
            mbb::multistep_world<true>(p, s, noise, K, tick_base, k0, k1,
                                       blank_agent, obs, W, w);
        else
            mbb::multistep_world<false>(p, s, noise, K, tick_base, k0, k1,
                                        blank_agent, obs, W, w);
        mbb::store_world(s, sf_out, si_out, W, w);
    }
}
