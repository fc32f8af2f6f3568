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
