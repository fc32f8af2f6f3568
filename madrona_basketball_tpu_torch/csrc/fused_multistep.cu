// Kernel F: K simulation ticks for every world in one launch, no policy.
//
// Replaces the Pallas kernel make_fused_multistep
// (madrona_basketball_tpu/ops/fused_step.py:1134, pallas_call :1274).
// Noise is in-kernel Philox (mbb_fused_multistep; kernel B's counter
// scheme, so a K-tick launch equals K one-tick launches with tick_base
// advanced) or an external (K * 16, W) matrix (mbb_fused_multistep_ext,
// tests and parity).  Two instances: obs every tick (bench.py's headline
// workload) or once, from the final state (held actions, eval bursts).
//
// Bound: operations, and in practice the latency of one tick's dependent
// chain of 19 systems: a world is one thread, and 8192 worlds fill only
// ~2 warps of each SM, so nothing hides that chain.  What the design does:
//   * A CTA owns a tile of MS_TILE = 32 worlds.  Warp 0 (the sim warp)
//     keeps each world in one thread's registers for all K ticks
//     (sim_world.cuh::sim_tick) and loads and stores the state once.
//   * Warp 1 (the noise warp) draws tick t + 1's Philox groups (or loads
//     its external rows) into a two-slot shared ring while warp 0 runs
//     tick t, so the draws leave the sim's chain.
//   * Obs every tick: system 18 leaves the sim warp too.  Warp 0 stores
//     the 62 fields system 18 reads into a two-slot snapshot after each
//     tick; warps 2-3 (one per agent) turn the previous tick's snapshot
//     into its 128 obs rows in a shared tile of 256 x 32, overwritten
//     every tick (the TPU kernel's VMEM-resident obs block), and the tile
//     goes to global memory once, after the last tick, in coalesced rows
//     (not 8.4 MB of global stores a tick at 8192 worlds).
//   * Held obs: system 18 runs once, on the final state, from warp 0.
//   * One CTA barrier a tick orders the roles: the sim reads ring slot
//     t & 1 and writes snapshot slot t & 1 while the noise warp writes
//     ring slot (t + 1) & 1 and the obs warps read snapshot slot
//     (t - 1) & 1.
// The TPU kernel's (8, W/8) tiles and VMEM block limits have no
// counterpart: rows stay (rows, W), any W is taken (the last tile masks
// its missing worlds).  Resident warps per SM: mbb_fused_multistep_occupancy.
//
// Built by madrona_basketball_tpu_torch/_build.py; called through ctypes
// from ops/fused_step.py::fused_multistep.  host_step.cpp runs the same
// role functions in this order on the CPU.

#include <cstdint>

#include <cuda_runtime.h>

#include "sim_world.cuh"

using namespace mbb;

namespace {

// threads per CTA: sim + noise warps, plus two obs warps with obs every tick
template <bool OBS_EVERY_TICK>
constexpr int threads() { return OBS_EVERY_TICK ? 128 : 64; }

// dynamic shared memory: the noise ring, plus the snapshot ring and the
// obs tile with obs every tick
template <bool OBS_EVERY_TICK>
constexpr size_t smem_bytes() {
    return (2 * MS_RING_SLOT +
            (OBS_EVERY_TICK ? 2 * MS_SNAP_SLOT + N_OBS_ROWS * MS_TILE : 0)) *
           sizeof(float);
}

template <bool OBS_EVERY_TICK>
__global__ void __launch_bounds__(OBS_EVERY_TICK ? 128 : 64, 2)
fused_multistep_kernel(SimParams p, const float *__restrict__ ext,
                       const float *__restrict__ sf,
                       const int *__restrict__ si, float *__restrict__ sf_out,
                       int *__restrict__ si_out, float *__restrict__ obs,
                       int W, int K, int tick_base, uint32_t k0, uint32_t k1,
                       int blank_agent) {
    extern __shared__ float smem[];
    float *ring = smem;                       // 2 x (9, MS_TILE)
    float *snap = ring + 2 * MS_RING_SLOT;    // 2 x (62, MS_TILE)
    float *tile = snap + 2 * MS_SNAP_SLOT;    // (256, MS_TILE)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int w0 = blockIdx.x * MS_TILE;
    const int w = w0 + lane;
    const bool live = w < W;

    World s;
    if (warp == 0 && live) load_world(s, sf, si, W, w);
    if (warp == 1 && live)
        draw_tick_noise(ring, lane, ext, 0, tick_base, k0, k1, W, w);
    __syncthreads();
    for (int t = 0; t < K; ++t) {
        if (warp == 0) {
            if (live) {
                sim_tick(p, s, ring + (t & 1) * MS_RING_SLOT, lane,
                         blank_agent);
                if constexpr (OBS_EVERY_TICK)
                    store_obs_snapshot(s, snap + (t & 1) * MS_SNAP_SLOT, lane);
            }
        } else if (warp == 1) {
            if (live && t + 1 < K)
                draw_tick_noise(ring + ((t + 1) & 1) * MS_RING_SLOT, lane,
                                ext, t + 1, tick_base, k0, k1, W, w);
        } else if constexpr (OBS_EVERY_TICK) {
            if (live && t > 0)
                obs_from_snapshot(p, snap + ((t - 1) & 1) * MS_SNAP_SLOT,
                                  warp - 2, tile, lane);
        }
        __syncthreads();
    }
    if constexpr (OBS_EVERY_TICK) {
        if (warp >= 2 && live)
            obs_from_snapshot(p, snap + ((K - 1) & 1) * MS_SNAP_SLOT,
                              warp - 2, tile, lane);
        __syncthreads();
        for (int i = threadIdx.x; i < N_OBS_ROWS * MS_TILE; i += blockDim.x) {
            const int r = i / MS_TILE, c = i % MS_TILE;
            if (w0 + c < W) obs[(size_t)r * W + w0 + c] = tile[i];
        }
    } else if (warp == 0 && live) {
        fill_observations(p, s, obs, W, w);
    }
    if (warp == 0 && live) store_world(s, sf_out, si_out, W, w);
}

template <bool OBS_EVERY_TICK>
cudaError_t prepare() {
    return cudaFuncSetAttribute(fused_multistep_kernel<OBS_EVERY_TICK>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_bytes<OBS_EVERY_TICK>());
}

template <bool OBS_EVERY_TICK>
int launch(SimParams p, const float *ext, const float *sf, const int *si,
           float *sf_out, int *si_out, float *obs, int W, int K,
           int tick_base, uint32_t k0, uint32_t k1, int blank_agent,
           cudaStream_t stream) {
    const cudaError_t err = prepare<OBS_EVERY_TICK>();
    if (err != cudaSuccess) return (int)err;
    fused_multistep_kernel<OBS_EVERY_TICK>
        <<<(W + MS_TILE - 1) / MS_TILE, threads<OBS_EVERY_TICK>(),
           smem_bytes<OBS_EVERY_TICK>(), stream>>>(
            p, ext, sf, si, sf_out, si_out, obs, W, K, tick_base, k0, k1,
            blank_agent);
    return (int)cudaGetLastError();
}

int launch_any(SimParams p, const float *ext, const float *sf, const int *si,
               float *sf_out, int *si_out, float *obs, int W, int K,
               int tick_base, uint32_t k0, uint32_t k1, int obs_every_tick,
               int blank_agent, cudaStream_t stream) {
    if (W < 1 || K < 1) return (int)cudaErrorInvalidValue;
    return obs_every_tick
               ? launch<true>(p, ext, sf, si, sf_out, si_out, obs, W, K,
                              tick_base, k0, k1, blank_agent, stream)
               : launch<false>(p, ext, sf, si, sf_out, si_out, obs, W, K,
                               tick_base, k0, k1, blank_agent, stream);
}

template <bool OBS_EVERY_TICK>
int occupancy(int *out) {
    cudaError_t err = prepare<OBS_EVERY_TICK>();
    if (err != cudaSuccess) return (int)err;
    out[1] = threads<OBS_EVERY_TICK>();
    out[2] = (int)smem_bytes<OBS_EVERY_TICK>();
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, fused_multistep_kernel<OBS_EVERY_TICK>, out[1],
        smem_bytes<OBS_EVERY_TICK>());
}

}  // namespace

// In-kernel Philox noise, key (k0, k1), ticks tick_base .. tick_base + K - 1.
extern "C" int mbb_fused_multistep(SimParams p, const float *sf,
                                   const int *si, float *sf_out, int *si_out,
                                   float *obs, int W, int K, int tick_base,
                                   uint32_t k0, uint32_t k1,
                                   int obs_every_tick, int blank_agent,
                                   cudaStream_t stream) {
    return launch_any(p, nullptr, sf, si, sf_out, si_out, obs, W, K,
                      tick_base, k0, k1, obs_every_tick, blank_agent, stream);
}

// External noise: (K * 16, W), rows 0-8 of each 16-row chunk used.
extern "C" int mbb_fused_multistep_ext(SimParams p, const float *noise,
                                       const float *sf, const int *si,
                                       float *sf_out, int *si_out, float *obs,
                                       int W, int K, int obs_every_tick,
                                       int blank_agent, cudaStream_t stream) {
    return launch_any(p, noise, sf, si, sf_out, si_out, obs, W, K, 0, 0u, 0u,
                      obs_every_tick, blank_agent, stream);
}

// Resident CTAs per SM, threads per CTA and dynamic shared memory of the
// held-obs (out[0..2]) and the obs-every-tick (out[3..5]) instance.
extern "C" int mbb_fused_multistep_occupancy(int *out) {
    const int err = occupancy<false>(out);
    if (err != 0) return err;
    return occupancy<true>(out + 3);
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
