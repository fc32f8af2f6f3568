// The windowed-meter scan of one rollout, on the device.
//
// Replaces the XLA scan at madrona_basketball_tpu/ppo/train_fused.py:602-615
// (no Pallas kernel there).  Input: kernel C's per-(block, tick) sums
// ticks (nb, T, 8) = [done count, sum(curr * done), sum(lens * done), 0...]
// and the meters (4,) = [reward mean, reward window, length mean, length
// window].  One block: thread t sums tick t over the nb blocks in block
// order; thread 0 then runs the T updates of both AverageMeters (window
// 100, ppo/train.py::_meter_update) in order and writes the meters (4,).
//
// Bound: bytes (nb * T * 8 floats read), but the T-step recursion is one
// serial chain, so launch latency sets the time.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void meter_update(float &mean, float &cur,
                                             float vsum, float count) {
    const float cap = 100.0f;
    if (!(count > 0.0f)) return;
    const float new_mean = vsum / fmaxf(count, 1.0f);
    const float size = fminf(count, cap);
    const float old = fminf(cap - size, cur);
    const float total = old + size;
    mean = (mean * old + new_mean * size) / fmaxf(total, 1.0f);
    cur = total;
}

__global__ void meter_scan_kernel(const float *__restrict__ ticks,
                                  const float *__restrict__ meters,
                                  float *__restrict__ out, int nb, int T) {
    extern __shared__ float per_t[];  // T * 3
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        for (int k = 0; k < nb; ++k) {
            const float *tk = ticks + ((size_t)k * T + t) * 8;
            s0 = s0 + tk[0];
            s1 = s1 + tk[1];
            s2 = s2 + tk[2];
        }
        per_t[t * 3 + 0] = s0;
        per_t[t * 3 + 1] = s1;
        per_t[t * 3 + 2] = s2;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    float r_mean = meters[0], r_size = meters[1];
    float l_mean = meters[2], l_size = meters[3];
    for (int t = 0; t < T; ++t) {
        meter_update(r_mean, r_size, per_t[t * 3 + 1], per_t[t * 3 + 0]);
        meter_update(l_mean, l_size, per_t[t * 3 + 2], per_t[t * 3 + 0]);
    }
    out[0] = r_mean;
    out[1] = r_size;
    out[2] = l_mean;
    out[3] = l_size;
}

}  // namespace

extern "C" int mbb_meter_scan(const float *ticks, const float *meters,
                              float *out, int nb, int T,
                              cudaStream_t stream) {
    if (nb < 1 || T < 1 || T > 4096) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)3 * T * sizeof(float);
    meter_scan_kernel<<<1, 32, smem, stream>>>(ticks, meters, out, nb, T);
    return (int)cudaGetLastError();
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
