// The tracer's device phase stamp and its clock calibration
// (utils/profiling.py).
//
// Replaces no TPU kernel: the JAX package traces with jax.profiler only.
// A stamp is one thread that reads the ring's cursor, writes (id,
// %globaltimer) at it while it is under the capacity, and advances it, so
// a full ring counts the records it dropped (cursor - capacity) and never
// wraps.  Launched inside a stream capture it is one kernel node, which
// every replay runs with the ids and pointers baked in at capture.  The
// calibration launches CAL pairs of a one-thread clock read, each between
// a host CLOCK_MONOTONIC read (Python's time.perf_counter_ns) before the
// launch and one after the stream has drained, and writes both.
//
// Bound: launch latency (two 8-byte stores and a 4-byte read-modify-write).

#include <cuda_runtime.h>
#include <time.h>

namespace {

__device__ __forceinline__ long long globaltimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void stamp_kernel(long long *ring, int *cursor, int capacity,
                             int id) {
    const int i = *cursor;
    if (i < capacity) {
        ring[2 * (size_t)i] = id;
        ring[2 * (size_t)i + 1] = globaltimer();
    }
    *cursor = i + 1;
}

__global__ void clock_kernel(long long *out) { *out = globaltimer(); }

long long monotonic_ns() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

}  // namespace

extern "C" int mbb_trace_stamp(long long *ring, int *cursor, int capacity,
                               int id, cudaStream_t stream) {
    if (capacity < 1) return (int)cudaErrorInvalidValue;
    stamp_kernel<<<1, 1, 0, stream>>>(ring, cursor, capacity, id);
    return (int)cudaGetLastError();
}

// device_ns (n,) on the card; host_ns (2n,) in host memory: the host reads
// before and after pair i at 2i and 2i + 1
extern "C" int mbb_trace_stamp_calibrate(long long *device_ns,
                                         long long *host_ns, int n,
                                         cudaStream_t stream) {
    cudaError_t err = cudaStreamSynchronize(stream);
    for (int i = 0; i < n && err == cudaSuccess; ++i) {
        const long long before = monotonic_ns();
        clock_kernel<<<1, 1, 0, stream>>>(device_ns + i);
        err = cudaStreamSynchronize(stream);
        const long long after = monotonic_ns();
        host_ns[2 * i] = before;
        host_ns[2 * i + 1] = after;
    }
    return err == cudaSuccess ? (int)cudaGetLastError() : (int)err;
}

extern "C" const char *mbb_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
