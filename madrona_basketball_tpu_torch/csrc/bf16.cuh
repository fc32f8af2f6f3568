// bfloat16 trajectory storage (the --bf16-traj and --bf16-policy
// branches of kernels B, C, D, E and G), written once for nvcc and for
// g++ (the host builds host_gae.cpp and host_update.cpp).  A bf16 value
// travels as its 16 bits in a uint16_t: the high half of the float32 of
// the same value.
//   * f32_to_bf16 rounds to nearest, ties to even: on the card
//     __float2bfloat16_rn, on the host the same rounding on the float's
//     bits (torch's `.to(torch.bfloat16)`, NaN to 0x7fc0 as torch's);
//     the two agree on every float that is not a NaN, and map a NaN to
//     a NaN.
//   * bf16_to_f32 is exact: the bits shifted into the high half.

#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#include <cuda_bf16.h>
#define MBB_BF_HD __host__ __device__ __forceinline__
#else
#define MBB_BF_HD inline
#endif

namespace mbb {

MBB_BF_HD uint16_t f32_to_bf16(float x) {
#if defined(__CUDA_ARCH__)
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
#else
    uint32_t u;
    std::memcpy(&u, &x, sizeof u);
    if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;  // NaN
    return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
#endif
}

MBB_BF_HD float bf16_to_f32(uint16_t b) {
#if defined(__CUDA_ARCH__)
    return __uint_as_float((uint32_t)b << 16);
#else
    const uint32_t u = (uint32_t)b << 16;
    float x;
    std::memcpy(&x, &u, sizeof x);
    return x;
#endif
}

// A trajectory element of storage type TT (float, or uint16_t for bf16)
// from a float32 and back.
template <class TT>
MBB_BF_HD TT to_traj(float x);
template <>
MBB_BF_HD float to_traj<float>(float x) { return x; }
template <>
MBB_BF_HD uint16_t to_traj<uint16_t>(float x) { return f32_to_bf16(x); }

MBB_BF_HD float from_traj(float x) { return x; }
MBB_BF_HD float from_traj(uint16_t x) { return bf16_to_f32(x); }

}  // namespace mbb
