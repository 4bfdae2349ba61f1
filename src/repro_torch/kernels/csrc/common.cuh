// Shared device helpers of the fabric kernels.
//
// Exactness: the port matches the JAX reference bit for bit, so these
// kernels are compiled with -fmad=false (no contraction) and contract
// only where the reference does, with an explicit __fmaf_rn.  Constants
// are folded to float on the host, in the reference's grouping, and
// passed in each kernel's parameter struct.  See repro_torch/numerics.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// glibc sinf (sysdeps/ieee754/flt-32/s_sinf.c): the reference's XLA CPU
// backend calls the C library's sinf, so the ECN dither uses the same
// double-precision reduction and polynomial (numerics.sinf is the tensor
// twin of this function).
__constant__ uint32_t kInvPio4[24] = {
    0xa2u,       0xa2f9u,     0xa2f983u,   0xa2f9836eu, 0xf9836e4eu,
    0x836e4e44u, 0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u,
    0x29fc2757u, 0xfc2757d1u, 0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu,
    0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u, 0xc0db6295u, 0xdb629599u,
    0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u};

__device__ __forceinline__ double sinf_poly(double x, double x2, int n) {
  const double S1 = -0x1.555545995a603p-3, S2 = 0x1.1107605230bc4p-7,
               S3 = -0x1.994eb3774cf24p-13;
  const double C0 = 1.0, C1 = -0x1.ffffffd0c621cp-2,
               C2 = 0x1.55553e1068f19p-5, C3 = -0x1.6c087e89a359dp-10,
               C4 = 0x1.99343027bf8c3p-16;
  if ((n & 1) == 0) {
    double x3 = x * x2;
    double s1 = S2 + x2 * S3;
    double x7 = x3 * x2;
    double s = x + x3 * S1;
    return s + x7 * s1;
  }
  double x4 = x2 * x2;
  double c2 = C3 + x2 * C4;
  double c1 = C0 + x2 * C1;
  double x6 = x4 * x2;
  double c = c1 + x4 * C2;
  return c + x6 * c2;
}

__device__ __forceinline__ float glibc_sinf(float y) {
  uint32_t xi = __float_as_uint(y);
  uint32_t top = (xi >> 20) & 0x7ffu;
  if (top < 0x3F4u) {  // |y| < pi/4
    if (top < 0x398u) return y;
    double x = (double)y;
    return (float)sinf_poly(x, x * x, 0);
  }
  double x;
  int n, q;
  if (top < 0x42Fu) {  // |y| < 120: one multiply-subtract reduction
    double xd = (double)y;
    double r = xd * 0x1.45F306DC9C883p+23;
    n = ((int)r + 0x800000) >> 24;
    x = xd - (double)n * 0x1.921FB54442D18p0;
    q = n & 3;
  } else {  // 4/pi table reduction in 64-bit integer arithmetic
    int sign = (int)(xi >> 31);
    const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
    int shift = (xi >> 23) & 7;
    uint32_t m = ((xi & 0xffffffu) | 0x800000u) << shift;
    uint64_t res0 = (uint64_t)(uint32_t)(m * arr[0]);
    uint64_t res1 = (uint64_t)m * arr[4];
    uint64_t res2 = (uint64_t)m * arr[8];
    res0 = (res2 >> 32) | (res0 << 32);
    res0 += res1;
    uint64_t nn = (res0 + (1ull << 61)) >> 62;
    res0 -= nn << 62;
    x = (double)(int64_t)res0 * 0x1.921FB54442D18p-62;
    n = (int)nn;
    q = (n + sign) & 3;
  }
  double s = (q == 1 || q == 2) ? -1.0 : 1.0;
  double v = sinf_poly(x * s, x * x, n);
  if ((q & 2) && (n & 1)) v = -v;
  return (float)v;
}
