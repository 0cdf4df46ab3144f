// Helpers shared by the port's kernels. This header compiles under nvcc
// (device code), under NVRTC (K1's per-structure device code) and under a
// host C++ compiler, which is how the CPU tests run the fused kernel's
// generated row functions.
//
// Integer arithmetic mirrors the plain PyTorch versions and the JAX
// reference bit for bit: 32-bit lanes wrap in two's complement, `//` and
// `%` of numpy floor, the query language's `%` truncates (C, jax.lax.rem).
#pragma once

#ifdef __CUDACC_RTC__
// NVRTC has no C library headers, and K1's device code includes none: the
// names it takes from them, in the words of the toolkit's own
// cuda/std/__cuda/cstdint_prelude.h and cuda/std/climits. The math
// functions are NVRTC's built-ins.
typedef signed char int8_t;
typedef short int16_t;
typedef int int32_t;
typedef signed long long int64_t;
typedef unsigned char uint8_t;
typedef unsigned short uint16_t;
typedef unsigned int uint32_t;
typedef unsigned long long uint64_t;
typedef uint64_t uintptr_t;
#define INT_MAX 0x7fffffff
#define INT_MIN (-INT_MAX - 1)
#else
#include <limits.h>
#include <math.h>
#include <stdint.h>
#endif

// ARES_DEV: device code (inline host code under a host compiler); ARES_HD:
// code that nvcc also calls from the host side of a launcher
#ifdef __CUDACC__
#define ARES_DEV __device__ __forceinline__
#define ARES_HD __host__ __device__ __forceinline__
#else
#define ARES_DEV inline
#define ARES_HD inline
#endif

ARES_DEV int ares_add(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
ARES_DEV int ares_sub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
ARES_DEV int ares_mul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }
ARES_DEV int ares_neg(int a) { return (int)(0u - (uint32_t)a); }

// numpy floor division and modulo; b > 0 at every call site.
ARES_DEV int ares_floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
ARES_DEV int ares_floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Truncating remainder; 0 where b is 0 (the emitters also mark that row
// invalid) or -1 (where C's `%` would trap).
ARES_DEV int ares_rem(int a, int b) {
  return (b == 0 || b == -1) ? 0 : a % b;
}

// Shifts as XLA defines them for an amount outside [0, 31].
ARES_DEV int ares_shl(int a, int b) {
  return (b < 0 || b > 31) ? 0 : (int)((uint32_t)a << b);
}
ARES_DEV int ares_shr(int a, int b) {
  return (b < 0 || b > 31) ? (a < 0 ? -1 : 0) : (a >> b);
}

// float -> int32, truncating toward zero; saturates, and NaN gives 0.
ARES_DEV int ares_f2i(float f) {
  if (f != f) return 0;
  if (f >= 2147483648.0f) return INT_MAX;
  if (f <= -2147483648.0f) return INT_MIN;
  return (int)f;
}
