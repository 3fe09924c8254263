// A host stand-in for the CUDA runtime header, so that the port's warp
// device code (csrc/objective.cuh, lbfgs_device.cuh, minco_device.cuh)
// compiles with g++ and runs on a CPU: warp_host.cpp runs each of a warp's
// 32 lanes as a std::thread, __syncwarp() is a barrier of the 32, and the
// explicit roundings are their IEEE host counterparts (std::fma; compile
// with -ffp-contract=off so that no other product is fused). A plain
// expression may round as nvcc's contraction does not, and expf and sqrtf
// are the host's: the results agree with the card to roundoff, not bits.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

using std::max;
using std::min;

inline thread_local std::barrier<>* warp_barrier = nullptr;
inline void __syncwarp() { warp_barrier->arrive_and_wait(); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
#ifndef INFINITY
#define INFINITY (__builtin_inff())
#endif
