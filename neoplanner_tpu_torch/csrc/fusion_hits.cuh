// The hit scatter of the windowed dense fusion B8 v1: the port of
// neoplanner_tpu/mapping/occupancy_pallas.py `_scatter_hits` (:494). B8 v2
// adds its hits in its own pass (csrc/fusion_tile.cuh), with the same bits.
//
// hit (n) holds the flat grid index of each image column's hit cell, -1 for
// none. Each adds l_hit there with an atomic clip-add (min(old + l_hit,
// l_max) by compare-and-swap). Every add is the same positive l_hit onto a
// value that is already clipped, so a cell hit k times ends at k sequential
// adds, then clip, whatever the order of the atomics: the update is
// deterministic and equals the reference's scatter-add followed by the clip.
#pragma once
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
    fuse_hits_kernel(const long long* __restrict__ hit, float* __restrict__ out,
                     int n, float l_hit, float l_min, float l_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long h = hit[i];
  if (h < 0) return;
  unsigned int* a = reinterpret_cast<unsigned int*>(out + h);
  unsigned int old = *a, seen;
  do {
    seen = old;
    const float nv =
        fminf(fmaxf(__fadd_rn(__uint_as_float(seen), l_hit), l_min), l_max);
    old = atomicCAS(a, seen, __float_as_uint(nv));
  } while (old != seen);
}

// launch the hit scatter of n columns on stream st
inline cudaError_t launch_hits(const long long* hit, float* out, int n,
                               float l_hit, float l_min, float l_max,
                               cudaStream_t st) {
  if (n > 0)
    fuse_hits_kernel<<<(n + 255) / 256, 256, 0, st>>>(hit, out, n, l_hit,
                                                      l_min, l_max);
  return cudaGetLastError();
}

}  // namespace
