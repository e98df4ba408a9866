// Row gather + distance for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gatherdist/kernel.py
// (_gatherdist_kernel, via gatherdist_pallas). It computes what
// src/repro_torch/kernels/gatherdist/ref.py::gatherdist_ref computes: for
// each (query i, slot j), sum((x - q)^2) (l2) or -x.q (ip) between
// queries[i] and points[ids[i, j]], in f32 over f32 or bf16 rows; INVALID
// or out-of-range ids give +inf.
//
// Design: one warp per (query, id) pair, eight pairs per block. The warp
// reads the row coalesced, 16 bytes a lane, reads the query row beside it
// (the S pairs of one query share it through L1/L2) and finishes the sum
// with a warp shuffle.
//
// What bounds it: the gathered row bytes, Q*S*d*itemsize (at Q=4096, S=32,
// d=128 f32: 67 MB, about 20 us at 3.35 TB/s). Later work: stage each
// query in shared memory once per block of its pairs.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int WARPS = 8;

template <typename T, bool L2>
__global__ void gatherdist_kernel(const T* __restrict__ points,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ queries,
                                  float* __restrict__ out, int n, int d,
                                  int s, long long pairs, int use_vec) {
  const long long p = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= pairs) return;  // the whole warp leaves together
  const int id = ids[p];
  if (id < 0 || id >= n) {
    if (lane == 0) out[p] = INFINITY;
    return;
  }
  const T* row = points + (size_t)id * d;
  const float* q = queries + (size_t)(p / s) * d;
  const int nvec = use_vec ? d / Vec<T>::N : 0;
  const float acc = warp_sum(row_query_partial<T, L2>(row, q, d, nvec, lane));
  if (lane == 0) out[p] = L2 ? acc : -acc;
}

template <typename T>
void launch(const void* points, const int* ids, const float* queries,
            float* out, int q, int n, int d, int s, int l2, int use_vec,
            cudaStream_t stream) {
  const long long pairs = (long long)q * s;
  const unsigned blocks = (unsigned)((pairs + WARPS - 1) / WARPS);
  const T* pts = static_cast<const T*>(points);
  if (l2)
    gatherdist_kernel<T, true><<<blocks, 32 * WARPS, 0, stream>>>(
        pts, ids, queries, out, n, d, s, pairs, use_vec);
  else
    gatherdist_kernel<T, false><<<blocks, 32 * WARPS, 0, stream>>>(
        pts, ids, queries, out, n, d, s, pairs, use_vec);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 rows, 1 = bfloat16 rows. metric: 1 = l2, 0 = ip.
// Returns the CUDA error code of the launch (0 on success).
int gatherdist_launch(const void* points, int dtype, const void* ids,
                      const void* queries, void* out, int q, int n, int d,
                      int s, int l2, int use_vec, void* stream) {
  const int* id = static_cast<const int*>(ids);
  const float* qs = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(points, id, qs, o, q, n, d, s, l2, use_vec, st);
  else
    launch<__nv_bfloat16>(points, id, qs, o, q, n, d, s, l2, use_vec, st);
  return static_cast<int>(cudaGetLastError());
}

const char* gatherdist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
