// Fused frontier expansion for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/expand/kernel.py
// (_expand_kernel, via expand_pallas). It computes what the plain version,
// src/repro_torch/kernels/expand/ref.py::expand_frontier_ref, computes:
// for each query and each of its E frontier nodes, gather the node's
// adjacency row, gather the R neighbour rows (f32 or bf16 storage, f32
// math), compute sum((x - q)^2) (l2) or -x.q (ip), and keep only the first
// occurrence of every id in the query's flattened E*R tile. n_dist counts
// the valid adjacency entries before dedup. Invalid or out-of-range
// frontier entries give all-INVALID rows and count 0.
//
// Design: one block per query, one warp per frontier slot e (E warps).
//   1. each lane reads one adjacency entry at a time into a shared-memory
//      tile of E*R ids; a ballot counts the valid ones;
//   2. each thread tests its tile entries against every earlier entry of
//      the tile (first occurrence wins);
//   3. for every surviving id the warp reads the row coalesced, 16 bytes a
//      lane, against the query held in shared memory, and finishes the sum
//      with a warp shuffle. U rows are in flight at once per warp.
// Any R and any d work: the vector body covers d when rows are 16-byte
// aligned, the scalar loop covers the rest (the whole row otherwise).
//
// What bounds it: the gathered row bytes. At Q=4096, E=4, R=32, d=128 f32
// that is at most 4096*128*512 B = 268 MB of row gathers, about 80 us at
// 3.35 TB/s; the adjacency rows, the query and the outputs are small beside
// it. Later work: cp.async/TMA gathers to keep more bytes in flight, and
// keeping the SMs busy past queries whose lanes are frozen (their frontier
// is all INVALID, so their blocks exit after the adjacency step).
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int U = 4;  // rows in flight per warp

// this lane's share of sum((x - q)^2) (L2) or x.q (ip) over one row
template <typename T, bool L2>
__device__ __forceinline__ float row_partial(const T* __restrict__ row,
                                             const float* __restrict__ qs,
                                             int d, int nvec, int lane) {
  constexpr int V = Vec<T>::N;
  float acc = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float x[V];
    load16(row + c * V, x);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float qv = qs[c * V + k];
      if (L2) {
        const float t = x[k] - qv;
        acc = fmaf(t, t, acc);
      } else {
        acc = fmaf(x[k], qv, acc);
      }
    }
  }
  for (int i = nvec * V + lane; i < d; i += 32) {
    const float xv = to_f32(row[i]);
    if (L2) {
      const float t = xv - qs[i];
      acc = fmaf(t, t, acc);
    } else {
      acc = fmaf(xv, qs[i], acc);
    }
  }
  return acc;
}

template <typename T, bool L2>
__global__ void expand_kernel(const T* __restrict__ points,
                              const int* __restrict__ nbrs,
                              const int* __restrict__ frontier,
                              const float* __restrict__ queries,
                              int* __restrict__ out_ids,
                              float* __restrict__ out_dists,
                              int* __restrict__ out_ndist,
                              int n, int d, int r, int e_width, int use_vec) {
  extern __shared__ float smem[];
  float* qs = smem;                     // (d,) the query
  int* tile = reinterpret_cast<int*>(qs + d);  // (E*R,) valid ids
  int* kept = tile + e_width * r;       // (E*R,) ids after dedup
  int* cnt = kept + e_width * r;        // (E,) valid entries per warp

  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t_len = e_width * r;
  const float* q = queries + (size_t)qi * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = q[i];

  // 1. adjacency row of this warp's frontier node
  const int f = frontier[(size_t)qi * e_width + warp];
  const bool f_ok = f >= 0 && f < n;
  int c = 0;
  for (int j0 = 0; j0 < r; j0 += 32) {
    const int j = j0 + lane;
    int a = INVALID_ID;
    if (f_ok && j < r) a = nbrs[(size_t)f * r + j];
    const bool ok = f_ok && j < r && a >= 0 && a < n;
    if (j < r) tile[warp * r + j] = ok ? a : INVALID_ID;
    c += __popc(__ballot_sync(0xffffffffu, ok));
  }
  if (lane == 0) cnt[warp] = c;
  __syncthreads();

  // 2. first-occurrence dedup across the query's whole tile
  for (int t = threadIdx.x; t < t_len; t += blockDim.x) {
    const int a = tile[t];
    bool keep = a != INVALID_ID;
    for (int s = 0; keep && s < t; ++s) keep = tile[s] != a;
    kept[t] = keep ? a : INVALID_ID;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < e_width; ++w) s += cnt[w];
    out_ndist[qi] = s;
  }

  // 3. distances of the surviving ids, U rows in flight per warp
  constexpr int V = Vec<T>::N;
  const int nvec = use_vec ? d / V : 0;
  int* oid = out_ids + (size_t)qi * t_len + warp * r;
  float* od = out_dists + (size_t)qi * t_len + warp * r;
  for (int j0 = 0; j0 < r; j0 += U) {
    int id[U];
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      id[u] = j < r ? kept[warp * r + j] : INVALID_ID;
      acc[u] = id[u] == INVALID_ID
                   ? 0.f
                   : row_partial<T, L2>(points + (size_t)id[u] * d, qs, d,
                                        nvec, lane);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float s = warp_sum(acc[u]);
      const int j = j0 + u;
      if (lane == u && j < r) {
        oid[j] = id[u];
        od[j] = id[u] == INVALID_ID ? INFINITY : (L2 ? s : -s);
      }
    }
  }
}

template <typename T>
void launch(const void* points, const int* nbrs, const int* frontier,
            const float* queries, int* out_ids, float* out_dists,
            int* out_ndist, int q, int n, int d, int r, int e, int l2,
            int use_vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * d + sizeof(int) * (2 * e * r + e);
  const T* pts = static_cast<const T*>(points);
  if (l2)
    expand_kernel<T, true><<<q, 32 * e, smem, stream>>>(
        pts, nbrs, frontier, queries, out_ids, out_dists, out_ndist, n, d, r,
        e, use_vec);
  else
    expand_kernel<T, false><<<q, 32 * e, smem, stream>>>(
        pts, nbrs, frontier, queries, out_ids, out_dists, out_ndist, n, d, r,
        e, use_vec);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 rows, 1 = bfloat16 rows. metric: 1 = l2, 0 = ip.
// Returns the CUDA error code of the launch (0 on success).
int expand_launch(const void* points, int dtype, const void* nbrs,
                  const void* frontier, const void* queries, void* out_ids,
                  void* out_dists, void* out_ndist, int q, int n, int d, int r,
                  int e, int l2, int use_vec, void* stream) {
  const int* nb = static_cast<const int*>(nbrs);
  const int* fr = static_cast<const int*>(frontier);
  const float* qs = static_cast<const float*>(queries);
  int* oi = static_cast<int*>(out_ids);
  float* od = static_cast<float*>(out_dists);
  int* on = static_cast<int*>(out_ndist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(points, nb, fr, qs, oi, od, on, q, n, d, r, e, l2, use_vec,
                  s);
  else
    launch<__nv_bfloat16>(points, nb, fr, qs, oi, od, on, q, n, d, r, e, l2,
                          use_vec, s);
  return static_cast<int>(cudaGetLastError());
}

const char* expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
