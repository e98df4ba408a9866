// Fused frontier expansion for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/expand/kernel.py:49
// (_expand_kernel, via expand_pallas). It computes what the plain version,
// src/repro_torch/kernels/expand/ref.py::expand_frontier_ref, computes:
// for each query and each of its E frontier nodes, gather the node's
// adjacency row, gather the R neighbour rows (f32 or bf16 storage, f32
// math), compute sum((x - q)^2) (l2) or -x.q (ip), and keep only the first
// occurrence of every id in the query's flattened E*R tile. n_dist counts
// the valid adjacency entries before dedup. Invalid or out-of-range
// frontier entries give all-INVALID rows and count 0.
//
// What bounds it: the gathered row bytes. At Q=4096, E=4, R=32, d=128 f32
// the distinct kept rows come to ~190 MB, ~59 us at 3.35 TB/s; adjacency
// rows, queries and outputs are small beside them. Each row hangs off two
// dependent reads (frontier -> adjacency row -> row), so the card reaches
// its bandwidth only with ~100 KB of rows in flight on every SM.
//
// Two routes, chosen by ops.py::plan from the shape, dtype and alignment:
//
// * `bulk` (expand_bulk.cuh): rows that are whole 16-byte spans on a
//   16-byte base (d % 4 == 0 f32, d % 8 == 0 bf16), R % 4 == 0. Persistent
//   one-warp blocks: each prefetches frontier and adjacency rows queries
//   ahead, deduplicates each tile in one linear pass
//   before any row is copied, and gathers each kept row with one 1-D bulk
//   copy into a stage in shared memory, then takes the distances there (16
//   rows at once, loaded whatever their id, so the loads overlap). A launch
//   with fewer queries than warps splits each query over up to E warps. A
//   frozen lane costs its frontier read and its writes; the rows in flight
//   cost no registers.
// * `warp`: every other shape. One block per query, one warp per frontier
//   slot: adjacency row into a shared tile, a first-occurrence dedup
//   against all earlier entries, then U = 4 rows in flight per warp, read
//   16 bytes a lane (or element by element when rows are not 16-byte
//   aligned).
//
// Both routes take a row's distance the same way (lane c takes 16-byte
// chunks c, c + 32, ..., fmaf in element order, then the warp_sum
// butterfly), the bulk route from the shared-memory copy, so the two give
// the same bits.
#include <math.h>

#include "common.cuh"
#include "expand_bulk.cuh"

namespace {

using namespace repro_torch;

constexpr int U = 4;  // rows in flight per warp (warp route)

// this lane's share of sum((x - q)^2) (L2) or x.q (ip) over one row, from
// device memory or (kShared) from its shared-memory copy
template <typename T, bool L2, bool kShared = false>
__device__ __forceinline__ float row_partial(const T* __restrict__ row,
                                             const float* __restrict__ qs,
                                             int d, int nvec, int lane) {
  constexpr int V = Vec<T>::N;
  float acc = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float x[V];
    load16<kShared>(row + c * V, x);
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

// The bulk route: one warp a block (expand_bulk.cuh).
template <typename T, bool L2>
__global__ void __launch_bounds__(32)
expand_bulk_kernel(const T* __restrict__ points, const int* __restrict__ nbrs,
                   const int* __restrict__ frontier,
                   const float* __restrict__ queries, const bulk::Outputs o,
                   int qn, int n, int split, const __grid_constant__ bulk::Geometry g) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const int lane = threadIdx.x;
  const bulk::Warp w(ring_smem, g);
  w.init(lane);
  const int d = g.d, r = g.r;
  constexpr int V = Vec<T>::N;
  constexpr int UB = V == 4 ? 16 : 8;  // rows summed at once: 64 row values a lane
  const int nvec = d / V;  // the bulk route takes whole 16-byte chunks only
  auto body = [&](const bulk::Stage& st, int qi, int e) {
    const T* rows = reinterpret_cast<const T*>(st.rows);
    const size_t base = (size_t)qi * g.t + e * r;
    for (int j0 = 0; j0 < r; j0 += 32) {
      const int nrow = min(32, r - j0);
      float mine = INFINITY;  // the distance of row j0 + lane
      for (int u0 = 0; u0 < nrow; u0 += UB) {
        // UB rows at once, loaded whatever their id: a slot whose id was
        // dropped holds stale bytes, and a row past R stands in for the
        // last; their sums are never written
        float acc[UB];
#pragma unroll
        for (int u = 0; u < UB; ++u) acc[u] = 0.f;
        for (int c = lane; c < nvec; c += 32) {
          float qv[V];
#pragma unroll
          for (int k = 0; k < V; k += 4) load16<true>(st.q + c * V + k, qv + k);
#pragma unroll
          for (int u = 0; u < UB; ++u) {
            const int j = min(j0 + u0 + u, r - 1);
            float x[V];
            load16<true>(rows + (size_t)j * d + c * V, x);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              if (L2) {
                const float t = x[k] - qv[k];
                acc[u] = fmaf(t, t, acc[u]);
              } else {
                acc[u] = fmaf(x[k], qv[k], acc[u]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const float s = warp_sum(acc[u]);
          if (lane == u0 + u) mine = L2 ? s : -s;
        }
      }
      const int j = j0 + lane;
      if (j < r) {
        const int id = st.ids[j];
        o.ids[base + j] = id;
        o.dists[base + j] = id == INVALID_ID ? INFINITY : mine;
      }
    }
  };
  bulk::expand_warp<false>(w, reinterpret_cast<const unsigned char*>(points),
                           nullptr, nbrs, frontier, queries, o, qn, n, split, lane,
                           body);
}

template <typename T, bool L2>
int launch_bulk(const void* points, const int* nbrs, const int* frontier,
                const float* queries, const bulk::Outputs& o, int q, int n,
                const bulk::Geometry& g, int blocks, int split,
                cudaStream_t stream) {
  static int smem_set = 0;
  auto kernel = expand_bulk_kernel<T, L2>;
  const cudaError_t e = bulk::allow_smem(kernel, g.total, &smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, 32, g.total, stream>>>(static_cast<const T*>(points), nbrs,
                                          frontier, queries, o, q, n, split, g);
  return static_cast<int>(cudaGetLastError());
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

// The warp route. dtype: 0 = float32 rows, 1 = bfloat16 rows. metric: 1 =
// l2, 0 = ip. Returns the CUDA error code of the launch (0 on success).
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

// The bulk route's dynamic shared memory for one block (ops.py checks its
// own bulk_smem against it).
int expand_bulk_smem(int e, int r, int d, int row_bytes, int int8, int stages) {
  return bulk::geometry(e, r, d, row_bytes, int8 != 0, stages).total;
}

// The bulk route: ``blocks`` persistent one-warp blocks, ``stages`` ring
// stages each, ``split`` warps a query (1 <= split <= e). Returns the CUDA
// error code of the launch (0 on success).
int expand_bulk_launch(const void* points, int dtype, const void* nbrs,
                       const void* frontier, const void* queries,
                       void* out_ids, void* out_dists, void* out_ndist, int q,
                       int n, int d, int r, int e, int l2, int blocks,
                       int stages, int split, void* stream) {
  if (stages < 1 || split < 1 || split > e)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = d * (dtype == 0 ? 4 : 2);
  const bulk::Geometry g = bulk::geometry(e, r, d, row_bytes, false, stages);
  const bulk::Outputs o{static_cast<int*>(out_ids), static_cast<float*>(out_dists),
                        static_cast<int*>(out_ndist), nullptr};
  const int* nb = static_cast<const int*>(nbrs);
  const int* fr = static_cast<const int*>(frontier);
  const float* qs = static_cast<const float*>(queries);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return l2 ? launch_bulk<float, true>(points, nb, fr, qs, o, q, n, g, blocks, split, s)
              : launch_bulk<float, false>(points, nb, fr, qs, o, q, n, g, blocks, split, s);
  return l2 ? launch_bulk<__nv_bfloat16, true>(points, nb, fr, qs, o, q, n, g, blocks, split, s)
            : launch_bulk<__nv_bfloat16, false>(points, nb, fr, qs, o, q, n, g, blocks, split, s);
}

const char* expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
