// Fused frontier expansion over an int8 corpus, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/expand/kernel.py:118
// (_expand_kernel_int8, via expand_pallas_int8). It computes what the plain
// version, src/repro_torch/kernels/expand/ref.py::expand_frontier_int8_ref,
// computes: for each query and each of its E frontier nodes, gather the
// node's adjacency row, gather the R neighbours' int8 code rows and their
// 12-byte [scale, |x_hat|^2, err] metadata rows, and emit each neighbour's
// certified lower-bound distance (core/corpus.py); only the first
// occurrence of an id in the query's flattened E*R tile survives, and
// n_dist counts the valid adjacency entries before dedup.
//
// Two forms, a template flag each (kQuantQuery), sharing the gather, the
// dedup and the outputs:
//   * int8-query (the Pallas kernel's arithmetic): the block quantizes its
//     query once into shared memory (absmax, rintf, true division), takes
//     the exact int8 x int8 dot with __dp4a into int32, dequantizes it by
//     scale_row * scale_q, l2 in the norm form, and subtracts its own exact
//     err_q inside the bound;
//   * f32-query (the reference's XLA path): each code is dequantized in
//     registers and compared with the f32 query in shared memory; err_q = 0.
// The query quantization, the row reads and the bound are the __device__
// functions of common.cuh that gatherdist_int8.cu calls too, so the two
// kernels give the same bits on the candidates they share.
//
// Design: expand.cu's block. One block per query, one warp per frontier
// slot; the adjacency row goes into a shared-memory tile of E*R ids, every
// thread tests its entries against all earlier ones (first occurrence
// wins), then each warp bounds its surviving rows with common.cuh's
// warp_int8_bounds: a group of 8 lanes a row, 16 bytes a lane (one 128-byte
// row at d = 128), so one warp load covers four rows, and U = 4 such loads
// are in flight; each group's 8 lanes read the row's 12-byte metadata row
// as three scalar loads beside the codes (rows sit at a 12-byte stride, so
// never one float4). A block whose frontier is all INVALID (a finished
// lane, frozen in the loop) writes its empty tile and leaves before the
// query prologue. Any d works: 4-byte words or single bytes when rows are
// not 16-byte aligned.
//
// What bounds it: the gathered bytes, d + 12 per distinct row (140 B at
// d = 128, against 512 B for the f32 kernel); at Q=4096, E=4, R=32 the rows
// come to at most 73 MB, ~22 us at 3.35 TB/s. The dp4a dot is 1/4 of an
// instruction per code byte, far below the bound; what stands between the
// kernel and the bound is the latency of dependent gathers (adjacency row,
// then code rows), which the rows in flight are there to hide.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int U = 4;  // warp loads in flight, four rows each

template <bool L2, bool kQuantQuery>
__global__ void expand_int8_kernel(const int8_t* __restrict__ codes,
                                   const float* __restrict__ meta,
                                   const int* __restrict__ nbrs,
                                   const int* __restrict__ frontier,
                                   const float* __restrict__ queries,
                                   int* __restrict__ out_ids,
                                   float* __restrict__ out_dists,
                                   int* __restrict__ out_ndist,
                                   int* __restrict__ out_dots,
                                   int n, int d, int r, int e_width,
                                   int vec, float slack) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // (d,) f32 query
  int8_t* qc = reinterpret_cast<int8_t*>(smem);       // or its int8 codes
  int* tile = reinterpret_cast<int*>(smem + d);       // (E*R,) valid ids
  int* kept = tile + e_width * r;                     // (E*R,) after dedup
  int* cnt = kept + e_width * r;                      // (E,) per warp
  __shared__ QueryQuant qq_s;

  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t_len = e_width * r;
  const float* q = queries + (size_t)qi * d;
  int* oid = out_ids + (size_t)qi * t_len;
  float* od = out_dists + (size_t)qi * t_len;
  int* odot = out_dots ? out_dots + (size_t)qi * t_len : nullptr;

  const int f = frontier[(size_t)qi * e_width + warp];
  const bool f_ok = f >= 0 && f < n;
  if (!__syncthreads_or(f_ok)) {  // a frozen lane: nothing to gather
    for (int t = threadIdx.x; t < t_len; t += blockDim.x) {
      oid[t] = INVALID_ID;
      od[t] = INFINITY;
      if (odot) odot[t] = 0;
    }
    if (threadIdx.x == 0) out_ndist[qi] = 0;
    return;
  }

  // 0. the query: f32 copy, or codes + scale_q / err_q / |q_hat|^2
  if (!kQuantQuery)
    for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = q[i];
  if (warp == 0) {
    const QueryQuant s = quantize_query<kQuantQuery>(q, d, lane, qc);
    if (lane == 0) qq_s = s;
  }

  // 1. adjacency row of this warp's frontier node
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

  // 3. bounds of the surviving ids
  const QueryQuant qq = qq_s;
  warp_int8_bounds<L2, kQuantQuery, U>(
      codes, meta, n, d, vec, kept + warp * r, r, qs, qc, qq, slack, lane,
      oid + warp * r, od + warp * r, odot ? odot + warp * r : nullptr);
}

template <bool L2, bool kQuantQuery>
void launch(const int8_t* codes, const float* meta, const int* nbrs,
            const int* frontier, const float* queries, int* out_ids,
            float* out_dists, int* out_ndist, int* out_dots, int q, int n,
            int d, int r, int e, int vec, float slack, cudaStream_t stream) {
  const size_t smem = sizeof(float) * d + sizeof(int) * (2 * e * r + e);
  expand_int8_kernel<L2, kQuantQuery><<<q, 32 * e, smem, stream>>>(
      codes, meta, nbrs, frontier, queries, out_ids, out_dists, out_ndist,
      out_dots, n, d, r, e, vec, slack);
}

}  // namespace

extern "C" {

// metric: 1 = l2, 0 = ip. quant_query: 1 = int8-query form, 0 = f32-query.
// vec: 16, 4 or 1, the bytes a lane reads at once (rows 16- or 4-byte
// aligned, or neither). out_dots may be null; in the int8-query form it
// receives the int32 dots (0 on INVALID slots). Returns the CUDA error code
// of the launch.
int expand_int8_launch(const void* codes, const void* meta, const void* nbrs,
                       const void* frontier, const void* queries,
                       void* out_ids, void* out_dists, void* out_ndist,
                       void* out_dots, int q, int n, int d, int r, int e,
                       int l2, int quant_query, int vec, float slack,
                       void* stream) {
  const int8_t* cd = static_cast<const int8_t*>(codes);
  const float* mt = static_cast<const float*>(meta);
  const int* nb = static_cast<const int*>(nbrs);
  const int* fr = static_cast<const int*>(frontier);
  const float* qs = static_cast<const float*>(queries);
  int* oi = static_cast<int*>(out_ids);
  float* od = static_cast<float*>(out_dists);
  int* on = static_cast<int*>(out_ndist);
  int* dt = static_cast<int*>(out_dots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l2 && quant_query)
    launch<true, true>(cd, mt, nb, fr, qs, oi, od, on, dt, q, n, d, r, e,
                       vec, slack, s);
  else if (l2)
    launch<true, false>(cd, mt, nb, fr, qs, oi, od, on, dt, q, n, d, r, e,
                        vec, slack, s);
  else if (quant_query)
    launch<false, true>(cd, mt, nb, fr, qs, oi, od, on, dt, q, n, d, r, e,
                        vec, slack, s);
  else
    launch<false, false>(cd, mt, nb, fr, qs, oi, od, on, dt, q, n, d, r, e,
                         vec, slack, s);
  return static_cast<int>(cudaGetLastError());
}

const char* expand_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
