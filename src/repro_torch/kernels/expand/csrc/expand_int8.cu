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
//   * int8-query (the Pallas kernel's arithmetic): the query is quantized
//     once (absmax, rintf, true division), the exact int8 x int8 dot taken
//     with __dp4a into int32, dequantized by scale_row * scale_q, l2 in the
//     norm form, and the query's own exact err_q subtracted inside the
//     bound;
//   * f32-query (the reference's XLA path): each code is dequantized in
//     registers and compared with the f32 query; err_q = 0.
// The query quantization, the row arithmetic and the bound are the
// __device__ functions of common.cuh (quantize_query, warp_int8_bounds and
// its shared-memory twin shared_int8_bounds, one arithmetic) that
// gatherdist_int8.cu calls too, so the two kernels give the same bits
// on the candidates they share, on either route.
//
// What bounds it: the gathered bytes, d + 12 per distinct row (140 B at
// d = 128, against 512 B for the f32 kernel); at Q=4096, E=4, R=32 the rows
// come to ~60 MB, ~18 us at 3.35 TB/s. The dp4a dot is 1/4 of an
// instruction per code byte, far below the bound; what stands between the
// kernel and the bound is the latency of dependent gathers (frontier, then
// adjacency row, then code and metadata rows) and the number of them in
// flight.
//
// Two routes, chosen by ops.py::plan from the shape and alignment:
//
// * `bulk` (expand_bulk.cuh, the design of expand.cu's bulk route): code
//   rows that are whole 16-byte spans on a 16-byte base (d % 16 == 0),
//   R % 4 == 0. Persistent one-warp blocks; each deduplicates its tiles in one
//   linear pass, copies each kept code row with one 1-D bulk copy and its
//   metadata row with three 4-byte cp.async beside it, all completing on
//   the stage's mbarrier, so a bound never waits on metadata after its
//   codes have landed; it quantizes each query once (on its first stage)
//   and bounds the stage's rows from shared memory (shared_int8_bounds: 8
//   lanes a row, 16 bytes a lane, the query chunk loaded once for 16
//   rows). Four rows a lane keep the kernel at 96 registers, so twenty
//   warps fit an SM.
// * `warp`: every other shape. One block per query, one warp per frontier
//   slot; the adjacency row goes into a shared tile, a first-occurrence
//   dedup against all earlier entries, then warp_int8_bounds on the rows in
//   device memory (U = 4 warp loads in flight, four rows each; 4-byte
//   words or single bytes when rows are not 16-byte aligned). A block whose
//   frontier is all INVALID writes its empty tile and leaves before the
//   query prologue.
#include <math.h>

#include "common.cuh"
#include "expand_bulk.cuh"

namespace {

using namespace repro_torch;

constexpr int U = 4;  // warp loads in flight, four rows each (both routes)

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

// The bulk route: one warp a block (expand_bulk.cuh). Twenty of them an
// SM (at most 102 registers a thread), as shared memory holds.
template <bool L2, bool kQuantQuery>
__global__ void __launch_bounds__(32, 20)
expand_int8_bulk_kernel(const int8_t* __restrict__ codes,
                        const float* __restrict__ meta,
                        const int* __restrict__ nbrs,
                        const int* __restrict__ frontier,
                        const float* __restrict__ queries, const bulk::Outputs o,
                        int qn, int n, int split, float slack,
                        const __grid_constant__ bulk::Geometry g) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const int lane = threadIdx.x;
  const bulk::Warp w(ring_smem, g);
  w.init(lane);
  const int d = g.d, r = g.r;
  QueryQuant qq{};
  int last = -1;  // the query qq and w.qc belong to
  auto body = [&](const bulk::Stage& st, int qi, int e) {
    if (qi != last) {  // a query's stages come in a row
      qq = quantize_query<kQuantQuery>(st.q, d, lane, w.qc);
      __syncwarp();
      last = qi;
    }
    const size_t base = (size_t)qi * g.t + e * r;
    shared_int8_bounds<L2, kQuantQuery, U>(
        reinterpret_cast<const int8_t*>(st.rows), st.meta, d, st.ids, r, st.q,
        w.qc, qq, slack, lane, o.ids + base, o.dists + base,
        o.dots ? o.dots + base : nullptr);
  };
  bulk::expand_warp<true>(w, reinterpret_cast<const unsigned char*>(codes), meta,
                          nbrs, frontier, queries, o, qn, n, split, lane, body);
}

template <bool L2, bool kQuantQuery>
int launch_bulk(const int8_t* codes, const float* meta, const int* nbrs,
                const int* frontier, const float* queries, const bulk::Outputs& o,
                int q, int n, float slack, const bulk::Geometry& g, int blocks,
                int split, cudaStream_t stream) {
  static int smem_set = 0;
  auto kernel = expand_int8_bulk_kernel<L2, kQuantQuery>;
  const cudaError_t e = bulk::allow_smem(kernel, g.total, &smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, 32, g.total, stream>>>(codes, meta, nbrs, frontier, queries,
                                          o, q, n, split, slack, g);
  return static_cast<int>(cudaGetLastError());
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

// The warp route. metric: 1 = l2, 0 = ip. quant_query: 1 = int8-query
// form, 0 = f32-query. vec: 16, 4 or 1, the bytes a lane reads at once (rows 16- or 4-byte
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

// The bulk route's dynamic shared memory for one block (ops.py checks its
// own bulk_smem against it).
int expand_int8_bulk_smem(int e, int r, int d, int row_bytes, int int8,
                          int stages) {
  return bulk::geometry(e, r, d, row_bytes, int8 != 0, stages).total;
}

// The bulk route (d % 16 == 0 on a 16-byte base, R % 4 == 0): ``blocks``
// persistent one-warp blocks, ``stages`` ring stages each, ``split`` warps
// a query (1 <= split <= e); the other arguments as expand_int8_launch's.
int expand_int8_bulk_launch(const void* codes, const void* meta,
                            const void* nbrs, const void* frontier,
                            const void* queries, void* out_ids, void* out_dists,
                            void* out_ndist, void* out_dots, int q, int n, int d,
                            int r, int e, int l2, int quant_query, float slack,
                            int blocks, int stages, int split, void* stream) {
  if (stages < 1 || split < 1 || split > e)
    return static_cast<int>(cudaErrorInvalidValue);
  const bulk::Geometry g = bulk::geometry(e, r, d, d, true, stages);
  const bulk::Outputs o{static_cast<int*>(out_ids), static_cast<float*>(out_dists),
                        static_cast<int*>(out_ndist), static_cast<int*>(out_dots)};
  const int8_t* cd = static_cast<const int8_t*>(codes);
  const float* mt = static_cast<const float*>(meta);
  const int* nb = static_cast<const int*>(nbrs);
  const int* fr = static_cast<const int*>(frontier);
  const float* qs = static_cast<const float*>(queries);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l2 && quant_query)
    return launch_bulk<true, true>(cd, mt, nb, fr, qs, o, q, n, slack, g, blocks, split, s);
  if (l2)
    return launch_bulk<true, false>(cd, mt, nb, fr, qs, o, q, n, slack, g, blocks, split, s);
  if (quant_query)
    return launch_bulk<false, true>(cd, mt, nb, fr, qs, o, q, n, slack, g, blocks, split, s);
  return launch_bulk<false, false>(cd, mt, nb, fr, qs, o, q, n, slack, g, blocks, split, s);
}

const char* expand_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
