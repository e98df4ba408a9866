// Row gather + certified lower-bound distance over an int8 corpus, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gatherdist/kernel.py:50
// (_gatherdist_kernel_int8, via gatherdist_pallas_int8). It computes what
// src/repro_torch/kernels/gatherdist/ref.py::gatherdist_int8_ref computes:
// for each (query i, slot j), the certified lower bound (core/corpus.py) of
// the distance between queries[i] and corpus row ids[i, j], from the row's
// int8 codes and its [scale, |x_hat|^2, err] metadata row; INVALID or
// out-of-range ids give +inf. A template flag (kQuantQuery) picks the form:
//   * f32-query: codes dequantized in registers against the f32 query,
//     err_q = 0 (the reference's gather_dist on a QuantizedCorpus; the
//     search loop's start points and E=1 steps);
//   * int8-query: the Pallas kernel's arithmetic, the query quantized by
//     absmax, an exact __dp4a int32 dot, dequantized by scale_row * scale_q.
// The query quantization, the row reads and the bound are common.cuh's,
// shared with expand_int8.cu: the two kernels agree bit for bit on shared
// candidates.
//
// Design: one warp per query, eight queries per block. The warp quantizes
// its query once into its slice of shared memory (or copies the f32 query
// there), then bounds the query's S rows with common.cuh's
// warp_int8_bounds: a group of 8 lanes a row, 16 bytes a lane, four rows a
// warp load, U = 2 loads in flight (S = 4 at the start points, S = R at
// the E = 1 steps).
//
// What bounds it: the gathered bytes, d + 12 per distinct row, plus the
// queries (at Q=4096, S=4, d=128: 2.3 MB of rows plus 2.1 MB of queries,
// ~1.3 us at 3.35 TB/s); at these sizes the launch and the dependent
// query-then-row reads dominate.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int WARPS = 8;
constexpr int U = 2;  // warp loads in flight, four rows each

// floats of shared memory a warp holds its query in: d rounded up to 16 B
__host__ __device__ inline int slice_floats(int d) { return (d + 3) / 4 * 4; }

template <bool L2, bool kQuantQuery>
__global__ void gatherdist_int8_kernel(const int8_t* __restrict__ codes,
                                       const float* __restrict__ meta,
                                       const int* __restrict__ ids,
                                       const float* __restrict__ queries,
                                       float* __restrict__ out,
                                       int* __restrict__ out_dots, int qn,
                                       int n, int d, int s, int vec,
                                       float slack) {
  extern __shared__ __align__(16) float smem[];  // (WARPS, slice_floats(d))
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS + warp;
  if (qi >= qn) return;  // the whole warp leaves together
  float* qs = smem + warp * slice_floats(d);
  int8_t* qc = reinterpret_cast<int8_t*>(qs);
  const float* q = queries + (size_t)qi * d;
  if (!kQuantQuery)
    for (int i = lane; i < d; i += 32) qs[i] = q[i];
  const QueryQuant qq = quantize_query<kQuantQuery>(q, d, lane, qc);
  __syncwarp();
  const size_t base = (size_t)qi * s;
  warp_int8_bounds<L2, kQuantQuery, U>(
      codes, meta, n, d, vec, ids + base, s, qs, qc, qq, slack, lane, nullptr,
      out + base, out_dots ? out_dots + base : nullptr);
}

template <bool L2, bool kQuantQuery>
void launch(const int8_t* codes, const float* meta, const int* ids,
            const float* queries, float* out, int* out_dots, int q, int n,
            int d, int s, int vec, float slack, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((q + WARPS - 1) / WARPS);
  const size_t smem = sizeof(float) * WARPS * slice_floats(d);
  gatherdist_int8_kernel<L2, kQuantQuery><<<blocks, 32 * WARPS, smem, stream>>>(
      codes, meta, ids, queries, out, out_dots, q, n, d, s, vec, slack);
}

}  // namespace

extern "C" {

// metric: 1 = l2, 0 = ip. quant_query: 1 = int8-query form, 0 = f32-query.
// vec: 16, 4 or 1, the bytes a lane reads at once. out_dots may be null;
// in the int8-query form it receives the int32 dots (0 on INVALID pairs).
// Returns the CUDA error code of the launch.
int gatherdist_int8_launch(const void* codes, const void* meta,
                           const void* ids, const void* queries, void* out,
                           void* out_dots, int q, int n, int d, int s, int l2,
                           int quant_query, int vec, float slack,
                           void* stream) {
  const int8_t* cd = static_cast<const int8_t*>(codes);
  const float* mt = static_cast<const float*>(meta);
  const int* id = static_cast<const int*>(ids);
  const float* qs = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  int* dt = static_cast<int*>(out_dots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l2 && quant_query)
    launch<true, true>(cd, mt, id, qs, o, dt, q, n, d, s, vec, slack, st);
  else if (l2)
    launch<true, false>(cd, mt, id, qs, o, dt, q, n, d, s, vec, slack, st);
  else if (quant_query)
    launch<false, true>(cd, mt, id, qs, o, dt, q, n, d, s, vec, slack, st);
  else
    launch<false, false>(cd, mt, id, qs, o, dt, q, n, d, s, vec, slack, st);
  return static_cast<int>(cudaGetLastError());
}

const char* gatherdist_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
