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
// The query quantization, the row sums and the bound are common.cuh's,
// shared with expand_int8.cu: the two kernels agree bit for bit on shared
// candidates, on every route of each.
//
// The main path launches it once a batch in greedy and beam mode and twice
// in doubling mode (init_state), in the f32-query form, l2, with Q = 4096
// and S = 4: every row holds the same 4 start ids (engine.start_ids,
// expanded), so its bytes are the queries (2.1 MB) and 4 code rows, ~0.67 us
// at 3.35 TB/s. What bounds it on the card is not those bytes but the
// launch and one chain of dependent loads: a row's id, then its code row.
//
// Design, route `regs`, the form and metric the main path runs (ops.plan:
// f32-query form, l2, code rows whole 16-byte spans on a 16-byte base,
// queries on a 16-byte base, d <= 256): one warp a query, WARPS warps a
// block, one wave at Q = 4096. A group of 8 lanes takes a row, four rows a
// warp load, RU loads a pass (RU = 1 at S <= 4, else 4). Each lane first
// issues its rows' id, metadata and 16-byte code chunks (part, part + 8,
// ...), and only then reads its query chunks straight from device memory
// into registers, in the order group_partial_deq takes them from shared
// memory (no shared copy, no __syncwarp). The sums are group_partial_deq's
// at vec = 16, term for term, so the bits are warp_int8_bounds'.
//
// Route `warp`, the first kernel (every other shape, form and metric, and
// timing): the same warp a query, but the query is copied (or quantized)
// into shared memory first, then common.cuh's warp_int8_bounds reads ids
// -> metadata -> code rows, U = 2 loads in flight. The same early-issue
// design took the other forms too, and bought nothing there (H100, Q =
// 4096, S = 4, random starts): the int8-query form tied `warp` (0.0039
// against 0.0039 ms; quantize_query's warp reductions sit on the chain),
// and ip lost (0.0042 against 0.0041; the query's norm needs its own
// loads). So `regs` takes only the f32-query l2 form.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, 20 launches a
// CUDA graph; PERF.md section 6 has the record): at Q = 4096, S = 4,
// f32-query l2, `regs` takes ~3.5 us at random starts (~38 % of the bytes
// bound) and ~3.1 us at the 4 shared starts (~21 %), against ~3.7 us for
// `warp`; the empty kernel on the same grid takes ~1.2 us. What is left
// is that floor and the two dependent loads (id, then code row), which no
// order of loads removes.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int WARPS = 8;  // warps a block, both routes
constexpr int U = 2;      // warp route: warp loads in flight, four rows each

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

// Route `regs`, the f32-query form at l2. C: a lane's 16-byte chunks of a
// row (d / 16 / 8 rounded up: 1 at d <= 128, 2 at d <= 256); RU: four-row
// warp loads a pass.
template <int C, int RU>
__global__ void __launch_bounds__(32 * WARPS)
gatherdist_int8_regs_kernel(const int8_t* __restrict__ codes,
                            const float* __restrict__ meta,
                            const int* __restrict__ ids,
                            const float* __restrict__ queries,
                            float* __restrict__ out, int qn, int n, int d,
                            int s, float slack) {
  constexpr int ROWS = 32 / GROUP;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS + warp;
  if (qi >= qn) return;  // the whole warp leaves together
  const int g = lane / GROUP, part = lane % GROUP;
  const int d16 = d / 16;
  const int4* codes16 = reinterpret_cast<const int4*>(codes);
  const float4* q4 = reinterpret_cast<const float4*>(queries + (size_t)qi * d);
  const int* qids = ids + (size_t)qi * s;
  float* od = out + (size_t)qi * s;
  float4 qv[C][4];
  const QueryQuant qq = {0.f, 0.f, 0.f, 0.f};  // l2, f32 query: err_q = 0
  for (int j0 = 0; j0 < s; j0 += ROWS * RU) {
    int id[RU];
    float scale[RU], sqn[RU], err[RU];
    int4 w[RU][C];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int j = j0 + ROWS * u + g;
      int a = j < s ? __ldg(qids + j) : INVALID_ID;
      if (a < 0 || a >= n) a = INVALID_ID;
      id[u] = a;
      scale[u] = sqn[u] = err[u] = 0.f;
      if (a != INVALID_ID) {
        const float* m = meta + 3 * (size_t)a;  // 12-byte stride: scalar loads
        scale[u] = __ldg(m);
        sqn[u] = __ldg(m + 1);
        err[u] = __ldg(m + 2);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int cc = part + GROUP * c;
        w[u][c] = a != INVALID_ID && cc < d16
                      ? __ldg(codes16 + (size_t)a * d16 + cc)
                      : make_int4(0, 0, 0, 0);
      }
    }
    if (j0 == 0) {  // the query, once the first rows' loads are in flight
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int cc = part + GROUP * c;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          qv[c][k] = cc < d16 ? __ldg(q4 + 4 * cc + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float accf[RU];
    int acci[RU];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      accf[u] = 0.f;
      acci[u] = 0;
      if (id[u] == INVALID_ID) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int cc = part + GROUP * c;
        if (cc >= d16) continue;
        const int4 x = w[u][c];
        accf[u] = deq_word<true>(x.x, scale[u], qv[c][0], accf[u]);
        accf[u] = deq_word<true>(x.y, scale[u], qv[c][1], accf[u]);
        accf[u] = deq_word<true>(x.z, scale[u], qv[c][2], accf[u]);
        accf[u] = deq_word<true>(x.w, scale[u], qv[c][3], accf[u]);
      }
    }
    int_bounds_out<true, false, RU>(id, scale, sqn, err, accf, acci, j0, s, qq,
                                    slack, g, part, nullptr, od, nullptr);
  }
}

// Launch-floor reference: a kernel that does nothing, on a given grid.
__global__ void empty_kernel() {}

template <bool L2, bool kQuantQuery>
void launch(const int8_t* codes, const float* meta, const int* ids,
            const float* queries, float* out, int* out_dots, int q, int n,
            int d, int s, int vec, float slack, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((q + WARPS - 1) / WARPS);
  const size_t smem = sizeof(float) * WARPS * slice_floats(d);
  gatherdist_int8_kernel<L2, kQuantQuery><<<blocks, 32 * WARPS, smem, stream>>>(
      codes, meta, ids, queries, out, out_dots, q, n, d, s, vec, slack);
}

template <int C>
void launch_regs(const int8_t* codes, const float* meta, const int* ids,
                 const float* queries, float* out, int q, int n, int d, int s,
                 float slack, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((q + WARPS - 1) / WARPS);
  if (s <= 32 / GROUP)
    gatherdist_int8_regs_kernel<C, 1><<<blocks, 32 * WARPS, 0, stream>>>(
        codes, meta, ids, queries, out, q, n, d, s, slack);
  else
    gatherdist_int8_regs_kernel<C, 4><<<blocks, 32 * WARPS, 0, stream>>>(
        codes, meta, ids, queries, out, q, n, d, s, slack);
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

// Route `regs`, the f32-query form at l2: code rows and queries on 16-byte
// bases, d % 16 == 0, d <= 256 (ops.plan). Arguments as
// gatherdist_int8_launch's.
int gatherdist_int8_regs_launch(const void* codes, const void* meta,
                                const void* ids, const void* queries,
                                void* out, int q, int n, int d, int s,
                                float slack, void* stream) {
  const int8_t* cd = static_cast<const int8_t*>(codes);
  const float* mt = static_cast<const float*>(meta);
  const int* id = static_cast<const int*>(ids);
  const float* qs = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 16 != 0 || d > 16 * GROUP * 2) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 16 * GROUP)
    launch_regs<1>(cd, mt, id, qs, o, q, n, d, s, slack, st);
  else
    launch_regs<2>(cd, mt, id, qs, o, q, n, d, s, slack, st);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on `blocks` blocks of `threads` threads: the launch
// floor that chip_smoke.py reads each route's time against (gatherdist-int8's
// grid and rerank_fetch's alike: an empty kernel's time depends on its grid
// alone).
int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* gatherdist_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
