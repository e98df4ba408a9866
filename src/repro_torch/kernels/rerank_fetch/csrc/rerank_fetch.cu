// Exact f32 distances of flat (row id, query) pairs, for Hopper (sm_90a):
// the guard-band rerank's exact pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rerank_fetch/kernel.py:31
// (_fetch_kernel, via fetch_rerank_dists_pallas). It computes what
// src/repro_torch/kernels/rerank_fetch/ref.py::fetch_rerank_pairs_ref
// computes: for each pair p, sum((x - q)^2) (l2) or -x.q (ip) between the
// raw row raw[ids[p]] and the query row queries[lanes[p]], ids clipped to
// [0, N) and lanes to [0, Q) as the reference clips its ids. The Pallas
// kernel takes a pre-gathered (P, d) copy of the query rows and a P that
// is a multiple of its tile; here the kernel reads queries[lanes[p]] in
// place, so that copy is never written, and the ragged edge is masked.
//
// The main path launches it once for an int8 batch with a non-empty band
// (core/range_search.py::_rerank_band), none otherwise. The band arrives
// lane-major (torch.nonzero of a (Q, cap) mask): at the greedy batch of
// the 1M x 128 deployment, P = 160,039 pairs (39 a query) in 1,638 runs of
// one lane, ~98 pairs a run. Its raw f32 rows are cold (the int8 walk reads only
// codes): the bound is the distinct rows once (4 d bytes each), the query
// rows, the pairs and the output; every pair's row read without dedup is
// 160,039 x 512 B = 81.9 MB, so repeats must come from L2. No sort or
// dedup on the device: a sort of the band costs more than it could save.
//
// Design, route `regs` (ops.plan: at least REGS_MIN_PAIRS pairs over rows
// and queries of whole 16-byte spans on 16-byte bases, d <= 256):
// persistent blocks of FWARPS warps, as many as the card holds. A warp
// takes 32 consecutive pairs at a time (chunks w, w + warps, ...): one
// coalesced load of their ids and lanes, the next chunk's issued before
// this one is summed, then passed on by shuffle. A group of 8 lanes takes
// 8 consecutive pairs of the chunk, FU at a time: the FU rows' 16-byte
// chunks (part, part + 8, ...) are all loaded into registers before any is
// summed, so each warp keeps 4 FU rows in flight. The group keeps its query
// chunks in registers across a run of equal lanes and reloads them only
// when the lane changes (any order of pairs is right; a lane-major one
// reloads rarely). After the group sum, pair k of a group stays in the
// group's lane k, so the chunk's 32 results leave in one coalesced store.
// Below REGS_MIN_PAIRS the first kernel is faster: a warp here walks its
// 32 pairs in turn, two row passes and the pair loads deep, while the card
// has warps to spare. On lane-major pairs, as the band arrives, the two
// cross between 16,384 and 24,576 pairs on an H100 (regs ~0.0053 ms from
// 2,048 pairs up to 32,768, the persistent grid's floor; warp 0.0044 at
// 16,384, 0.0057 at 24,576): REGS_MIN_PAIRS is 24,576.
//
// The alternative the design was chosen against: persistent one-warp
// blocks, each lane starting one 1-D bulk copy of its pair's row into a
// two-stage ring in shared memory, the next chunk's copies in flight while
// this chunk is summed from shared memory. It lost on an H100 at the
// greedy band: 0.0304 ms warm and 0.0427 cold against regs' 0.0220 and
// 0.0364 (six one-warp blocks an SM hold 96 KB in flight; regs holds 16
// warps x 8 KB in registers with no barrier wait). Eight rows a group in
// registers (FU = 8) lost too, and spilled at d = 256. Neither is kept.
//
// Route `warp`, the first kernel (every other shape, and timing): one warp
// a pair, eight pairs a block, common.cuh's row_query_partial, ids and
// lanes read first, then one row and one query row (~0.040 ms warm at the
// band).
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md section 6
// has the record): at the greedy band `regs` takes ~0.023 ms warm, ~66 %
// of its 0.0149 ms bytes bound, against ~0.040 for `warp`; cold (L2
// flushed before the launch) ~0.037, ~40 %: each distinct row comes from
// device memory and the flush's dirty lines are written back beside it.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int WARPS = 8;   // warp route: pairs a block
constexpr int FWARPS = 8;  // regs route: warps a block
constexpr int FU = 4;      // regs route: rows a group loads before summing
constexpr unsigned ALL = 0xffffffffu;

template <bool L2>
__global__ void rerank_fetch_kernel(const float* __restrict__ raw,
                                    const int* __restrict__ ids,
                                    const float* __restrict__ queries,
                                    const int* __restrict__ lanes,
                                    float* __restrict__ out, int n, int nq,
                                    int d, long long pairs, int use_vec) {
  const long long p = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= pairs) return;  // the whole warp leaves together
  const int id = min(max(ids[p], 0), n - 1);
  const int qi = min(max(lanes[p], 0), nq - 1);
  const float* row = raw + (size_t)id * d;
  const float* q = queries + (size_t)qi * d;
  const int nvec = use_vec ? d / 4 : 0;
  const float acc = warp_sum(row_query_partial<float, L2>(row, q, d, nvec, lane));
  if (lane == 0) out[p] = L2 ? acc : -acc;
}

// Pair p's clipped row id and query lane; past the pairs, row 0 and lane
// 0 (read, never written out).
__device__ __forceinline__ void pair_at(const int* __restrict__ ids,
                                        const int* __restrict__ lanes,
                                        long long p, long long pairs, int n,
                                        int nq, int& id, int& qi) {
  id = qi = 0;
  if (p < pairs) {
    id = min(max(__ldg(ids + p), 0), n - 1);
    qi = min(max(__ldg(lanes + p), 0), nq - 1);
  }
}

// This lane's share of one pair's sum: its chunks of the row (x) against
// its chunks of the query (qv); chunks past the row are zero in both.
template <bool L2, int C>
__device__ __forceinline__ float chunk_partial(const float4 (&x)[C],
                                               const float4 (&qv)[C]) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float a[4] = {x[c].x, x[c].y, x[c].z, x[c].w};
    const float b[4] = {qv[c].x, qv[c].y, qv[c].z, qv[c].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (L2) {
        const float t = a[k] - b[k];
        acc = fmaf(t, t, acc);
      } else {
        acc = fmaf(a[k], b[k], acc);
      }
    }
  }
  return acc;
}

// A group's query chunks (part, part + 8, ...) of lane qi, into qv.
template <int C>
__device__ __forceinline__ void load_query(const float4* __restrict__ q4,
                                           int qi, int d4, int part,
                                           float4 (&qv)[C]) {
  const float4* qrow = q4 + (size_t)qi * d4;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int cc = part + GROUP * c;
    qv[c] = cc < d4 ? __ldg(qrow + cc) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Route `regs`. C: a lane's 16-byte chunks of a row (d / 4 / 8 rounded up).
template <bool L2, int C>
__global__ void __launch_bounds__(32 * FWARPS)
rerank_fetch_regs_kernel(const float* __restrict__ raw,
                         const int* __restrict__ ids,
                         const float* __restrict__ queries,
                         const int* __restrict__ lanes, float* __restrict__ out,
                         int n, int nq, int d, long long pairs) {
  const int lane = threadIdx.x & 31, g = lane / GROUP, part = lane % GROUP;
  const long long step = (long long)gridDim.x * FWARPS * 32;
  long long p0 = ((long long)blockIdx.x * FWARPS + (threadIdx.x >> 5)) * 32;
  const int d4 = d / 4;
  const float4* raw4 = reinterpret_cast<const float4*>(raw);
  const float4* q4 = reinterpret_cast<const float4*>(queries);
  int id, qi;
  pair_at(ids, lanes, p0 + lane, pairs, n, nq, id, qi);
  int cur = -1;  // the lane whose query chunks qv holds
  float4 qv[C];
  for (; p0 < pairs; p0 += step) {
    int nid, nqi;  // the next chunk's pair, in flight while this one is summed
    pair_at(ids, lanes, p0 + step + lane, pairs, n, nq, nid, nqi);
    float res = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < GROUP; k0 += FU) {
      float4 x[FU][C];
      int ql[FU];
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        const int src = GROUP * g + k0 + u;
        const int r = __shfl_sync(ALL, id, src);
        ql[u] = __shfl_sync(ALL, qi, src);
        const float4* row = raw4 + (size_t)r * d4;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int cc = part + GROUP * c;
          x[u][c] = cc < d4 ? __ldg(row + cc) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        if (ql[u] != cur) {
          cur = ql[u];
          load_query<C>(q4, cur, d4, part, qv);
        }
        const float acc = group_sum(chunk_partial<L2, C>(x[u], qv));
        if (part == k0 + u) res = acc;
      }
    }
    if (p0 + lane < pairs) out[p0 + lane] = L2 ? res : -res;
    id = nid;
    qi = nqi;
  }
}

template <int C>
int launch_regs(const float* raw, const int* ids, const float* queries,
                const int* lanes, float* out, int n, int nq, int d,
                long long pairs, int l2, int blocks, cudaStream_t st) {
  if (l2)
    rerank_fetch_regs_kernel<true, C><<<blocks, 32 * FWARPS, 0, st>>>(
        raw, ids, queries, lanes, out, n, nq, d, pairs);
  else
    rerank_fetch_regs_kernel<false, C><<<blocks, 32 * FWARPS, 0, st>>>(
        raw, ids, queries, lanes, out, n, nq, d, pairs);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the regs route an SM holds at once, or -1 on a CUDA error.
template <int C>
int occupancy() {
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rerank_fetch_regs_kernel<true, C>, 32 * FWARPS, 0);
  return e == cudaSuccess ? per_sm : -1;
}

}  // namespace

extern "C" {

// metric: 1 = l2, 0 = ip. use_vec: rows of raw start on 16-byte
// boundaries. Returns the CUDA error code of the launch.
int rerank_fetch_launch(const void* raw, const void* ids, const void* queries,
                        const void* lanes, void* out, int n, int nq, int d,
                        long long pairs, int l2, int use_vec, void* stream) {
  const float* rw = static_cast<const float*>(raw);
  const int* id = static_cast<const int*>(ids);
  const float* qs = static_cast<const float*>(queries);
  const int* ln = static_cast<const int*>(lanes);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((pairs + WARPS - 1) / WARPS);
  if (l2)
    rerank_fetch_kernel<true><<<blocks, 32 * WARPS, 0, st>>>(
        rw, id, qs, ln, o, n, nq, d, pairs, use_vec);
  else
    rerank_fetch_kernel<false><<<blocks, 32 * WARPS, 0, st>>>(
        rw, id, qs, ln, o, n, nq, d, pairs, use_vec);
  return static_cast<int>(cudaGetLastError());
}

// Route `regs`: rows and queries on 16-byte bases, d % 4 == 0, d <= 256
// (ops.plan); `blocks` persistent blocks (ops.launch_grid). Other
// arguments as rerank_fetch_launch's.
int rerank_fetch_regs_launch(const void* raw, const void* ids,
                             const void* queries, const void* lanes, void* out,
                             int n, int nq, int d, long long pairs, int l2,
                             int blocks, void* stream) {
  const float* rw = static_cast<const float*>(raw);
  const int* id = static_cast<const int*>(ids);
  const float* qs = static_cast<const float*>(queries);
  const int* ln = static_cast<const int*>(lanes);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 != 0 || d > 4 * GROUP * 8) return static_cast<int>(cudaErrorInvalidValue);
  const int c = (d / 4 + GROUP - 1) / GROUP;  // a lane's chunks of a row
  return c <= 4 ? launch_regs<4>(rw, id, qs, ln, o, n, nq, d, pairs, l2, blocks, st)
                : launch_regs<8>(rw, id, qs, ln, o, n, nq, d, pairs, l2, blocks, st);
}

// Blocks of the regs route an SM holds at d; -1 on an error.
int rerank_fetch_blocks_per_sm(int d) {
  return (d / 4 + GROUP - 1) / GROUP <= 4 ? occupancy<4>() : occupancy<8>();
}

const char* rerank_fetch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
