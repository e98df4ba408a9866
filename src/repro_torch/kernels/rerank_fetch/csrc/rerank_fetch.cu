// Exact f32 distances of flat (row id, query) pairs, for Hopper (sm_90a):
// the guard-band rerank's exact pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rerank_fetch/kernel.py:31
// (_fetch_kernel, via fetch_rerank_dists_pallas). It computes what
// src/repro_torch/kernels/rerank_fetch/ref.py::fetch_rerank_pairs_ref
// computes: for each pair p, sum((x - q)^2) (l2) or -x.q (ip) between the
// raw row raw[ids[p]] and the query row queries[lanes[p]], ids clipped to
// [0, N) and lanes to [0, Q) as the reference clips its ids.
//
// Design: one warp per pair, eight pairs per block, the loop of
// gatherdist.cu (common.cuh's row_query_partial): the warp reads the raw
// row 16 bytes a lane against the query row (the diff form, as the Pallas
// kernel and the reference's _exact_pairs compute it) and finishes with a
// shuffle reduction. The Pallas kernel takes a pre-gathered (P, d) copy of
// the query rows and a P that is a multiple of its tile; here the kernel
// reads queries[lanes[p]] in place, so that copy is never written, and a
// block masks its own ragged edge.
//
// What bounds it: the gathered raw rows, 4 d bytes per distinct row (the
// query rows are few and stay in L2): at P = 65536, d = 128 that is at most
// 34 MB, ~10 us at 3.35 TB/s. Later work: the tiered corpus reads the same
// rows from pinned host memory through this kernel.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int WARPS = 8;

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

const char* rerank_fetch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
