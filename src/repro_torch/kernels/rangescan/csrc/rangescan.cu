// Brute-force range scan for Hopper (sm_90a): every (query, point) distance,
// the exact in-range count, and the K closest in-range points.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rangescan/kernel.py:73
// (_rangescan_kernel with _merge_topk, via rangescan_pallas). It computes
// what src/repro_torch/kernels/rangescan/ref.py::rangescan_ref computes:
// dist = max(|q|^2 + |x|^2 - 2 q.x, 0) (l2, the norm form, in that order) or
// -q.x (ip), in f32 over f32 or bf16 points; counts[i] = #{j : dist <= r};
// the K in-range points with the smallest (dist, id), ascending, ids
// INVALID-padded and dists +inf-padded; a non-finite kept distance gives
// INVALID.
//
// Design. The Pallas kernel walks N in order on one core and carries its
// count and sorted K-buffer across grid steps. Hopper blocks run in no
// order, so two kernels:
//
// * rangescan_scan_kernel: grid (query tiles, N splits). A block owns
//   BQ = 8 * TQ queries and one contiguous split of N, walked in tiles of
//   BN = 128 points. Each tile is a register-blocked product on the CUDA
//   cores in full f32 (no TF32, no tensor cores: TF32 keeps ~3 digits and
//   would flip range membership at r): query and point chunks of DK = 32
//   dims are staged in shared memory (points read 16 bytes a lane when the
//   rows are aligned; the next chunk is read into registers while the
//   current one is multiplied), thread (warp w, lane l) accumulates
//   queries w*TQ.. against points l, l + 32, l + 64, l + 96. Every dot and
//   norm is one fmaf chain over k = 0..d-1 in order, whatever the row's
//   position or tile, so identical rows give identical bits. Counts are
//   warp sums added to counts[q] with one atomicAdd a warp (exact and
//   order-free). An in-range point whose key (ordered dist bits << 32 | id)
//   beats the query's threshold goes to a per-query pending list in shared
//   memory; after each tile one warp per query sorts pending plus the
//   query's kept list (bitonic, in shared memory) and keeps the best K in
//   this split's scratch row; the K-th key becomes the new threshold.
// * rangescan_merge_kernel: one block per query merges its splits' sorted
//   lists (bitonic over chunks of up to 2048 keys) into the final sorted K.
//   Keys are unique (one id each), so the order is the reference's stable
//   sort: ties go to the lower id.
//
// No padding copies: a block masks the ragged ends of Q, N and d itself
// (zeros in shared memory, which leave an fmaf chain unchanged).
//
// What bounds it: the product, 2 Q N d flops on the f32 pipes (67 TFLOP/s
// on an H100 SXM): at Q = 512, N = 1M, d = 256 that is 4.0 ms, against
// 0.31 ms to read the points once. At Q = 1 the bytes bound it (0.31 ms);
// there the small tile (TQ = 1) wastes 8x the flops of one query, which
// the f32 pipes absorb. Later work: TMA-staged tiles, a double-buffered
// pipeline, and 3xTF32 or DMMA-style split products on the tensor cores
// where their rounding can be bounded.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

typedef unsigned long long u64;

constexpr int THREADS = 256;       // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TN = 4;              // points a thread holds per tile
constexpr int BN = 32 * TN;        // points per tile
constexpr int DK = 32;             // dims per staged chunk
constexpr int KMAX = 256;          // largest K
constexpr int STAGE = 512;         // next_pow2(KMAX + BN): one flush's sort
constexpr int MCAP = 2048;         // keys the merge sorts at once
constexpr int MAX_SPLITS = 1024;   // N splits (the merge's prefix sums)
constexpr u64 EMPTY = ~0ull;

// total order on f32 as uint32; -0 is folded onto +0 first, since the
// reference's sort treats them as equal (then the lower id wins)
__device__ __forceinline__ unsigned ordered(float d) {
  unsigned b = __float_as_uint(d);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Ascending bitonic sort of s[0, m), m a power of two, by `nthreads`
// threads numbered `tid`; kBlock: the whole block (else one warp).
template <bool kBlock>
__device__ void bitonic_sort(u64* s, int m, int tid, int nthreads) {
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < m; i += nthreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const u64 a = s[i], b = s[ixj];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      if (kBlock)
        __syncthreads();
      else
        __syncwarp();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int x) {
  int m = 1;
  while (m < x) m <<= 1;
  return m;
}

template <int TQ>
struct ScanSmem {
  static constexpr int BQ = WARPS * TQ;
  static constexpr int QS = BQ + 4;  // padded row: float4 reads, fewer conflicts
  static constexpr int XS = BN + 1;  // padded row: conflict-free transposed stores
  static constexpr size_t pend = 0;                                   // u64 [BQ][BN]
  static constexpr size_t stage = pend + sizeof(u64) * BQ * BN;       // u64 [WARPS][STAGE]
  static constexpr size_t thr = stage + sizeof(u64) * WARPS * STAGE;  // u64 [BQ]
  static constexpr size_t qs = thr + sizeof(u64) * BQ;                // float [DK][QS]
  static constexpr size_t xs = qs + sizeof(float) * DK * QS;          // float [DK][XS]
  static constexpr size_t qn = xs + sizeof(float) * DK * XS;          // float [BQ]
  static constexpr size_t xn = qn + sizeof(float) * BQ;               // float [BN]
  static constexpr size_t pend_n = xn + sizeof(float) * BN;           // int [BQ]
  static constexpr size_t kept_n = pend_n + sizeof(int) * BQ;         // int [BQ]
  static constexpr size_t bytes = kept_n + sizeof(int) * BQ;
};

template <typename T, int TQ, int V, bool L2>
__global__ void __launch_bounds__(THREADS, 2)
rangescan_scan_kernel(const float* __restrict__ queries,
                      const T* __restrict__ points, float r, int q_total,
                      int n, int d, int k, int n_split, int split_len,
                      int* __restrict__ counts, u64* __restrict__ part_keys,
                      int* __restrict__ part_n) {
  using S = ScanSmem<TQ>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* pend = reinterpret_cast<u64*>(smem + S::pend);
  u64* stage = reinterpret_cast<u64*>(smem + S::stage);
  u64* thr = reinterpret_cast<u64*>(smem + S::thr);
  float* qs = reinterpret_cast<float*>(smem + S::qs);
  float* xs = reinterpret_cast<float*>(smem + S::xs);
  float* qn_s = reinterpret_cast<float*>(smem + S::qn);
  float* xn_s = reinterpret_cast<float*>(smem + S::xn);
  int* pend_n = reinterpret_cast<int*>(smem + S::pend_n);
  int* kept_n = reinterpret_cast<int*>(smem + S::kept_n);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_begin = split * split_len;
  const int n_end = min(n, n_begin + split_len);

  if (tid < BQ) {
    thr[tid] = EMPTY;
    pend_n[tid] = 0;
    kept_n[tid] = 0;
    if (L2) {  // |q|^2, one fmaf chain in dim order (as the points' norms)
      float acc = 0.f;
      if (q0 + tid < q_total) {
        const float* q = queries + (size_t)(q0 + tid) * d;
        for (int kk = 0; kk < d; ++kk) acc = fmaf(q[kk], q[kk], acc);
      }
      qn_s[tid] = acc;
    }
  }
  __syncthreads();

  int cnt[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) cnt[i] = 0;

  // The next (tile, chunk) is read into registers while the current one is
  // multiplied: xr[] holds this thread's XW words of V points' dims each
  // (16-byte loads when V > 1), qr[] its share of the query chunk.
  constexpr int XW = BN * DK / (V * THREADS);
  constexpr int QW = BQ * DK / THREADS;
  float xr[XW * V], qr[QW];
  const int nchunks = (d + DK - 1) / DK;
  auto fetch = [&](int t, int k0) {
#pragma unroll
    for (int w = 0; w < XW; ++w) {
      const int e = tid + THREADS * w;
      const int row = e / (DK / V), col = (e % (DK / V)) * V;
      const int p = t + row, kk = k0 + col;
      if (p < n_end && kk < d) {
        const T* src = points + (size_t)p * d + kk;
        if constexpr (V == 1) xr[w] = to_f32(*src);
        else load16(src, xr + w * V);
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) xr[w * V + c] = 0.f;
      }
    }
#pragma unroll
    for (int w = 0; w < QW; ++w) {
      const int e = tid + THREADS * w;
      const int q = q0 + e / DK, kk = k0 + e % DK;
      qr[w] = (q < q_total && kk < d) ? queries[(size_t)q * d + kk] : 0.f;
    }
  };
  if (n_begin < n_end) fetch(n_begin, 0);

  for (int t0 = n_begin; t0 < n_end; t0 += BN) {
    float acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    float xn_acc = 0.f;

    for (int c = 0; c < nchunks; ++c) {
      // the staged chunk goes to shared memory transposed, [dim][row]
      // (padded rows: conflict-free stores)
#pragma unroll
      for (int w = 0; w < XW; ++w) {
        const int e = tid + THREADS * w;
        const int row = e / (DK / V), col = (e % (DK / V)) * V;
#pragma unroll
        for (int v = 0; v < V; ++v) xs[(col + v) * S::XS + row] = xr[w * V + v];
      }
#pragma unroll
      for (int w = 0; w < QW; ++w) {
        const int e = tid + THREADS * w;
        qs[(e % DK) * S::QS + e / DK] = qr[w];
      }
      __syncthreads();
      if (c + 1 < nchunks) fetch(t0, (c + 1) * DK);
      else if (t0 + BN < n_end) fetch(t0 + BN, 0);
      if (L2 && tid < BN) {
#pragma unroll 8
        for (int kk = 0; kk < DK; ++kk) {
          const float x = xs[kk * S::XS + tid];
          xn_acc = fmaf(x, x, xn_acc);
        }
      }
#pragma unroll 4
      for (int kk = 0; kk < DK; ++kk) {
        float a[TQ], b[TN];
        if constexpr (TQ % 4 == 0) {
#pragma unroll
          for (int i = 0; i < TQ; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                qs + kk * S::QS + warp * TQ + i);
            a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < TQ; ++i) a[i] = qs[kk * S::QS + warp * TQ + i];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = xs[kk * S::XS + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (L2 && tid < BN) xn_s[tid] = xn_acc;
    __syncthreads();

    // distances, counts, and the pending candidates of this tile
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = warp * TQ + i;
      if (q0 + qi >= q_total) continue;
      const u64 t = thr[qi];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int p = t0 + lane + 32 * j;
        if (p >= n_end) continue;
        float dist;
        if (L2) {
          const float raw = __fsub_rn(__fadd_rn(qn_s[qi], xn_s[lane + 32 * j]),
                                      __fmul_rn(2.f, acc[i][j]));
          dist = raw < 0.f ? 0.f : raw;  // NaN stays NaN, as jnp.maximum
        } else {
          dist = -acc[i][j];
        }
        if (dist <= r) {
          ++cnt[i];
          const u64 key = ((u64)ordered(dist) << 32) | (unsigned)p;
          if (key < t) pend[qi * BN + atomicAdd(&pend_n[qi], 1)] = key;
        }
      }
    }
    __syncthreads();

    // flush: one warp per query with pending keys; pending (< BN) plus kept
    // (<= K) sort in the warp's stage, the best K go back to scratch
    for (int qi = warp; qi < BQ; qi += WARPS) {
      const int np = pend_n[qi];
      if (np == 0) continue;
      const int nk = kept_n[qi];
      const int tot = nk + np;
      const int m = pow2_at_least(tot);
      u64* st = stage + warp * STAGE;
      u64* kept = part_keys + ((size_t)(q0 + qi) * n_split + split) * k;
      for (int e = lane; e < m; e += 32)
        st[e] = e < nk ? kept[e] : (e < tot ? pend[qi * BN + e - nk] : EMPTY);
      __syncwarp();
      bitonic_sort<false>(st, m, lane, 32);
      const int nn = min(k, tot);
      for (int e = lane; e < nn; e += 32) kept[e] = st[e];
      if (lane == 0) {
        kept_n[qi] = nn;
        thr[qi] = nn == k ? st[k - 1] : EMPTY;
        pend_n[qi] = 0;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // counts: the warp's 32 lanes hold the same TQ queries
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    int c = cnt[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    const int q = q0 + warp * TQ + i;
    if (lane == 0 && q < q_total && c) atomicAdd(counts + q, c);
  }
  if (tid < BQ && q0 + tid < q_total)
    part_n[(size_t)(q0 + tid) * n_split + split] = kept_n[tid];
}

__global__ void __launch_bounds__(THREADS)
rangescan_merge_kernel(const u64* __restrict__ part_keys,
                       const int* __restrict__ part_n, int n_split, int k,
                       int* __restrict__ out_ids, float* __restrict__ out_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);               // [MCAP]
  int* pref = reinterpret_cast<int*>(buf + MCAP);        // [n_split + 1]
  __shared__ int tsum[THREADS];
  const int q = blockIdx.x, tid = threadIdx.x;
  const int* pn = part_n + (size_t)q * n_split;

  // exclusive prefix sum of the splits' list lengths
  const int chunk = (n_split + THREADS - 1) / THREADS;
  const int s0 = min(n_split, tid * chunk), s1 = min(n_split, s0 + chunk);
  int local = 0;
  for (int s = s0; s < s1; ++s) local += pn[s];
  tsum[tid] = local;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    const int v = tid >= off ? tsum[tid - off] : 0;
    __syncthreads();
    tsum[tid] += v;
    __syncthreads();
  }
  int run = tsum[tid] - local;
  for (int s = s0; s < s1; ++s) {
    pref[s] = run;
    run += pn[s];
  }
  if (tid == THREADS - 1) pref[n_split] = tsum[THREADS - 1];
  __syncthreads();

  const int total = pref[n_split];
  const u64* keys = part_keys + (size_t)q * n_split * k;
  int kept = 0;
  for (int c0 = 0; c0 < total; c0 += MCAP - k) {
    const int len = min(MCAP - k, total - c0);
    const int m = pow2_at_least(kept + len);
    for (int i = tid; i < len; i += THREADS) {
      const int g = c0 + i;  // the last split starting at or before g
      int lo = 0, hi = n_split - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pref[mid] <= g) lo = mid; else hi = mid - 1;
      }
      buf[kept + i] = keys[(size_t)lo * k + (g - pref[lo])];
    }
    for (int i = kept + len + tid; i < m; i += THREADS) buf[i] = EMPTY;
    __syncthreads();
    bitonic_sort<true>(buf, m, tid, THREADS);
    kept = min(k, kept + len);
  }

  for (int i = tid; i < k; i += THREADS) {
    const u64 key = i < kept ? buf[i] : EMPTY;
    float dist = INFINITY;
    int id = INVALID_ID;
    if (key != EMPTY) {
      dist = from_ordered((unsigned)(key >> 32));
      if (isfinite(dist)) id = (int)(unsigned)(key & 0xffffffffu);
    }
    out_d[(size_t)q * k + i] = dist;
    out_ids[(size_t)q * k + i] = id;
  }
}

template <typename T, int TQ, int V, bool L2>
cudaError_t launch_scan(const float* queries, const void* points, float r,
                        int q, int n, int d, int k, int n_split,
                        int split_len, int* counts, u64* part_keys,
                        int* part_n, cudaStream_t stream) {
  using S = ScanSmem<TQ>;
  auto kern = rangescan_scan_kernel<T, TQ, V, L2>;
  static bool smem_set = false;  // once per instantiation, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((unsigned)((q + S::BQ - 1) / S::BQ), (unsigned)n_split);
  kern<<<grid, THREADS, S::bytes, stream>>>(
      queries, static_cast<const T*>(points), r, q, n, d, k, n_split,
      split_len, counts, part_keys, part_n);
  return cudaGetLastError();
}

// l2: 1 = l2, 0 = ip; use_vec: rows start on 16-byte boundaries
template <typename T, int TQ>
cudaError_t launch_scan_variant(int l2, int use_vec, const float* queries,
                                const void* points, float r, int q, int n,
                                int d, int k, int n_split, int split_len,
                                int* counts, u64* part_keys, int* part_n,
                                cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (use_vec)
    return l2 ? launch_scan<T, TQ, V, true>(queries, points, r, q, n, d, k,
                                            n_split, split_len, counts,
                                            part_keys, part_n, stream)
              : launch_scan<T, TQ, V, false>(queries, points, r, q, n, d, k,
                                             n_split, split_len, counts,
                                             part_keys, part_n, stream);
  return l2 ? launch_scan<T, TQ, 1, true>(queries, points, r, q, n, d, k,
                                          n_split, split_len, counts,
                                          part_keys, part_n, stream)
            : launch_scan<T, TQ, 1, false>(queries, points, r, q, n, d, k,
                                           n_split, split_len, counts,
                                           part_keys, part_n, stream);
}

template <typename T>
cudaError_t launch_scan_tile(int small_q, int l2, int use_vec,
                             const float* queries, const void* points,
                             float r, int q, int n, int d, int k, int n_split,
                             int split_len, int* counts, u64* part_keys,
                             int* part_n, cudaStream_t stream) {
  if (small_q)
    return launch_scan_variant<T, 1>(l2, use_vec, queries, points, r, q, n,
                                     d, k, n_split, split_len, counts,
                                     part_keys, part_n, stream);
  return launch_scan_variant<T, 4>(l2, use_vec, queries, points, r, q, n, d,
                                   k, n_split, split_len, counts, part_keys,
                                   part_n, stream);
}

}  // namespace

extern "C" {

// The launch geometry the wrapper plans with: queries per block (8 with
// small_q, taken when Q <= 8; else 32), points per tile, the largest K,
// the most N splits.
int rangescan_block_queries(int small_q) {
  return small_q ? ScanSmem<1>::BQ : ScanSmem<4>::BQ;
}

int rangescan_points_per_tile() { return BN; }

int rangescan_max_k() { return KMAX; }

int rangescan_max_splits() { return MAX_SPLITS; }

// dtype: 0 = float32 points, 1 = bfloat16 points (queries are float32).
// metric: 1 = l2, 0 = ip. use_vec: every point row starts on a 16-byte
// boundary (16-byte loads). counts must be zeroed by the caller; part_keys
// (Q, n_split, k) uint64 and part_n (Q, n_split) int32 are scratch.
// Returns the CUDA error code of the launches (0 on success).
int rangescan_launch(const void* queries, const void* points, int dtype,
                     float r, int q, int n, int d, int k, int l2, int small_q,
                     int use_vec, int n_split, int split_len, void* counts,
                     void* part_keys, void* part_n, void* out_ids,
                     void* out_d, void* stream) {
  if (k < 1 || k > KMAX || n_split < 1 || n_split > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qs = static_cast<const float*>(queries);
  int* c = static_cast<int*>(counts);
  u64* pk = static_cast<u64*>(part_keys);
  int* pn = static_cast<int*>(part_n);
  cudaError_t err =
      dtype == 0
          ? launch_scan_tile<float>(small_q, l2, use_vec, qs, points, r, q,
                                    n, d, k, n_split, split_len, c, pk, pn, st)
          : launch_scan_tile<__nv_bfloat16>(small_q, l2, use_vec, qs, points,
                                            r, q, n, d, k, n_split, split_len,
                                            c, pk, pn, st);
  if (err != cudaSuccess) return (int)err;
  // at most 16 KB + 4 KB: under the default 48 KB of a launch
  const size_t smem = sizeof(u64) * MCAP + sizeof(int) * (n_split + 1);
  rangescan_merge_kernel<<<(unsigned)q, THREADS, smem, st>>>(
      pk, pn, n_split, k, static_cast<int*>(out_ids),
      static_cast<float*>(out_d));
  return (int)cudaGetLastError();
}

const char* rangescan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
