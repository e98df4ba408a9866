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
// The Pallas kernel walks N in order on one core and carries its count and
// sorted K-buffer across grid steps. Hopper blocks run in no order, so a
// scan kernel over (query tile, N split) blocks keeps each split's sorted
// K-list in scratch, and rangescan_merge_kernel (one block a query) merges
// the splits' lists (bitonic over chunks of up to 2048 keys). Keys are
// (ordered dist bits << 32 | id), unique, so ties go to the lower id, as
// the reference's stable sort.
//
// What bounds it: the product, 2 Q N d flops. At the two-tower batch (Q =
// 512, N = 1M, d = 256) that is 2.6e11: 3.9 ms on the f32 pipes (67 TFLOP/s,
// H100 SXM), 1.59 ms as three TF32 products on the tensor cores (495
// TFLOP/s), against 0.31 ms to read the points once. At one request (Q = 1)
// the bytes bound it: 0.31 ms.
//
// The wgmma route (rows of 16-byte multiples on 16-byte boundaries: d % 4
// == 0 for f32, d % 8 == 0 for bf16) puts the product on the tensor cores at
// f32-level accuracy by 3xTF32. Plain TF32 keeps ~3 digits and would flip
// range membership at r; the f32 pipes run at 67 TFLOP/s, and so do the
// FP64 tensor cores; three TF32 products run at 495 / 3 = 165 TFLOP/s.
//  * The split: v = hi + lo exactly, hi = tf32_rn(v) (cvt.rn.tf32.f32: to
//    nearest even, low 13 bits zero), and the product reads tf32_rn(lo).
//    The dot is lo_x.hi_q + hi_x.lo_q + hi_x.hi_q, the small terms first
//    in each k-step, summed in f32 on the tensor cores; lo.lo (~2^-22 of a
//    term) is dropped. bf16 points are exact in TF32 (lo_x = 0): two
//    products. Integer rows give hi = v, lo = 0 and exact sums, so they
//    match the plain version bit for bit. ref.py::dots_3xtf32 is the scheme
//    in plain torch.
//  * Orientation: points are the 64-row M side of wgmma (m64nNk8, A from
//    registers), the block's queries the N side (a tile of 8 to 256), so
//    one design serves one request (N = 8: the bytes bound it) and the
//    batch (N = 256, two query tiles). tf32 wgmma takes B K-major: the
//    (Q, d) query rows are, and a chunk of 32 f32 dims is one 128-byte
//    swizzled row.
//  * Loads: a short pre-pass writes q_hi and q_lo (Q x d each, L2-resident)
//    and |q|^2. A ring of stages in shared memory (2 at a tile of 256, 3 at
//    8, up to 8) holds a chunk of 32 dims of 128 points and of the tile's
//    q_hi and q_lo, loaded by TMA (2-D tensor maps; out-of-bounds rows and
//    dims arrive as zeros) against mbarriers: a full barrier a stage that
//    the copies complete, an empty one that every warp arrives on. The
//    producer is one thread of warpgroup 1 (a producer warp would cap every
//    thread at 168 registers; a tile of 256 keeps 128 accumulators a
//    thread). Each warpgroup reads its 64 rows' A fragments from the
//    swizzled chunk, splits them in registers, and issues 12 (f32) or 8
//    (bf16) wgmmas a chunk. Within 16 dims the k-steps take the dims
//    permuted (perm_dim; the pre-pass writes the queries in that order), so
//    a thread reads its fragments with one 16-byte load a row.
//  * Blocks: (query tile, N split), one an SM (the ring takes most of
//    shared memory), two at the tile of 8, whose 24 short products a chunk
//    leave one block's warps waiting; splits sized so the grid is about one
//    wave. A divergent path beside products in flight serializes them
//    (ptxas C7520), so the norms and the stage's release come after each
//    chunk's wait.
//  * Norms (l2): |x|^2 and |q|^2 are one fmaf chain each in dim order, so
//    identical rows give identical bits wherever they lie.
//  * An epilogue that does not grow with the tile: per element, dist <= r
//    adds one to the query's count (shared atomics; in-range pairs are rare
//    at the served radius; one global atomic a query a block at the end),
//    and a key below the query's threshold (its K-th kept key) is appended,
//    with its query, to one bounded list (2048 entries). The list is merged
//    into the split's sorted K-lists (one warp a query, bitonic) when a tile
//    might not fit and at the end of the split; a dense tile goes in rounds
//    of at most 4 candidates a thread.
//
// The SIMT route (the rest: rows that TMA cannot address, d = 17, 33) is
// the earlier kernel on the CUDA cores in full f32: BQ = 8 TQ queries
// against tiles of 128 points, chunks of 32 dims staged in shared memory
// through registers (16-byte loads where rows are aligned), each dot and
// norm one fmaf chain in dim order; after each tile one warp a query sorts
// its pending keys with its kept list. The route is chosen by shape alone
// (ops.py::plan), never on a failure.
//
// cuTensorMapEncodeTiled is reached through common.cuh's encoder().
#include <math.h>
#include <stdint.h>
#include <stdio.h>

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

// ---------------------------------------------------------------------------
// The wgmma route: 3xTF32 products on the tensor cores, fed by TMA.
// ---------------------------------------------------------------------------
namespace wg {

constexpr int THREADS = 256;          // two consumer warpgroups, 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BM = 128;               // points a tile: 64 rows a warpgroup
constexpr int DK = 32;                // dims a chunk: one 128-byte f32 row
constexpr int CAP = 2048;             // the block's candidate list
constexpr int ROUND = 4 * THREADS;    // candidates one slow-path round adds at most
constexpr int FLUSH_KEYS = 512;       // a warp's flush buffer: kept (<= 256) + new
constexpr int SMEM_LIMIT = 232448;    // what a block may use on an H100
constexpr int SMEM_SM = 233472;       // what an SM's blocks share
constexpr int ERR_ENTRY = 100000;     // no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 100001;    // base of its CUresult codes

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of a block: the fixed part (thresholds, candidate list,
// flush buffers, counts, norms), then the ring of stages, each the points'
// chunk (128 rows x 32 dims, 128-byte swizzle for f32, 64-byte for bf16)
// and the query tile's chunk of q_hi and of q_lo (BN rows x 32 f32 dims,
// 128-byte swizzle), then the ring's barriers.
template <typename T, int BN>
struct Cfg {
  static constexpr int PTS_BYTES = BM * DK * (int)sizeof(T);
  static constexpr int Q_BYTES = BN * DK * 4;
  static constexpr int STAGE_BYTES = PTS_BYTES + 2 * Q_BYTES;
  static constexpr int THR = 0;                                 // u64 [BN]
  static constexpr int LIST_KEY = THR + 8 * BN;                 // u64 [CAP]
  static constexpr int FLUSH = LIST_KEY + 8 * CAP;              // u64 [WARPS][FLUSH_KEYS]
  static constexpr int CNT = FLUSH + 8 * WARPS * FLUSH_KEYS;    // int [BN]
  static constexpr int KEPT = CNT + 4 * BN;                     // int [BN]
  static constexpr int QHAS = KEPT + 4 * BN;                    // int [BN]
  static constexpr int QN = QHAS + 4 * BN;                      // float [BN]
  static constexpr int XN = QN + 4 * BN;                        // float [BM]
  static constexpr int LIST_Q = XN + 4 * BM;                    // uint8 [CAP]
  static constexpr int MISC = LIST_Q + CAP;                     // int [4]
  static constexpr int RING = round_up(MISC + 16, 1024);
  // blocks an SM: two at the smallest tile, whose short products leave the
  // warps of one block waiting (two rings in flight), else one
  static constexpr int MINB = BN == 8 ? 2 : 1;
  static constexpr int LIMIT = MINB == 1 ? SMEM_LIMIT : SMEM_SM / MINB - 1024;
  static constexpr int FIT = (LIMIT - 1024 - RING - 16 * 8) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BARS = RING + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;      // + alignment
  static constexpr int TERMS = sizeof(T) == 4 ? 3 : 2;        // products a k-step
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(SMEM <= LIMIT, "over the block's shared memory");
};

struct Args {
  const float* qn;      // |q|^2 (l2), Q values
  float r;
  int q_total, n, d, k, n_split, split_len, l2;
  int* counts;
  u64* part_keys;
  int* part_n;
};

// hi = tf32_rn(v): v rounded to 10 mantissa bits, to nearest, ties to even
// (cvt.rn.tf32.f32), the low 13 bits cleared, so the tensor cores read it
// exactly. ref.py::tf32_rn is the same rounding in integer arithmetic.
__device__ __forceinline__ uint32_t tf32_rn(float v) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r & 0xFFFFE000u;
}

// v = hi + (v - hi) exactly; the product reads lo = tf32_rn(v - hi).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(v);
  lo = tf32_rn(__fsub_rn(v, __uint_as_float(hi)));
}

// The products' k order. A dot product may sum its terms in any order, so
// within each 16 dims the k-steps take them permuted: column j (0..7) of
// k-step 2 s + h is dim 16 s + 4 (j % 4) + 2 h + j / 4. A thread's A
// fragments of two k-steps (columns lane % 4 and lane % 4 + 4, rows rw and
// rw + 8) are then 4 consecutive dims of each row: one 16-byte load a row
// (four 4-byte loads without the permutation). The query pre-pass writes
// q_hi and q_lo in the same order, position p of a row holding dim
// perm_dim(p); rows are padded to whole chunks of 32 with zeros.
__device__ __forceinline__ int perm_dim(int p) {
  const int t = (p % 32) / 8, j = p % 8;
  return p / 32 * 32 + 16 * (t / 2) + 4 * (j % 4) + 2 * (t % 2) + j / 4;
}

// D (64 x N, f32) += A (64 x 8, tf32 registers) . B (8 x N, tf32 in shared
// memory, K-major, 128-byte swizzle); scale_d = 0 starts a new sum.
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<16> {
  __device__ static __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  __device__ static __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// Dims 4 c .. 4 c + 3 of row r of a points chunk in shared memory (c in
// 0..7): the 128-byte swizzle of f32 rows puts 16-byte unit c of row r at
// unit c ^ (r % 8); the 64-byte swizzle of bf16 rows puts unit c / 2 at
// (c / 2) ^ ((r / 2) % 4).
__device__ __forceinline__ float4 dims4(const uint8_t* t, int r, int c, float*) {
  return *reinterpret_cast<const float4*>(t + r * 128 + (((c ^ r) & 7) << 4));
}
__device__ __forceinline__ float4 dims4(const uint8_t* t, int r, int c, __nv_bfloat16*) {
  const uint2 v = *reinterpret_cast<const uint2*>(
      t + r * 64 + ((((c >> 1) ^ (r >> 1)) & 3) << 4) + (c & 1) * 8);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// This thread's share of one point row's |x|^2 over a chunk, in dim order.
template <typename T>
__device__ __forceinline__ float row_norm(const uint8_t* t, int r, float acc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 v = dims4(t, r, c, static_cast<T*>(nullptr));
    acc = fmaf(v.x, v.x, acc);
    acc = fmaf(v.y, v.y, acc);
    acc = fmaf(v.z, v.z, acc);
    acc = fmaf(v.w, v.w, acc);
  }
  return acc;
}

// The block's shared state besides the ring.
template <int BN>
struct State {
  u64* thr;        // per query: the key a candidate must beat (the K-th kept)
  u64* list_key;   // the candidate list: keys ...
  uint8_t* list_q; // ... and their queries (local index)
  u64* flush;      // per warp: a flush's sort buffer
  int* cnt;        // per query: in-range points so far
  int* kept_n;     // per query: keys kept in this split's scratch row
  int* qhas;       // per query: 1 when the list holds one of its keys
  float* qn;       // per query: |q|^2
  float* xn;       // per tile row: |x|^2
  int* list_n;     // keys in the list
  int* tile_cands; // candidates of the current tile (two, used in turn)
};

template <int BN>
__device__ __forceinline__ State<BN> state_of(uint8_t* sm) {
  using C = Cfg<float, BN>;  // the fixed part does not depend on T
  State<BN> s;
  s.thr = reinterpret_cast<u64*>(sm + C::THR);
  s.list_key = reinterpret_cast<u64*>(sm + C::LIST_KEY);
  s.list_q = sm + C::LIST_Q;
  s.flush = reinterpret_cast<u64*>(sm + C::FLUSH);
  s.cnt = reinterpret_cast<int*>(sm + C::CNT);
  s.kept_n = reinterpret_cast<int*>(sm + C::KEPT);
  s.qhas = reinterpret_cast<int*>(sm + C::QHAS);
  s.qn = reinterpret_cast<float*>(sm + C::QN);
  s.xn = reinterpret_cast<float*>(sm + C::XN);
  s.list_n = reinterpret_cast<int*>(sm + C::MISC);
  s.tile_cands = s.list_n + 1;
  return s;
}

// Sort a warp's buffer st[0, fill) (fill <= FLUSH_KEYS) and keep the best k;
// returns how many are kept.
__device__ __forceinline__ int sort_trim(u64* st, int fill, int k, int lane) {
  const int m = pow2_at_least(fill);
  for (int e = fill + lane; e < m; e += 32) st[e] = EMPTY;
  __syncwarp();
  bitonic_sort<false>(st, m, lane, 32);
  return min(k, fill);
}

// Merge the candidate list into each query's sorted K-list in this split's
// scratch row (one warp a query), update the thresholds, empty the list.
// Called by the whole block.
template <int BN>
__device__ __noinline__ void flush_list(const State<BN> s, u64* part_keys, int q0,
                                        int n_split, int split, int k) {
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_list = *s.list_n;
  u64* st = s.flush + warp * FLUSH_KEYS;
  for (int qi = warp; qi < BN; qi += WARPS) {
    if (!s.qhas[qi]) continue;
    u64* kept = part_keys + ((size_t)(q0 + qi) * n_split + split) * k;
    const int nk = s.kept_n[qi];
    for (int e = lane; e < nk; e += 32) st[e] = kept[e];
    int fill = nk;
    for (int e0 = 0; e0 < n_list; e0 += 32) {
      const int e = e0 + lane;
      const bool hit = e < n_list && s.list_q[e] == qi;
      const unsigned b = __ballot_sync(0xffffffffu, hit);
      if (hit) st[fill + __popc(b & ((1u << lane) - 1u))] = s.list_key[e];
      fill += __popc(b);
      if (fill > FLUSH_KEYS - 32) {
        __syncwarp();
        fill = sort_trim(st, fill, k, lane);
      }
    }
    __syncwarp();
    fill = sort_trim(st, fill, k, lane);
    for (int e = lane; e < fill; e += 32) kept[e] = st[e];
    if (lane == 0) {
      s.kept_n[qi] = fill;
      s.thr[qi] = fill == k ? st[k - 1] : EMPTY;
      s.qhas[qi] = 0;
    }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0) *s.list_n = 0;
  __syncthreads();
}

// q_hi = tf32_rn(q), q_lo = tf32_rn(q - q_hi), (Q, dp) each, dp = d rounded
// up to 32, in the products' k order (perm_dim; zeros past d), and |q|^2 as
// one fmaf chain in dim order (the scan's norms are the same chains).
__global__ void __launch_bounds__(128)
rangescan_split_queries(const float* __restrict__ queries, int q_total, int d, int dp,
                        float* __restrict__ q_hi, float* __restrict__ q_lo,
                        float* __restrict__ qn) {
  const int q = blockIdx.x;
  const float* row = queries + (size_t)q * d;
  for (int p = threadIdx.x; p < dp; p += blockDim.x) {
    const int i = perm_dim(p);
    uint32_t hi, lo;
    split_tf32(i < d ? row[i] : 0.f, hi, lo);
    q_hi[(size_t)q * dp + p] = __uint_as_float(hi);
    q_lo[(size_t)q * dp + p] = __uint_as_float(lo);
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < d; ++i) acc = fmaf(row[i], row[i], acc);
    qn[q] = acc;
  }
}

// Block (query tile, N split): BN queries (the N side of every product)
// against 128-point tiles of one split (the M side: 64 rows a warpgroup).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, (Cfg<T, BN>::MINB))
rangescan_wgmma_kernel(const __grid_constant__ CUtensorMap tp,
                       const __grid_constant__ CUtensorMap tqh,
                       const __grid_constant__ CUtensorMap tql, const Args a) {
  using C = Cfg<T, BN>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int TERMS = C::TERMS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const State<BN> s = state_of<BN>(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BARS);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wgi = tid / 128, wtid = tid % 128;
  const int q0 = blockIdx.x * BN, split = blockIdx.y;
  const int n_begin = split * a.split_len;
  const int n_end = min(a.n, n_begin + a.split_len);
  const int n_tiles = n_begin < n_end ? (n_end - n_begin + BM - 1) / BM : 0;
  const int nch = (a.d + DK - 1) / DK;
  const int total = n_tiles * nch;   // chunks the ring carries

  for (int i = tid; i < BN; i += THREADS) {
    s.thr[i] = EMPTY;
    s.cnt[i] = 0;
    s.kept_n[i] = 0;
    s.qhas[i] = 0;
    s.qn[i] = (a.l2 && q0 + i < a.q_total) ? a.qn[q0 + i] : 0.f;
  }
  if (tid == 0) {
    *s.list_n = 0;
    s.tile_cands[0] = s.tile_cands[1] = 0;
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);   // every warp releases each stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer is the first thread of warpgroup 1: it fills the ring, then
  // refills a stage once all eight warps have released it.
  const bool producer = tid == 128;
  auto load_chunk = [&](int g) {
    const int st = g % C::STAGES, t = g / nch, c = g % nch;
    uint8_t* dst = sm + C::RING + st * C::STAGE_BYTES;
    mbar_expect_tx(&full[st], C::STAGE_BYTES);
    tma_load(dst, &tp, &full[st], c * DK, n_begin + t * BM);
    tma_load(dst + C::PTS_BYTES, &tqh, &full[st], c * DK, q0);
    tma_load(dst + C::PTS_BYTES + C::Q_BYTES, &tql, &full[st], c * DK, q0);
  };
  if (producer)
    for (int g = 0; g < min(C::STAGES, total); ++g) load_chunk(g);

  // Accumulator element j of this thread: point row m = rl + 8 ((j / 2) % 2)
  // of the warpgroup's 64 (rl = 16 (warp % 4) + lane / 4), query column
  // n = 8 (j / 4) + 2 (lane % 4) + j % 2.
  const int rl = 16 * (warp % 4) + lane / 4;
  const int rw = wgi * 64 + rl;          // the row within the tile
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  float xn_acc = 0.f;
  int lst = 0;   // the list's length, as the last barrier left it

  for (int t = 0; t < n_tiles; ++t) {
    for (int c = 0; c < nch; ++c) {
      const int g = t * nch + c, st = g % C::STAGES;
      const uint8_t* pt = sm + C::RING + st * C::STAGE_BYTES;
      const uint8_t* qh = pt + C::PTS_BYTES;
      const uint8_t* ql = qh + C::Q_BYTES;
      mbar_wait(&full[st], (g / C::STAGES) & 1);
      // A from registers: rows (rw, rw + 8) x columns (lane % 4, + 4) of
      // each k-step, i.e. (perm_dim) dims 16 hh + 4 (lane % 4) .. + 3 of k-steps
      // 2 hh and 2 hh + 1; f32 rows split into hi and lo, bf16 rows exact
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float4 v = dims4(pt, rw + 8 * m, 4 * hh + lane % 4, static_cast<T*>(nullptr));
          const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {   // fragment u = m + 2 e: row + 8 m, column + 4 e
              uint32_t& fh = ahi[2 * hh + h][m + 2 * e];
              if constexpr (F32) split_tf32(x[2 * h + e], fh, alo[2 * hh + h][m + 2 * e]);
              else fh = __float_as_uint(x[2 * h + e]);
            }
        }
      fence_regs<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dh = sw128_desc(qh + ks * 32, 16, 1024);
        const uint64_t dl = sw128_desc(ql + ks * 32, 16, 1024);
        // the small terms first: lo_x . hi_q, hi_x . lo_q, then hi_x . hi_q
        // (bf16: x . lo_q, then x . hi_q)
#pragma unroll
        for (int tt = 0; tt < TERMS; ++tt) {
          const int go = c > 0 || ks > 0 || tt > 0;   // 0 starts the tile's sum
          const uint32_t* fa = (F32 && tt == 0) ? alo[ks] : ahi[ks];
          const uint64_t db = (tt == TERMS - 1 || (F32 && tt == 0)) ? dh : dl;
          Wgmma<BN>::mma(acc, fa, db, go);
        }
      }
      wgmma_commit();
      if (a.l2 && wtid < 64)
        xn_acc = row_norm<T>(pt, wgi * 64 + wtid, xn_acc);
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      // the stage goes back to the producer, who refills it once all eight
      // warps are done with it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (producer && g + C::STAGES < total) {
        mbar_wait(&empty[st], (g / C::STAGES) & 1);
        load_chunk(g + C::STAGES);
      }
      __syncwarp();   // the producer's warp reconverges before its next wgmma
    }

    // -- the tile's epilogue: distances, counts, candidates ----------------
    if (a.l2) {
      if (wtid < 64) s.xn[wgi * 64 + wtid] = xn_acc;
      xn_acc = 0.f;
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wgi) : "memory");
    }
    const int p0 = n_begin + t * BM + rw;   // the thread's points p0, p0 + 8
    auto dist_of = [&](int j) -> float {
      if (!a.l2) return -acc[j];
      const int n = 8 * (j / 4) + 2 * (lane % 4) + j % 2;
      const float raw = __fsub_rn(__fadd_rn(s.qn[n], s.xn[rw + 8 * ((j / 2) % 2)]),
                                  __fmul_rn(2.f, acc[j]));
      return raw < 0.f ? 0.f : raw;   // NaN stays NaN, as jnp.maximum
    };
    auto valid = [&](int j) -> bool {
      return q0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2 < a.q_total &&
             p0 + 8 * ((j / 2) % 2) < n_end;
    };
    auto key_of = [&](int j, float dist) -> u64 {
      return ((u64)ordered(dist) << 32) | (unsigned)(p0 + 8 * ((j / 2) % 2));
    };
    // pass 1: counts, and how many candidates this thread holds
    int mine = 0;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int n = 8 * (j / 4) + 2 * (lane % 4) + j % 2;
      if (valid(j)) {
        const float dist = dist_of(j);
        if (dist <= a.r) {
          atomicAdd(&s.cnt[n], 1);
          if (key_of(j, dist) < s.thr[n]) ++mine;
        }
      }
    }
    if (mine) atomicAdd(&s.tile_cands[t & 1], mine);
    __syncthreads();
    const int tot = s.tile_cands[t & 1];
    if (tid == 0) s.tile_cands[(t + 1) & 1] = 0;
    if (tot > 0 && lst + tot <= CAP) {
      // the usual case: the tile's candidates fit in the list as it is
      if (mine) {
        int pos = atomicAdd(s.list_n, mine);
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int n = 8 * (j / 4) + 2 * (lane % 4) + j % 2;
          if (valid(j)) {
            const float dist = dist_of(j);
            if (dist <= a.r) {
              const u64 key = key_of(j, dist);
              if (key < s.thr[n]) {
                s.list_key[pos] = key;
                s.list_q[pos] = (uint8_t)n;
                s.qhas[n] = 1;
                ++pos;
              }
            }
          }
        }
      }
    } else if (tot > 0) {
      // a dense tile: rounds of at most 4 candidates a thread, the list
      // flushed before a round that might not fit
#pragma unroll
      for (int v = 0; v < BN / 8; ++v) {
        if (lst > CAP - ROUND) {
          flush_list<BN>(s, a.part_keys, q0, a.n_split, split, a.k);
          lst = 0;
        }
        int cnt = 0;
        u64 keys[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * v + e, n = 8 * v + 2 * (lane % 4) + e % 2;
          keys[e] = EMPTY;
          if (valid(j)) {
            const float dist = dist_of(j);
            if (dist <= a.r) {
              const u64 key = key_of(j, dist);
              if (key < s.thr[n]) {
                keys[e] = key;
                ++cnt;
              }
            }
          }
        }
        if (cnt) {
          int pos = atomicAdd(s.list_n, cnt);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (keys[e] != EMPTY) {
              const int n = 8 * v + 2 * (lane % 4) + e % 2;
              s.list_key[pos] = keys[e];
              s.list_q[pos] = (uint8_t)n;
              s.qhas[n] = 1;
              ++pos;
            }
        }
        __syncthreads();
        lst = *s.list_n;
        __syncthreads();
      }
    }
    __syncthreads();
    lst = *s.list_n;
  }
  if (lst > 0) flush_list<BN>(s, a.part_keys, q0, a.n_split, split, a.k);
  __syncthreads();
  for (int i = tid; i < BN; i += THREADS) {
    const int q = q0 + i;
    if (q >= a.q_total) continue;
    if (s.cnt[i]) atomicAdd(a.counts + q, s.cnt[i]);
    a.part_n[(size_t)q * a.n_split + split] = s.kept_n[i];
  }
}

// A row-major (rows, cols) matrix as a 2-D tensor map of box_cols x box_rows
// boxes. Returns 0 or an error code.
int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
             int cols, int rows, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_ENTRY;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult rc = enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(rc);
}

template <typename T, int BN>
int launch(const void* points, const float* q_hi, const float* q_lo, const Args& a,
           cudaStream_t stream) {
  using C = Cfg<T, BN>;
  constexpr bool F32 = sizeof(T) == 4;
  CUtensorMap tp, tqh, tql;
  int rc = make_map(&tp, points,
                    F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    (int)sizeof(T), a.d, a.n, DK, BM,
                    F32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0)
    rc = make_map(&tqh, q_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, round_up(a.d, DK),
                  a.q_total, DK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map(&tql, q_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, round_up(a.d, DK),
                  a.q_total, DK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  auto kern = rangescan_wgmma_kernel<T, BN>;
  static bool smem_set = false;   // once per instantiation, before any capture
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((unsigned)((a.q_total + BN - 1) / BN), (unsigned)a.n_split);
  kern<<<grid, THREADS, C::SMEM, stream>>>(tp, tqh, tql, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bn(int bn, const void* points, const float* q_hi, const float* q_lo,
              const Args& a, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch<T, 8>(points, q_hi, q_lo, a, stream);
    case 16: return launch<T, 16>(points, q_hi, q_lo, a, stream);
    case 32: return launch<T, 32>(points, q_hi, q_lo, a, stream);
    case 64: return launch<T, 64>(points, q_hi, q_lo, a, stream);
    case 128: return launch<T, 128>(points, q_hi, q_lo, a, stream);
    case 256: return launch<T, 256>(points, q_hi, q_lo, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

extern "C" {

// The launch geometry the wrapper plans with (ops.py holds the same
// numbers and checks them against these once): the SIMT route's queries a
// block (8 with small_q, taken when Q <= 8; else 32), points a tile (both
// routes), the largest K, the most N splits.
int rangescan_block_queries(int small_q) {
  return small_q ? ScanSmem<1>::BQ : ScanSmem<4>::BQ;
}

int rangescan_points_per_tile() { return BN; }

int rangescan_max_k() { return KMAX; }

int rangescan_max_splits() { return MAX_SPLITS; }

// The wgmma route's ring: stages of a block with query tile bn, dtype 0 =
// f32 points, 1 = bf16 (0 for a tile it does not take).
int rangescan_wgmma_stages(int dtype, int bn) {
  switch (bn) {
#define STAGES_OF(B) \
    case B: return dtype == 0 ? wg::Cfg<float, B>::STAGES : wg::Cfg<__nv_bfloat16, B>::STAGES;
    STAGES_OF(8) STAGES_OF(16) STAGES_OF(32) STAGES_OF(64) STAGES_OF(128) STAGES_OF(256)
#undef STAGES_OF
    default: return 0;
  }
}

// Blocks of the wgmma route an SM holds at query tile bn.
int rangescan_wgmma_blocks_per_sm(int bn) { return bn == 8 ? wg::Cfg<float, 8>::MINB : 1; }

static_assert(wg::BM == BN, "both routes walk 128-point tiles");

static int merge(u64* pk, const int* pn, int q, int n_split, int k, void* out_ids,
                 void* out_d, cudaStream_t st) {
  // at most 16 KB + 4 KB: under the default 48 KB of a launch
  const size_t smem = sizeof(u64) * MCAP + sizeof(int) * (n_split + 1);
  rangescan_merge_kernel<<<(unsigned)q, THREADS, smem, st>>>(
      pk, pn, n_split, k, static_cast<int*>(out_ids), static_cast<float*>(out_d));
  return (int)cudaGetLastError();
}

// The SIMT route. dtype: 0 = float32 points, 1 = bfloat16 points (queries
// are float32). metric: 1 = l2, 0 = ip. use_vec: every point row starts on
// a 16-byte boundary (16-byte loads). counts must be zeroed by the caller;
// part_keys (Q, n_split, k) uint64 and part_n (Q, n_split) int32 are
// scratch. Returns the CUDA error code of the launches (0 on success).
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
  return merge(pk, pn, q, n_split, k, out_ids, out_d, st);
}

// The wgmma route: the query pre-pass, the scan and the merge. Points (N,
// d) f32 (d % 4 == 0) or bf16 (d % 8 == 0) on a 16-byte boundary; block_q
// one of 8, 16, 32, 64, 128, 256; q_split (2, Q, d rounded up to 32) f32,
// qn (Q,) f32, part_keys and part_n are scratch; counts zeroed by the caller.
// Returns 0, a CUDA error code, or one of this file's codes.
int rangescan_wgmma_launch(const void* queries, const void* points, int dtype,
                           float r, int q, int n, int d, int k, int l2,
                           int block_q, int n_split, int split_len, void* q_split,
                           void* qn, void* counts, void* part_keys, void* part_n,
                           void* out_ids, void* out_d, void* stream) {
  if (k < 1 || k > KMAX || n_split < 1 || n_split > MAX_SPLITS ||
      d % (dtype == 0 ? 4 : 8) != 0 || reinterpret_cast<uintptr_t>(points) % 16 != 0 ||
      rangescan_wgmma_stages(dtype, block_q) == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = (d + wg::DK - 1) / wg::DK * wg::DK;
  float* q_hi = static_cast<float*>(q_split);
  float* q_lo = q_hi + (size_t)q * dp;
  wg::rangescan_split_queries<<<(unsigned)q, 128, 0, st>>>(
      static_cast<const float*>(queries), q, d, dp, q_hi, q_lo, static_cast<float*>(qn));
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  wg::Args a;
  a.qn = static_cast<const float*>(qn);
  a.r = r;
  a.q_total = q;
  a.n = n;
  a.d = d;
  a.k = k;
  a.n_split = n_split;
  a.split_len = split_len;
  a.l2 = l2;
  a.counts = static_cast<int*>(counts);
  a.part_keys = static_cast<u64*>(part_keys);
  a.part_n = static_cast<int*>(part_n);
  rc = dtype == 0 ? wg::launch_bn<float>(block_q, points, q_hi, q_lo, a, st)
                  : wg::launch_bn<__nv_bfloat16>(block_q, points, q_hi, q_lo, a, st);
  if (rc != 0) return rc;
  return merge(a.part_keys, a.part_n, q, n_split, k, out_ids, out_d, st);
}

const char* rangescan_error_string(int code) {
  static char buf[96];
  if (code == wg::ERR_ENTRY) return "cuTensorMapEncodeTiled is not available from the driver";
  if (code >= wg::ERR_ENCODE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - wg::ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
