// Flash-attention forward for Hopper (sm_90a): GQA, causal masking on
// absolute positions (q_offset), a sliding window and the logit soft cap.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flashattn/kernel.py:33
// (_flash_kernel, via flash_attention_pallas), with flashattn_wgmma.cu. It
// computes what src/repro_torch/kernels/flashattn/ref.py::flash_attention_ref
// computes: s = (q . k) * scale in f32, the optional soft cap
// cap * tanh(s / cap), the mask (k_pos < Skv; k_pos <= q_pos if causal;
// q_pos - k_pos < window if window > 0, with q_pos = q_offset + row), an
// online softmax (running max, denominator and f32 accumulator of p . v
// across the key sweep), and acc / max(l, 1e-30) in q's dtype. A masked
// key's p is set to 0, so a row that sees no key gives 0, as the plain
// version does.
//
// Rows. The G = Hq / Hkv query heads of one kv head share its keys, so a
// block takes rows of all of them: row r of the (Sq * G) rows of kv head
// kvh is query position r / G of head kvh * G + r % G. Each key tile a
// block loads then serves G heads.
//
// Three routes, chosen by ops.py from the rows, the dtype and dh alone:
//  * decode_split (Sq * G <= 16, this file): flash_split_kernel splits the
//    visible keys [lo, hi) of each (b, kv head) into `splits` ranges
//    (flash-decoding; ops.py::decode_splits plans them on the host: about
//    two blocks an SM, at least 256 keys a split), a block of 4 warps a
//    (split, kv head, b). Each warp takes 32 keys at a time. A K or V row
//    is read by dh * size / 16 lanes, 16 bytes each (a warp load covers
//    whole rows, 8 loads in flight a lane); a key's dot is summed over its
//    row's lanes by shuffles and kept by the lane of that key, the warp
//    keeps its own online-softmax state, and p . v runs with the same
//    lanes over V. The block's warps are merged in shared memory. With
//    more than one split, each block writes its rows' partial (acc, m, l)
//    in f32 to a workspace and counts itself done (an atomic on a
//    per-(b, kv head) count); the last block of a (b, kv head) rescales the
//    partials to their common max, divides, writes the output and resets
//    the count to 0: one launch, no memset. A split whose keys a row
//    cannot see gives m = -1e30, l = 0, acc = 0: exp(m - max) is 0 there,
//    or 1 against 0 sums when the row sees no key at all, which then
//    gives 0.
//    What bounds it: the bytes of K and V (at G = 2, decode does 2 flops a
//    byte; the math stays on the CUDA cores). B * Hkv blocks alone (64 for
//    gemma3-27b at B=4) would leave half the SMs idle; the split fills the
//    card.
//  * wgmma (bf16, dh 64 or 128, more rows): flashattn_wgmma.cu, on the
//    tensor cores.
//  * tile_f32 (f32, and bf16 at dh 16 or 32, more rows): flash_tile_kernel,
//    a block of 256 threads owning 64 rows and sweeping 64-key tiles. Q
//    (scaled), K and V tiles are staged in shared memory as f32; a thread
//    computes a 4 x 4 block of scores with fmaf chains over dh, keeps the
//    softmax state of its 4 rows in registers, writes p over the K tile, and
//    accumulates p . v for its 4 rows x dh / 16 columns. Bounded by the f32
//    operations on the CUDA cores (67 TFLOP/s); TF32 tensor cores would
//    break the f32 path's 1e-4 agreement, and no configuration of the repo
//    serves dh 16 or 32 in bf16.
// In every route, key tiles that no row of a block can see (past the causal
// frontier, or wholly before the window) are never loaded.
//
// Inputs are read through their strides (last dim contiguous), so q in the
// model's (B, S, Hq, dh) layout and the cache's (B, T, Hkv, dh) layout are
// read in place, and a slice of the cache ([:kv_valid]) is a view. f32 or
// bf16 storage, f32 math (fmaf, no fast math).
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;
constexpr int BM = 64;          // rows of a tile-kernel block
constexpr int BN = 64;          // keys of a tile
constexpr int MAX_DECODE_ROWS = 16;   // rows of the decode_split route

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of dims b, h, s
  int sq, skv, group, causal, window, q_offset;
  float softcap, scale;
};

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  return kpos < a.skv && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || qpos - kpos < a.window);
}

// The keys [lo, hi) that some row of [r0, r1) may see.
__device__ __forceinline__ void key_range(const Args& a, int r0, int r1,
                                          int& lo, int& hi) {
  const int pmin = a.q_offset + r0 / a.group;
  const int pmax = a.q_offset + (r1 - 1) / a.group;
  lo = 0;
  hi = a.skv;
  if (a.causal) hi = min(hi, pmax + 1);
  if (a.window > 0) lo = max(lo, pmin - a.window + 1);
}

__device__ __forceinline__ float cap(float x, float softcap) {
  return softcap > 0.f ? softcap * tanhf(x / softcap) : x;
}

__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive f32 values from shared memory (N in {1, 2, 4}, aligned).
template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    out[0] = u.x; out[1] = u.y;
  } else {
    out[0] = *p;
  }
}

template <int DH>
constexpr int tile_smem_floats() {
  return BM * (DH + 4) +                                            // q
         (BN * (DH + 4) > BN * (BM + 2) ? BN * (DH + 4) : BN * (BM + 2)) +  // k, then p
         BN * DH;                                                   // v
}

// ---------------------------------------------------------------------------
// Tile kernel (prefill): 64 rows a block, 64-key tiles.
// ---------------------------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 2) flash_tile_kernel(Args a) {
  constexpr int VE = Vec<T>::N;            // elements per 16-byte load
  constexpr int CH = DH / VE;              // 16-byte chunks per row
  constexpr int QK_LD = DH + 4;            // padded rows of q_s and k_s
  constexpr int P_LD = BM + 2;             // padded rows of p_s
  constexpr int CV = DH >= 64 ? 4 : DH / 16;   // value columns per group
  constexpr int CN = DH / (16 * CV);           // column groups per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* kp_s = q_s + BM * QK_LD;   // the K tile, then the P tile over it
  float* v_s = kp_s + (BN * QK_LD > BN * P_LD ? BN * QK_LD : BN * P_LD);

  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int rows = a.group * a.sq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;   // latest rows first
  const int r1 = min(r0 + BM, rows);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];

  for (int c = t; c < BM * CH; c += THREADS) {
    const int rl = c / CH, ch = c % CH, r = r0 + rl;
    float x[VE];
    if (r < rows) {
      const int h = kvh * a.group + r % a.group;
      load16(q + b * a.qs[0] + h * a.qs[1] + (long long)(r / a.group) * a.qs[2] + ch * VE, x);
#pragma unroll
      for (int e = 0; e < VE; ++e) x[e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VE; e += 4)
      *reinterpret_cast<float4*>(q_s + rl * QK_LD + ch * VE + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = a.q_offset + (r0 + ty + 16 * i) / a.group;
  float m[4], l[4], acc[4][CN][CV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c)
#pragma unroll
      for (int e = 0; e < CV; ++e) acc[i][c][e] = 0.f;
  }

  int lo, hi;
  key_range(a, r0, r1, lo, hi);
  for (int n0 = (lo / BN) * BN; n0 < hi; n0 += BN) {
    __syncthreads();   // the last tile's p_s / v_s reads (and q_s writes) are done
    for (int c = t; c < BN * CH; c += THREADS) {
      const int nl = c / CH, ch = c % CH, n = n0 + nl;
      float xk[VE], xv[VE];
      if (n < a.skv) {
        load16(kb + (long long)n * a.ks[2] + ch * VE, xk);
        load16(vb + (long long)n * a.vs[2] + ch * VE, xv);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) xk[e] = xv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VE; e += 4) {
        *reinterpret_cast<float4*>(kp_s + nl * QK_LD + ch * VE + e) =
            make_float4(xk[e], xk[e + 1], xk[e + 2], xk[e + 3]);
        *reinterpret_cast<float4*>(v_s + nl * DH + ch * VE + e) =
            make_float4(xv[e], xv[e + 1], xv[e + 2], xv[e + 3]);
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * QK_LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(kp_s + (tx + 16 * j) * QK_LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kk[j].w, s[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool vis[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(a, qpos[i], n0 + tx + 16 * j);
        s[i][j] = vis[j] ? cap(s[i][j], a.softcap) : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)   // the 16 lanes of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = vis[j] ? expf(s[i][j] - mn) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = mn;
    }
    __syncthreads();   // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kp_s[(tx + 16 * j) * P_LD + ty + 16 * i] = s[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c)
#pragma unroll
        for (int e = 0; e < CV; ++e) acc[i][c][e] *= alpha[i];
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = kp_s[n * P_LD + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        float vv[CV];
        lds<CV>(v_s + n * DH + c * 16 * CV + tx * CV, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < CV; ++e) acc[i][c][e] = fmaf(pv[i], vv[e], acc[i][c][e]);
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    const int h = kvh * a.group + r % a.group;
    T* orow = o + b * a.os[0] + h * a.os[1] + (long long)(r / a.group) * a.os[2];
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CN; ++c)
#pragma unroll
      for (int e = 0; e < CV; ++e)
        store_val(orow + c * 16 * CV + tx * CV + e, acc[i][c][e] / den);
  }
}

// ---------------------------------------------------------------------------
// Decode: the key sweep split across blocks, then merged.
// ---------------------------------------------------------------------------
constexpr int DTHREADS = 128;
constexpr int DWARPS = DTHREADS / 32;

struct Split {
  int lo, hi, splits;   // split s sweeps [lo + s * n / splits, lo + (s + 1) * n / splits)
  float* ws;            // (B, Hkv, splits, rows, dh + 2): acc, m, l
  int* count;           // (B * Hkv,) zeros: the splits of a (b, kv head) done so far
};

template <int ROWS, int DH>
constexpr int split_smem_floats() {
  return 2 * DWARPS * ROWS + DWARPS * ROWS * DH;
}

// 16 bytes of f32 or bf16 storage as f32 values
__device__ __forceinline__ void unpack16(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The splits' partial rows of one (b, kv head), rescaled to their common
// max and divided by the summed denominator; read through L2 (__ldcg), as
// other blocks wrote them.
template <typename T, int DH>
__device__ __forceinline__ void merge_splits(const Args& a, const Split& sp, int b, int kvh,
                                             int hkv) {
  const int rows = a.group * a.sq;
  const float* ws = sp.ws + (long long)(b * hkv + kvh) * sp.splits * rows * (DH + 2);
  T* o = static_cast<T*>(a.o);
  for (int i = threadIdx.x; i < rows * DH; i += DTHREADS) {
    const int r = i / DH, d = i % DH;
    float mx = NEG;
    for (int s = 0; s < sp.splits; ++s) mx = fmaxf(mx, __ldcg(ws + (s * rows + r) * (DH + 2) + DH));
    float den = 0.f, num = 0.f;
    for (int s = 0; s < sp.splits; ++s) {
      const float* part = ws + (s * rows + r) * (DH + 2);
      const float f = expf(__ldcg(part + DH) - mx);
      den = fmaf(__ldcg(part + DH + 1), f, den);
      num = fmaf(__ldcg(part + d), f, num);
    }
    const int h = kvh * a.group + r % a.group;
    store_val(o + b * a.os[0] + h * a.os[1] + (long long)(r / a.group) * a.os[2] + d,
              num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(DTHREADS, 4) flash_split_kernel(Args a, Split sp) {
  constexpr int VE = Vec<T>::N;              // elements a 16-byte load
  constexpr int CH = DH / VE;                // 16-byte chunks a row = lanes a row
  constexpr int RPI = 32 / CH;               // rows a warp load
  constexpr int KG = CH < 8 ? CH : 8;        // K loads in flight a lane
  constexpr int U = RPI * 8 <= 32 ? 8 : 32 / RPI;   // V loads in flight a lane
  extern __shared__ float4 smem4[];
  float* m_w = reinterpret_cast<float*>(smem4);   // DWARPS x ROWS
  float* l_w = m_w + DWARPS * ROWS;               // DWARPS x ROWS
  float* a_w = l_w + DWARPS * ROWS;               // DWARPS x ROWS x DH

  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = a.group * a.sq;
  const int n_keys = max(sp.hi - sp.lo, 0);
  const int k0 = sp.lo + static_cast<int>((long long)split * n_keys / sp.splits);
  const int k1 = sp.lo + static_cast<int>((long long)(split + 1) * n_keys / sp.splits);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];

  // A row of K or V is read by CH lanes, 16 bytes each: lane = sub * CH + c
  // reads chunk c of row sub of a warp load. Each lane keeps chunk c of
  // every row's scaled q.
  const int sub = lane / CH, c = lane % CH;
  float qr[ROWS][VE];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < rows) {
      const int h = kvh * a.group + r % a.group;
      load16(static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1] +
                 (long long)(r / a.group) * a.qs[2] + c * VE, qr[r]);
#pragma unroll
      for (int e = 0; e < VE; ++e) qr[r][e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) qr[r][e] = 0.f;
    }
  }

  float m[ROWS], l[ROWS], acc[ROWS][VE];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[r][e] = 0.f;
  }
  for (int base = k0 + w * 32; base < k1; base += DWARPS * 32) {
    // scores of the warp's 32 keys: load u brings key base + sub * CH + u;
    // its dot, summed over the row's CH lanes, stays with lane sub * CH + u,
    // so lane j ends with key base + j
    const int n = base + lane;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll
    for (int u0 = 0; u0 < CH; u0 += KG) {
      uint4 raw[KG];
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const int key = base + sub * CH + u0 + u;
        raw[u] = key < k1 ? __ldg(reinterpret_cast<const uint4*>(kb + (long long)key * a.ks[2]) + c)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        float x[VE];
        unpack16(raw[u], x, T());
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VE; ++e) d = fmaf(qr[r][e], x[e], d);
#pragma unroll
          for (int o = 1; o < CH; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          if (c == u0 + u) s[r] = d;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool vis = n < k1 && r < rows && visible(a, a.q_offset + r / a.group, n);
      const float x = vis ? cap(s[r], a.softcap) : NEG;
      const float mn = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - mn);
      s[r] = vis ? expf(x - mn) : 0.f;
      l[r] = l[r] * alpha + s[r];     // this lane's share
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[r][e] *= alpha;
    }
    // p . v: load u brings V row j0 + u * RPI + sub, chunk c
    const int nk = min(32, k1 - base);
    for (int j0 = 0; j0 < nk; j0 += RPI * U) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = j0 + u * RPI + sub;
        raw[u] = jj < nk ? __ldg(reinterpret_cast<const uint4*>(
                               vb + (long long)(base + jj) * a.vs[2]) + c)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = j0 + u * RPI + sub;
        float x[VE];
        unpack16(raw[u], x, T());
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float pr = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[r][e] = fmaf(pr, x[e], acc[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int o = CH; o < 32; o <<= 1)       // the lanes of one chunk
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    const float lt = warp_sum(l[r]);
    if (lane == 0) {
      m_w[w * ROWS + r] = m[r];
      l_w[w * ROWS + r] = lt;
    }
    if (lane < CH)
#pragma unroll
      for (int e = 0; e < VE; ++e) a_w[(w * ROWS + r) * DH + c * VE + e] = acc[r][e];
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o);
  for (int i = t; i < rows * DH; i += DTHREADS) {
    const int r = i / DH, d = i % DH;
    float mx = NEG;
#pragma unroll
    for (int u = 0; u < DWARPS; ++u) mx = fmaxf(mx, m_w[u * ROWS + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int u = 0; u < DWARPS; ++u) {
      const float f = expf(m_w[u * ROWS + r] - mx);
      den = fmaf(l_w[u * ROWS + r], f, den);
      num = fmaf(a_w[(u * ROWS + r) * DH + d], f, num);
    }
    if (sp.splits == 1) {
      const int h = kvh * a.group + r % a.group;
      store_val(o + b * a.os[0] + h * a.os[1] + (long long)(r / a.group) * a.os[2] + d,
                num / fmaxf(den, 1e-30f));
    } else {
      float* part = sp.ws + (((long long)(b * gridDim.y + kvh) * sp.splits + split) * rows + r) *
                                (DH + 2);
      part[d] = num;
      if (d == 0) {
        part[DH] = mx;
        part[DH + 1] = den;
      }
    }
  }
  if (sp.splits == 1) return;
  // the last block of a (b, kv head) to finish merges its splits and
  // resets the count for the next launch
  __shared__ int last;
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(sp.count + b * gridDim.y + kvh, 1) == sp.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_splits<T, DH>(a, sp, b, kvh, gridDim.y);
  if (t == 0) sp.count[b * gridDim.y + kvh] = 0;
}

template <auto Kernel, typename... Extra>
cudaError_t launch(dim3 grid, int threads, int smem_floats, cudaStream_t st,
                   const Args& a, Extra... extra) {
  const int bytes = smem_floats * (int)sizeof(float);
  static bool smem_set = false;  // once per kernel, before any graph capture
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  Kernel<<<grid, threads, bytes, st>>>(a, extra...);
  return cudaGetLastError();
}

template <typename T, int DH, int ROWS>
cudaError_t launch_split(const Args& a, const Split& sp, int batch, int hkv,
                         cudaStream_t st) {
  return launch<flash_split_kernel<T, DH, ROWS>>(
      dim3(sp.splits, hkv, batch), DTHREADS, split_smem_floats<ROWS, DH>(), st, a, sp);
}

template <typename T, int DH>
cudaError_t dispatch_decode(const Args& a, const Split& sp, int batch, int hkv,
                            cudaStream_t st) {
  // three row counts, to keep the build short: 2 (gemma3's G = 2 at one
  // position; G = 1 leaves a row unused), 8 and 16
  const int rows = a.group * a.sq;
  if (rows <= 2) return launch_split<T, DH, 2>(a, sp, batch, hkv, st);
  if (rows <= 8) return launch_split<T, DH, 8>(a, sp, batch, hkv, st);
  if (rows <= MAX_DECODE_ROWS) return launch_split<T, DH, 16>(a, sp, batch, hkv, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_tile(const Args& a, int dh, int batch, int hkv, cudaStream_t st) {
  const dim3 grid((a.group * a.sq + BM - 1) / BM, hkv, batch);
  switch (dh) {
    case 16: return launch<flash_tile_kernel<T, 16>>(grid, THREADS, tile_smem_floats<16>(), st, a);
    case 32: return launch<flash_tile_kernel<T, 32>>(grid, THREADS, tile_smem_floats<32>(), st, a);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {   // bf16 at dh 64 and 128 takes the wgmma route
    switch (dh) {
      case 64: return launch<flash_tile_kernel<T, 64>>(grid, THREADS, tile_smem_floats<64>(), st, a);
      case 128: return launch<flash_tile_kernel<T, 128>>(grid, THREADS, tile_smem_floats<128>(), st, a);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_decode_dh(const Args& a, const Split& sp, int dh, int batch,
                               int hkv, cudaStream_t st) {
  switch (dh) {
    case 16: return dispatch_decode<T, 16>(a, sp, batch, hkv, st);
    case 32: return dispatch_decode<T, 32>(a, sp, batch, hkv, st);
    case 64: return dispatch_decode<T, 64>(a, sp, batch, hkv, st);
    case 128: return dispatch_decode<T, 128>(a, sp, batch, hkv, st);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, void* o, int hq,
               int hkv, int sq, int skv, const long long* q_strides,
               const long long* k_strides, const long long* v_strides,
               const long long* o_strides, int causal, int window, int q_offset,
               float softcap, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = q_strides[i];
    a.ks[i] = k_strides[i];
    a.vs[i] = v_strides[i];
    a.os[i] = o_strides[i];
  }
  a.sq = sq;
  a.skv = skv;
  a.group = hq / hkv;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.softcap = softcap;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v and o alike). Strides are in elements,
// for dims (b, h, s); the last dim is contiguous and every row starts on a
// 16-byte boundary (the wrapper checks both). Each returns the CUDA error
// code of its launches.

// The tile_f32 route: f32 at dh 16..128, bf16 at dh 16 and 32.
int flashattn_tile_launch(const void* q, const void* k, const void* v, void* o,
                          int dtype, int batch, int hq, int hkv, int sq, int skv,
                          int dh, const long long* q_strides,
                          const long long* k_strides, const long long* v_strides,
                          const long long* o_strides, int causal, int window,
                          int q_offset, float softcap, float scale, void* stream) {
  const Args a = make_args(q, k, v, o, hq, hkv, sq, skv, q_strides, k_strides,
                           v_strides, o_strides, causal, window, q_offset, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? dispatch_tile<float>(a, dh, batch, hkv, st)
                                   : dispatch_tile<__nv_bfloat16>(a, dh, batch, hkv, st);
  return static_cast<int>(e);
}

// The decode_split route (Sq * G <= 16): the visible keys [lo, hi) in
// `splits` ranges. When splits > 1, ws holds B * Hkv * splits * Sq * G *
// (dh + 2) floats and count B * Hkv ints, zero before the launch and zero
// again after it (the last block of each (b, kv head) resets its count).
int flashattn_decode_launch(const void* q, const void* k, const void* v, void* o,
                            int dtype, int batch, int hq, int hkv, int sq, int skv,
                            int dh, const long long* q_strides,
                            const long long* k_strides, const long long* v_strides,
                            const long long* o_strides, int causal, int window,
                            int q_offset, float softcap, float scale, int lo, int hi,
                            int splits, void* ws, void* count, void* stream) {
  const Args a = make_args(q, k, v, o, hq, hkv, sq, skv, q_strides, k_strides,
                           v_strides, o_strides, causal, window, q_offset, softcap, scale);
  if (splits < 1 || (splits > 1 && (ws == nullptr || count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Split sp{lo, hi, splits, static_cast<float*>(ws), static_cast<int*>(count)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0
      ? dispatch_decode_dh<float>(a, sp, dh, batch, hkv, st)
      : dispatch_decode_dh<__nv_bfloat16>(a, sp, dh, batch, hkv, st);
  return static_cast<int>(e);
}

const char* flashattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
