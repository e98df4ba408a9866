// Flash-attention forward for Hopper (sm_90a): GQA, causal masking on
// absolute positions (q_offset), a sliding window and the logit soft cap.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flashattn/kernel.py:33
// (_flash_kernel, via flash_attention_pallas). It computes what
// src/repro_torch/kernels/flashattn/ref.py::flash_attention_ref computes:
// s = (q * scale) . k in f32, the optional soft cap cap * tanh(s / cap), the
// mask (k_pos < Skv; k_pos <= q_pos if causal; q_pos - k_pos < window if
// window > 0, with q_pos = q_offset + row), an online softmax (running max,
// denominator and f32 accumulator of p . v across the key sweep), and
// acc / max(l, 1e-30) in q's dtype. A masked key's p is set to 0, so a row
// that sees no key gives 0, as the plain version does.
//
// Rows. The G = Hq / Hkv query heads of one kv head share its keys, so a
// block takes rows of all of them: row r of the (Sq * G) rows of kv head
// kvh is query position r / G of head kvh * G + r % G. Each key tile a
// block loads then serves G heads.
//
// Two kernels, one function:
//  * flash_tile_kernel (Sq * G > 16, prefill): a block of 256 threads owns
//    64 rows and sweeps 64-key tiles. Q (scaled), K and V tiles are staged
//    in shared memory as f32; a thread computes a 4 x 4 block of scores
//    (rows ty + 16 i, keys tx + 16 j) with fmaf chains over dh, keeps the
//    softmax state of its 4 rows in registers (a row's 64 keys lie on 16
//    lanes of one warp: shuffles reduce them), writes p over the K tile,
//    and accumulates p . v for its 4 rows x dh / 16 columns. Key tiles that
//    no row of the block can see (past the causal frontier, or wholly
//    before the window) are never loaded: a causal prefill of S tokens does
//    about half of the S x S tile pairs, a windowed one about S x window.
//  * flash_decode_kernel (Sq * G <= 16, decode): one block per (b, kv head)
//    takes all rows; its 8 warps split the visible keys 32 at a time. A
//    lane scores one key against every row (its K row read 16 bytes at a
//    time, the rows' q from shared memory by broadcast); the warp keeps its
//    own online-softmax state, and p . v runs with lanes over dh; the 8
//    warps' states are merged at the end.
//
// Inputs are read through their strides (last dim contiguous), so q in the
// model's (B, S, Hq, dh) layout and the cache's (B, T, Hkv, dh) layout are
// read in place, and a slice of the cache ([:kv_valid]) is a view. f32 or
// bf16 storage, f32 math on the CUDA cores (fmaf, no tensor cores, no fast
// math).
//
// What bounds it: prefill, the operations (4 dh flops a visible
// (row, key) pair: 5.5e11 for a global gemma3-27b layer at B=4, S=4096),
// which this version runs on the CUDA cores (67 TFLOP/s f32) rather than
// the tensor cores (989 TFLOP/s bf16); decode, the bytes of K and V. Later
// work: wgmma/TMA tiles for prefill, a split of the key sweep across blocks
// for decode (B * Hkv blocks leave SMs idle).
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 64;          // rows of a tile-kernel block
constexpr int BN = 64;          // keys of a tile
constexpr int MAX_DECODE_ROWS = 16;

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

// N values from global memory (16-byte aligned groups where N * size = 16).
template <int N, typename T>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, float* out) {
  if constexpr (N * sizeof(T) == 16) {
    load16(p, out);
  } else if constexpr (sizeof(T) == 2 && N == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (sizeof(T) == 4 && N == 2) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = u.x; out[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
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
// Decode kernel: every row of one (b, kv head) in one block, warps over keys.
// ---------------------------------------------------------------------------
template <int ROWS, int DH>
constexpr int decode_smem_floats() {
  return ROWS * DH + 2 * WARPS * ROWS + WARPS * ROWS * DH;
}

template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(Args a) {
  constexpr int VE = Vec<T>::N;
  constexpr int VPL = DH >= 32 ? DH / 32 : 1;   // value columns per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // ROWS x DH, scaled
  float* m_w = q_s + ROWS * DH;                   // WARPS x ROWS
  float* l_w = m_w + WARPS * ROWS;                // WARPS x ROWS
  float* a_w = l_w + WARPS * ROWS;                // WARPS x ROWS x DH

  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int rows = a.group * a.sq;
  const T* q = static_cast<const T*>(a.q);
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];
  for (int i = t; i < ROWS * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    float x = 0.f;
    if (r < rows) {
      const int h = kvh * a.group + r % a.group;
      x = to_f32(q[b * a.qs[0] + h * a.qs[1] + (long long)(r / a.group) * a.qs[2] + d]) *
          a.scale;
    }
    q_s[i] = x;
  }
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][VPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[r][e] = 0.f;
  }
  const bool active = lane * VPL < DH;
  int lo, hi;
  key_range(a, 0, rows, lo, hi);
  for (int base = lo + w * 32; base < hi; base += WARPS * 32) {
    const int n = base + lane;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    if (n < hi) {
      const T* kr = kb + (long long)n * a.ks[2];
#pragma unroll 4
      for (int d = 0; d < DH; d += VE) {
        float x[VE];
        load16(kr + d, x);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int e = 0; e < VE; ++e) s[r] = fmaf(q_s[r * DH + d + e], x[e], s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool vis = n < hi && r < rows &&
                       visible(a, a.q_offset + r / a.group, n);
      const float x = vis ? cap(s[r], a.softcap) : NEG;
      const float mn = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - mn);
      s[r] = vis ? expf(x - mn) : 0.f;
      l[r] = l[r] * alpha + s[r];     // this lane's share
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[r][e] *= alpha;
    }
    const int nk = min(32, hi - base);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float vv[VPL];
      if (active) load_vals<VPL>(vb + (long long)(base + j) * a.vs[2] + lane * VPL, vv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r], j);
        if (active)
#pragma unroll
          for (int e = 0; e < VPL; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float lt = warp_sum(l[r]);
    if (lane == 0) {
      m_w[w * ROWS + r] = m[r];
      l_w[w * ROWS + r] = lt;
    }
    if (active)
#pragma unroll
      for (int e = 0; e < VPL; ++e) a_w[(w * ROWS + r) * DH + lane * VPL + e] = acc[r][e];
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o);
  for (int i = t; i < rows * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    float mx = NEG;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) mx = fmaxf(mx, m_w[u * ROWS + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) {
      const float f = expf(m_w[u * ROWS + r] - mx);
      den = fmaf(l_w[u * ROWS + r], f, den);
      num = fmaf(a_w[(u * ROWS + r) * DH + d], f, num);
    }
    const int h = kvh * a.group + r % a.group;
    store_val(o + b * a.os[0] + h * a.os[1] + (long long)(r / a.group) * a.os[2] + d,
              num / fmaxf(den, 1e-30f));
  }
}

template <auto Kernel>
cudaError_t launch(dim3 grid, int smem_floats, const Args& a, cudaStream_t st) {
  const int bytes = smem_floats * (int)sizeof(float);
  static bool smem_set = false;  // once per kernel, before any graph capture
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  Kernel<<<grid, THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_rows(const Args& a, int batch, int hkv, cudaStream_t st) {
  const int rows = a.group * a.sq;
  if (rows > MAX_DECODE_ROWS) {
    const dim3 grid((rows + BM - 1) / BM, hkv, batch);
    return launch<flash_tile_kernel<T, DH>>(grid, tile_smem_floats<DH>(), a, st);
  }
  const dim3 grid(hkv, batch);
  if (rows <= 1)
    return launch<flash_decode_kernel<T, DH, 1>>(grid, decode_smem_floats<1, DH>(), a, st);
  if (rows <= 2)
    return launch<flash_decode_kernel<T, DH, 2>>(grid, decode_smem_floats<2, DH>(), a, st);
  if (rows <= 4)
    return launch<flash_decode_kernel<T, DH, 4>>(grid, decode_smem_floats<4, DH>(), a, st);
  if (rows <= 8)
    return launch<flash_decode_kernel<T, DH, 8>>(grid, decode_smem_floats<8, DH>(), a, st);
  return launch<flash_decode_kernel<T, DH, 16>>(grid, decode_smem_floats<16, DH>(), a, st);
}

template <typename T>
cudaError_t dispatch_dh(const Args& a, int dh, int batch, int hkv, cudaStream_t st) {
  switch (dh) {
    case 16: return dispatch_rows<T, 16>(a, batch, hkv, st);
    case 32: return dispatch_rows<T, 32>(a, batch, hkv, st);
    case 64: return dispatch_rows<T, 64>(a, batch, hkv, st);
    case 128: return dispatch_rows<T, 128>(a, batch, hkv, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v and o alike). Strides are in elements,
// for dims (b, h, s); the last dim is contiguous and every row starts on a
// 16-byte boundary (the wrapper checks both). Returns the CUDA error code.
int flashattn_launch(const void* q, const void* k, const void* v, void* o,
                     int dtype, int batch, int hq, int hkv, int sq, int skv,
                     int dh, const long long* q_strides,
                     const long long* k_strides, const long long* v_strides,
                     const long long* o_strides, int causal, int window,
                     int q_offset, float softcap, float scale, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0
      ? dispatch_dh<float>(a, dh, batch, hkv, st)
      : dispatch_dh<__nv_bfloat16>(a, dh, batch, hkv, st);
  return static_cast<int>(e);
}

int flashattn_max_decode_rows() { return MAX_DECODE_ROWS; }

const char* flashattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
