// Device helpers shared by the port's CUDA kernels: 16-byte row loads of
// f32 or bf16 storage into f32 registers, a row-vs-query distance share,
// warp-wide reductions, the int8 corpus's query quantization, row reads
// (8 lanes a row), certified lower bound and bounds loops (over rows in
// device memory or in a shared-memory copy), and Hopper's mbarriers, TMA
// and 1-D bulk copies, cp.async, wgmma fences and the host's tensor-map
// encoder.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define INVALID_ID 2147483647

namespace repro_torch {

// elements of a row type per 16-byte load
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes at p (16-byte aligned) as f32 values: from device memory
// through the read-only path, or (kShared) from a shared-memory copy
template <bool kShared = false>
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4* v4 = reinterpret_cast<const float4*>(p);
  const float4 v = kShared ? *v4 : __ldg(v4);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <bool kShared = false>
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4* u4 = reinterpret_cast<const uint4*>(p);
  const uint4 v = kShared ? *u4 : __ldg(u4);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// This lane's share of sum((x - q)^2) (L2) or x.q (ip) between one row of
// f32/bf16 storage and one f32 query, both in global memory: nvec 16-byte
// chunks of the row (0 when rows are not 16-byte aligned), then the rest
// element by element.
template <typename T, bool L2>
__device__ __forceinline__ float row_query_partial(const T* __restrict__ row,
                                                   const float* __restrict__ q,
                                                   int d, int nvec, int lane) {
  constexpr int V = Vec<T>::N;
  float acc = 0.f;
  for (int c = lane; c < nvec; c += 32) {
    float x[V];
    load16(row + c * V, x);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float qv = __ldg(q + c * V + k);
      if (L2) {
        const float t = x[k] - qv;
        acc = fmaf(t, t, acc);
      } else {
        acc = fmaf(x[k], qv, acc);
      }
    }
  }
  for (int i = nvec * V + lane; i < d; i += 32) {
    const float xv = to_f32(row[i]);
    const float qv = __ldg(q + i);
    if (L2) {
      const float t = xv - qv;
      acc = fmaf(t, t, acc);
    } else {
      acc = fmaf(xv, qv, acc);
    }
  }
  return acc;
}

// The xor butterfly leaves the same bits in every lane: each step adds a
// pair of values in both orders, and f32 addition is commutative.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// int8 corpus (src/repro_torch/core/corpus.py). The arithmetic below is the
// one the two int8 kernels share, written with explicit round-to-nearest
// intrinsics so that the compiler contracts nothing differently in either:
// expand_int8 and gatherdist_int8 give the same bits for the same
// (query, row). Divisions are true IEEE divisions and rounding is rintf
// (half to even, as torch.round and jnp.round), never roundf.
// ---------------------------------------------------------------------------

struct QueryQuant {
  float scale;   // scale_q = max(max|q|, 1e-12) / 127 (int8-query form)
  float err;     // err_q = ||q - q_hat|| (int8-query form), else 0
  float sqnorm;  // |q_hat|^2 (int8-query form)
  float norm;    // ||q||
};

// One warp reads the f32 query q (d values). In the int8-query form it also
// writes the query's codes to qc, round_up(d, 4) bytes, 4-byte aligned, the
// padding zeroed. Lane l owns the 4-element groups l, l + 32, ...; each sum
// runs in that order and ends in the butterfly, so the result depends on d
// and q alone, not on the kernel that calls it.
template <bool kQuantQuery>
__device__ __forceinline__ QueryQuant quantize_query(const float* __restrict__ q,
                                                     int d, int lane,
                                                     int8_t* __restrict__ qc) {
  const int groups = (d + 3) / 4;
  float amax = 0.f, nrm = 0.f;
  for (int g = lane; g < groups; g += 32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * g + j;
      if (i < d) {
        const float x = q[i];
        amax = fmaxf(amax, fabsf(x));
        nrm = __fmaf_rn(x, x, nrm);
      }
    }
  }
  QueryQuant s;
  s.norm = __fsqrt_rn(warp_sum(nrm));
  s.scale = 0.f;
  s.err = 0.f;
  s.sqnorm = 0.f;
  if (!kQuantQuery) return s;
  const float scale = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
  float err = 0.f, sq = 0.f;
  for (int g = lane; g < groups; g += 32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * g + j;
      float c = 0.f;
      if (i < d) {
        const float x = q[i];
        c = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
        const float h = __fmul_rn(c, scale);
        const float e = __fsub_rn(x, h);
        err = __fmaf_rn(e, e, err);
        sq = __fmaf_rn(h, h, sq);
      }
      qc[i] = static_cast<int8_t>(c);
    }
  }
  s.scale = scale;
  s.err = __fsqrt_rn(warp_sum(err));
  s.sqnorm = warp_sum(sq);
  return s;
}

// An int8 code row is read by a group of 8 lanes, so one warp load
// instruction covers four rows (at d = 128, 8 lanes x 16 B each). ``vec`` is
// the bytes a lane loads at once: 16 when rows are 16-byte aligned (d % 16
// == 0 on an aligned base), 4 when 4-byte aligned, 1 otherwise. Lane ``part``
// of the group takes chunks part, part + 8, ... in that order, so a row's
// partial sums, and the group butterfly below, depend on d, vec and the
// values alone: every kernel that reads rows this way gives the same bits.
constexpr int GROUP = 8;

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int group_sum_int(int v) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This lane's share of the exact int8 dot of a code row with the query's
// codes qc (shared memory, 16-byte aligned): __dp4a over 4-byte words.
__device__ __forceinline__ int group_dot_i8(const int8_t* __restrict__ row,
                                            const int8_t* __restrict__ qc,
                                            int d, int part, int vec) {
  int acc = 0;
  if (vec == 16) {
    const int4* r16 = reinterpret_cast<const int4*>(row);
    const int4* q16 = reinterpret_cast<const int4*>(qc);
    for (int c = part; c < d / 16; c += GROUP) {
      const int4 w = __ldg(r16 + c);
      const int4 x = q16[c];
      acc = __dp4a(w.x, x.x, acc);
      acc = __dp4a(w.y, x.y, acc);
      acc = __dp4a(w.z, x.z, acc);
      acc = __dp4a(w.w, x.w, acc);
    }
  } else if (vec == 4) {
    const int* r4 = reinterpret_cast<const int*>(row);
    const int* q4 = reinterpret_cast<const int*>(qc);
    for (int c = part; c < d / 4; c += GROUP)
      acc = __dp4a(__ldg(r4 + c), q4[c], acc);
  } else {
    for (int i = part; i < d; i += GROUP)
      acc += static_cast<int>(__ldg(row + i)) * static_cast<int>(qc[i]);
  }
  return acc;
}

// One code dequantized and set against one f32 query value.
template <bool L2>
__device__ __forceinline__ float deq_term(int code, float scale, float qv,
                                          float acc) {
  const float x = __fmul_rn(static_cast<float>(code), scale);
  if (L2) {
    const float t = __fsub_rn(x, qv);
    return __fmaf_rn(t, t, acc);
  }
  return __fmaf_rn(x, qv, acc);
}

// One 4-byte code word against 4 query values v.
template <bool L2>
__device__ __forceinline__ float deq_word(int w, float scale, float4 v,
                                          float acc) {
  acc = deq_term<L2>(static_cast<int8_t>(w), scale, v.x, acc);
  acc = deq_term<L2>(static_cast<int8_t>(w >> 8), scale, v.y, acc);
  acc = deq_term<L2>(static_cast<int8_t>(w >> 16), scale, v.z, acc);
  return deq_term<L2>(static_cast<int8_t>(w >> 24), scale, v.w, acc);
}

// The same against 4 query values at q (16-byte aligned).
template <bool L2>
__device__ __forceinline__ float deq_word(int w, float scale, const float* q,
                                          float acc) {
  return deq_word<L2>(w, scale, *reinterpret_cast<const float4*>(q), acc);
}

// This lane's share of sum((codes * scale - q)^2) (L2) or
// sum(codes * scale * q) (ip): the f32-query form, each code dequantized in
// registers against the f32 query q (shared memory, 16-byte aligned).
template <bool L2>
__device__ __forceinline__ float group_partial_deq(const int8_t* __restrict__ row,
                                                   float scale,
                                                   const float* __restrict__ q,
                                                   int d, int part, int vec) {
  float acc = 0.f;
  if (vec == 16) {
    const int4* r16 = reinterpret_cast<const int4*>(row);
    for (int c = part; c < d / 16; c += GROUP) {
      const int4 w = __ldg(r16 + c);
      const float* qv = q + 16 * c;
      acc = deq_word<L2>(w.x, scale, qv, acc);
      acc = deq_word<L2>(w.y, scale, qv + 4, acc);
      acc = deq_word<L2>(w.z, scale, qv + 8, acc);
      acc = deq_word<L2>(w.w, scale, qv + 12, acc);
    }
  } else if (vec == 4) {
    const int* r4 = reinterpret_cast<const int*>(row);
    for (int c = part; c < d / 4; c += GROUP)
      acc = deq_word<L2>(__ldg(r4 + c), scale, q + 4 * c, acc);
  } else {
    for (int i = part; i < d; i += GROUP)
      acc = deq_term<L2>(__ldg(row + i), scale, q[i], acc);
  }
  return acc;
}

// The int8-query form's approximate distance from the exact int32 dot:
// dots = idot * (scale_row * scale_q); l2 takes the norm form
// max(|x_hat|^2 + |q_hat|^2 - 2 dots, 0), ip -dots.
template <bool L2>
__device__ __forceinline__ float int8_dhat(int idot, float scale, float sqnorm,
                                           const QueryQuant& qq) {
  const float dots = __fmul_rn(__int2float_rn(idot), __fmul_rn(scale, qq.scale));
  if (L2)
    return fmaxf(__fsub_rn(__fadd_rn(sqnorm, qq.sqnorm), __fmul_rn(2.f, dots)), 0.f);
  return -dots;
}

// The certified lower bound (core/corpus.py::lower_bound_dists) of one
// candidate with metadata row (err, sqnorm); slack is f32(1 + GUARD_SLACK).
template <bool L2>
__device__ __forceinline__ float lower_bound(float d_hat, float err,
                                             float sqnorm,
                                             const QueryQuant& qq,
                                             float slack) {
  if (L2) {
    const float g = __fmul_rn(__fadd_rn(err, qq.err), slack);
    const float s = fmaxf(__fsub_rn(__fsqrt_rn(fmaxf(d_hat, 0.f)), g), 0.f);
    return __fmul_rn(s, s);
  }
  const float eps = __fmul_rn(
      __fadd_rn(__fmul_rn(err, qq.norm),
                __fmul_rn(__fsqrt_rn(fmaxf(sqnorm, 0.f)), qq.err)),
      slack);
  return __fsub_rn(d_hat, eps);
}

// The last step of a bounds pass: each group's sums reduced, and its first
// lane writing the bound, the id and the dot of its row.
template <bool L2, bool kQuantQuery, int U>
__device__ __forceinline__ void int_bounds_out(
    const int* id, const float* scale, const float* sqn, const float* err,
    const float* accf, const int* acci, int j0, int cnt, const QueryQuant& qq,
    float slack, int g, int part, int* oid, float* od, int* odot) {
  constexpr int ROWS = 32 / GROUP;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + ROWS * u + g;
    const int si = kQuantQuery ? group_sum_int(acci[u]) : 0;
    const float sf = kQuantQuery ? 0.f : group_sum(accf[u]);
    if (part == 0 && j < cnt) {
      float dist = INFINITY;
      if (id[u] != INVALID_ID) {
        const float d_hat = kQuantQuery ? int8_dhat<L2>(si, scale[u], sqn[u], qq)
                                        : (L2 ? sf : -sf);
        dist = lower_bound<L2>(d_hat, err[u], sqn[u], qq, slack);
      }
      if (oid) oid[j] = id[u];
      od[j] = dist;
      if (odot) odot[j] = id[u] == INVALID_ID ? 0 : si;
    }
  }
}

// The certified lower bounds of one query against cnt candidate ids, by
// one warp: a group of 8 lanes a row, four rows per warp load, U such loads
// in flight (U * 4 rows a pass). Each group's first lane writes its row's
// bound (+inf for an INVALID or out-of-range id), the id when oid is
// given, and the int32 dot when odot is given (0 in the f32-query form).
// qs is the f32 query in shared memory, qc its codes (int8-query form).
template <bool L2, bool kQuantQuery, int U>
__device__ __forceinline__ void warp_int8_bounds(
    const int8_t* __restrict__ codes, const float* __restrict__ meta, int n,
    int d, int vec, const int* ids, int cnt, const float* qs,
    const int8_t* qc, const QueryQuant& qq, float slack, int lane, int* oid,
    float* od, int* odot) {
  const int g = lane / GROUP, part = lane % GROUP;
  constexpr int ROWS = 32 / GROUP;
  for (int j0 = 0; j0 < cnt; j0 += ROWS * U) {
    int id[U];
    float scale[U], sqn[U], err[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + ROWS * u + g;
      int a = j < cnt ? ids[j] : INVALID_ID;
      if (a < 0 || a >= n) a = INVALID_ID;
      id[u] = a;
      scale[u] = sqn[u] = err[u] = 0.f;
      if (a != INVALID_ID) {
        const float* m = meta + 3 * (size_t)a;  // 12-byte stride: scalar loads
        scale[u] = __ldg(m);
        sqn[u] = __ldg(m + 1);
        err[u] = __ldg(m + 2);
      }
    }
    float accf[U];
    int acci[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      accf[u] = 0.f;
      acci[u] = 0;
      if (id[u] != INVALID_ID) {
        const int8_t* row = codes + (size_t)id[u] * d;
        if (kQuantQuery)
          acci[u] = group_dot_i8(row, qc, d, part, vec);
        else
          accf[u] = group_partial_deq<L2>(row, scale[u], qs, d, part, vec);
      }
    }
    int_bounds_out<L2, kQuantQuery, U>(id, scale, sqn, err, accf, acci, j0, cnt,
                                       qq, slack, g, part, oid, od, odot);
  }
}

// The same over a shared-memory copy of the candidates' rows: slot j's code
// row at rows + j * d and metadata at meta + 3 * j, ids INVALID where a slot
// holds no candidate, d % 16 == 0 (16 bytes a lane). Each lane's query
// chunk is loaded once for the U rows, and the rows are read whatever
// their id (a slot whose id was dropped holds stale bytes; a slot past cnt
// stands in for the last), so the loads overlap; the sums run in the order
// group_partial_deq / group_dot_i8 take at vec = 16, so the bits are
// warp_int8_bounds'.
template <bool L2, bool kQuantQuery, int U>
__device__ __forceinline__ void shared_int8_bounds(
    const int8_t* rows, const float* meta, int d, const int* ids, int cnt,
    const float* qs, const int8_t* qc, const QueryQuant& qq, float slack,
    int lane, int* oid, float* od, int* odot) {
  const int g = lane / GROUP, part = lane % GROUP;
  constexpr int ROWS = 32 / GROUP;
  for (int j0 = 0; j0 < cnt; j0 += ROWS * U) {
    int id[U], js[U];
    float scale[U], sqn[U], err[U], accf[U];
    int acci[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + ROWS * u + g;
      js[u] = min(j, cnt - 1);
      id[u] = j < cnt ? ids[j] : INVALID_ID;
      scale[u] = meta[3 * js[u]];
      sqn[u] = meta[3 * js[u] + 1];
      err[u] = meta[3 * js[u] + 2];
      accf[u] = 0.f;
      acci[u] = 0;
    }
    const int4* row16 = reinterpret_cast<const int4*>(rows);
    const int d16 = d / 16;  // a row's 16-byte chunks
    for (int c = part; c < d16; c += GROUP) {
      if (kQuantQuery) {
        const int4 x = reinterpret_cast<const int4*>(qc)[c];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int4 w = row16[js[u] * d16 + c];
          acci[u] = __dp4a(w.x, x.x, acci[u]);
          acci[u] = __dp4a(w.y, x.y, acci[u]);
          acci[u] = __dp4a(w.z, x.z, acci[u]);
          acci[u] = __dp4a(w.w, x.w, acci[u]);
        }
      } else {
        const float4* q4 = reinterpret_cast<const float4*>(qs + 16 * c);
        const float4 q0 = q4[0], q1 = q4[1], q2 = q4[2], q3 = q4[3];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int4 w = row16[js[u] * d16 + c];
          accf[u] = deq_word<L2>(w.x, scale[u], q0, accf[u]);
          accf[u] = deq_word<L2>(w.y, scale[u], q1, accf[u]);
          accf[u] = deq_word<L2>(w.z, scale[u], q2, accf[u]);
          accf[u] = deq_word<L2>(w.w, scale[u], q3, accf[u]);
        }
      }
    }
    int_bounds_out<L2, kQuantQuery, U>(id, scale, sqn, err, accf, acci, j0, cnt,
                                       qq, slack, g, part, oid, od, odot);
  }
}

// ---------------------------------------------------------------------------
// Hopper (sm_90a): mbarriers, TMA loads and wgmma, for the kernels that feed
// the tensor cores from shared memory (flashattn_wgmma.cu, rangescan.cu).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of the given parity to complete. A wait of more than
// WAIT_LIMIT_NS traps (a launch error the wrapper raises) instead of
// hanging the card: a copy that never completes is a fault, not a delay.
constexpr uint64_t WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if ((tries & 1023) == 1023) {
      const uint64_t now = globaltimer_ns();
      if (start == 0) start = now;
      else if (now - start > WAIT_LIMIT_NS) __trap();
    }
  }
}

// One box of a 2-D or 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One contiguous span of ``bytes`` (a multiple of 16; both addresses
// 16-byte aligned) from device memory into shared memory, completing on
// bar: the 1-D bulk copy, one instruction from one thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Four bytes from device memory into shared memory, asynchronously
// (cp.async): completed by cp_async_wait, or tracked by an mbarrier
// through cp_async_mbar_arrive.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// bar's current phase completes only after every cp.async this thread has
// started so far (the pending count is raised by one, then lowered when
// they land).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle. A K-major
// tile (rows of 128 bytes, 8-row groups 1024 bytes apart) takes sbo = 1024;
// an MN-major tile also takes lbo, the distance between its 64-column halves.
__device__ __forceinline__ uint64_t sw128_desc(const void* ptr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(ptr) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// cuTensorMapEncodeTiled, a driver-API call, reached through
// cudaGetDriverEntryPoint(ByVersion), so a library links no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace repro_torch
