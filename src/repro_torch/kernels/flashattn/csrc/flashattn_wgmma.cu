// Flash-attention forward for Hopper, bf16 prefill on the tensor cores:
// the wgmma route of src/repro_torch/kernels/flashattn/ops.py (bf16 q, k, v
// with dh 64 or 128 and more than 16 rows a kv head). It computes what
// flashattn.cu's kernels and ref.py::flash_attention_ref compute (see
// flashattn.cu for the function, the masks and the GQA rows), and replaces,
// with them, the Pallas TPU kernel src/repro/kernels/flashattn/kernel.py:33
// (_flash_kernel, via flash_attention_pallas).
//
// What bounds it: the operations, 4 dh flops a visible (row, key) pair
// (5.5e11 for a global gemma3-27b layer at B=4, S=4096: 0.56 ms at the
// 989 TFLOP/s bf16 dense tensor-core rate). The design keeps the tensor
// cores fed and everything else off their path:
//  * A block owns 128 rows, (position, head) pairs of one kv head (row r is
//    position r / G of head kvh * G + r % G), so each K/V tile feeds all G
//    heads. Two warpgroups of 128 threads take 64 rows each. 256 threads at
//    one block an SM leave a thread up to 255 registers; each holds Q (dh/4
//    bf16 pairs), S (64 f32), P (32 bf16 pairs) and O (dh / 2 f32) at once
//    without spilling. (A third, producer warp or warpgroup would cap every
//    thread at 168 registers: ptxas sizes a block's registers by its
//    largest share of the four schedulers, and it does not grant what
//    setmaxnreg raises.)
//  * K and V arrive by TMA (cp.async.bulk.tensor, 4-D tensor maps encoded
//    on the host for each call from the tensors' own strides, so the
//    cache slice cache.k[:, :t] seen as (B, Hkv, t, dh) is read in place)
//    into a ring of 128-key tiles (3 stages at dh 128, 7 at dh 64) against
//    mbarriers: a full barrier a stage that the copy completes, an empty
//    one that every consumer warp arrives on when done. The producer is one
//    thread of warpgroup 1: it fills the ring, then refills a stage once
//    both warpgroups have released it (warpgroup 1 releases second, so it
//    seldom waits). The 128-byte swizzle caps a box row at 128 bytes, so a
//    128-wide row arrives as two 64-column boxes. Keys past Skv arrive as
//    zeros (TMA's out-of-bounds fill) and are masked.
//  * Q is read once a block into registers, in wgmma's register-A fragment
//    layout; S = Q.K^T runs as wgmma m64n128k16 with A from registers and
//    K from shared memory (no shared-memory traffic for Q), f32
//    accumulators in registers. The scale, the soft cap and log2(e) are
//    applied to the f32 scores (never folded into a bf16 q); the online
//    softmax keeps each row's (m, l) in registers (a row lives on 4 lanes)
//    and takes one FFMA and one ex2 an element on a tile without mask or
//    cap. P is rounded to bf16 in registers, in the accumulator layout,
//    which is the register-A fragment layout, so O += P.V runs as wgmma
//    m64n{dh}k16 with A from registers and V (MN-major, transposed by the
//    descriptor) from shared memory: P never touches shared memory.
//  * Overlap: within a warpgroup, S_{j+1} = Q.K_{j+1}^T and O += P_j.V_j
//    are issued together and the softmax of S_{j+1} runs while P_j.V_j
//    does; across the two warpgroups, named barriers make them issue in
//    turn (ping-pong), so one's softmax runs while the other's products
//    hold the tensor cores. O is rescaled only when a row's max moved.
//  * Masks only where needed: tiles no row of the block sees are never
//    loaded (causal frontier, window start); a warpgroup evaluates the
//    mask only on a tile that crosses its causal diagonal, its window's
//    edge or Skv. Blocks start with the latest rows, so the longest causal
//    sweeps are scheduled first.
// The mbarrier, TMA and wgmma helpers and the tensor-map encoder are
// common.cuh's.
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int BM = 64;                   // rows of a consumer warpgroup
constexpr int NWG = 2;                   // consumer warpgroups
constexpr int BN = 128;                  // keys of a K/V tile
constexpr int THREADS = 128 * NWG;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ERR_ENTRY = 100000;        // no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 100001;       // base of its CUresult codes

template <int DH>
struct Cfg {
  static constexpr int HALVES = DH / 64;            // 64-column boxes a row
  static constexpr int KV_BYTES = BN * DH * 2;      // one K or V tile
  static constexpr int STAGES = 229376 / (2 * KV_BYTES) < 8 ? 229376 / (2 * KV_BYTES) : 8;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment
};

struct Params {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  long long qs[3], os[3];       // element strides of dims b, h, s
  int sq, skv, group, rows, causal, window, q_offset;
  int k_hs, v_hs;               // 1: the tensor map's dims 1, 2 are (h, s)
  float softcap, scale;
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// The keys [lo, hi) that some row of [r0, r1) may see.
__device__ __forceinline__ void key_range(const Params& p, int r0, int r1,
                                          int& lo, int& hi) {
  const int pmin = p.q_offset + r0 / p.group;
  const int pmax = p.q_offset + (r1 - 1) / p.group;
  lo = 0;
  hi = p.skv;
  if (p.causal) hi = min(hi, pmax + 1);
  if (p.window > 0) lo = max(lo, pmin - p.window + 1);
}

// Named barriers 3 and 4 order the two warpgroups' products
// (ping-pong): a warpgroup waits on its own barrier before it issues, and
// arrives on the other's after, so one warpgroup's softmax runs while the
// other's products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_rs_kmajor_n128(float* d, const uint32_t* a, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (DH == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// S = Q . K^T (64 rows x 128 keys) into sc, Q from registers: issued and
// committed, not waited for.
template <int DH>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2], const uint32_t (&qa)[DH / 16][4],
                                        const uint8_t* kt) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_rs_kmajor_n128(sc, qa[kk], sw128_desc(kt + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024),
                         kk > 0);
  wgmma_commit();
}

// O += P . V: issued and committed, not waited for.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2], const uint32_t (&pa)[BN / 16][4],
                                         const uint8_t* vt) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_pv<DH>(o, pa[kk], sw128_desc(vt + kk * 16 * 128, BN * 128, 1024));
  wgmma_commit();
}

// 2^x by the MUFU unit (ex2.approx, flushing subnormal results to 0: an
// unnormalized probability below 2^-126 is 0 here).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether the tile of keys [n0, n0 + BN) needs the mask for some row of a
// warpgroup whose positions span [pmin, pmax]: where it crosses the causal
// diagonal, the window's edge or Skv.
__device__ __forceinline__ bool tile_masked(const Params& p, int n0, int pmin, int pmax) {
  return n0 + BN > p.skv || (p.causal && n0 + BN - 1 > pmin) ||
         (p.window > 0 && pmax - n0 >= p.window);
}

// A consumer warp is done with a stage.
__device__ __forceinline__ void release(uint64_t* empty, int stage, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[stage]);
}

// Tile j of the sweep (keys t0 * BN + j * BN ...) into its stage, K and V
// by TMA, completing on the stage's full barrier.
template <int DH>
__device__ __forceinline__ void load_tile(uint8_t* sm, uint64_t* full, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const Params& p, int t0,
                                          int j, int kvh, int b) {
  using C = Cfg<DH>;
  const int s = j % C::STAGES, n0 = (t0 + j) * BN;
  mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
  uint8_t* kd = sm + C::K_OFF + s * C::KV_BYTES;
  uint8_t* vd = sm + C::V_OFF + s * C::KV_BYTES;
#pragma unroll
  for (int h = 0; h < C::HALVES; ++h) {
    if (p.k_hs) tma_load(kd + h * BN * 128, tk, &full[s], h * 64, kvh, n0, b);
    else tma_load(kd + h * BN * 128, tk, &full[s], h * 64, n0, kvh, b);
    if (p.v_hs) tma_load(vd + h * BN * 128, tv, &full[s], h * 64, kvh, n0, b);
    else tma_load(vd + h * BN * 128, tv, &full[s], h * 64, n0, kvh, b);
  }
}

// The scores of a tile in sc -> unnormalized probabilities: the running max
// m (log2 units: the scale times log2(e) is applied to the scores) and
// denominator l of each of the thread's two rows, and alpha, the factor that
// rescales the earlier tiles. A tile with no mask and no soft cap takes the
// short path: max of the raw scores, then p = 2^(s * scale * log2(e) - m),
// one FFMA and one MUFU an element.
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& p,
                                             const int (&qpos)[2], int n0, bool masked,
                                             int lane) {
  const float sl = p.scale * LOG2E;
  float mx[2] = {NEG, NEG}, sum[2] = {0.f, 0.f};
  const bool plain = !masked && p.softcap <= 0.f;
  if (plain) {
#pragma unroll
    for (int idx = 0; idx < BN / 2; ++idx) mx[(idx / 2) % 2] = fmaxf(mx[(idx / 2) % 2], sc[idx]);
  } else {
    if (p.softcap > 0.f) {
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx)
        sc[idx] = p.softcap * tanhf(sc[idx] * p.scale / p.softcap) * LOG2E;
    } else {
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx) sc[idx] *= sl;
    }
    if (masked) {   // element idx: row (idx / 2) % 2, key 8 (idx / 4) + 2 (lane % 4) + idx % 2
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx)
        if (!visible(p, qpos[(idx / 2) % 2], n0 + (idx / 4) * 8 + (lane % 4) * 2 + idx % 2))
          sc[idx] = NEG;
    }
#pragma unroll
    for (int idx = 0; idx < BN / 2; ++idx) mx[(idx / 2) % 2] = fmaxf(mx[(idx / 2) % 2], sc[idx]);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {   // a row lives on 4 lanes
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
    const float mn = fmaxf(m[x], plain ? mx[x] * sl : mx[x]);
    alpha[x] = ex2(m[x] - mn);
    m[x] = mn;
  }
  if (plain) {
#pragma unroll
    for (int idx = 0; idx < BN / 2; ++idx) {
      sc[idx] = ex2(fmaf(sc[idx], sl, -m[(idx / 2) % 2]));
      sum[(idx / 2) % 2] += sc[idx];
    }
  } else {
#pragma unroll
    for (int idx = 0; idx < BN / 2; ++idx) {
      sc[idx] = sc[idx] <= NEG ? 0.f : ex2(sc[idx] - m[(idx / 2) % 2]);
      sum[(idx / 2) % 2] += sc[idx];
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) l[x] = l[x] * alpha[x] + sum[x];
}

// O *= alpha, and P to bf16: the accumulator layout of S is the
// register-A fragment layout of P . V.
template <int DH>
__device__ __forceinline__ void rescale_and_pack(float (&o)[DH / 2], uint32_t (&pa)[BN / 16][4],
                                                 const float (&sc)[BN / 2],
                                                 const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))   // a max moved
#pragma unroll
    for (int idx = 0; idx < DH / 2; ++idx) o[idx] *= alpha[(idx / 2) % 2];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) pa[kk][u] = pack_bf16(sc[8 * kk + 2 * u], sc[8 * kk + 2 * u + 1]);
}

// ---------------------------------------------------------------------------
// 128 rows a block (two consumer warpgroups), 128-key tiles.
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * (NWG * BM);   // latest rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  key_range(p, r0, min(r0 + NWG * BM, p.rows), lo, hi);
  const int t0 = lo / BN;
  const int nt = hi > lo ? (hi - 1) / BN - t0 + 1 : 0;   // key tiles to sweep

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);     // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = tid / 32, lane = tid % 32;
  const int rw0 = r0 + wg * BM;             // this warpgroup's first row
  const int rl0 = w * 16 + lane / 4;        // the thread's rows: rl0, rl0 + 8
  // Q as register-A fragments, once: qa[kk][u] holds row rl0 + 8 (u % 2),
  // columns 16 kk + 8 (u / 2) + 2 (lane % 4) + {0, 1}
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = rw0 + rl0 + 8 * x;
    const __nv_bfloat16* qrow = nullptr;
    if (r < p.rows)
      qrow = p.q + b * p.qs[0] + (kvh * p.group + r % p.group) * p.qs[1] +
             (long long)(r / p.group) * p.qs[2] + (lane % 4) * 2;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        qa[kk][2 * hf + x] = qrow ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + hf * 8) : 0u;
  }

  // the accumulators: rows rl0 and rl0 + 8 of the warpgroup, columns
  // 8 j + 2 (lane % 4) + {0, 1} of each 8-column group j
  int qpos[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) qpos[x] = p.q_offset + (rw0 + rl0 + 8 * x) / p.group;
  const int wr1 = max(min(rw0 + BM, p.rows), rw0 + 1);
  const int pmin = p.q_offset + rw0 / p.group;
  const int pmax = p.q_offset + (wr1 - 1) / p.group;
  float o[DH / 2], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[BN / 16][4];   // P of the last tile, bf16 register-A fragments

  // Tile i's scores are computed while tile i - 1's P . V runs: S_i = Q K_i^T
  // and O += P_{i-1} V_{i-1} are issued together; the softmax of S_i runs
  // once S_i is done, beside the running P . V; then stage i - 1 is
  // released, O rescaled and P_i rounded to bf16.
  // The producer is one thread of warpgroup 1, which releases each stage
  // after warpgroup 0 (it issues second): it fills the ring, then refills
  // a stage as soon as both warpgroups have released it.
  const bool producer = wg == 1 && tid == 0;
  if (producer)
    for (int j = 0; j < min(C::STAGES, nt); ++j)
      load_tile<DH>(sm, full, &tk, &tv, p, t0, j, kvh, b);
  if (nt > 0) {
    if (wg == 1) turn_pass(1);   // warpgroup 0 issues first
    mbar_wait(&full[0], 0);
    fence_regs<BN / 2>(sc);
    wgmma_fence();
    turn_wait(wg);
    issue_s<DH>(sc, qa, sm + C::K_OFF);
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs<BN / 2>(sc);
    softmax_tile(sc, m, l, alpha, p, qpos, t0 * BN, tile_masked(p, t0 * BN, pmin, pmax), lane);
    rescale_and_pack<DH>(o, pa, sc, alpha);
  }
  for (int i = 1; i < nt; ++i) {
    const int n0 = (t0 + i) * BN;
    mbar_wait(&full[i % C::STAGES], (i / C::STAGES) & 1);
    fence_regs<BN / 2>(sc);
    fence_regs<DH / 2>(o);
    wgmma_fence();
    turn_wait(wg);
    issue_s<DH>(sc, qa, sm + C::K_OFF + (i % C::STAGES) * C::KV_BYTES);
    issue_pv<DH>(o, pa, sm + C::V_OFF + ((i - 1) % C::STAGES) * C::KV_BYTES);
    turn_pass(wg);
    wgmma_wait<1>();
    fence_regs<BN / 2>(sc);
    softmax_tile(sc, m, l, alpha, p, qpos, n0, tile_masked(p, n0, pmin, pmax), lane);
    wgmma_wait<0>();
    fence_regs<DH / 2>(o);
    release(empty, (i - 1) % C::STAGES, lane);
    if (producer && i - 1 + C::STAGES < nt) {
      mbar_wait(&empty[(i - 1) % C::STAGES], ((i - 1) / C::STAGES) & 1);
      load_tile<DH>(sm, full, &tk, &tv, p, t0, i - 1 + C::STAGES, kvh, b);
    }
    rescale_and_pack<DH>(o, pa, sc, alpha);
  }
  if (nt > 0) {
    fence_regs<DH / 2>(o);
    wgmma_fence();
    turn_wait(wg);
    issue_pv<DH>(o, pa, sm + C::V_OFF + ((nt - 1) % C::STAGES) * C::KV_BYTES);
    if (wg == 0) turn_pass(0);   // warpgroup 1 issues last
    wgmma_wait<0>();
    fence_regs<DH / 2>(o);
    release(empty, (nt - 1) % C::STAGES, lane);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = rw0 + rl0 + 8 * x;
    if (r >= p.rows) continue;
    const int h = kvh * p.group + r % p.group;
    __nv_bfloat16* orow = p.o + b * p.os[0] + h * p.os[1] + (long long)(r / p.group) * p.os[2];
    const float den = fmaxf(l[x], 1e-30f);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + (lane % 4) * 2) =
          __floats2bfloat162_rn(o[j * 4 + x * 2] / den, o[j * 4 + x * 2 + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch.
// ---------------------------------------------------------------------------
// A (B, H, S, dh) bf16 view as a 4-D tensor map of 64 x 128 boxes: dims
// (dh, s, h, b), or (dh, h, s, b) when h has the smaller stride (the cache
// layout), so the strides grow with the dims. Returns 0 or an error code;
// *hs says which order was taken.
int make_map(CUtensorMap* map, const void* base, int dh, int s, int h, int b,
             const long long* st, int* hs) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_ENTRY;
  *hs = st[1] < st[2];
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)(*hs ? h : s),
                              (cuuint64_t)(*hs ? s : h), (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)(*hs ? st[1] : st[2]) * 2,
                                 (cuuint64_t)(*hs ? st[2] : st[1]) * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)(*hs ? 1 : BN),
                             (cuuint32_t)(*hs ? BN : 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(base), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(rc);
}

template <int DH>
cudaError_t launch(const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
                   int batch, int hkv, cudaStream_t st) {
  static bool smem_set = false;   // once per kernel, before any graph capture
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DH>::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((p.rows + NWG * BM - 1) / (NWG * BM), hkv, batch);
  flash_wgmma_kernel<DH><<<grid, THREADS, Cfg<DH>::SMEM, st>>>(tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 1 (bf16 q, k, v and o); dh 64 or 128. Strides are in elements, for
// dims (b, h, s); the last dim is contiguous and every row and stride is a
// multiple of 16 bytes (the wrapper checks both). Returns 0, a CUDA error
// code, or one of this file's codes (flashattn_wgmma_error_string).
int flashattn_wgmma_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int batch, int hq, int hkv, int sq, int skv, int dh,
                           const long long* q_strides, const long long* k_strides,
                           const long long* v_strides, const long long* o_strides,
                           int causal, int window, int q_offset, float softcap,
                           float scale, void* stream) {
  if (dtype != 1 || (dh != 64 && dh != 128)) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.o = static_cast<__nv_bfloat16*>(o);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = q_strides[i];
    p.os[i] = o_strides[i];
  }
  p.sq = sq;
  p.skv = skv;
  p.group = hq / hkv;
  p.rows = p.group * sq;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.softcap = softcap;
  p.scale = scale;
  CUtensorMap tk, tv;
  int rc = make_map(&tk, k, dh, skv, hkv, batch, k_strides, &p.k_hs);
  if (rc == 0) rc = make_map(&tv, v, dh, skv, hkv, batch, v_strides, &p.v_hs);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dh == 128 ? launch<128>(tk, tv, p, batch, hkv, st)
                                  : launch<64>(tk, tv, p, batch, hkv, st);
  return static_cast<int>(e);
}

const char* flashattn_wgmma_error_string(int code) {
  static char buf[96];
  if (code == ERR_ENTRY) return "cuTensorMapEncodeTiled is not available from the driver";
  if (code >= ERR_ENCODE) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
