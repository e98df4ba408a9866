// The `bulk` route of the fused frontier expansion, shared by expand.cu
// (f32/bf16 rows) and expand_int8.cu (int8 code rows): persistent
// one-warp blocks that gather rows into shared memory by 1-D bulk copy,
// many of them in flight, and take the distances from there.
//
// A warp walks the units blockIdx.x, blockIdx.x + gridDim.x, ... (its
// "ordinals" 0, 1, ...). A unit is a query, or, when a launch has fewer
// queries than the card has warps, a share of one: with ``split`` units a
// query, unit part k takes the frontier slots e = k (mod split), so the
// slots' copies and distances run on split warps at once (each warp
// deduplicates the whole tile). For each ordinal it
//   1. copies the frontier row (E ints, cp.async) LF ordinals ahead;
//   2. bulk-copies the E adjacency rows (R ints each) into a tile buffer
//      LA ordinals ahead, completing on that buffer's mbarrier;
//   3. deduplicates the E*R tile in one linear pass: 32 entries a round,
//      __match_any_sync finds each id's first lane within the round and an
//      open-addressed shared-memory table (>= 4T slots, linear probing) the
//      ids of earlier rounds, so exactly the first occurrence of each id is
//      kept; a round's new ids go in by plain stores and a read-back
//      (cheaper on Hopper than a loop of shared-memory atomicCAS); n_dist
//      counts the valid entries before dedup;
//   4. for each frontier slot that kept an id, fills one stage of its ring:
//      the slot's kept ids, one bulk copy of each kept row into the row
//      slot of its column (only kept rows cost bytes), a bulk copy of the
//      query and, on an int8 corpus, the rows' 12-byte metadata by
//      cp.async; the stage's mbarrier completes when all of it has landed.
// When a warp's S stages (ops.py::bulk_launch: one, or one a slot of a
// split query where the card holds them) are all in flight, it first takes the
// oldest stage's distances and writes its R outputs, so while it computes
// one query's distances the next queries' rows are on their way, and
// the stages of all the warps of an SM keep ~100 KB in flight without
// registers holding them. A slot that kept nothing, and a query whose
// frontier is all INVALID (a frozen lane), are written out (INVALID /
// +inf, n_dist) at once and take no stage: a frozen lane costs its
// frontier read and its output writes.
//
// Why one warp does it all: a warp starts its bulk copies one after
// another, one row each, so one producer warp feeding consumer warps could
// not start the copies the card needs (a version built that way was slower
// than the warp route); every warp starting its own spreads that work over
// all the warps of an SM.
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace bulk {

constexpr int LA = 2;            // ordinals ahead whose adjacency rows are in flight
constexpr int LF = 4;            // ordinals ahead whose frontier rows are in flight
constexpr int TB = LA + 1;       // adjacency tile buffers
constexpr int FR = LF + 1;       // frontier ring
constexpr int HASH_EMPTY = -1;   // a free slot of the dedup table

__host__ __device__ constexpr int up16(int b) { return (b + 15) & ~15; }

// The shared-memory layout of a warp's block, from the shape alone; ops.py's
// bulk_smem computes the same total. Row bytes are a multiple of 16 and R
// a multiple of 4, so every bulk copy's destination is 16-byte aligned.
struct Geometry {
  int e, r, d, t;            // frontier slots, degree, dim, tile entries E*R
  int hs, hs_bits;           // dedup table slots, a power of two >= 4T
  int row_bytes, meta_bytes;
  int stages;                // the ring's stages
  int off_fr, off_tiles, off_kid, off_ht, off_qc, off_stages;
  int st_ids, st_q, st_meta, st_rows, stage_bytes;
  int total;
};

__host__ __device__ inline Geometry geometry(int e, int r, int d, int row_bytes,
                                             bool int8, int stages) {
  Geometry g;
  g.e = e;
  g.r = r;
  g.d = d;
  g.t = e * r;
  g.hs = 32;
  g.hs_bits = 5;
  while (g.hs < 4 * g.t) {
    g.hs <<= 1;
    ++g.hs_bits;
  }
  g.row_bytes = row_bytes;
  g.meta_bytes = int8 ? up16(12 * r) : 0;
  g.stages = stages;
  g.off_fr = up16(8 * (TB + stages));               // barriers: adj, full
  g.off_tiles = g.off_fr + up16(4 * FR * e);        // (FR, E) frontier rows
  g.off_kid = g.off_tiles + up16(4 * TB * g.t);     // (TB, T) adjacency tiles
  g.off_ht = g.off_kid + up16(4 * g.t);             // (T,) ids kept by the dedup
  g.off_qc = g.off_ht + 4 * g.hs;                   // (hs,) dedup table
  g.off_stages = g.off_qc + (int8 ? up16(d) : 0);   // (d,) int8 query codes
  g.st_ids = 16;                                    // [query, slot] header first
  g.st_q = g.st_ids + up16(4 * r);                  // (R,) ids
  g.st_meta = g.st_q + up16(4 * d);                 // (d,) f32 query
  g.st_rows = g.st_meta + g.meta_bytes;             // (R, 3) metadata (int8)
  g.stage_bytes = g.st_rows + r * row_bytes;        // (R, row) rows
  g.total = g.off_stages + stages * g.stage_bytes;
  return g;
}

struct Outputs {
  int* ids;     // (Q, T)
  float* dists; // (Q, T)
  int* ndist;   // (Q,)
  int* dots;    // (Q, T) or null (int8-query form only)
};

struct Stage {
  int* hdr;              // [query, frontier slot]
  int* ids;
  float* q;
  float* meta;
  unsigned char* rows;
};

// A warp's shared memory.
struct Warp {
  uint64_t* adj;
  uint64_t* full;
  int* fr;
  int* tiles;
  int* kid;
  int* ht;
  int8_t* qc;
  unsigned char* stages;
  const Geometry& g;

  __device__ Warp(unsigned char* base, const Geometry& geo) : g(geo) {
    adj = reinterpret_cast<uint64_t*>(base);
    full = adj + TB;
    fr = reinterpret_cast<int*>(base + g.off_fr);
    tiles = reinterpret_cast<int*>(base + g.off_tiles);
    kid = reinterpret_cast<int*>(base + g.off_kid);
    ht = reinterpret_cast<int*>(base + g.off_ht);
    qc = reinterpret_cast<int8_t*>(base + g.off_qc);
    stages = base + g.off_stages;
  }

  __device__ Stage stage(int slot) const {
    unsigned char* p = stages + (size_t)slot * g.stage_bytes;
    return {reinterpret_cast<int*>(p), reinterpret_cast<int*>(p + g.st_ids),
            reinterpret_cast<float*>(p + g.st_q),
            reinterpret_cast<float*>(p + g.st_meta), p + g.st_rows};
  }

  // The barriers and the empty dedup table.
  __device__ void init(int lane) const {
    if (lane == 0) {
      for (int i = 0; i < TB + g.stages; ++i) mbar_init(adj + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int i = lane; i < g.hs; i += 32) ht[i] = HASH_EMPTY;
    __syncwarp();
  }
};

// Entries [base, base + len) of the outputs as nothing: INVALID, +inf, 0.
__device__ __forceinline__ void write_empty(const Outputs& o, size_t base,
                                            int len, int lane) {
  for (int j = lane; j < len; j += 32) {
    o.ids[base + j] = INVALID_ID;
    o.dists[base + j] = INFINITY;
    if (o.dots) o.dots[base + j] = 0;
  }
}

// The whole route for one warp. ``rows`` is the corpus (row_bytes a row);
// ``meta`` its (N, 3) metadata when kMeta (int8), else unused.
// body(stage, query, frontier slot) takes a landed stage's distances and
// writes its R outputs.
template <bool kMeta, typename Body>
__device__ __forceinline__ void expand_warp(
    const Warp& w, const unsigned char* __restrict__ rows,
    const float* __restrict__ meta, const int* __restrict__ nbrs,
    const int* __restrict__ frontier, const float* __restrict__ queries,
    const Outputs& o, int qn, int n, int split, int lane, Body&& body) {
  const Geometry& g = w.g;
  const int E = g.e, R = g.r, T = g.t, S = g.stages;
  constexpr unsigned ALL = 0xffffffffu;
  // unit u is query u / split, frontier slots e = u % split (mod split)
  const long long units = (long long)qn * split;
  const long long u0 = blockIdx.x, us = gridDim.x;
  int filled = 0, taken = 0;  // stages filled and taken so far

  // the oldest stage in flight: wait for it, take its distances
  auto take = [&]() {
    const int slot = taken % S;
    mbar_wait(w.full + slot, (taken / S) & 1);
    const Stage st = w.stage(slot);
    body(st, st.hdr[0], st.hdr[1]);
    ++taken;
    __syncwarp();
  };

  // pass i copies ordinal i's frontier, ordinal i - LF + LA's adjacency
  // rows, and processes ordinal i - LF; every pass commits one cp.async group
  for (int i = 0;; ++i) {
    const int p = i - LF;
    const long long up = u0 + p * us;
    if (p >= 0 && up >= units) break;
    const long long uf = u0 + i * us;
    if (uf < units && lane < E)
      cp_async4(w.fr + (i % FR) * E + lane, frontier + uf / split * E + lane);
    cp_async_commit();

    const int a = p + LA;
    if (a >= 0 && u0 + a * us < units) {
      cp_async_wait<LF - LA>();  // ordinal a's frontier row has landed
      __syncwarp();
      const int f = lane < E ? w.fr[(a % FR) * E + lane] : INVALID_ID;
      const bool ok = lane < E && f >= 0 && f < n;
      const unsigned f_ok = __ballot_sync(ALL, ok);
      int* tile = w.tiles + (a % TB) * T;
      uint64_t* bar = w.adj + a % TB;
      if (lane == 0) mbar_expect_tx(bar, __popc(f_ok) * R * 4);
      __syncwarp();
      if (ok) bulk_load(tile + lane * R, nbrs + (size_t)f * R, R * 4, bar);
      // an INVALID frontier slot's rows read as INVALID entries, unless the
      // whole frontier is (a frozen lane's tile is never read)
      for (unsigned bad = f_ok ? ~f_ok & ((1ull << E) - 1) : 0u; bad; bad &= bad - 1)
        for (int j = lane; j < R; j += 32) tile[(__ffs(bad) - 1) * R + j] = INVALID_ID;
    }
    if (p < 0) continue;

    // -- ordinal p: query qi, slots e = part (mod split) --------------------
    const int qi = static_cast<int>(up / split);
    const int part = static_cast<int>(up % split);
    const size_t base = (size_t)qi * T;
    mbar_wait(w.adj + p % TB, (p / TB) & 1);
    const int f = lane < E ? w.fr[(p % FR) * E + lane] : INVALID_ID;
    const unsigned f_ok = __ballot_sync(ALL, lane < E && f >= 0 && f < n);
    if (f_ok == 0) {  // a frozen lane: its outputs, nothing else
      for (int e = part; e < E; e += split) write_empty(o, base + e * R, R, lane);
      if (lane == 0 && part == 0) o.ndist[qi] = 0;
      continue;
    }
    // linear first-occurrence dedup of the tile, 32 entries a round, up to
    // the end of the last slot this unit takes (a slot's first occurrences
    // depend on the entries before it alone); n_dist counts every entry
    const int* tile = w.tiles + (p % TB) * T;
    const unsigned mask = g.hs - 1;
    const int t_end = (E - (E - 1 - part) % split) * R;
    int nd = 0;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const int id = t < T ? tile[t] : INVALID_ID;
      const bool valid = id >= 0 && id < n;
      nd += __popc(__ballot_sync(ALL, valid));
      if (t0 >= t_end) continue;
      // the round's first lane of each id looks it up among the ids of
      // earlier rounds (the table: linear probing, no deletions)
      const unsigned peers = __match_any_sync(ALL, valid ? id : -1);
      bool keep = valid && __ffs(peers) - 1 == lane;
      unsigned h = (static_cast<unsigned>(id) * 0x9E3779B1u) >> (32 - g.hs_bits);
      if (keep) {
        for (int v; (v = w.ht[h]) != HASH_EMPTY; h = (h + 1) & mask)
          if (v == id) {
            keep = false;
            break;
          }
      }
      // the round's new ids go in by plain stores and a read-back; a lane
      // whose empty slot another new id took moves on to the next empty one
      if (keep) w.ht[h] = id;
      __syncwarp();
      bool lost = keep && w.ht[h] != id;
      while (__any_sync(ALL, lost)) {
        if (lost) {
          do h = (h + 1) & mask; while (w.ht[h] != HASH_EMPTY);
          w.ht[h] = id;
        }
        __syncwarp();
        if (lost) lost = w.ht[h] != id;
        __syncwarp();
      }
      if (t < t_end) w.kid[t] = keep ? id : INVALID_ID;
    }
    __syncwarp();
    for (int h = 4 * lane; h < g.hs; h += 128)
      *reinterpret_cast<int4*>(w.ht + h) = make_int4(HASH_EMPTY, HASH_EMPTY,
                                                     HASH_EMPTY, HASH_EMPTY);
    if (lane == 0 && part == 0) o.ndist[qi] = nd;
    __syncwarp();

    // one stage per frontier slot of this unit that kept an id
    for (int e = part; e < E; e += split) {
      const int* kid = w.kid + e * R;
      int cnt = 0;
      for (int j0 = 0; j0 < R; j0 += 32)
        cnt += __popc(__ballot_sync(ALL, j0 + lane < R && kid[j0 + lane] != INVALID_ID));
      if (cnt == 0) {
        write_empty(o, base + e * R, R, lane);
        continue;
      }
      if (filled - taken == S) take();  // the ring is full: free its oldest
      const int slot = filled % S;
      const Stage st = w.stage(slot);
      uint64_t* bar = w.full + slot;
      for (int j = lane; j < R; j += 32) {
        const int id = kid[j];
        st.ids[j] = id;
        if (kMeta && id != INVALID_ID) {
          const float* m = meta + 3 * (size_t)id;
          cp_async4(st.meta + 3 * j, m);
          cp_async4(st.meta + 3 * j + 1, m + 1);
          cp_async4(st.meta + 3 * j + 2, m + 2);
        }
      }
      if (lane == 0) {
        st.hdr[0] = qi;
        st.hdr[1] = e;
      }
      if (kMeta) cp_async_mbar_arrive(bar);
      __syncwarp();
      if (lane == 0) mbar_expect_tx(bar, cnt * g.row_bytes + 4 * g.d);
      __syncwarp();
      for (int j = lane; j < R; j += 32) {
        const int id = kid[j];
        if (id != INVALID_ID)
          bulk_load(st.rows + (size_t)j * g.row_bytes,
                    rows + (size_t)id * g.row_bytes, g.row_bytes, bar);
      }
      if (lane == 0) bulk_load(st.q, queries + (size_t)qi * g.d, 4 * g.d, bar);
      ++filled;
    }
  }
  while (taken < filled) take();
  cp_async_wait<0>();
}

// Sets a kernel's dynamic shared-memory limit when a launch needs more
// than it was set to, and, the first time, asks for the largest shared
// memory carve-out of the SM (else the runtime may pick a smaller one and
// fewer blocks stay resident than ops.py plans); returns the CUDA error.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int* set) {
  if (bytes <= *set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e == cudaSuccess) *set = bytes;
  return e;
}

}  // namespace bulk
}  // namespace repro_torch
