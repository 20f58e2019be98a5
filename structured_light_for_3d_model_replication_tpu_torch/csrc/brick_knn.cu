// Brick-grid self-KNN over occupied cells. For C cells of 32 slots each,
// bricks (C, 32) int4 rows of (x, y, z as float bits, global id) -- an
// empty slot has +inf coordinates and id -1 --, nbr (C, 27) int32 indices
// of each cell's neighbour cells with the nnb (C,) present ones first, and
// k <= 32: for every query slot of every cell, the k smallest pairs
//   (d2, id),  d2 = (dx*dx + dy*dy) + dz*dz,  d = query - candidate,
// over the nnb * 32 candidate slots, ascending by d2 and then by id (a total
// order, so the result is deterministic and independent of the order in
// which candidates are met), the query's own id skipped when exclude_self
// is set, missing entries (+inf, -1). Output rows are k wide, in brick
// order (row = cell * 32 + slot); the caller gathers them back to point
// order.
//
// Replaces the TPU kernel `brick_knn_pallas`
// (structured_light_for_3d_model_replication_tpu/ops/brickknn_pallas.py:380,
// `_brick_knn_pallas_impl` at :190, pallas_call at :325). Nothing of its
// Mosaic design is carried over: it DMA-ed four bricks per stage into VMEM,
// packed the candidate lane into the low 10 mantissa bits of d2 and ran k
// threshold passes over a (128, 896) tile. Here d2 is exact.
//
// Bound on the H100 (SXM, 700 W): the larger of bytes -- the live points
// (16 B each), the neighbour table (112 B a cell) and a k-wide (d2, id) row
// per live point, at 3.35 TB/s -- and fp32 operations, 8 per pair of a live
// query and a live candidate, at 67 TFLOP/s. Bit-equality forbids FMA, so
// a pair issues 11 fp32 instructions; at 128 lanes an SM that is the
// kernel's issue-rate floor. chip_smoke.py works all three out from each
// run's inputs.
//
// Design (one warp per cell, two cells a block). A surface cloud fills a
// cell's 32 slots about a quarter, so one lane per query slot left most
// lanes idle and walked every empty candidate slot. Here:
// 1. The warp loads its cell's present neighbour bricks three at a time
//    (one coalesced 512-byte row per brick, all three in flight) and
//    compacts their live slots -- those with finite coordinates: any other
//    slot has d2 = inf or NaN against every query -- into a shared-memory
//    candidate list by __ballot_sync and __popc of the lanes below. The
//    list holds kCap candidates; a cell with more is taken in several
//    chunks, and its queries' lists wait in the output rows between chunks.
// 2. The cell's live queries are taken one at a time, each across the whole
//    warp: lane j keeps the query's j-th best pair as one 64-bit key (d2
//    bits above the id; both orders agree for d2 >= 0 and id >= 0), lanes
//    k..31 hold "none". The 32 lanes evaluate 32 compacted candidates at
//    once (the next 32 are read meanwhile); __ballot_sync picks those below
//    the k-th key. Few picks are inserted one by one: each is broadcast,
//    its place is the count of keys at or below it (a ballot), and the
//    lanes above take their neighbour's key by __shfl_up_sync. Many picks
//    (the first batch of every query picks all it holds) are sorted by a
//    warp bitonic network; the k smallest of the list and the sorted picks
//    are then the lower half of one bitonic merge of the two runs.
// 3. Lanes 0..k-1 write the query's row (coalesced); a dead query slot
//    gets (+inf, -1) at once and costs nothing else.
// The neighbour table lists the cell itself first, then its face, edge and
// corner neighbours (brickknn_kernel._neighbor_table), so the k-th key
// tightens early and few later candidates are picked. Every difference,
// product and sum is rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn: no
// FMA contraction), so d2 is bit-equal to the plain PyTorch version
// `brick_knn_cells_plain`; the keys are selected by a total order, so the
// list is the same whatever order the candidates are met in.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 32;
constexpr int kNeighbors = 27;
constexpr int kWarps = 2;      // cells per block
constexpr int kGroup = 3;      // neighbour bricks loaded at a time
constexpr int kCap = 256;      // compacted candidates a warp holds
constexpr int kSortMin = 10;   // picks from which a sort + merge is cheaper
// 256 candidates x 16 B = 4 KB of shared memory a warp; at 64 registers a
// thread (the launch bounds) 32 warps fit an SM and leave most of its 256
// KB to the L1 cache, which serves the neighbour bricks that adjacent
// cells share. A cell with more live candidates (a dense 27-neighbourhood
// holds up to 864) is taken in chunks. Fewer cells a block waste less
// when one cell of a block takes much longer than the others.
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ bool finite3(int4 v) {
  return fabsf(__int_as_float(v.x)) < CUDART_INF_F &&
         fabsf(__int_as_float(v.y)) < CUDART_INF_F &&
         fabsf(__int_as_float(v.z)) < CUDART_INF_F;
}

__device__ __forceinline__ unsigned long long pair_key(float d2, int id) {
  return ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)id;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? b : a;
}

// Ascending bitonic sort of one key a lane across the warp.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long x,
                                                        int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, x, stride);
      const bool ascending = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      x = (low == ascending) ? umin64(x, o) : umax64(x, o);
    }
  }
  return x;
}

__global__ void __launch_bounds__(kWarps * 32, 16)
brick_knn(const int4* __restrict__ bricks, const int* __restrict__ nbr,
          const int* __restrict__ nnb, int64_t cells, int k, int exclude_self,
          float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ int4 cand_all[kWarps][kCap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t cell = (int64_t)blockIdx.x * kWarps + warp;
  if (cell >= cells) return;  // the whole warp; no block-wide barrier is used
  int4* cand = cand_all[warp];
  const unsigned below = (1u << lane) - 1;
  const unsigned kmask = k == 32 ? kFull : (1u << k) - 1;

  const int nn = min(nnb[cell], kNeighbors);
  const int nb_lane = lane < kNeighbors ? nbr[cell * kNeighbors + lane] : 0;
  const int4 qv = bricks[cell * kSlots + lane];
  const unsigned queries = __ballot_sync(kFull, finite3(qv));
  const int64_t row0 = cell * kSlots;

  // A query slot without finite coordinates has no neighbour.
  for (unsigned dead = ~queries; dead; dead &= dead - 1) {
    const int64_t row = (row0 + __ffs(dead) - 1) * k;
    if (lane < k) {
      out_d[row + lane] = CUDART_INF_F;
      out_i[row + lane] = -1;
    }
  }

  int next = 0;  // the first neighbour brick not yet staged
  bool first = true;
  do {
    // Stage: compact live candidate slots, brick by brick, until the list
    // would overflow.
    int count = 0;
    const int from = next;
    next = nn;
    bool full = false;
    for (int g0 = from; g0 < nn && !full; g0 += kGroup) {
      int4 v[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int b = __shfl_sync(kFull, nb_lane, min(g0 + u, kNeighbors - 1));
        if (g0 + u < nn) v[u] = __ldg(&bricks[(int64_t)b * kSlots + lane]);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (!full && g0 + u < nn) {
          const bool live = finite3(v[u]);
          const unsigned m = __ballot_sync(kFull, live);
          const int c = __popc(m);
          if (count + c > kCap) {
            next = g0 + u;
            full = true;
          } else {
            if (live) cand[count + __popc(m & below)] = v[u];
            count += c;
          }
        }
      }
    }
    __syncwarp();

    for (unsigned qs = queries; qs; qs &= qs - 1) {
      const int q = __ffs(qs) - 1;
      const float qx = __shfl_sync(kFull, __int_as_float(qv.x), q);
      const float qy = __shfl_sync(kFull, __int_as_float(qv.y), q);
      const float qz = __shfl_sync(kFull, __int_as_float(qv.z), q);
      const int qid = __shfl_sync(kFull, qv.w, q);
      const int64_t row = (row0 + q) * k;
      unsigned long long e = kNone;  // this lane's entry of the query's list
      if (!first && lane < k) {
        const float d = out_d[row + lane];
        if (d < CUDART_INF_F) e = pair_key(d, out_i[row + lane]);
      }
      bool empty = first;  // the list holds no pair yet
      unsigned long long kth = __shfl_sync(kFull, e, k - 1);
      int4 cv_next = lane < count ? cand[lane] : make_int4(0, 0, 0, 0);
      for (int b0 = 0; b0 < count; b0 += 32) {
        const int4 cv = cv_next;  // the next batch is read while this one runs
        if (b0 + 32 + lane < count) cv_next = cand[b0 + 32 + lane];
        unsigned long long c = kNone;
        const float dx = __fsub_rn(qx, __int_as_float(cv.x));
        const float dy = __fsub_rn(qy, __int_as_float(cv.y));
        const float dz = __fsub_rn(qz, __int_as_float(cv.z));
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (b0 + lane < count && d2 < CUDART_INF_F &&
            !(exclude_self && cv.w == qid))
          c = pair_key(d2, cv.w);
        const bool pick = c < kth;
        const unsigned picks = __ballot_sync(kFull, pick);
        if (picks == 0) continue;
        if (__popc(picks) >= kSortMin) {
          // Sort the picks; the k smallest of two ascending runs are the
          // lower half of their bitonic merge.
          unsigned long long s = warp_sort(pick ? c : kNone, lane);
          if (!empty) {
            s = umin64(e, __shfl_sync(kFull, s, 31 - lane));
#pragma unroll
            for (int stride = 16; stride > 0; stride >>= 1) {
              const unsigned long long o = __shfl_xor_sync(kFull, s, stride);
              s = (lane & stride) ? umax64(s, o) : umin64(s, o);
            }
          }
          e = lane < k ? s : kNone;
        } else {
          // Insert the picks one by one: lane pos takes the pick, the lanes
          // above shift up by one. A pick that an earlier one pushed past
          // the k-th entry finds no lane below k.
          for (unsigned ps = picks; ps; ps &= ps - 1) {
            const unsigned long long ct = __shfl_sync(kFull, c, __ffs(ps) - 1);
            const unsigned long long up = __shfl_up_sync(kFull, e, 1);
            const int pos = k - __popc(__ballot_sync(kFull, ct < e) & kmask);
            if (lane < k && lane >= pos) e = lane == pos ? ct : up;
          }
        }
        empty = false;
        kth = __shfl_sync(kFull, e, k - 1);
      }
      if (lane < k) {
        out_d[row + lane] =
            e == kNone ? CUDART_INF_F : __uint_as_float((unsigned)(e >> 32));
        out_i[row + lane] = e == kNone ? -1 : (int)(unsigned)e;
      }
    }
    __syncwarp();  // the list is consumed before the next chunk is staged
    first = false;
  } while (next < nn);
}

}  // namespace

extern "C" int sl_brick_knn(const void* bricks, const void* nbr,
                            const void* nnb, int64_t cells, int k,
                            int exclude_self, void* out_d, void* out_i,
                            void* stream) {
  if (cells < 0 || k < 1 || k > 32) return (int)cudaErrorInvalidValue;
  if (cells == 0) return (int)cudaSuccess;
  const int64_t blocks = (cells + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  brick_knn<<<(unsigned)blocks, kWarps * 32, 0,
              reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(bricks), static_cast<const int*>(nbr),
      static_cast<const int*>(nnb), cells, k, exclude_self,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
