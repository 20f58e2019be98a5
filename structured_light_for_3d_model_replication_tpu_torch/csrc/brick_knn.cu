// Brick-grid self-KNN over occupied cells. For C cells of 32 slots each,
// bricks (C, 32) int4 rows of (x, y, z as float bits, global id) -- an
// empty slot has +inf coordinates and id -1 --, nbr (C, 27) int32 indices
// of each cell's neighbour cells with the nnb (C,) present ones first, and
// k <= 32: for every query slot of every cell, the k smallest pairs
//   (d2, id),  d2 = (dx*dx + dy*dy) + dz*dz,  d = query - candidate,
// over the nnb * 32 candidate slots, ascending by d2 and then by id (a total
// order, so the result is deterministic), the query's own id skipped when
// exclude_self is set, missing entries (+inf, -1). Output rows are k wide,
// in brick order (row = cell * 32 + slot); the caller gathers them back to
// point order.
//
// Replaces the TPU kernel `brick_knn_pallas`
// (structured_light_for_3d_model_replication_tpu/ops/brickknn_pallas.py:380,
// `_brick_knn_pallas_impl` at :190, pallas_call at :325). Nothing of its
// Mosaic design is carried over: it DMA-ed four bricks per stage into VMEM,
// packed the candidate lane into the low 10 mantissa bits of d2 and ran k
// threshold passes over a (128, 896) tile. Here d2 is exact and the
// selection is a sorted insertion list per thread.
//
// Bound on the H100: the larger of fp32 operations -- 8 per evaluated pair
// (3 sub, 3 mul, 2 add), nnb * 32 pairs per live query slot, at 67 TFLOP/s
// -- and bytes -- the bricks (16 B a slot), the neighbour table (112 B a
// cell) and the outputs (8k B a slot), at 3.35 TB/s. chip_smoke.py works
// both out from each run's inputs. What the bound leaves out is the
// insertion into each thread's top-k list, which is branchy; this first
// version is right, not fast.
//
// Design: one warp per cell, one thread per query slot, four cells per
// block. The warp stages its cell's neighbour bricks in shared memory, nine
// at a time (one coalesced 512-byte row per brick), and every thread reads
// each staged candidate as a broadcast. Each thread keeps its list of CAP =
// k rounded up to a multiple of 4 entries in registers (the insertion is
// unrolled, so the list is never indexed dynamically); the first k entries
// are the answer. Every difference, product and sum is rounded on its own
// (__fsub_rn/__fmul_rn/__fadd_rn: no FMA contraction), so d2 is bit-equal
// to the plain PyTorch version `brick_knn_cells_plain`. A cell with nnb ==
// 0 (past the occupied count) writes (+inf, -1) at once.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 32;
constexpr int kNeighbors = 27;
constexpr int kWarps = 4;   // cells per block
constexpr int kStage = 9;   // neighbour bricks staged at a time

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

template <int CAP>
__global__ void __launch_bounds__(kWarps * 32)
brick_knn(const int4* __restrict__ bricks, const int* __restrict__ nbr,
          const int* __restrict__ nnb, int64_t cells, int k, int exclude_self,
          float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ int4 stage[kWarps][kStage * kSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t cell = (int64_t)blockIdx.x * kWarps + warp;
  if (cell >= cells) return;  // the whole warp; no block-wide barrier is used

  const int nn = nnb[cell];
  const int4 qv = bricks[cell * kSlots + lane];
  const float qx = __int_as_float(qv.x);
  const float qy = __int_as_float(qv.y);
  const float qz = __int_as_float(qv.z);
  const int qid = qv.w;
  const bool live = qid >= 0;

  float bd[CAP];
  int bi[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    bd[i] = CUDART_INF_F;
    bi[i] = -1;
  }

  for (int j0 = 0; j0 < nn; j0 += kStage) {
    const int nj = min(kStage, nn - j0);
    __syncwarp();
    for (int u = 0; u < nj; ++u) {
      const int64_t b = nbr[cell * kNeighbors + j0 + u];
      stage[warp][u * kSlots + lane] = bricks[b * kSlots + lane];
    }
    __syncwarp();
    if (!live) continue;
    for (int c = 0; c < nj * kSlots; ++c) {
      const int4 cv = stage[warp][c];
      const float dx = __fsub_rn(qx, __int_as_float(cv.x));
      const float dy = __fsub_rn(qy, __int_as_float(cv.y));
      const float dz = __fsub_rn(qz, __int_as_float(cv.z));
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (!(d2 < CUDART_INF_F)) continue;  // empty slot: +inf or NaN
      if (exclude_self && cv.w == qid) continue;
      if (!before(d2, cv.w, bd[CAP - 1], bi[CAP - 1])) continue;
      // Insert: slot i takes its upper neighbour while the new pair sorts
      // before it, the new pair where that stops, and keeps its own below.
      bool above = true;
#pragma unroll
      for (int i = CAP - 1; i > 0; --i) {
        const bool shift = before(d2, cv.w, bd[i - 1], bi[i - 1]);
        const float nd = shift ? bd[i - 1] : (above ? d2 : bd[i]);
        const int ni = shift ? bi[i - 1] : (above ? cv.w : bi[i]);
        bd[i] = nd;
        bi[i] = ni;
        above = shift;
      }
      if (above) {
        bd[0] = d2;
        bi[0] = cv.w;
      }
    }
  }

  float* od = out_d + (cell * kSlots + lane) * k;
  int* oi = out_i + (cell * kSlots + lane) * k;
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    if (i < k) {
      od[i] = bd[i];
      oi[i] = bi[i];
    }
  }
}

template <int CAP>
cudaError_t launch(const int4* bricks, const int* nbr, const int* nnb,
                   int64_t cells, int k, int exclude_self, float* out_d,
                   int* out_i, cudaStream_t stream) {
  const int64_t blocks = (cells + kWarps - 1) / kWarps;
  brick_knn<CAP><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      bricks, nbr, nnb, cells, k, exclude_self, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sl_brick_knn(const void* bricks, const void* nbr,
                            const void* nnb, int64_t cells, int k,
                            int exclude_self, void* out_d, void* out_i,
                            void* stream) {
  if (cells < 0 || k < 1 || k > 32) return (int)cudaErrorInvalidValue;
  if (cells == 0) return (int)cudaSuccess;
  const int4* b = static_cast<const int4*>(bricks);
  const int* nb = static_cast<const int*>(nbr);
  const int* nn = static_cast<const int*>(nnb);
  float* d = static_cast<float*>(out_d);
  int* i = static_cast<int*>(out_i);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch ((k + 3) / 4 * 4) {
    case 4: return (int)launch<4>(b, nb, nn, cells, k, exclude_self, d, i, s);
    case 8: return (int)launch<8>(b, nb, nn, cells, k, exclude_self, d, i, s);
    case 12:
      return (int)launch<12>(b, nb, nn, cells, k, exclude_self, d, i, s);
    case 16:
      return (int)launch<16>(b, nb, nn, cells, k, exclude_self, d, i, s);
    case 20:
      return (int)launch<20>(b, nb, nn, cells, k, exclude_self, d, i, s);
    case 24:
      return (int)launch<24>(b, nb, nn, cells, k, exclude_self, d, i, s);
    case 28:
      return (int)launch<28>(b, nb, nn, cells, k, exclude_self, d, i, s);
    default:
      return (int)launch<32>(b, nb, nn, cells, k, exclude_self, d, i, s);
  }
}
