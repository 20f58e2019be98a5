// k = 1 nearest-neighbour sweep over a batch of E independent problems (the
// ring's edges): for each of M queries (E, M, 3) the nearest valid key of its
// own edge's transposed (E, 3, N) key table -> d2 (E, M) float32 and
// idx (E, M) int64. A single sweep is the batch of one.
//
// Replaces the TPU kernel `nearest_one`
// (structured_light_for_3d_model_replication_tpu/ops/nn_pallas.py:99,
// pallas_call at :122), the correspondence sweep of every ICP iteration,
// `count_corr` and `information_matrix`; under the fused ring's `vmap` that
// kernel runs over the edge axis, which here is folded into the tile index of
// one launch. The TPU kernel packs the key index
// into the low 13 mantissa bits of d2 (a workaround for its min-only
// reduction, which also caps N at 8192). This kernel keeps d2 exact and the
// index separate, so N is unbounded and d2 differs from the TPU's by at most
// that kernel's own 2^-10 relative quantization.
//
// Distances are direct-difference fp32, dx*dx + dy*dy + dz*dz, rounded op by
// op (`__fmul_rn`/`__fadd_rn`: no FMA contraction) so they are bit-equal to
// the plain PyTorch version. An invalid key (p2v not finite) is staged with
// +inf coordinates, so its d2 is +inf and it never wins. Ties go to the
// lowest key index; with no valid key d2 = +inf and idx = 0.
//
// Bound on the H100: fp32 issue. The row's bound counts 8 operations per
// (query, key) pair at the 67 TFLOP/s non-tensor peak (~8 us at
// M = N = 8192), but bit-equality forbids FMA, so a pair issues 11
// instructions (3 sub, 3 mul, 2 add, a compare, two selects): at 128 lanes
// per SM and 132 SMs that is ~22 us at M = N = 8192, ~5.5 us at
// 2048 x 8192. Bytes are negligible (the key table is 128 KB at N = 8192).
//
// Design (one launch per call):
// * the grid is E x tiles x splits blocks: a block's tile index t names its
//   edge (t / tiles) and its query tile within the edge (t % tiles), and it
//   reads only that edge's queries and keys, so each edge's result is the
//   single sweep's, bit for bit, and 23 edges of 2048 queries fill the SMs
//   that one edge's 2048 leave idle;
// * a block of 256 threads (8 warps) owns a tile of 32 * kQ queries, kQ per
//   lane in registers (4, or 2 where 4 leaves too few blocks to fill the
//   card: the path's 2048-query warm-up), so every key read from shared
//   memory (one float4 broadcast) serves kQ independent compare/select
//   chains;
// * the block stages its share of the keys in 1024-key chunks into shared
//   memory, and each warp sweeps one eighth of every chunk for the tile;
// * the eight warps' (d2, idx) are combined in shared memory as one 64-bit
//   word each, d2's bits above the index: for non-negative floats the
//   unsigned order of the bits is the float order, so the smallest word is
//   the smallest d2 with the lowest index on ties;
// * where M is small (the path's 2048-query ICP warm-up is 32 tiles for 132
//   SMs) the key range is split across a thread-block cluster of up to 8
//   blocks on neighbouring SMs; block 0 of the cluster reads the others'
//   words through distributed shared memory and writes the result. No
//   scratch in device memory, no atomics, no second launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 1024;          // keys per shared-memory round

__device__ __forceinline__ unsigned long long pack(float d, uint32_t k) {
  return ((unsigned long long)__float_as_uint(d) << 32) | k;
}

template <int kQ>  // queries per lane
__global__ void __launch_bounds__(kThreads)
nn1(const float* __restrict__ queries, const float* __restrict__ keys_t,
    const float* __restrict__ p2v, float* __restrict__ d2,
    int64_t* __restrict__ idx, int64_t M, int64_t N, int64_t tiles,
    int64_t per_block) {
  constexpr int kTile = 32 * kQ;  // queries per block
  __shared__ float4 sk[kChunk];
  __shared__ unsigned long long sred[kWarps][kTile];
  __shared__ unsigned long long sbest[kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // 32-bit division: the grid holds fewer than 2^31 blocks.
  const unsigned t = blockIdx.x / csize;
  const unsigned e = t / (unsigned)tiles;  // this block's edge
  const int64_t q0 = (int64_t)(t - e * (unsigned)tiles) * kTile;
  queries += (int64_t)e * M * 3;
  keys_t += (int64_t)e * 3 * N;
  p2v += (int64_t)e * N;
  d2 += (int64_t)e * M;
  idx += (int64_t)e * M;

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  uint32_t bi[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int64_t i = q0 + lane + 32 * q;
    qx[q] = i < M ? queries[3 * i] : 0.f;
    qy[q] = i < M ? queries[3 * i + 1] : 0.f;
    qz[q] = i < M ? queries[3 * i + 2] : 0.f;
    best[q] = CUDART_INF_F;
    bi[q] = 0;
  }

  const int64_t k0 = (int64_t)rank * per_block;
  const int64_t k1 = k0 + per_block < N ? k0 + per_block : N;
  for (int64_t c0 = k0; c0 < k1; c0 += kChunk) {
    const int n = k1 - c0 < kChunk ? (int)(k1 - c0) : kChunk;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int64_t k = c0 + j;
      sk[j] = isfinite(p2v[k])
                  ? make_float4(keys_t[k], keys_t[N + k], keys_t[2 * N + k],
                                0.f)
                  : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                0.f);
    }
    __syncthreads();
    const int per_warp = (n + kWarps - 1) / kWarps;
    const int j0 = warp * per_warp;
    const int cnt = j0 + per_warp < n ? per_warp : n - j0;
    const float4* kp = sk + j0;
    uint32_t k = (uint32_t)(c0 + j0);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j, ++k) {
      const float4 v = kp[j];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float dx = __fsub_rn(qx[q], v.x);
        const float dy = __fsub_rn(qy[q], v.y);
        const float dz = __fsub_rn(qz[q], v.z);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d < best[q]) {
          best[q] = d;
          bi[q] = k;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kQ; ++q) sred[warp][lane + 32 * q] = pack(best[q], bi[q]);
  __syncthreads();
  if (threadIdx.x < kTile) {
    unsigned long long m = sred[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const unsigned long long v = sred[w][threadIdx.x];
      m = v < m ? v : m;
    }
    sbest[threadIdx.x] = m;
  }
  cluster.sync();  // every block's sbest is written (a __syncthreads alone)
  if (rank == 0 && threadIdx.x < kTile) {
    unsigned long long m = sbest[threadIdx.x];
    for (unsigned r = 1; r < csize; ++r) {
      const unsigned long long v = *cluster.map_shared_rank(
          &sbest[threadIdx.x], r);
      m = v < m ? v : m;
    }
    const int64_t i = q0 + threadIdx.x;
    if (i < M) {
      d2[i] = __uint_as_float((unsigned)(m >> 32));
      idx[i] = (int64_t)(m & 0xffffffffull);
    }
  }
  cluster.sync();  // no block leaves while block 0 still reads its sbest
}

}  // namespace

// E: the batch of edges (1 for a single sweep), each with its own M queries
// and N key slots, contiguous edge after edge; splits: the cluster size, 1,
// 2, 4 or 8 blocks sharing one query tile; per_lane: queries per lane, 2 or 4
// (a tile of 64 or 128 queries).
extern "C" int sl_nearest_one(const void* queries, const void* keys_t,
                              const void* p2v, void* d2, void* idx, int64_t E,
                              int64_t M, int64_t N, int splits, int per_lane,
                              void* stream) {
  if (E < 0 || M < 0 || N < 1 || N > 0x7fffffffLL ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      (per_lane != 2 && per_lane != 4))
    return (int)cudaErrorInvalidValue;
  if (E == 0 || M == 0) return (int)cudaSuccess;
  const int64_t tile = 32 * per_lane;
  const int64_t tiles = (M + tile - 1) / tile;
  if (tiles * splits > 0x7fffffffLL / E) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(E * tiles * splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int64_t per_block = (N + splits - 1) / splits;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, per_lane == 4 ? nn1<4> : nn1<2>,
      static_cast<const float*>(queries), static_cast<const float*>(keys_t),
      static_cast<const float*>(p2v), static_cast<float*>(d2),
      static_cast<int64_t*>(idx), M, N, tiles, per_block);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
