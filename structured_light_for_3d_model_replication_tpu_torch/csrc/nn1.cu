// k = 1 nearest-neighbour sweep: for each of M queries (M, 3) the nearest
// valid key of a transposed (3, N) key table -> d2 (M,) float32 and
// idx (M,) int64.
//
// Replaces the TPU kernel `nearest_one`
// (structured_light_for_3d_model_replication_tpu/ops/nn_pallas.py:99,
// pallas_call at :122), the correspondence sweep of every ICP iteration,
// `count_corr` and `information_matrix`. The TPU kernel packs the key index
// into the low 13 mantissa bits of d2 (a workaround for its min-only
// reduction, which also caps N at 8192). This kernel keeps d2 exact and the
// index separate, so N is unbounded and d2 differs from the TPU's by at most
// that kernel's own 2^-10 relative quantization.
//
// Distances are direct-difference fp32, dx*dx + dy*dy + dz*dz, rounded op by
// op (`__fmul_rn`/`__fadd_rn`: no FMA contraction) so they are bit-equal to
// the plain PyTorch version. Invalid keys carry p2v = +inf and never win.
// Ties go to the lowest key index; with no valid key d2 = +inf and idx = 0.
//
// Bound on the H100: fp32 arithmetic, about 8 operations per (query, key)
// pair -- M = N = 8192 is ~0.54 GFLOP, ~8 us at the 67 TFLOP/s non-tensor
// fp32 peak. Bytes are negligible (the key table is 128 KB).
//
// Design: one thread per query, 64 threads per block. At M = 8192 that is
// only 128 query blocks for 132 SMs, so the key range is also split across
// gridDim.y: each block stages its share of the keys through shared memory
// in 256-key chunks (x, y, z, validity as one float4, read as a broadcast)
// and keeps a running (d2, idx) in registers. Each block writes its
// per-split minimum as one 64-bit word, d2's bits above the index -- for
// non-negative floats the unsigned order of the bits is the float order, so
// the smallest word is the smallest d2 with the lowest index on ties. A
// second small kernel takes the minimum over the splits and unpacks it.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;        // queries (threads) per block
constexpr int kChunk = 256;   // keys per shared-memory round

__global__ void __launch_bounds__(kQ)
nn1_partial(const float* __restrict__ queries, const float* __restrict__ keys_t,
            const float* __restrict__ p2v,
            unsigned long long* __restrict__ partial, int64_t M, int64_t N,
            int64_t keys_per_split) {
  __shared__ float4 sk[kChunk];
  const int64_t i = (int64_t)blockIdx.x * kQ + threadIdx.x;
  const int64_t k0 = (int64_t)blockIdx.y * keys_per_split;
  const int64_t k1 = k0 + keys_per_split < N ? k0 + keys_per_split : N;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < M) {
    qx = queries[3 * i];
    qy = queries[3 * i + 1];
    qz = queries[3 * i + 2];
  }
  float best = CUDART_INF_F;
  int64_t best_i = k0 < N ? k0 : 0;
  for (int64_t c0 = k0; c0 < k1; c0 += kChunk) {
    __syncthreads();
    for (int j = threadIdx.x; j < kChunk; j += kQ) {
      const int64_t k = c0 + j;
      float4 v = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
      if (k < k1)
        v = make_float4(keys_t[k], keys_t[N + k], keys_t[2 * N + k],
                        isfinite(p2v[k]) ? 0.f : CUDART_INF_F);
      sk[j] = v;
    }
    __syncthreads();
    const int n = k1 - c0 < kChunk ? (int)(k1 - c0) : kChunk;
    for (int j = 0; j < n; ++j) {
      const float4 v = sk[j];
      const float dx = __fsub_rn(qx, v.x);
      const float dy = __fsub_rn(qy, v.y);
      const float dz = __fsub_rn(qz, v.z);
      float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                          __fmul_rn(dz, dz));
      d = __fadd_rn(d, v.w);  // +inf for an invalid key
      if (d < best) {
        best = d;
        best_i = c0 + j;
      }
    }
  }
  if (i < M)
    partial[(int64_t)blockIdx.y * M + i] =
        ((unsigned long long)__float_as_uint(best) << 32) |
        (unsigned long long)(uint32_t)best_i;
}

__global__ void nn1_reduce(const unsigned long long* __restrict__ partial,
                           float* __restrict__ d2, int64_t* __restrict__ idx,
                           int64_t M, int64_t N, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  unsigned long long m = partial[i];
  for (int s = 1; s < splits; ++s) {
    const unsigned long long v = partial[(int64_t)s * M + i];
    m = v < m ? v : m;
  }
  d2[i] = __uint_as_float((unsigned)(m >> 32));
  const int64_t k = (int64_t)(m & 0xffffffffull);
  idx[i] = k < N ? k : N - 1;
}

}  // namespace

extern "C" int sl_nearest_one(const void* queries, const void* keys_t,
                              const void* p2v, void* partial, void* d2,
                              void* idx, int64_t M, int64_t N, int splits,
                              void* stream) {
  if (M < 0 || N < 1 || N > 0x7fffffffLL || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t per = (N + splits - 1) / splits;
  const dim3 grid((unsigned)((M + kQ - 1) / kQ), (unsigned)splits);
  auto* part = static_cast<unsigned long long*>(partial);
  nn1_partial<<<grid, kQ, 0, s>>>(static_cast<const float*>(queries),
                                  static_cast<const float*>(keys_t),
                                  static_cast<const float*>(p2v), part, M, N,
                                  per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn1_reduce<<<(unsigned)((M + 255) / 256), 256, 0, s>>>(
      part, static_cast<float*>(d2), static_cast<int64_t*>(idx), M, N,
      splits);
  return (int)cudaGetLastError();
}
