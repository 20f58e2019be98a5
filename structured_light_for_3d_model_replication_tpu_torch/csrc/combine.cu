// TSDF running-average combine: fold one stop's scatter sums into the brick
// pool. For n = cap * 512 voxels, tsdf, weight, num, den (n,) float32 and
// rgb, rgbnum (n, 3) float32 interleaved, and a weight clamp max_weight:
//   wsum    = weight + den
//   safe    = max(wsum, 1e-12)
//   hit     = den > 0
//   tsdf'   = hit ? (tsdf * weight + num) / safe : tsdf
//   rgb'    = hit ? (rgb * weight + rgbnum) / safe : rgb     (per channel)
//   weight' = min(wsum, max_weight)
// -- the XLA form `tsdf._combine` of the JAX package, which is the NumPy
// oracle's formula (a true division, not the TPU kernel's reciprocal).
//
// Replaces the TPU kernel `combine_pallas`
// (structured_light_for_3d_model_replication_tpu/ops/tsdf_pallas.py:55,
// pallas_call at :73): one launch per `integrate`, i.e. per fused stop of
// a streaming session and per TSDF mesh. The TPU kernel split the RGB
// channels into three (cap, 512) planes and re-stacked them afterwards only
// because of Mosaic's (8, 128) tiling; here rgb and rgbnum are read in
// their interleaved (cap, 512, 3) layout, with no copies.
//
// Bound on the H100: bytes. Per voxel 40 B are read (tsdf, weight, num,
// den, 3 rgb, 3 rgbnum) and 20 B written (tsdf', weight', 3 rgb'): 60 B.
// At 16384 brick slots that is 503.3 MB, 0.150 ms at 3.35 TB/s; the
// arithmetic (a dozen flops and four divisions per voxel) is far below the
// fp32 rate.
//
// Design: one thread per voxel in a grid-stride loop. Each thread loads all
// of its voxel's inputs before it stores anything, so the outputs may alias
// the inputs (the volume is updated in place: tsdf_out == tsdf, etc.) --
// every element is read and written by the same thread. Every product, sum
// and quotient is rounded on its own (`__fmul_rn`/`__fadd_rn`/`__fdiv_rn`:
// no FMA contraction, no approximate division), so the result is bit-equal
// to the plain PyTorch version `tsdf_combine_reference`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fold(float v, float w, float add, float safe,
                                      bool hit) {
  return hit ? __fdiv_rn(__fadd_rn(__fmul_rn(v, w), add), safe) : v;
}

__global__ void __launch_bounds__(256)
tsdf_combine(const float* tsdf, const float* weight, const float* rgb,
             const float* __restrict__ num, const float* __restrict__ den,
             const float* __restrict__ rgbnum, float* tsdf_out,
             float* weight_out, float* rgb_out, int64_t n, float max_weight) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float t = tsdf[i];
    const float w = weight[i];
    const float a = num[i];
    const float d = den[i];
    const float r0 = rgb[3 * i], r1 = rgb[3 * i + 1], r2 = rgb[3 * i + 2];
    const float c0 = rgbnum[3 * i], c1 = rgbnum[3 * i + 1],
                c2 = rgbnum[3 * i + 2];
    const float wsum = __fadd_rn(w, d);
    const float safe = fmaxf(wsum, 1e-12f);
    const bool hit = d > 0.f;
    tsdf_out[i] = fold(t, w, a, safe, hit);
    weight_out[i] = fminf(wsum, max_weight);
    rgb_out[3 * i] = fold(r0, w, c0, safe, hit);
    rgb_out[3 * i + 1] = fold(r1, w, c1, safe, hit);
    rgb_out[3 * i + 2] = fold(r2, w, c2, safe, hit);
  }
}

}  // namespace

extern "C" int sl_tsdf_combine(const void* tsdf, const void* weight,
                               const void* rgb, const void* num,
                               const void* den, const void* rgbnum,
                               void* tsdf_out, void* weight_out, void* rgb_out,
                               int64_t n, float max_weight, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // Enough resident blocks for every SM; the loop strides over the rest.
  if (blocks > 132 * 16) blocks = 132 * 16;
  tsdf_combine<<<(unsigned)blocks, threads, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tsdf), static_cast<const float*>(weight),
      static_cast<const float*>(rgb), static_cast<const float*>(num),
      static_cast<const float*>(den), static_cast<const float*>(rgbnum),
      static_cast<float*>(tsdf_out), static_cast<float*>(weight_out),
      static_cast<float*>(rgb_out), n, max_weight);
  return (int)cudaGetLastError();
}
