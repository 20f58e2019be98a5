// Band-sparse screened-Poisson operator: for M flat 8^3 bricks x, W (M, 512)
// float32, face-neighbour slots nbr (M, 6) int32 (columns +x,-x,+y,-y,+z,-z;
// a slot outside [0, M) means absent) and block_valid (M,) bool,
//   out = block_valid ? -((sum of the six neighbours - 6 x) - W x) : 0.
//
// Replaces the TPU kernels `matvec_pallas_v2` and `matvec_pallas`
// (structured_light_for_3d_model_replication_tpu/ops/poisson_pallas.py:130
// and :175, pallas_call at :156 and :201), which compute this same function:
// the operator of every fine CG iteration of the depth 9-13 solve. The v2
// TPU kernel pre-extracted a (M, 6, 64) halo tensor and placed it with a
// one-hot (384, 512) matmul, and v1 fetched whole neighbour bricks by DMA;
// both were ways around Mosaic's tiling. Here a voxel simply reads its
// missing neighbour from the neighbour brick's opposite face in global
// memory.
//
// Bound on the H100: bytes. Per valid brick x and W are read and out is
// written (3 x 2048 B), an invalid brick writes 2048 B, and every brick
// reads 24 B of nbr; the face reads of neighbour bricks hit L2. At the
// depth-10 band of 131072 slots that is ~0.8 GB, ~0.24 ms at 3.35 TB/s.
//
// Design: one block of 512 threads per brick, one thread per voxel. The
// brick's x goes to shared memory; in-brick neighbours come from there,
// cross-brick ones straight from global x. The six terms are summed in the
// plain version's order (+x, -x, +y, -y, +z, -z) and every product and sum is
// rounded on its own (`__fmul_rn`/`__fadd_rn`/`__fsub_rn`: no FMA
// contraction), so the result is bit-equal to the plain PyTorch version
// `matvec_band_reference`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kV = 512;  // voxels per 8^3 brick

__device__ __forceinline__ float halo(const float* __restrict__ x,
                                      const int32_t* __restrict__ nbr,
                                      int64_t b, int d, int src, int64_t M) {
  const int32_t n = nbr[b * 6 + d];
  return (n >= 0 && n < M) ? x[(int64_t)n * kV + src] : 0.f;
}

__global__ void __launch_bounds__(kV)
matvec_band(const float* __restrict__ x, const float* __restrict__ W,
            const int32_t* __restrict__ nbr,
            const uint8_t* __restrict__ block_valid, float* __restrict__ out,
            int64_t M) {
  __shared__ float sx[kV];
  const int64_t b = blockIdx.x;
  const int v = threadIdx.x;
  const int64_t at = b * kV + v;
  if (!block_valid[b]) {
    out[at] = 0.f;
    return;
  }
  const float xv = x[at];
  sx[v] = xv;
  __syncthreads();
  const int ix = v >> 6, iy = (v >> 3) & 7, iz = v & 7;
  float acc = 0.f;
  acc = __fadd_rn(acc, ix < 7 ? sx[v + 64] : halo(x, nbr, b, 0, v - 448, M));
  acc = __fadd_rn(acc, ix > 0 ? sx[v - 64] : halo(x, nbr, b, 1, v + 448, M));
  acc = __fadd_rn(acc, iy < 7 ? sx[v + 8] : halo(x, nbr, b, 2, v - 56, M));
  acc = __fadd_rn(acc, iy > 0 ? sx[v - 8] : halo(x, nbr, b, 3, v + 56, M));
  acc = __fadd_rn(acc, iz < 7 ? sx[v + 1] : halo(x, nbr, b, 4, v - 7, M));
  acc = __fadd_rn(acc, iz > 0 ? sx[v - 1] : halo(x, nbr, b, 5, v + 7, M));
  const float lap = __fsub_rn(acc, __fmul_rn(6.f, xv));
  out[at] = -__fsub_rn(lap, __fmul_rn(W[at], xv));
}

}  // namespace

extern "C" int sl_matvec_band(const void* x, const void* W, const void* nbr,
                              const void* block_valid, void* out, int64_t M,
                              void* stream) {
  if (M < 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  matvec_band<<<(unsigned)M, kV, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(W),
      static_cast<const int32_t*>(nbr),
      static_cast<const uint8_t*>(block_valid), static_cast<float*>(out), M);
  return (int)cudaGetLastError();
}
