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
// both were ways around Mosaic's tiling.
//
// Bound on the H100: bytes. Per valid brick x and W are read and out is
// written (3 x 2048 B), an invalid brick writes 2048 B, and every brick
// reads 25 B of nbr and block_valid; the face reads of neighbour bricks hit
// L2 (the band's slots are sorted by block coordinate, so a brick's
// neighbours are near it in the slot order). At the depth-10 band of 131072
// slots that is ~0.8 GB, ~0.24 ms at 3.35 TB/s.
//
// Design: a block of 256 threads owns 4 bricks, one thread per z-row of 8
// voxels (64 rows a brick), so x, W and out move as two 16-byte vectors a
// thread and the in-row z neighbours come from registers. Each brick's rows
// go to shared memory in a (10, 10) row grid padded by one row on each side
// in x and y, and its neighbours' faces are staged into the padding before
// the stencil: the +-x faces are contiguous 256-byte slabs and the +-y faces
// eight 32-byte rows, loaded as 16-byte vectors by 16 threads each; the
// +-z faces are one float per row (x[nbr, ix, iy, 0] or [.., 7]). After one
// barrier every voxel reads its six neighbours with no branch on the face
// tests beyond the row ends. An invalid brick loads nothing and stores
// zeros. The six terms are summed in the plain version's order (+x, -x, +y,
// -y, +z, -z) and every product and sum is rounded on its own
// (`__fmul_rn`/`__fadd_rn`/`__fsub_rn`: no FMA contraction), so the result is
// bit-equal to the plain PyTorch version `matvec_band_reference`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kV = 512;      // voxels per 8^3 brick
constexpr int kRows = 64;    // z-rows per brick
constexpr int kBricks = 4;   // bricks per block
constexpr int kThreads = kRows * kBricks;

__device__ __forceinline__ bool present(int32_t n, int64_t M) {
  return n >= 0 && n < M;
}

__device__ __forceinline__ float at(const float4& a, const float4& b, int z) {
  switch (z) {
    case 0: return a.x;
    case 1: return a.y;
    case 2: return a.z;
    case 3: return a.w;
    case 4: return b.x;
    case 5: return b.y;
    case 6: return b.z;
    default: return b.w;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
matvec_band(const float* __restrict__ x, const float* __restrict__ W,
            const int32_t* __restrict__ nbr,
            const uint8_t* __restrict__ block_valid, float* __restrict__ out,
            int64_t M) {
  // Row (ix, iy) of brick `bl` at sx[bl][ix + 1][iy + 1][half]; the padding
  // rows hold the +-x and +-y neighbour faces.
  __shared__ float4 sx[kBricks][10][10][2];
  __shared__ float szp[kBricks][kRows];  // +z face: x[nbr+z, ix, iy, 0]
  __shared__ float szm[kBricks][kRows];  // -z face: x[nbr-z, ix, iy, 7]
  const int bl = threadIdx.x / kRows;
  const int r = threadIdx.x % kRows;
  const int ix = r >> 3, iy = r & 7;
  const int64_t b = (int64_t)blockIdx.x * kBricks + bl;
  const bool in = b < M;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  bool valid = false;
  int32_t nface = -1, nzp = -1, nzm = -1;
  const int role = r >> 4;  // the face this thread stages: +x, -x, +y, -y
  const int f = r & 15;     // its 16-byte piece of that face
  if (in) {
    valid = block_valid[b] != 0;
    nface = nbr[b * 6 + role];
    nzp = nbr[b * 6 + 4];
    nzm = nbr[b * 6 + 5];
  }
  float4 x0 = zero, x1 = zero, w0 = zero, w1 = zero;
  if (valid) {
    const float4* xr = reinterpret_cast<const float4*>(x + b * kV + r * 8);
    const float4* wr = reinterpret_cast<const float4*>(W + b * kV + r * 8);
    x0 = xr[0];
    x1 = xr[1];
    w0 = wr[0];
    w1 = wr[1];
    // A 16-byte piece of the face: the slab ix = 0 / 7 of the +-x
    // neighbour (piece f = row iy = f / 2, half f % 2), or the row iy = 0 / 7
    // of column ix = f / 2 of the +-y neighbour.
    float4 fv = zero;
    if (present(nface, M)) {
      const float* src = x + (int64_t)nface * kV;
      const int off = role == 0   ? f * 4
                      : role == 1 ? 448 + f * 4
                      : role == 2 ? (f >> 1) * 64 + (f & 1) * 4
                                  : (f >> 1) * 64 + 56 + (f & 1) * 4;
      fv = *reinterpret_cast<const float4*>(src + off);
    }
    const float zp = present(nzp, M) ? x[(int64_t)nzp * kV + r * 8] : 0.f;
    const float zm = present(nzm, M) ? x[(int64_t)nzm * kV + r * 8 + 7] : 0.f;
    sx[bl][ix + 1][iy + 1][0] = x0;
    sx[bl][ix + 1][iy + 1][1] = x1;
    const int fa = (f >> 1) + 1, half = f & 1;
    if (role == 0) sx[bl][9][fa][half] = fv;
    else if (role == 1) sx[bl][0][fa][half] = fv;
    else if (role == 2) sx[bl][fa][9][half] = fv;
    else sx[bl][fa][0][half] = fv;
    szp[bl][r] = zp;
    szm[bl][r] = zm;
  }
  __syncthreads();
  if (!in) return;
  float4* o = reinterpret_cast<float4*>(out + b * kV + r * 8);
  if (!valid) {
    o[0] = zero;
    o[1] = zero;
    return;
  }
  const float4 xp0 = sx[bl][ix + 2][iy + 1][0], xp1 = sx[bl][ix + 2][iy + 1][1];
  const float4 xm0 = sx[bl][ix][iy + 1][0], xm1 = sx[bl][ix][iy + 1][1];
  const float4 yp0 = sx[bl][ix + 1][iy + 2][0], yp1 = sx[bl][ix + 1][iy + 2][1];
  const float4 ym0 = sx[bl][ix + 1][iy][0], ym1 = sx[bl][ix + 1][iy][1];
  const float zp = szp[bl][r], zm = szm[bl][r];
  float res[8];
#pragma unroll
  for (int z = 0; z < 8; ++z) {
    const float xv = at(x0, x1, z);
    float acc = 0.f;
    acc = __fadd_rn(acc, at(xp0, xp1, z));
    acc = __fadd_rn(acc, at(xm0, xm1, z));
    acc = __fadd_rn(acc, at(yp0, yp1, z));
    acc = __fadd_rn(acc, at(ym0, ym1, z));
    acc = __fadd_rn(acc, z < 7 ? at(x0, x1, z + 1) : zp);
    acc = __fadd_rn(acc, z > 0 ? at(x0, x1, z - 1) : zm);
    const float lap = __fsub_rn(acc, __fmul_rn(6.f, xv));
    res[z] = -__fsub_rn(lap, __fmul_rn(at(w0, w1, z), xv));
  }
  o[0] = make_float4(res[0], res[1], res[2], res[3]);
  o[1] = make_float4(res[4], res[5], res[6], res[7]);
}

}  // namespace

// x, W and out must be 16-byte aligned (the wrapper checks x and W).
extern "C" int sl_matvec_band(const void* x, const void* W, const void* nbr,
                              const void* block_valid, void* out, int64_t M,
                              void* stream) {
  if (M < 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)W | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (M == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((M + kBricks - 1) / kBricks);
  matvec_band<<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(W),
      static_cast<const int32_t*>(nbr),
      static_cast<const uint8_t*>(block_valid), static_cast<float*>(out), M);
  return (int)cudaGetLastError();
}
