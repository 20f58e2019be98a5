// Gray-code stack decode: (B, F, H, W) uint8 capture stacks -> two
// (B, H, W) int32 maps of projector column and row.
//
// Replaces the TPU kernel `decode_maps_pallas`
// (structured_light_for_3d_model_replication_tpu/ops/decode_pallas.py:57,
// pallas_call at :94). Per pixel and bit: pattern > inverse, packed
// MSB-first, Gray -> binary by the doubling XOR cascade, then
// `code * ds + (ds - 1) / 2`. The validity mask stays in PyTorch.
//
// Bound on the H100: memory. Planes 0 and 1 (white, black) feed only the
// mask, which PyTorch computes, so the kernel reads the 2 * (col_bits +
// row_bits) bit planes once and each pixel writes 8 bytes:
// B * ((F - 2) * H * W + 8 * H * W) bytes, about 108 MB per 1080p stop with
// F = 46, i.e. ~32 us at 3.35 TB/s. Arithmetic is a few integer ops per byte.
//
// Design: one thread owns 16 adjacent pixels of one image. It walks the bit
// planes at stride H*W with one 16-byte load per plane (neighbouring threads
// on neighbouring 16-byte words, so each plane is read fully coalesced),
// compares four bytes at a time with `__vcmpgtu4`, and keeps the 2 x 16
// Gray accumulators in registers; nothing intermediate reaches device
// memory. The maps leave as 16-byte stores. Any H and W are taken, with no
// TPU-style lane padding: the last group of an image masks the pixels past
// H*W. When H*W is not a multiple of 16 (the planes' starts are then not
// 16-byte aligned) or a pointer is misaligned, the same kernel reads one
// byte and writes one int32 per pixel under that mask.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 16;       // pixels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t finish(int32_t g, int n_bits, int ds) {
  for (int s = 1; s < n_bits; s <<= 1) g ^= g >> s;
  return g * ds + (ds - 1) / 2;
}

// acc[j] = (acc[j] << 1) | (pattern_j > inverse_j) for the 4 bytes of a word.
__device__ __forceinline__ void push4(int32_t* acc, unsigned a, unsigned c) {
  const unsigned gt = __vcmpgtu4(a, c);  // 0xff in each byte where a > c
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = (acc[i] << 1) | ((gt >> (8 * i)) & 1);
}

__device__ __forceinline__ void push16(int32_t* acc, const uint8_t* pat,
                                       const uint8_t* inv) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(pat));
  const uint4 c = __ldg(reinterpret_cast<const uint4*>(inv));
  push4(acc + 0, a.x, c.x);
  push4(acc + 4, a.y, c.y);
  push4(acc + 8, a.z, c.z);
  push4(acc + 12, a.w, c.w);
}

__device__ __forceinline__ void store16(int32_t* out, const int32_t* acc,
                                        int n_bits, int ds) {
  int4* o = reinterpret_cast<int4*>(out);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = make_int4(finish(acc[4 * q + 0], n_bits, ds),
                     finish(acc[4 * q + 1], n_bits, ds),
                     finish(acc[4 * q + 2], n_bits, ds),
                     finish(acc[4 * q + 3], n_bits, ds));
}

// Packs the n_bits pattern/inverse pairs from plane `first` on into acc.
// `wide`: 16 valid pixels and 16-byte aligned planes; else the first n only.
// The branch stays outside the plane loop, so the wide loop is nothing but
// back-to-back 16-byte loads the compiler can keep in flight.
__device__ __forceinline__ void unpack(int32_t* acc, const uint8_t* base,
                                       int64_t P, int first, int n_bits,
                                       int n, bool wide) {
#pragma unroll
  for (int j = 0; j < kPix; ++j) acc[j] = 0;
  const uint8_t* pat = base + first * P;
  if (wide) {
    for (int k = 0; k < n_bits; ++k, pat += 2 * P) push16(acc, pat, pat + P);
    return;
  }
  for (int k = 0; k < n_bits; ++k, pat += 2 * P) {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (j < n) acc[j] = (acc[j] << 1) | (pat[j] > pat[P + j]);
  }
}

__device__ __forceinline__ void put(int32_t* out, const int32_t* acc,
                                    int n_bits, int ds, int n, bool wide) {
  if (wide) {
    store16(out, acc, n_bits, ds);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (j < n) out[j] = finish(acc[j], n_bits, ds);
  }
}

__global__ void __launch_bounds__(kThreads)
decode_maps(const uint8_t* __restrict__ stack, int32_t* __restrict__ col,
            int32_t* __restrict__ row, int64_t B, int F, int64_t P,
            int col_bits, int row_bits, int ds, bool vec) {
  const int64_t groups = (P + kPix - 1) / kPix;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * groups) return;
  const int64_t b = t / groups;
  const int64_t p0 = (t - b * groups) * kPix;
  const int n = (int)(P - p0 < kPix ? P - p0 : kPix);  // ragged edge mask
  const bool wide = vec && n == kPix;
  const uint8_t* base = stack + b * (int64_t)F * P + p0;

  int32_t acc[kPix];
  unpack(acc, base, P, 2, col_bits, n, wide);
  put(col + b * P + p0, acc, col_bits, ds, n, wide);
  unpack(acc, base, P, 2 + 2 * col_bits, row_bits, n, wide);
  put(row + b * P + p0, acc, row_bits, ds, n, wide);
}

}  // namespace

extern "C" int sl_decode_maps(const void* stack, void* col, void* row,
                              int64_t B, int F, int64_t H, int64_t W,
                              int col_bits, int row_bits, int downsample,
                              void* stream) {
  if (B < 0 || H < 0 || W < 0 || col_bits < 1 || row_bits < 1 ||
      col_bits > 30 || row_bits > 30 || downsample < 1 ||
      F != 2 + 2 * col_bits + 2 * row_bits)
    return (int)cudaErrorInvalidValue;
  const int64_t P = H * W;
  if (B == 0 || P == 0) return (int)cudaSuccess;
  const bool vec = P % kPix == 0 &&
                   ((reinterpret_cast<uintptr_t>(stack) |
                     reinterpret_cast<uintptr_t>(col) |
                     reinterpret_cast<uintptr_t>(row)) & 15) == 0;
  const int64_t threads = B * ((P + kPix - 1) / kPix);
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  decode_maps<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(stack), static_cast<int32_t*>(col),
      static_cast<int32_t*>(row), B, F, P, col_bits, row_bits, downsample,
      vec);
  return (int)cudaGetLastError();
}
