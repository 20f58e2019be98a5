// Marching-tets active-cell classification: for M bricks of a (M, 729)
// float32 corner frame c9 (9^3 corners per 8^3 brick, flat (x*9 + y)*9 + z),
// a device scalar iso and block_valid (M,) bool, the (M, 512) bool mask
//   active[b, c] = any(c9 > iso) && !all(c9 > iso) && block_valid[b]
// over the 8 corners of cell c = (cx*8 + cy)*8 + cz.
//
// Replaces the TPU kernel `classify_pallas`
// (structured_light_for_3d_model_replication_tpu/ops/marching_pallas.py:54,
// pallas_call at :63), the first pass of the device marching extractor. The
// TPU kernel took c9 - iso and returned any/all planes over the whole 729
// frame as f32 0/1, reduced by lane rolls; this kernel compares c9 > iso
// (the XLA branch of `marching_jax._phase_corners`, which agrees with
// c9 - iso > 0 only under gradual underflow: build without -ftz or
// --use_fast_math) and writes the 512 cell flags directly.
//
// Bound on the H100: bytes, M * (729 * 4 + 512 + 1) B -- ~0.45 GB at the
// depth-10 band of 131072 slots, ~0.13 ms at 3.35 TB/s.
//
// Design: one block of 512 threads per brick. The 729 corner values are
// loaded once into shared memory with coalesced loads; each thread reads its
// cell's 8 corners (flat offsets 0, 81, 90, 9, 1, 82, 91, 10 in the corner
// order of `marching._CORNERS`) from there. An invalid brick writes zeros
// and reads nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kV = 512;   // cells per brick
constexpr int kNC = 729;  // corners per brick

__global__ void __launch_bounds__(kV)
classify_cells(const float* __restrict__ c9, const float* __restrict__ iso_p,
               const uint8_t* __restrict__ block_valid,
               uint8_t* __restrict__ active) {
  __shared__ float s[kNC];
  const int64_t b = blockIdx.x;
  const int c = threadIdx.x;
  if (!block_valid[b]) {
    active[b * kV + c] = 0;
    return;
  }
  const float* frame = c9 + b * kNC;
  for (int i = c; i < kNC; i += kV) s[i] = frame[i];
  __syncthreads();
  const float iso = *iso_p;
  const int base = ((c >> 6) * 9 + ((c >> 3) & 7)) * 9 + (c & 7);
  const int off[8] = {0, 81, 90, 9, 1, 82, 91, 10};
  bool any_in = false, all_in = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in = s[base + off[j]] > iso;
    any_in |= in;
    all_in &= in;
  }
  active[b * kV + c] = (uint8_t)(any_in && !all_in);
}

}  // namespace

extern "C" int sl_classify_cells(const void* c9, const void* iso,
                                 const void* block_valid, void* active,
                                 int64_t M, void* stream) {
  if (M < 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  classify_cells<<<(unsigned)M, kV, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c9), static_cast<const float*>(iso),
      static_cast<const uint8_t*>(block_valid),
      static_cast<uint8_t*>(active));
  return (int)cudaGetLastError();
}
