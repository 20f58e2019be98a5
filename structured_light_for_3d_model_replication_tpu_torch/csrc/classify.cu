// The marching-tets classify pass in one kernel: from M bricks chi (M, 512)
// float32, their 8-neighbour table nb8 (M, 8) int64 [own, +x, +y, +z, +xy,
// +xz, +yz, +xyz] (an entry outside [0, M) is absent), a device scalar iso
// and block_valid (M,) bool, it writes
//   c9 (M, 729) float32, the corner frame: corner (x, y, z) in [0, 8]^3 at
//     flat (x*9 + y)*9 + z, read from the neighbour picked by which
//     coordinates are 8, at the wrapped voxel, or from the own brick's
//     clamp voxel where that neighbour is absent (for every brick, valid or
//     not);
//   active (M, 512) bool, cell c = (cx*8 + cy)*8 + cz:
//     any(c9 > iso) && !all(c9 > iso) over its 8 corners, && block_valid;
//   count: the number of active cells (int32).
// Bit for bit what `ops/marching_classify.classify_bricks_reference` (the
// plain corner frame, then the plain classify) computes.
//
// Replaces the TPU kernel `classify_pallas`
// (structured_light_for_3d_model_replication_tpu/ops/marching_pallas.py:54,
// pallas_call at :63), which took a corner frame already built in HBM and
// returned any/all planes as f32 0/1, and with it the frame's assembly
// before it (`marching_jax._phase_corners`). The comparison is c9 > iso,
// as the XLA branch does; it agrees with c9 - iso > 0 only under gradual
// underflow, so build without -ftz or --use_fast_math.
//
// Bound on the H100: bytes. Per brick 2048 (own brick) + 64 (nb8) + 1
// (valid) in, 2916 (frame) + 512 (mask) out: ~726 MB, ~0.217 ms at 3.35 TB/s
// for M = 131072. The +faces read from the neighbours (217 floats a brick)
// are counted as L2 hits: those bricks are read as own bricks anyway.
//
// Design: one warp a brick, kWarps bricks a block, grid-stride over the
// bricks with a kStages-deep ring a warp in shared memory, so the loads of
// the next bricks are in flight while one is classified. A ring slot holds
// the own brick (16-byte cp.async, rows are 2048 B) and the 217 face values
// (4-byte cp.async from the neighbour's wrapped voxel, or from the own
// brick's clamp voxel when the neighbour is absent). The warp then stores
// the frame coalesced, 32 positions a step, and ballots `v > iso` on the
// way: the 23 ballot words are the frame's 729 inside bits in flat order,
// so the 9-bit z-column mask of (x, y) starts at bit (x*9 + y)*9. A lane
// takes a cell row (cx, cy): OR and AND of its four columns, any = (o | o
// >> 1) & 0xff, all = (a & a >> 1) & 0xff, and the 8 flags of any & ~all
// expanded to 8 bytes in one 8-byte store. The count is one integer atomic
// a warp (exact in any order). Timed on the card against 2-8 stages, 2-16
// warps a block and the own brick by one TMA bulk copy on an mbarrier, 8
// warps with 6 stages (one block an SM, 5 bricks in flight a warp) by
// cp.async was as fast as any and simpler than the TMA form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kV = 512;                    // voxels (cells) a brick
constexpr int kNC = 729;                   // corners a brick, 9^3
constexpr int kNF = kNC - kV;              // +face corners, from neighbours
constexpr int kSteps = (kNC + 31) / 32;    // frame positions a lane
constexpr int kFaceSteps = (kNF + 31) / 32;
constexpr int kValid = kNC;                // slot word holding block_valid
constexpr int kSlot = 732;                 // floats a slot (16-B multiple)
constexpr int kWarps = 8;
constexpr int kStages = 6;
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kRingBytes = sizeof(float) * kWarps * kStages * kSlot;
constexpr size_t kSmemBytes =
    kRingBytes + sizeof(uint32_t) * kNF + sizeof(uint16_t) * kNC;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Spreads the low 4 bits of b to the low bit of 4 bytes.
__device__ __forceinline__ uint32_t bits_to_bytes(uint32_t b) {
  return ((b & 0xfu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kWarps * 32)
classify_bricks(const float* __restrict__ chi, const int64_t* __restrict__ nb8,
                const float* __restrict__ iso_p,
                const uint8_t* __restrict__ block_valid,
                float* __restrict__ c9, uint64_t* __restrict__ active,
                int* __restrict__ count, int64_t M) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  // Per face corner f: neighbour case | src voxel << 3 | clamp voxel << 12.
  uint32_t* face_tab = reinterpret_cast<uint32_t*>(smem + kWarps * kStages
                                                   * kSlot);
  // Per frame position p: where its value sits in a slot.
  uint16_t* frame_off = reinterpret_cast<uint16_t*>(face_tab + kNF);
  for (int p = threadIdx.x; p < kNC; p += blockDim.x) {
    const int x = p / 81, y = (p / 9) % 9, z = p % 9;
    // Own corners before p: the own voxel index when p is own, and p minus
    // it the face index when p is a +face corner.
    const int ob = 64 * x + (x < 8 ? 8 * y + (y < 8 ? z : 0) : 0);
    if (x < 8 && y < 8 && z < 8) {
      frame_off[p] = static_cast<uint16_t>(ob);
    } else {
      const int hit = (x == 8) | (y == 8) << 1 | (z == 8) << 2;
      // nb8 order: own, +x, +y, +z, +xy, +xz, +yz, +xyz.
      const int nb = hit == 3 ? 4 : (hit == 4 ? 3 : hit);
      const int src = ((x & 7) * 8 + (y & 7)) * 8 + (z & 7);
      const int clamp = (min(x, 7) * 8 + min(y, 7)) * 8 + min(z, 7);
      frame_off[p] = static_cast<uint16_t>(kV + p - ob);
      face_tab[p - ob] = static_cast<uint32_t>(nb | src << 3 | clamp << 12);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float iso = *iso_p;
  float* mine = ring + warp * kStages * kSlot;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t n_mine = first < M ? (M - 1 - first) / stride + 1 : 0;

  // Lanes 0-7 fetch the brick's nb8 row, lane 8 its valid flag.
  auto fetch = [&](int64_t n) -> int64_t {
    if (n >= n_mine) return 0;
    const int64_t b = first + n * stride;
    if (lane < 8) {
      return __ldg(reinterpret_cast<const long long*>(nb8) + b * 8 + lane);
    }
    if (lane == 8) return __ldg(block_valid + b);
    return 0;
  };
  // Start the copies of brick n into ring slot `slot`; `nbv` is fetch(n).
  auto start = [&](int64_t n, int slot, int64_t nbv) {
    const int64_t b = first + n * stride;
    float* s = mine + slot * kSlot;
    const float* own = chi + b * kV;
#pragma unroll
    for (int i = 0; i < kV / 128; ++i) {
      const int q = (lane + 32 * i) * 4;
      cp_async16(s + q, own + q);
    }
    const int row = (lane < 8 && static_cast<uint64_t>(nbv) <
                     static_cast<uint64_t>(M)) ? static_cast<int>(nbv) : -1;
#pragma unroll
    for (int j = 0; j < kFaceSteps; ++j) {
      const int f = lane + 32 * j;
      const uint32_t e = f < kNF ? face_tab[f] : 0u;
      const int r = __shfl_sync(kAll, row, static_cast<int>(e & 7u));
      const float* g = r >= 0 ? chi + static_cast<int64_t>(r) * kV
                                    + ((e >> 3) & 511u)
                              : own + (e >> 12);
      if (f < kNF) cp_async4(s + kV + f, g);
    }
    if (lane == 8) reinterpret_cast<int*>(s)[kValid] = static_cast<int>(nbv);
  };

  int64_t nbv = fetch(0);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_mine) start(st, st, nbv);
    cp_async_commit();
    nbv = fetch(st + 1);
  }
  int n_active = 0;
  for (int64_t n = 0; n < n_mine; ++n) {
    const int64_t ahead = n + kStages - 1;
    if (ahead < n_mine) start(ahead, static_cast<int>(ahead % kStages), nbv);
    cp_async_commit();
    nbv = fetch(ahead + 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();

    const int64_t b = first + n * stride;
    const float* s = mine + static_cast<int>(n % kStages) * kSlot;
    float* out = c9 + b * kNC;
    uint32_t word = 0;   // lane k < kSteps: ballot word k of the frame
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int p = lane + 32 * k;
      bool in = false;
      if (p < kNC) {
        const float v = s[frame_off[p]];
        out[p] = v;
        in = v > iso;
      }
      const uint32_t bal = __ballot_sync(kAll, in);
      if (lane == k) word = bal;
    }
    const bool valid = reinterpret_cast<const int*>(s)[kValid] != 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;               // cell row cx*8 + cy
      const int o0 = ((r >> 3) * 9 + (r & 7)) * 9;  // column (cx, cy)
      const int o1 = o0 + 81;                        // column (cx + 1, cy)
      // 18 bits from o: the columns (., cy) and (., cy + 1).
      const uint32_t p0 = __funnelshift_r(
          __shfl_sync(kAll, word, o0 >> 5),
          __shfl_sync(kAll, word, (o0 >> 5) + 1), o0 & 31);
      const uint32_t p1 = __funnelshift_r(
          __shfl_sync(kAll, word, o1 >> 5),
          __shfl_sync(kAll, word, (o1 >> 5) + 1), o1 & 31);
      const uint32_t o = (p0 | p0 >> 9 | p1 | p1 >> 9) & 0x1ffu;
      const uint32_t a = p0 & p0 >> 9 & p1 & p1 >> 9 & 0x1ffu;
      const uint32_t act =
          valid ? ((o | o >> 1) & ~(a & a >> 1)) & 0xffu : 0u;
      n_active += __popc(act);
      active[b * 64 + r] = static_cast<uint64_t>(bits_to_bytes(act >> 4))
                               << 32 | bits_to_bytes(act);
    }
    __syncwarp();   // the slot is read before the next copies into it
  }
  n_active = __reduce_add_sync(kAll, n_active);
  if (lane == 0 && n_active != 0) atomicAdd(count, n_active);
}

}  // namespace

extern "C" int sl_classify_bricks(const void* chi, const void* nb8,
                                  const void* iso, const void* block_valid,
                                  void* c9, void* active, void* count,
                                  int64_t M, void* stream) {
  if (M < 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess || M == 0) return (int)err;
  // Occupancy and SM count of the current device, taken once a device.
  static int blocks_per_sm[64] = {0};
  static int sm_count[64] = {0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (blocks_per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(classify_bricks,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    int per = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, classify_bricks, kWarps * 32, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    blocks_per_sm[dev] = per > 0 ? per : 1;
  }
  const int64_t want = (M + kWarps - 1) / kWarps;
  const int64_t full = (int64_t)blocks_per_sm[dev] * sm_count[dev];
  const unsigned grid = (unsigned)(want < full ? want : full);
  classify_bricks<<<grid, kWarps * 32, kSmemBytes, s>>>(
      static_cast<const float*>(chi), static_cast<const int64_t*>(nb8),
      static_cast<const float*>(iso),
      static_cast<const uint8_t*>(block_valid), static_cast<float*>(c9),
      static_cast<uint64_t*>(active), static_cast<int*>(count), M);
  return (int)cudaGetLastError();
}
