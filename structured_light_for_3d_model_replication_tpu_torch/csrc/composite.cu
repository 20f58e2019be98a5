// Per-tile front-to-back alpha composite of depth-sorted splat records. For
// NT image tiles of T x T pixels, nine (NT, K) float32 record planes -- u,
// v, the conic a, b, c, the colour r, g, b and the opacity --, the (NT, K)
// membership flag ok (bool, or float32 0/1) and the tiles' pixel origins
// x0, y0 (NT,): for every pixel (gx, gy) = (x0 + p % T, y0 + p / T) of
// every tile, over k = 0..K-1 in order,
//   dx = gx - u,  dy = gy - v
//   power = (-0.5 * (a * dx * dx + c * dy * dy)) - b * dx * dy
//   alpha = min(max(opa * expf(min(power, 0)), 0), 0.995)
//   rgb  += (trans * alpha) * colour,   trans *= 1 - alpha
// from trans = 1, rgb = 0; out (NT, T*T, 3) premultiplied rgb and
// (NT, T*T) alpha = 1 - trans. A record with ok == 0 is skipped: with
// finite records that is exactly the TPU kernel's alpha * ok = 0 step, and
// a NaN in a masked slot cannot poison the tile.
//
// Replaces the TPU kernel `composite_pallas`
// (structured_light_for_3d_model_replication_tpu/ops/splat_render_pallas.py:76,
// pallas_call at :90), which ran one grid step per tile with the pixel axis
// as (1, T*T) lanes and a fori_loop over the records in VMEM. Here the
// sequential grid becomes 1728 independent blocks (a 384 x 288 frame at
// T = 8), the lanes become threads.
//
// Bound on the H100 (SXM, 700 W): the larger of the bytes the inputs need
// -- the ok plane at its own size for every slot, 36 B for each live
// record, the tile's origins and 16 B a pixel out -- at 3.35 TB/s, and
// ~25 fp32 operations and one expf per live (pixel, record) pair at 67
// TFLOP/s. chip_smoke.py works both out from each run's inputs. A 384 x 288
// view's blocks all fit in one wave, so the time is set by the SMs that
// hold the densest tiles, not by either rate.
//
// Design: one block per tile, one thread per pixel (T*T <= 1024).
// 1. Each thread reads the ok flags of two records (j = p, p + T*T) and,
//    for the members only, issues the loads of all nine planes before it
//    stores any of them to shared memory: a tile costs one round trip for
//    its flags and one for its members' records. The binning sorts
//    non-members last, so most of a sparse tile's slots cost a flag read.
// 2. The block's last member slot comes from a warp max and one word a
//    warp; the fold stops there. Records are staged kChunk at a time.
// 3. A staged record is three 16-byte words, read by every thread as
//    broadcasts: three shared-memory loads a record where the first
//    version issued ten.
// 4. The fold takes eight records a step: their alphas do not depend on
//    the running colour, so the eight conics and exponentials overlap, and
//    then the eight are folded in order. The densest tiles (up to K
//    members) set the kernel's time; nothing else runs beside them.
// Every product, sum and difference is rounded on its own
// (__fmul_rn/__fadd_rn/__fsub_rn: no FMA contraction), the exponential is
// the accurate expf (the build never takes --use_fast_math), and the
// members are folded in the same order as before, so the output is
// bit-equal to the first version of this kernel; against the plain PyTorch
// version `composite_reference` only the order of the K-sum differs
// (sequential here, a reduction there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;   // records staged per pass (6 KB of shared)
constexpr int kPlanes = 9;    // u, v, a, b, c, r, g, b, opa
constexpr int kUnroll = 8;    // records a fold step
constexpr unsigned kFull = 0xffffffffu;

struct Planes {
  const float* p[kPlanes];
};

// A staged record: (u, v, a, b), (c, r, g, b), (opa, member, -, -), read by
// every thread of the tile as three 16-byte broadcasts.
struct Record {
  float4 uvab, ccol, opa;
};

__device__ __forceinline__ float alpha_of(const Record& rc, float gx,
                                          float gy) {
  const float dx = __fsub_rn(gx, rc.uvab.x);
  const float dy = __fsub_rn(gy, rc.uvab.y);
  const float qa = __fmul_rn(__fmul_rn(rc.uvab.z, dx), dx);
  const float qc = __fmul_rn(__fmul_rn(rc.ccol.x, dy), dy);
  const float qb = __fmul_rn(__fmul_rn(rc.uvab.w, dx), dy);
  const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  const float gauss = expf(fminf(power, 0.f));
  return fminf(fmaxf(__fmul_rn(rc.opa.x, gauss), 0.f), 0.995f);
}

template <typename OkT>
__global__ void composite_cells(Planes in, const OkT* __restrict__ ok,
                                const float* __restrict__ x0,
                                const float* __restrict__ y0,
                                float* __restrict__ rgb_out,
                                float* __restrict__ a_out, int64_t k,
                                int tile) {
  __shared__ Record rec[kChunk];
  __shared__ int warp_last[32];
  const int64_t cell = blockIdx.x;
  const int t2 = tile * tile;
  const int p = threadIdx.x;
  const int warps = (t2 + 31) >> 5;
  const int in_warp = min(32, t2 - (p & ~31));
  const unsigned warp_mask = in_warp == 32 ? kFull : (1u << in_warp) - 1;
  const float gx = __fadd_rn(x0[cell], (float)(p % tile));
  const float gy = __fadd_rn(y0[cell], (float)(p / tile));
  float trans = 1.f, r = 0.f, g = 0.f, b = 0.f;
  const int64_t base = cell * k;
  for (int64_t k0 = 0; k0 < k; k0 += kChunk) {
    const int n = (int)((k - k0) < kChunk ? (k - k0) : kChunk);
    __syncthreads();   // the previous chunk is consumed
    // Stage: the flags of two records a thread, then the planes of the
    // members among them, all loads issued before any store.
    int last = -1;
    for (int j0 = p; j0 < n; j0 += 2 * t2) {
      const int j1 = j0 + t2;
      const bool m0 = ok[base + k0 + j0] != OkT(0);
      const bool m1 = j1 < n && ok[base + k0 + j1] != OkT(0);
      float v0[kPlanes], v1[kPlanes];
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) {
        v0[q] = m0 ? in.p[q][base + k0 + j0] : 0.f;
        v1[q] = m1 ? in.p[q][base + k0 + j1] : 0.f;
      }
      rec[j0].opa = make_float4(v0[8], m0 ? 1.f : 0.f, 0.f, 0.f);
      if (m0) {
        rec[j0].uvab = make_float4(v0[0], v0[1], v0[2], v0[3]);
        rec[j0].ccol = make_float4(v0[4], v0[5], v0[6], v0[7]);
      }
      if (j1 < n) rec[j1].opa = make_float4(v1[8], m1 ? 1.f : 0.f, 0.f, 0.f);
      if (m1) {
        rec[j1].uvab = make_float4(v1[0], v1[1], v1[2], v1[3]);
        rec[j1].ccol = make_float4(v1[4], v1[5], v1[6], v1[7]);
      }
      last = m1 ? j1 : (m0 ? j0 : last);
    }
    // The fold stops after the chunk's last member.
    last = __reduce_max_sync(warp_mask, last);
    if ((p & 31) == 0) warp_last[p >> 5] = last;
    __syncthreads();
    int end = 0;
    for (int w = 0; w < warps; ++w) end = max(end, warp_last[w] + 1);

    for (int j = 0; j < end; j += kUnroll) {
      Record rc[kUnroll];
      float al[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rc[u] = rec[min(j + u, end - 1)];
        al[u] = alpha_of(rc[u], gx, gy);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u >= end || rc[u].opa.y == 0.f) continue;
        const float w = __fmul_rn(trans, al[u]);
        r = __fadd_rn(r, __fmul_rn(w, rc[u].ccol.y));
        g = __fadd_rn(g, __fmul_rn(w, rc[u].ccol.z));
        b = __fadd_rn(b, __fmul_rn(w, rc[u].ccol.w));
        trans = __fmul_rn(trans, __fsub_rn(1.f, al[u]));
      }
    }
  }
  const int64_t px = cell * t2 + p;
  rgb_out[3 * px] = r;
  rgb_out[3 * px + 1] = g;
  rgb_out[3 * px + 2] = b;
  a_out[px] = __fsub_rn(1.f, trans);
}

}  // namespace

extern "C" int sl_composite_cells(
    const void* u, const void* v, const void* ca, const void* cb,
    const void* cc, const void* cr, const void* cg, const void* cbl,
    const void* opa, const void* ok, const void* x0, const void* y0,
    void* rgb_out, void* a_out, int64_t nt, int64_t k, int tile,
    int ok_is_bool, void* stream) {
  if (nt < 0 || k < 0 || tile < 1 || tile * tile > 1024)
    return (int)cudaErrorInvalidValue;
  if (nt == 0) return (int)cudaSuccess;
  if (nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Planes in;
  const void* ptrs[kPlanes] = {u, v, ca, cb, cc, cr, cg, cbl, opa};
  for (int i = 0; i < kPlanes; ++i)
    in.p[i] = static_cast<const float*>(ptrs[i]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x0);
  const float* fy = static_cast<const float*>(y0);
  float* rgb = static_cast<float*>(rgb_out);
  float* a = static_cast<float*>(a_out);
  if (ok_is_bool)
    composite_cells<uint8_t><<<(unsigned)nt, tile * tile, 0, s>>>(
        in, static_cast<const uint8_t*>(ok), fx, fy, rgb, a, k, tile);
  else
    composite_cells<float><<<(unsigned)nt, tile * tile, 0, s>>>(
        in, static_cast<const float*>(ok), fx, fy, rgb, a, k, tile);
  return (int)cudaGetLastError();
}
