// Per-tile front-to-back alpha composite of depth-sorted splat records. For
// NT image tiles of T x T pixels, ten (NT, K) float32 record planes -- u, v,
// the conic a, b, c, the colour r, g, b, the opacity and the membership
// flag ok (0 or 1) -- and the tiles' pixel origins x0, y0 (NT,): for every
// pixel (gx, gy) = (x0 + p % T, y0 + p / T) of every tile, over k = 0..K-1
// in order,
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
// Bound on the H100: the records are read once (40 B per record) and the
// outputs written once (16 B per pixel): 10.6 MB at the 384 x 288 render
// with K = 128, ~3 us at 3.35 TB/s. The operations are ~25 fp32 operations
// and one expf per (pixel, record) pair, 14.2 M pairs there: ~5 us at
// 67 TFLOP/s. chip_smoke.py works both out from each run's inputs.
//
// Design: one block per tile, one thread per pixel (T*T <= 1024). The
// block stages its tile's records in shared memory, kChunk at a time (one
// coalesced load per plane), and every thread reads each staged record as
// a broadcast; transmittance and colour live in registers. There is no
// early exit on small transmittance: neither the TPU kernel nor the XLA
// form has one, and it would change pixels. Every product, sum and
// difference is rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn: no FMA
// contraction) and the exponential is the accurate expf (the build never
// takes --use_fast_math), as in the plain PyTorch version
// `composite_reference`; only the order of the K-sum differs from it
// (sequential here, a reduction there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;   // records staged per pass (5 KB of shared)
constexpr int kPlanes = 10;

struct Planes {
  const float* p[kPlanes];    // u, v, a, b, c, r, g, b, opa, ok
};

__global__ void composite_cells(Planes in, const float* __restrict__ x0,
                                const float* __restrict__ y0,
                                float* __restrict__ rgb_out,
                                float* __restrict__ a_out, int64_t k,
                                int tile) {
  __shared__ float rec[kPlanes][kChunk];
  const int64_t cell = blockIdx.x;
  const int t2 = tile * tile;
  const int p = threadIdx.x;
  const float gx = __fadd_rn(x0[cell], (float)(p % tile));
  const float gy = __fadd_rn(y0[cell], (float)(p / tile));
  float trans = 1.f, r = 0.f, g = 0.f, b = 0.f;
  const int64_t base = cell * k;
  for (int64_t k0 = 0; k0 < k; k0 += kChunk) {
    const int n = (int)((k - k0) < kChunk ? (k - k0) : kChunk);
    __syncthreads();   // the previous chunk is consumed
    for (int i = p; i < kPlanes * n; i += t2) {
      const int plane = i / n, j = i % n;
      rec[plane][j] = in.p[plane][base + k0 + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (rec[9][j] == 0.f) continue;
      const float dx = __fsub_rn(gx, rec[0][j]);
      const float dy = __fsub_rn(gy, rec[1][j]);
      const float qa = __fmul_rn(__fmul_rn(rec[2][j], dx), dx);
      const float qc = __fmul_rn(__fmul_rn(rec[4][j], dy), dy);
      const float qb = __fmul_rn(__fmul_rn(rec[3][j], dx), dy);
      const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
      const float gauss = expf(fminf(power, 0.f));
      const float alpha =
          fminf(fmaxf(__fmul_rn(rec[8][j], gauss), 0.f), 0.995f);
      const float w = __fmul_rn(trans, alpha);
      r = __fadd_rn(r, __fmul_rn(w, rec[5][j]));
      g = __fadd_rn(g, __fmul_rn(w, rec[6][j]));
      b = __fadd_rn(b, __fmul_rn(w, rec[7][j]));
      trans = __fmul_rn(trans, __fsub_rn(1.f, alpha));
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
    void* stream) {
  if (nt < 0 || k < 0 || tile < 1 || tile * tile > 1024)
    return (int)cudaErrorInvalidValue;
  if (nt == 0) return (int)cudaSuccess;
  if (nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Planes in;
  const void* ptrs[kPlanes] = {u, v, ca, cb, cc, cr, cg, cbl, opa, ok};
  for (int i = 0; i < kPlanes; ++i)
    in.p[i] = static_cast<const float*>(ptrs[i]);
  composite_cells<<<(unsigned)nt, tile * tile, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(x0), static_cast<const float*>(y0),
      static_cast<float*>(rgb_out), static_cast<float*>(a_out), k, tile);
  return (int)cudaGetLastError();
}
