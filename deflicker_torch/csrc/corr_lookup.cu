// RAFT correlation-window lookup for Hopper (sm_90a), inference only.
//
// Replaces the TPU kernel of deflicker_tpu/ops/pallas/corr_kernel.py:
// `_lookup_level` (:616, body `_level_kernel` :187-303), as driven by
// `corr_lookup_pallas` (:731-846) over the layout of `pad_fmap_pyramid`
// (:681-728).  None of that layout is kept: the 16-aligned band, the
// one-hot x-selection product, the shifted copies, the zero padding of each
// level and the 128-lane padding of D exist for the TPU's DMA alignment.
//
// Function computed.  For batch element b, pixel p (raster order over the
// 1/8-resolution grid), level l with (H_l, W_l) from floor-halving, and
// c = coords[b,p] / 2^l clamped to [-(r+2), W_l-1+r+2] x [-(r+2), H_l-1+r+2]:
//   out[b, p, l*81 + i*9 + j] =
//       (1/sqrt(D)) * sum_d f1[b,p,d] * bilinear(f2_l[b], c.x + (i-4), c.y + (j-4))[d]
// with the x offset on the OUTER index i (the reference's channel order), a
// bilinear corner outside [0,W_l) x [0,H_l) reading zero, f2 stored as bf16,
// f1, the sums and the output in f32.  The clamp keeps float -> int defined
// for coordinates far outside the level; every window it moves was all zero
// before and stays all zero.
//
// What the TPU kernel's structure offers here too: the 81 window points of a
// pixel share one fractional offset, so the window needs only the 10 x 10 dot
// products of f1(p) with f2_l at integer positions, then 81 four-term
// combinations; contracting over D before interpolating is legal because
// both are linear.
//
// Bound on the H100.  At the flow engine's shape (B = 8, 54 x 96 pixels,
// D = 256, 4 levels) the function must move f1 (42.5 MB), the bf16 pyramid
// (28.1 MB) and the output (53.7 MB): 0.037 ms at 3.35 TB/s.  Its 100 dots
// x 256 x 2 flop x 4 levels x 41,472 pixels are 8.5 GFLOP of f32 x bf16
// products with f32 sums, a matrix-vector product per pixel: 0.127 ms at the
// card's non-tensor f32 peak.  So operations bound it, and the traffic that
// matters is not HBM's: every pixel re-reads 400 rows of 512 bytes that its
// neighbours read too, out of L1/L2 (the whole bf16 pyramid fits L2).
//
// Design.  One warp owns one pixel for all levels: f1(p) lives in registers
// (D/32 floats a lane), so it is read once.  Per level the warp walks the 10
// window rows; in a row the 10 integer positions are 10 neighbouring 2*D-byte
// rows of f2, each read by the whole warp as one coalesced load (16 bytes a
// lane at D = 256), all ten issued before the first is used.  A bounds test
// per position stands in for padding.  The ten partial dots of a lane are
// reduced across the warp together by a packed butterfly (16 shuffles a row
// where ten separate reductions take 50), the 10 x 10 table goes to shared
// memory (400 bytes a warp), and the lanes write the level's 81 outputs as
// contiguous floats.  A block is 8 warps on 8 raster-consecutive pixels,
// whose windows overlap, which is what L1 is for.  There is no staging of a
// shared window in shared memory and no tensor-core product over a pixel
// tile yet: both need the windows of a tile to be close, which only holds
// for smooth flow, and a simple kernel that is right comes first.
//
// Interface: plain C, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define CORR_MAX_LEVELS 8

struct CorrDesc {
  int n_levels;
  int H[CORR_MAX_LEVELS];
  int W[CORR_MAX_LEVELS];
  const __nv_bfloat16* f2[CORR_MAX_LEVELS];   // level l: (B, H[l], W[l], D) bf16
};

namespace {

constexpr int R = 4;              // window radius
constexpr int K = 2 * R + 1;      // window points a side
constexpr int K1 = K + 1;         // integer positions a side
constexpr int ROWPAD = 16;        // K1 padded to a power of two for the butterfly
constexpr int NWARP = 8;
constexpr unsigned FULL = 0xffffffffu;

// VPL = values per lane = D / 32.  Raw<VPL> is a lane's share of one bf16 row.
template <int VPL> struct Raw;
template <> struct Raw<8> { typedef uint4 type; };
template <> struct Raw<4> { typedef uint2 type; };
template <> struct Raw<2> { typedef unsigned int type; };
template <> struct Raw<1> { typedef unsigned short type; };

__device__ __forceinline__ float lo_bf16(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float dot_raw(const uint4& q, const float (&a)[8]) {
  float s = a[0] * lo_bf16(q.x);
  s = fmaf(a[1], hi_bf16(q.x), s);
  s = fmaf(a[2], lo_bf16(q.y), s);
  s = fmaf(a[3], hi_bf16(q.y), s);
  s = fmaf(a[4], lo_bf16(q.z), s);
  s = fmaf(a[5], hi_bf16(q.z), s);
  s = fmaf(a[6], lo_bf16(q.w), s);
  s = fmaf(a[7], hi_bf16(q.w), s);
  return s;
}
__device__ __forceinline__ float dot_raw(const uint2& q, const float (&a)[4]) {
  float s = a[0] * lo_bf16(q.x);
  s = fmaf(a[1], hi_bf16(q.x), s);
  s = fmaf(a[2], lo_bf16(q.y), s);
  s = fmaf(a[3], hi_bf16(q.y), s);
  return s;
}
__device__ __forceinline__ float dot_raw(const unsigned int& q, const float (&a)[2]) {
  return fmaf(a[1], hi_bf16(q), a[0] * lo_bf16(q));
}
__device__ __forceinline__ float dot_raw(const unsigned short& q, const float (&a)[1]) {
  return a[0] * __uint_as_float(((unsigned int)q) << 16);
}

// Sum each of 16 per-lane values over the 32 lanes.  At offset o a lane with
// bit o set keeps the upper half of what is left and hands over the lower
// half, so the stages cost 8 + 4 + 2 + 1 shuffles and one more joins the odd
// and even lanes.  On return lane L holds the total of v[L >> 1].
template <int HALF, int OFFSET>
__device__ __forceinline__ void butterfly_stage(float (&v)[ROWPAD], int lane) {
  const bool up = (lane & OFFSET) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = up ? v[i + HALF] : v[i];
    const float send = up ? v[i] : v[i + HALF];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFFSET);
  }
}

__device__ __forceinline__ float reduce16(float (&v)[ROWPAD], int lane) {
  butterfly_stage<8, 16>(v, lane);
  butterfly_stage<4, 8>(v, lane);
  butterfly_stage<2, 4>(v, lane);
  butterfly_stage<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

template <int VPL>
__global__ void __launch_bounds__(NWARP * 32, 2)
corr_lookup_kernel(const CorrDesc d, const float* __restrict__ f1, const float* __restrict__ coords,
                   float* __restrict__ out, long long total, int N, float inv_sqrt_d) {
  typedef typename Raw<VPL>::type raw_t;
  constexpr int D = 32 * VPL;
  __shared__ float table_s[NWARP][K1 * K1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pix = (long long)blockIdx.x * NWARP + warp;
  if (pix >= total) return;            // the whole warp leaves; only warp-level syncs below
  float* table = table_s[warp];
  const int b = (int)(pix / N);

  float a[VPL];
  {
    const float* p = f1 + (size_t)pix * D + lane * VPL;
    if constexpr (VPL % 4 == 0) {
#pragma unroll
      for (int q = 0; q < VPL / 4; ++q) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
        a[4 * q] = t.x; a[4 * q + 1] = t.y; a[4 * q + 2] = t.z; a[4 * q + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) a[i] = __ldg(p + i);
    }
  }
  const float cx = __ldg(coords + 2 * (size_t)pix);
  const float cy = __ldg(coords + 2 * (size_t)pix + 1);
  float* o = out + (size_t)pix * d.n_levels * (K * K);

  for (int l = 0; l < d.n_levels; ++l) {
    const int Hl = d.H[l], Wl = d.W[l];
    const float s = 1.0f / (float)(1 << l);           // a power of two: exact
    const float lx = fminf(fmaxf(cx * s, -(float)(R + 2)), (float)(Wl - 1 + R + 2));
    const float ly = fminf(fmaxf(cy * s, -(float)(R + 2)), (float)(Hl - 1 + R + 2));
    const float fx = floorf(lx), fy = floorf(ly);
    const float wx = lx - fx, wy = ly - fy;
    const int x0 = (int)fx - R, y0 = (int)fy - R;
    const __nv_bfloat16* base = d.f2[l] + (size_t)b * Hl * Wl * D;

    for (int by = 0; by < K1; ++by) {
      const int y = y0 + by;
      const bool y_in = (y >= 0) && (y < Hl);
      // the row's ten loads first, so that they are in flight together
      raw_t q[K1];
#pragma unroll
      for (int ax = 0; ax < K1; ++ax) {
        const int x = x0 + ax;
        const bool in = y_in && (x >= 0) && (x < Wl);
        raw_t zero = raw_t();
        q[ax] = in ? __ldg(reinterpret_cast<const raw_t*>(base + ((size_t)y * Wl + x) * D) + lane)
                   : zero;
      }
      float v[ROWPAD];
#pragma unroll
      for (int ax = 0; ax < K1; ++ax) v[ax] = dot_raw(q[ax], a);
#pragma unroll
      for (int ax = K1; ax < ROWPAD; ++ax) v[ax] = 0.0f;
      const float tot = reduce16(v, lane);
      if ((lane & 1) == 0 && (lane >> 1) < K1) table[(lane >> 1) * K1 + by] = tot;
    }
    __syncwarp();

    // table[ax * K1 + by] = <f1, f2_l(x0 + ax, y0 + by)>; channel i*K + j is the
    // point (x + i - R, y + j - R): x on the outer index
    for (int k = lane; k < K * K; k += 32) {
      const int i = k / K, j = k - i * K;
      const float t00 = table[i * K1 + j];
      const float t01 = table[(i + 1) * K1 + j];         // x + 1
      const float t10 = table[i * K1 + j + 1];           // y + 1
      const float t11 = table[(i + 1) * K1 + j + 1];
      o[l * (K * K) + k] = ((t00 * (1.0f - wx) + t01 * wx) * (1.0f - wy)
                            + (t10 * (1.0f - wx) + t11 * wx) * wy) * inv_sqrt_d;
    }
    __syncwarp();
  }
}

template <int VPL>
void launch(const CorrDesc& d, const float* f1, const float* coords, float* out, long long total,
            int N, cudaStream_t stream) {
  const unsigned grid = (unsigned)((total + NWARP - 1) / NWARP);
  const float inv_sqrt_d = 1.0f / sqrtf((float)(32 * VPL));
  corr_lookup_kernel<VPL><<<grid, NWARP * 32, 0, stream>>>(d, f1, coords, out, total, N, inv_sqrt_d);
}

}  // namespace

extern "C" {

// f1 (B, N, D) f32, coords (B, N, 2) f32, out (B, N, n_levels * 81) f32, the
// levels as CorrDesc says; D in {32, 64, 128, 256}, radius 4.
int corr_lookup(const CorrDesc* d, const float* f1, const float* coords, float* out, int B, int N,
                int D, int radius, void* stream) {
  if (!d || d->n_levels < 1 || d->n_levels > CORR_MAX_LEVELS || radius != R || B < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  if ((total + NWARP - 1) / NWARP > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: launch<1>(*d, f1, coords, out, total, N, s); break;
    case 64: launch<2>(*d, f1, coords, out, total, N, s); break;
    case 128: launch<4>(*d, f1, coords, out, total, N, s); break;
    case 256: launch<8>(*d, f1, coords, out, total, N, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
