// RAFT correlation-window lookup for Hopper (sm_90a), inference only: one
// function, three memory schedules ("bodies").
//
// Replaces the TPU kernels of deflicker_tpu/ops/pallas/corr_kernel.py, all
// driven by `corr_lookup_pallas` (:731-846) over the layouts of
// `pad_fmap_pyramid` (:681-728):
//   * band body      — `_lookup_level` (:616, body `_level_kernel` :187-303),
//                      the default;
//   * shared body    — `_lookup_level_shared` (:459, body `_shared_kernel`
//                      :306-456), DEFLICKER_CORR_SHARED=1;
//   * resident body  — `_lookup_level_resident` (:571, body
//                      `_resident_kernel` :518-568), DEFLICKER_CORR_RESIDENT=1.
// None of the TPU layout is kept: the 16-aligned bands, the one-hot
// x-selection product, the shifted quad-phase copies, the zero padding of
// each level and the 128-lane padding of D exist for the TPU's DMA alignment.
//
// Function computed (the same by every body).  For batch element b, pixel p
// (raster order over the 1/8-resolution grid), level l with (H_l, W_l) from
// floor-halving, and c = coords[b,p] / 2^l clamped to
// [-(r+2), W_l-1+r+2] x [-(r+2), H_l-1+r+2]:
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
// What every body shares.  One warp owns one pixel: f1(p) lives in registers
// (D/32 floats a lane), so it is read once.  Per level the warp walks the 10
// window rows; in a row the 10 integer positions are 10 neighbouring 2*D-byte
// rows of f2, each read by the whole warp as 16 bytes a lane (at D = 256),
// all ten issued before the first is used.  The ten partial dots of a lane
// are reduced across the warp together by a packed butterfly (16 shuffles a
// row where ten separate reductions take 50), the 10 x 10 table goes to
// shared memory (400 bytes a warp), and the lanes write the level's 81
// outputs as contiguous floats.  The bodies differ only in where a window row
// is read from; each lane multiplies the same bf16 values by the same f1
// registers in the same order, so the three bodies give bit-identical output.
//
//   * Band body: a block is 8 warps on 8 raster-consecutive pixels; a warp
//     reads its rows from global memory with a bounds test per position
//     standing in for padding, and the 8 overlapping windows meet in L1.
//   * Shared body (the TPU's group-shared band): the same block, which per
//     level reduces the 8 window corners in the block.  When the union of the
//     8 windows spans at most SH_ROWS rows and SH_COLS columns (all 8 pixels
//     real and of one batch element), the block stages the union window row
//     by row into shared memory with cp.async, double-buffered (2 x SH_COLS x
//     2D bytes: 32 KB at D = 256; positions outside the level are zero-filled
//     by the copy), and each warp takes its 10 positions of a row from there.
//     Otherwise (motion boundaries, the ragged end) each warp keeps the band
//     body's global loads.  An optional counter per level records how many
//     blocks took the staged window.
//   * Resident body (the TPU's resident levels): the levels the caller marks
//     resident (those whose bf16 bytes per batch element fit, together, in
//     the block's dynamic shared memory) are copied whole into shared memory
//     once per block with cp.async, and the warps read those levels' windows
//     from there; the other levels take the band body's global loads inside
//     the same launch.  The staging is amortised over many pixels: a block
//     is 16 warps on one batch element's pixel tile (about N / (SMs / B)
//     pixels, so the grid is about one wave of one block per SM), each warp
//     walking every 16th pixel of the tile.  If the shared memory cannot be
//     set up the launch returns the error; the wrapper raises.
//
// Interface: plain C, loaded with ctypes; every launch goes on the caller's
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
constexpr int NWARP = 8;          // band and shared bodies: warps (pixels) a block
constexpr int NWARP_RES = 16;     // resident body: warps a block
constexpr int SH_ROWS = 12;       // shared body: most rows of a staged union window
constexpr int SH_COLS = 32;       // shared body: most columns of a staged union window
constexpr unsigned FULL = 0xffffffffu;

typedef __nv_bfloat16 bf16;

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

// The ten dots of one window row (q: a lane's share of the ten positions)
// into column `by` of the warp's table: table[ax * K1 + by].
template <int VPL>
__device__ __forceinline__ void row_to_table(const typename Raw<VPL>::type (&q)[K1],
                                             const float (&a)[VPL], float* table, int by,
                                             int lane) {
  float v[ROWPAD];
#pragma unroll
  for (int ax = 0; ax < K1; ++ax) v[ax] = dot_raw(q[ax], a);
#pragma unroll
  for (int ax = K1; ax < ROWPAD; ++ax) v[ax] = 0.0f;
  const float tot = reduce16(v, lane);
  if ((lane & 1) == 0 && (lane >> 1) < K1) table[(lane >> 1) * K1 + by] = tot;
}

// The window's 10 x 10 table from a whole level (b's slice) in global
// (SMEM = false) or shared (SMEM = true) memory, with a bounds test per
// position.
template <int VPL, bool SMEM>
__device__ __forceinline__ void window_table(const bf16* __restrict__ base, int Hl, int Wl,
                                             int x0, int y0, const float (&a)[VPL],
                                             float* table, int lane) {
  typedef typename Raw<VPL>::type raw_t;
  constexpr int D = 32 * VPL;
  for (int by = 0; by < K1; ++by) {
    const int y = y0 + by;
    const bool y_in = (y >= 0) && (y < Hl);
    // the row's ten loads first, so that they are in flight together
    raw_t q[K1];
#pragma unroll
    for (int ax = 0; ax < K1; ++ax) {
      const int x = x0 + ax;
      const bool in = y_in && (x >= 0) && (x < Wl);
      const raw_t* src = reinterpret_cast<const raw_t*>(base + ((size_t)y * Wl + x) * D) + lane;
      if constexpr (SMEM) {
        q[ax] = in ? *src : raw_t();
      } else {
        q[ax] = in ? __ldg(src) : raw_t();
      }
    }
    row_to_table<VPL>(q, a, table, by, lane);
  }
}

// The level's 81 outputs from the table: table[ax * K1 + by] =
// <f1, f2_l(x0 + ax, y0 + by)>; channel i*K + j is the point
// (x + i - R, y + j - R): x on the outer index.
__device__ __forceinline__ void table_to_out(const float* table, float wx, float wy,
                                             float inv_sqrt_d, float* o, int lane) {
  for (int k = lane; k < K * K; k += 32) {
    const int i = k / K, j = k - i * K;
    const float t00 = table[i * K1 + j];
    const float t01 = table[(i + 1) * K1 + j];         // x + 1
    const float t10 = table[i * K1 + j + 1];           // y + 1
    const float t11 = table[(i + 1) * K1 + j + 1];
    o[k] = ((t00 * (1.0f - wx) + t01 * wx) * (1.0f - wy)
            + (t10 * (1.0f - wx) + t11 * wx) * wy) * inv_sqrt_d;
  }
}

// A pixel's window corner and bilinear fractions at level l.
struct Corner {
  int x0, y0;
  float wx, wy;
};

__device__ __forceinline__ Corner corner(float cx, float cy, int l, int Hl, int Wl) {
  const float s = 1.0f / (float)(1 << l);           // a power of two: exact
  const float lx = fminf(fmaxf(cx * s, -(float)(R + 2)), (float)(Wl - 1 + R + 2));
  const float ly = fminf(fmaxf(cy * s, -(float)(R + 2)), (float)(Hl - 1 + R + 2));
  const float fx = floorf(lx), fy = floorf(ly);
  Corner c;
  c.wx = lx - fx;
  c.wy = ly - fy;
  c.x0 = (int)fx - R;
  c.y0 = (int)fy - R;
  return c;
}

template <int VPL>
__device__ __forceinline__ void load_f1(const float* __restrict__ f1, long long pix, int lane,
                                        float (&a)[VPL]) {
  const float* p = f1 + (size_t)pix * (32 * VPL) + lane * VPL;
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

// 16-byte global -> shared copy; a false `valid` zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// ---------------------------------------------------------------------------
// band body
// ---------------------------------------------------------------------------

template <int VPL>
__global__ void __launch_bounds__(NWARP * 32, 2)
corr_lookup_kernel(const CorrDesc d, const float* __restrict__ f1, const float* __restrict__ coords,
                   float* __restrict__ out, long long total, int N, float inv_sqrt_d) {
  constexpr int D = 32 * VPL;
  __shared__ float table_s[NWARP][K1 * K1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pix = (long long)blockIdx.x * NWARP + warp;
  if (pix >= total) return;            // the whole warp leaves; only warp-level syncs below
  float* table = table_s[warp];
  const int b = (int)(pix / N);

  float a[VPL];
  load_f1<VPL>(f1, pix, lane, a);
  const float cx = __ldg(coords + 2 * (size_t)pix);
  const float cy = __ldg(coords + 2 * (size_t)pix + 1);
  float* o = out + (size_t)pix * d.n_levels * (K * K);

  for (int l = 0; l < d.n_levels; ++l) {
    const int Hl = d.H[l], Wl = d.W[l];
    const Corner c = corner(cx, cy, l, Hl, Wl);
    window_table<VPL, false>(d.f2[l] + (size_t)b * Hl * Wl * D, Hl, Wl, c.x0, c.y0, a, table,
                             lane);
    __syncwarp();
    table_to_out(table, c.wx, c.wy, inv_sqrt_d, o + l * (K * K), lane);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// shared body
// ---------------------------------------------------------------------------

template <int VPL>
__global__ void __launch_bounds__(NWARP * 32, 2)
corr_lookup_shared_kernel(const CorrDesc d, const float* __restrict__ f1,
                          const float* __restrict__ coords, float* __restrict__ out,
                          long long total, int N, float inv_sqrt_d, int* __restrict__ staged) {
  typedef typename Raw<VPL>::type raw_t;
  constexpr int D = 32 * VPL;
  constexpr int CHUNKS = D / 8;                      // 16-byte pieces of a position
  __shared__ float table_s[NWARP][K1 * K1];
  __shared__ __align__(16) bf16 rowbuf[2][SH_COLS * D];
  __shared__ int corner_s[2][NWARP][3];              // x0, y0, batch (-1: no pixel)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pix = (long long)blockIdx.x * NWARP + warp;
  const bool real = pix < total;       // no early exit: the block syncs below
  float* table = table_s[warp];
  const int b = real ? (int)(pix / N) : -1;

  float a[VPL];
  float cx = 0.0f, cy = 0.0f;
  if (real) {
    load_f1<VPL>(f1, pix, lane, a);
    cx = __ldg(coords + 2 * (size_t)pix);
    cy = __ldg(coords + 2 * (size_t)pix + 1);
  } else {
#pragma unroll
    for (int i = 0; i < VPL; ++i) a[i] = 0.0f;
  }
  float* o = out + (size_t)(real ? pix : 0) * d.n_levels * (K * K);

  for (int l = 0; l < d.n_levels; ++l) {
    const int Hl = d.H[l], Wl = d.W[l];
    const Corner c = corner(cx, cy, l, Hl, Wl);
    // the block's union window (corner_s alternates by level parity, so a
    // fast warp's next level never overwrites what a slow one still reads)
    int (*cs)[3] = corner_s[l & 1];
    if (lane == 0) {
      cs[warp][0] = c.x0;
      cs[warp][1] = c.y0;
      cs[warp][2] = b;
    }
    __syncthreads();
    int xmin = cs[0][0], xmax = xmin, ymin = cs[0][1], ymax = ymin;
    bool one = cs[0][2] >= 0;
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      xmin = min(xmin, cs[w][0]);
      xmax = max(xmax, cs[w][0]);
      ymin = min(ymin, cs[w][1]);
      ymax = max(ymax, cs[w][1]);
      one = one && cs[w][2] == cs[0][2];
    }
    const int rows = ymax - ymin + K1, cols = xmax - xmin + K1;
    const bool stage = one && rows <= SH_ROWS && cols <= SH_COLS;   // uniform in the block

    if (stage) {
      if (staged != nullptr && threadIdx.x == 0) atomicAdd(staged + l, 1);
      const bf16* base = d.f2[l] + (size_t)b * Hl * Wl * D;
      auto load_row = [&](int r, bf16* dst) {
        const int y = ymin + r;
        const bool y_in = (y >= 0) && (y < Hl);
        for (int idx = threadIdx.x; idx < cols * CHUNKS; idx += NWARP * 32) {
          const int col = idx / CHUNKS, piece = idx - col * CHUNKS;
          const int x = xmin + col;
          const bool in = y_in && (x >= 0) && (x < Wl);
          const bf16* src = in ? base + ((size_t)y * Wl + x) * D + piece * 8 : base;
          cp_async16(dst + col * D + piece * 8, src, in);
        }
        cp_async_commit();
      };
      load_row(0, rowbuf[0]);
      for (int r = 0; r < rows; ++r) {
        if (r + 1 < rows) {
          load_row(r + 1, rowbuf[(r + 1) & 1]);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int by = ymin + r - c.y0;
        if (real && by >= 0 && by < K1) {
          const bf16* row = rowbuf[r & 1] + (c.x0 - xmin) * D;
          raw_t q[K1];
#pragma unroll
          for (int ax = 0; ax < K1; ++ax)
            q[ax] = *(reinterpret_cast<const raw_t*>(row + ax * D) + lane);
          row_to_table<VPL>(q, a, table, by, lane);
        }
        __syncthreads();               // rowbuf[r & 1] is refilled with row r + 2
      }
    } else if (real) {
      window_table<VPL, false>(d.f2[l] + (size_t)b * Hl * Wl * D, Hl, Wl, c.x0, c.y0, a, table,
                               lane);
    }
    __syncwarp();
    if (real) table_to_out(table, c.wx, c.wy, inv_sqrt_d, o + l * (K * K), lane);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// resident body
// ---------------------------------------------------------------------------

// bytes of shared memory the resident body takes besides the levels
constexpr size_t RES_TABLE_BYTES = (size_t)NWARP_RES * K1 * K1 * sizeof(float);

__host__ __device__ inline size_t level_bytes(const CorrDesc& d, int l, int D) {
  return (size_t)d.H[l] * d.W[l] * D * sizeof(bf16);
}

template <int VPL>
__global__ void __launch_bounds__(NWARP_RES * 32, 1)
corr_lookup_resident_kernel(const CorrDesc d, const float* __restrict__ f1,
                            const float* __restrict__ coords, float* __restrict__ out, int N,
                            float inv_sqrt_d, unsigned resident, int tile_px) {
  constexpr int D = 32 * VPL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  float* table = reinterpret_cast<float*>(smem) + warp * (K1 * K1);

  // the resident levels of batch element b, whole, one after the other
  const bf16* lvl_s[CORR_MAX_LEVELS];
  size_t off = RES_TABLE_BYTES;
  for (int l = 0; l < d.n_levels; ++l) {
    lvl_s[l] = nullptr;
    if (!((resident >> l) & 1u)) continue;
    bf16* dst = reinterpret_cast<bf16*>(smem + off);
    const size_t n16 = level_bytes(d, l, D) / 16;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(d.f2[l] + (size_t)b * d.H[l] * d.W[l] * D);
    for (size_t i = threadIdx.x; i < n16; i += NWARP_RES * 32)
      cp_async16(reinterpret_cast<unsigned char*>(dst) + 16 * i, src + 16 * i, true);
    lvl_s[l] = dst;
    off += level_bytes(d, l, D);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int p0 = blockIdx.x * tile_px;
  const int p1 = min(N, p0 + tile_px);
  for (int p = p0 + warp; p < p1; p += NWARP_RES) {
    const long long pix = (long long)b * N + p;
    float a[VPL];
    load_f1<VPL>(f1, pix, lane, a);
    const float cx = __ldg(coords + 2 * (size_t)pix);
    const float cy = __ldg(coords + 2 * (size_t)pix + 1);
    float* o = out + (size_t)pix * d.n_levels * (K * K);
    for (int l = 0; l < d.n_levels; ++l) {
      const int Hl = d.H[l], Wl = d.W[l];
      const Corner c = corner(cx, cy, l, Hl, Wl);
      if (lvl_s[l] != nullptr)
        window_table<VPL, true>(lvl_s[l], Hl, Wl, c.x0, c.y0, a, table, lane);
      else
        window_table<VPL, false>(d.f2[l] + (size_t)b * Hl * Wl * D, Hl, Wl, c.x0, c.y0, a,
                                 table, lane);
      __syncwarp();
      table_to_out(table, c.wx, c.wy, inv_sqrt_d, o + l * (K * K), lane);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum Body { BAND = 0, SHARED = 1, RESIDENT = 2 };

template <int VPL>
int launch(int body, const CorrDesc& d, const float* f1, const float* coords, float* out, int B,
           int N, unsigned resident, int tile_px, int* staged, cudaStream_t stream) {
  constexpr int D = 32 * VPL;
  const long long total = (long long)B * N;
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  if (body == RESIDENT) {
    size_t bytes = RES_TABLE_BYTES;
    for (int l = 0; l < d.n_levels; ++l)
      if ((resident >> l) & 1u) bytes += level_bytes(d, l, D);
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(corr_lookup_resident_kernel<VPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((N + tile_px - 1) / tile_px), (unsigned)B);
    corr_lookup_resident_kernel<VPL><<<grid, NWARP_RES * 32, bytes, stream>>>(
        d, f1, coords, out, N, inv_sqrt_d, resident, tile_px);
    return (int)cudaGetLastError();
  }
  const unsigned grid = (unsigned)((total + NWARP - 1) / NWARP);
  if (body == SHARED)
    corr_lookup_shared_kernel<VPL><<<grid, NWARP * 32, 0, stream>>>(d, f1, coords, out, total, N,
                                                                     inv_sqrt_d, staged);
  else
    corr_lookup_kernel<VPL><<<grid, NWARP * 32, 0, stream>>>(d, f1, coords, out, total, N,
                                                             inv_sqrt_d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of a block's dynamic shared memory the resident body can give to
// levels on the current device (the opt-in maximum less its tables); < 0 on
// a CUDA error.
long long corr_resident_capacity(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return (long long)optin - (long long)RES_TABLE_BYTES;
}

// f1 (B, N, D) f32, coords (B, N, 2) f32, out (B, N, n_levels * 81) f32, the
// levels as CorrDesc says; D in {32, 64, 128, 256}, radius 4.  body: 0 band,
// 1 shared (staged: NULL or n_levels ints, each counting the blocks that
// staged their union window at that level), 2 resident (bit l of `resident`
// keeps level l in shared memory; a block covers `tile_px` pixels of one
// batch element).
int corr_lookup(const CorrDesc* d, const float* f1, const float* coords, float* out, int B, int N,
                int D, int radius, int body, unsigned resident, int tile_px, int* staged,
                void* stream) {
  if (!d || d->n_levels < 1 || d->n_levels > CORR_MAX_LEVELS || radius != R || B < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  if (body < BAND || body > RESIDENT || (body == RESIDENT && (tile_px < 1 || B > 65535)))
    return (int)cudaErrorInvalidValue;
  if (((long long)B * N + NWARP - 1) / NWARP > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<1>(body, *d, f1, coords, out, B, N, resident, tile_px, staged, s);
    case 64: return launch<2>(body, *d, f1, coords, out, B, N, resident, tile_px, staged, s);
    case 128: return launch<4>(body, *d, f1, coords, out, B, N, resident, tile_px, staged, s);
    case 256: return launch<8>(body, *d, f1, coords, out, B, N, resident, tile_px, staged, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
