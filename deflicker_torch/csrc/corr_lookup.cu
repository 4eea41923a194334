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
// products of f1(p) with f2_l at integer positions (a pixel's "table"), then
// 81 four-term combinations; contracting over D before interpolating is legal
// because both are linear.
//
// Bound on the H100.  At the flow engine's shape (B = 8, 54 x 96 pixels,
// D = 256, 4 levels) the function must move f1 (42.5 MB), the bf16 pyramid
// (28.1 MB), the coords and the output (53.7 MB): 0.037 ms at 3.35 TB/s.
// Its dots are exact on tensor cores: f2 is bf16, and f32 f1 is the sum of
// three bf16 terms (t0 = bf16(f), t1 = bf16(f - t0), t2 = bf16(f - t0 - t1))
// whose products with bf16 values are exact in f32.  The ~6.3 GFLOP of
// needed dots at +-3 px, three times over, take 0.019 ms at 989 TFLOP/s; so
// bytes bound the function.
//
// Band body (row 5, the default; replaces `_lookup_level`, TPU kernel
// corr_kernel.py:616; also the route of a shared or resident tile whose
// union window cannot stage).  One warp owns one pixel, and each of its
// windows is one tensor-core product: mma.sync m16n8k16, bf16 -> f32.
//   * A: the window's positions m = by K1 + ax (y outer), 8 an M-tile (MT =
//     13 of them, two at a time), each position as two rows, its channel
//     halves, raw bf16 as stored.  A lane's 16-byte ld.global.nc reads 8
//     channels of one half for two k-steps (the channel order pi,
//     `band_channels` in ops/cuda/corr_kernel.py; the contraction does not
//     depend on the order), and the 8 lanes of a quarter-warp read one
//     whole 128-byte line of one position.  A position outside the level is
//     predicated off; a pair of M-tiles with no position inside (a
//     warp-uniform vote) issues no load and no product, so the work follows
//     the needed dots (`band_pairs` and `band_live_pairs` mirror the layout
//     and the rule).
//   * B: f1(p)'s three bf16 terms (t0 = bf16(f), t1 = bf16(f - t0), t2 =
//     bf16(f - t0 - t1): all 24 bits, every product exact in f32) of half
//     0's channels in columns 0-2 and of half 1's in columns 5-7, the same
//     pi; columns 3-4 zero.  Built once a pixel, kept in registers across
//     the levels (D / 16 a lane).
//   * A table entry is columns 0-2 of the position's half-0 row plus
//     columns 5-7 of its half-1 row, held by four lanes and joined by two
//     shuffles into the warp's 10 x 10 table in shared memory; then the
//     lanes write the 81 outputs.  Two M-tiles go together, two chains of
//     products a warp.
//   * What the layout weighs (tools/corr_variants.py, PERF.md): a row a
//     position, whose 16-byte loads are each one product's A fragments as
//     they lie, runs fewer instructions, but each quarter-warp then reads 64
//     bytes of each of two positions, two L1 lines a request, and its loads
//     cost twice as much; here the loads take one line a quarter-warp and
//     the fragments cost register moves (three bf16 terms leave room in the
//     8 columns for two row kinds only).
// Bound now: not one part.  The loop's instruction issue (fragment moves,
// index arithmetic, the join), the window bytes each pixel reads through L1
// (needed dots x 2 D: 6.2 GB at +-3 px at the engine's shape, ~0.2 ms at
// 128 B a clock an SM) and the products each take a comparable share and
// overlap little (tools/corr_variants.py takes them out one at a time;
// PERF.md has the times).  The CUDA-core design it replaces was bound by its
// issue alone (unpacking, 80 FMAs and a 16-value shuffle butterfly a window
// row, whatever the data).  Block: 8 warps on 8 raster-consecutive pixels.

// Shared and resident bodies (rows 6 and 7): one kernel, corr_lookup_tc_kernel,
// whose window products run as wgmma on the tensor cores.
//   * Tile: 64 pixels, an 8 x 8 square of one batch element's grid (pixels
//     past the ragged edge masked).  A block is two consumer warpgroups and
//     one producer warp, persistent over a run of tiles of one batch element.
//   * Operand A: the tile's f1 rows as TERMS bf16 terms (above), K-major in
//     shared memory with the 128-byte swizzle, 64 channels an atom, shared by
//     both consumer warpgroups.  TERMS = 2: the products keep 16 of f1's 24
//     bits (at most 2^-17 relative a product); on the H100 at the engine's
//     shape the output is within 2.5e-6 relative Frobenius (max abs 1.2e-5 of
//     4.4) of the plain twin, and three terms (all 24 bits: 9.6e-7, 6.4e-6)
//     took 0.25 ms instead of 0.21 (tools/corr_variants.py).  The tensor
//     cores' own f32 sums bound the error either way.
//   * Operand B, staged (shared mode, and resident mode's other levels): the
//     tile's union window at level l, [xmin, xmax + 10) x [ymin, ymax + 10)
//     over the 64 corners, cut into blocks of 8 x 8 positions, two blocks a
//     group of 128 positions (wgmma's N); each group's 64-channel chunks come
//     by TMA from a 4-D map of the level (D, W_l, H_l, B), box (64, 8, 8, 1),
//     128-byte swizzle.  Group g goes to consumer warpgroup g % 2, whose own
//     ring of full/empty mbarriers (RING stages of a chunk) is fed by its own
//     lane of the producer warp, so each ring is taken in order by one
//     consumer.  TMA reads zero at every coordinate outside the tensor,
//     negative ones too: the lookup's zero outside the level, with no bounds
//     test.  A union of at most ENV x ENV blocks stages (at the engine's
//     shape every tile at +-0.5 and +-3 px); a larger one (motion boundaries,
//     scattered flow) sends the tile's pixels through the band body's
//     per-pixel window products for that level (consumer warp W its 8
//     pixels, two at a time), by design and counted (`staged`), never on a
//     failure.
//   * Operand B, resident (resident mode): the levels the caller marks are
//     copied whole, batch element b's slice, once per block by TMA (a 3-D map
//     (D, H_l W_l, B), box (64, 8, 1)) into shared memory in the same layout,
//     positions in raster order; the tile's products then run against every
//     position of the level, 128 at a time, which holds at any flow scatter.
//   * Products: wgmma m64n128k16, bf16 -> f32, per group the chunks of D in
//     order and in each the terms in order: the same chain for a (pixel,
//     position) pair whichever operand holds the position, so staged and
//     resident results are bit-equal.  The two consumer warpgroups take
//     alternate groups, so one's selection runs under the other's products
//     (one warpgroup with two accumulators does not: ptxas serializes wgmma
//     when an accumulator is read while products are in flight).
//   * Select-then-combine epilogue: each thread walks its accumulator
//     fragments and writes entry (pixel m, position n) into m's table when n
//     lies in m's window; then the band body's combination writes the 81
//     outputs a level, consumer warp W for pixels 8W .. 8W + 7.
// Shared memory at D = 256: A 65,536 B, the rings 6 x 16,384, the tables
// 25,600, and what is left of the 227 KB (corr_resident_capacity) for
// resident levels (level 3 alone at the engine's shape).  D = 32 rows are 64
// bytes, below the swizzle's 128: such shared and resident launches take the
// band body, whose products run on the tensor cores at every D (one k-step
// an M-tile at D = 32, eight at D = 256).
//
// Interface: plain C, loaded with ctypes; every launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError() (or the error of
// a tensor map or shared-memory set-up that failed: no other route is taken).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

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
constexpr int MT = (K1 * K1 + 7) / 8;   // band products: M-tiles of 8 window positions
constexpr int NWARP = 8;          // band body: warps (pixels) a block
constexpr unsigned FULL = 0xffffffffu;

typedef __nv_bfloat16 bf16;

// c += A B on the tensor cores: A 16 x 16 (row-major fragments a0..a3), B
// 16 x 8 (column-major fragments b0, b1), bf16 operands, f32 sums.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The band products' layout at channel width D.  An M-tile is 8 window
// positions, each as two rows of A, its channel halves: half h holds
// channels 64w + 32h + [0, 32) for w < D / 64 (at D = 32: 16h + [0, 16)).
// Lane t of a row reads CPL of them from channel chan(w, h, t) with one
// 16-byte (8-byte) load, so the 8 lanes of a quarter-warp, which hold the
// two halves of one position, read one whole 128-byte line of it; a load's
// words feed k-steps 2w (the first two) and 2w + 1 (the last two) at
// contraction rows 2t, 2t + 1, 2t + 8, 2t + 9 (the channel order pi,
// `band_channels` in ops/cuda/corr_kernel.py).
template <int D> struct Band {
  static constexpr int NW = D >= 64 ? D / 64 : 1;   // loads a row a lane
  static constexpr int CPL = D >= 64 ? 8 : 4;       // channels a load
  typedef typename std::conditional<(D >= 64), uint4, uint2>::type raw_t;
  __device__ static int chan(int w, int h, int t) {
    return D >= 64 ? 64 * w + 32 * h + 8 * t : 16 * h + 4 * t;
  }
};

// word i of a load (i a constant after unrolling)
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(const uint2& v, int i) { return i == 0 ? v.x : v.y; }

// B fragments of one pixel's window products (f1row: its D floats; none
// read where `on` is false, and the fragments are zero): the three bf16
// terms of f1 (t0 = bf16(f), t1 = bf16(f - t0), t2 = bf16(f - t0 - t1):
// all 24 bits, so every product with a bf16 value is exact in f32) of half
// 0's channels in columns 0, 1, 2 and of half 1's in columns 5, 6, 7;
// columns 3 and 4 zero.  Lane (g, t) holds column g at contraction rows
// 2t, 2t + 1 (fragment 0) and 2t + 8, 2t + 9 (fragment 1): bf[w][2v + i]
// is fragment i of k-step 2w + v, channels chan(w, h, t) + 4v + 2i + {0, 1}.
template <int D>
__device__ __forceinline__ void f1_fragments(const float* __restrict__ f1row, bool on, int lane,
                                             uint32_t (&bf)[Band<D>::NW][4]) {
  typedef Band<D> L;
  const int g = lane >> 2, t = lane & 3, h = g >= 5, term = h ? g - 5 : g;
  on = on && (g < 3 || g >= 5);
#pragma unroll
  for (int w = 0; w < L::NW; ++w) {
    float f[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (on) {
      const float4* src = reinterpret_cast<const float4*>(f1row + L::chan(w, h, t));
#pragma unroll
      for (int i = 0; i < L::CPL / 4; ++i) {
        const float4 v = __ldg(src + i);
        f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z; f[4 * i + 3] = v.w;
      }
    }
    bf16 x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bf16 t0 = __float2bfloat16_rn(f[e]);
      const float r0 = f[e] - __bfloat162float(t0);     // exact
      const bf16 t1 = __float2bfloat16_rn(r0);
      const bf16 t2 = __float2bfloat16_rn(r0 - __bfloat162float(t1));
      x[e] = term == 0 ? t0 : (term == 1 ? t1 : t2);     // columns 3, 4: f = 0
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) bf[w][i] = pack_bf16(x[2 * i], x[2 * i + 1]);
  }
}

// NP pixels' 10 x 10 tables at one level, table[n][ax * K1 + by] =
// <f1_n, f2_l(x0[n] + ax, y0[n] + by)> (base: batch element b's slice of
// the level), as up to MT products each.  M-tile j holds window positions
// m = 8j .. 8j + 7 (m = by K1 + ax); rows 2p and 2p + 1 are the halves of
// position 8j + p, rows 8 + 2p and 9 + 2p those of 8j + 4 + p (p < 4).  So
// lane (g, t) loads half g & 1 of positions g / 2 + 4k.  Each step takes
// two M-tiles, two chains of products a warp: the next two of one pixel
// (NP = 1, the band body) or the next one of each of two pixels (NP = 2,
// the unstaged tiles of the shared and resident bodies, whose warps are
// fewer).  A load outside the level is predicated off (its row then holds
// what an earlier load left, and the table entry is written zero); a step
// with no position inside (a warp-uniform vote) issues no load and no
// product.  A position's dot is columns 0-2 of its half-0 row plus columns
// 5-7 of its half-1 row; as columns 3 and 4 are zero, every lane adds its
// two columns, and lanes 8p, 8p + 1 (columns 0-3) and 8p + 6, 8p + 7
// (columns 4-7) are joined by two shuffles.
template <int D, int NP>
__device__ __forceinline__ void window_products(const bf16* __restrict__ base, int Hl, int Wl,
                                                const int (&x0)[NP], const int (&y0)[NP],
                                                const uint32_t (&bf)[NP][Band<D>::NW][4],
                                                float* const (&table)[NP], int lane) {
  typedef Band<D> L;
  typedef typename L::raw_t raw_t;
  constexpr int ROWS = 4, RP = ROWS / NP;                  // rows of the lane a step, a pixel
  constexpr int POS = D * 2 / (int)sizeof(raw_t);          // raw_t a position
  constexpr int STEP = 128 / (int)sizeof(raw_t);           // raw_t from load w to w + 1
  const int g = lane >> 2, t = lane & 3;
  const raw_t* lane_base = reinterpret_cast<const raw_t*>(base + L::chan(0, g & 1, t));
  raw_t q[ROWS][L::NW];
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
#pragma unroll
    for (int w = 0; w < L::NW; ++w) q[k][w] = raw_t();
  int m = g >> 1, ax = m, by = 0;       // the lane's next position, m = by K1 + ax
#pragma unroll 1
  for (int i = 0; i < (MT * 8 + 4 * RP - 1) / (4 * RP); ++i) {
    bool in[ROWS];
    int cell[ROWS];
    const raw_t* src[ROWS];
#pragma unroll
    for (int j = 0; j < RP; ++j) {
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const int k = n * RP + j, x = x0[n] + ax, y = y0[n] + by;
        in[k] = m < K1 * K1 && (unsigned)x < (unsigned)Wl && (unsigned)y < (unsigned)Hl;
        cell[k] = m < K1 * K1 ? ax * K1 + by : -1;
        src[k] = lane_base + (ptrdiff_t)(y * Wl + x) * POS;
      }
      m += 4;
      ax += 4;
      if (ax >= K1) {
        ax -= K1;
        ++by;
      }
    }
    float c[2][4];                       // [tile]
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[u][e] = 0.0f;
    if (__any_sync(FULL, in[0] || in[1] || in[2] || in[3])) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (in[k]) {
#pragma unroll
          for (int w = 0; w < L::NW; ++w) q[k][w] = __ldg(src[k] + STEP * w);
        }
#pragma unroll
      for (int w = 0; w < L::NW; ++w)
#pragma unroll
        for (int v = 0; v < L::CPL / 4; ++v)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mma16816(c[u], word(q[2 * u][w], 2 * v), word(q[2 * u + 1][w], 2 * v),
                     word(q[2 * u][w], 2 * v + 1), word(q[2 * u + 1][w], 2 * v + 1),
                     bf[2 * u / RP][w][2 * v], bf[2 * u / RP][w][2 * v + 1]);
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      // row k of the lane: tile k / 2, fragment row g (k even) or g + 8
      const float mine = c[k / 2][2 * (k % 2)] + c[k / 2][2 * (k % 2) + 1];
      const float half = mine + __shfl_xor_sync(FULL, mine, 1);
      const float tot = half + __shfl_xor_sync(FULL, half, 6);
      if ((lane & 7) == 0 && cell[k] >= 0) table[k / RP][cell[k]] = in[k] ? tot : 0.0f;
    }
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

// ---------------------------------------------------------------------------
// band body
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NWARP * 32, 2)
corr_lookup_kernel(const CorrDesc d, const float* __restrict__ f1, const float* __restrict__ coords,
                   float* __restrict__ out, long long total, int N, float inv_sqrt_d) {
  __shared__ float table_s[NWARP][K1 * K1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pix = (long long)blockIdx.x * NWARP + warp;
  if (pix >= total) return;            // the whole warp leaves; only warp-level syncs below
  float* table = table_s[warp];
  const int b = (int)(pix / N);

  uint32_t bf[1][Band<D>::NW][4];
  f1_fragments<D>(f1 + (size_t)pix * D, true, lane, bf[0]);
  const float cx = __ldg(coords + 2 * (size_t)pix);
  const float cy = __ldg(coords + 2 * (size_t)pix + 1);
  float* o = out + (size_t)pix * d.n_levels * (K * K);

  for (int l = 0; l < d.n_levels; ++l) {
    const int Hl = d.H[l], Wl = d.W[l];
    const Corner c = corner(cx, cy, l, Hl, Wl);
    const int x0[1] = {c.x0}, y0[1] = {c.y0};
    float* const tab[1] = {table};
    window_products<D, 1>(d.f2[l] + (size_t)b * Hl * Wl * D, Hl, Wl, x0, y0, bf, tab, lane);
    __syncwarp();
    table_to_out(table, c.wx, c.wy, inv_sqrt_d, o + l * (K * K), lane);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// shared and resident bodies: window products on tensor cores
// ---------------------------------------------------------------------------

constexpr int TILE = 8;                       // a tile: TILE x TILE pixels
constexpr int NCWG = 2;                       // consumer warpgroups
constexpr int NCT = NCWG * 128;               // consumer threads
constexpr int TC_THREADS = NCT + 32;          // consumers, then the producer warp
constexpr int TP = TILE * TILE;               // 64 pixels: wgmma's M
constexpr int TERMS = 2;                      // bf16 terms of f1 (16 of its 24 bits)
constexpr int BLK = 8;                        // a staged block: BLK x BLK positions
constexpr int ENV = 4;                        // staging envelope: ENV x ENV blocks
constexpr int RING = 3;                       // stages of a consumer warpgroup's ring
constexpr int TC_STAGES = NCWG * RING;        // a stage: a 64-channel chunk of two blocks
constexpr int ATOM = 64 * 128;                // 64 rows x 64 bf16 channels, 128-byte swizzle
constexpr int GROUP = 128;                    // positions a product: wgmma's N, two blocks
constexpr int STAGE_BYTES = 2 * ATOM;
constexpr int TC_TABLES = TP * K1 * K1 * 4;   // the tile's tables
constexpr int TC_BARS = 256;                  // mbarriers

static_assert(RING >= 2, "a stage is freed once the chunk after it is issued");

// what a (tile, level) takes: no products (an empty level), the resident
// level's positions, the staged union window, or the band body's route
enum Kind { K_EMPTY = 0, K_RESIDENT = 1, K_STAGED = 2, K_CORE = 3 };

struct TcParams {
  CUtensorMap win[CORR_MAX_LEVELS];  // level l as (D, W_l, H_l, B), box (64, 8, 8, 1)
  CUtensorMap res[CORR_MAX_LEVELS];  // resident level l as (D, H_l W_l, B), box (64, 8, 1)
  CorrDesc d;
  const float* f1;
  const float* coords;
  float* out;
  int* staged;                        // NULL or n_levels counters of staged tiles
  int N, H, W, tiles_x, ntiles, tiles_per_block;
  unsigned resident;                  // bit l: level l is resident
  float inv_sqrt_d;
  int res_rows[CORR_MAX_LEVELS];      // resident level l: positions rounded up to 8
  unsigned res_off[CORR_MAX_LEVELS];  // its byte offset in the resident region
  unsigned res_bytes;                 // the resident region's bytes
};

// Shared memory from a 1,024-aligned base: A (TERMS x D/64 atoms), the rings,
// the resident levels, the tables (which also absorb the reads of a last
// resident group past its level's rows), the barriers.
__host__ __device__ constexpr size_t tc_a_bytes(int D) { return (size_t)TERMS * (D / 64) * ATOM; }
__host__ __device__ constexpr size_t tc_fixed_bytes(int D) {
  return tc_a_bytes(D) + (size_t)TC_STAGES * STAGE_BYTES + TC_TABLES + TC_BARS + 1024;
}

// A lane's two pixels of a tile, r = lane and lane + 32 (r = 8 y + x)
struct TilePix {
  float cx[2], cy[2];
  bool in[2];
};

__device__ __forceinline__ void tile_origin(const TcParams& p, int tile, int& gx0, int& gy0) {
  const int ty = tile / p.tiles_x;
  gx0 = (tile - ty * p.tiles_x) * TILE;
  gy0 = ty * TILE;
}

__device__ __forceinline__ void load_tile(const TcParams& p, int b, int tile, int lane,
                                          TilePix& t) {
  int gx0, gy0;
  tile_origin(p, tile, gx0, gy0);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = lane + 32 * s, gx = gx0 + (r & 7), gy = gy0 + (r >> 3);
    t.in[s] = gx < p.W && gy < p.H;
    const size_t pix = (size_t)b * p.N + (size_t)gy * p.W + gx;
    t.cx[s] = t.in[s] ? __ldg(p.coords + 2 * pix) : 0.0f;
    t.cy[s] = t.in[s] ? __ldg(p.coords + 2 * pix + 1) : 0.0f;
  }
}

struct Plan {
  int kind, xmin, ymin, nbx, nby;
};

// The (tile, level) plan, computed alike by every warp of the block (the
// whole warp calls it).  x0, y0: the corners of the lane's two pixels, a
// far sentinel for a masked pixel so that no position falls in its window.
__device__ __forceinline__ Plan plan_level(const TcParams& p, int l, const TilePix& t,
                                           int (&x0)[2], int (&y0)[2]) {
  const int Hl = p.d.H[l], Wl = p.d.W[l];
  int lo_x = INT_MAX, hi_x = INT_MIN, lo_y = INT_MAX, hi_y = INT_MIN;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    x0[s] = y0[s] = -(1 << 28);
    if (t.in[s]) {
      const Corner c = corner(t.cx[s], t.cy[s], l, Hl, Wl);
      x0[s] = c.x0;
      y0[s] = c.y0;
      lo_x = min(lo_x, c.x0);
      hi_x = max(hi_x, c.x0);
      lo_y = min(lo_y, c.y0);
      hi_y = max(hi_y, c.y0);
    }
  }
  const int xmin = __reduce_min_sync(FULL, lo_x), ymin = __reduce_min_sync(FULL, lo_y);
  const int xmax = __reduce_max_sync(FULL, hi_x), ymax = __reduce_max_sync(FULL, hi_y);
  const int nbx = (xmax - xmin + K1 + BLK - 1) / BLK, nby = (ymax - ymin + K1 + BLK - 1) / BLK;
  int kind;
  if (Hl < 1 || Wl < 1)
    kind = K_EMPTY;
  else if ((p.resident >> l) & 1u)
    kind = K_RESIDENT;
  else
    kind = (nbx <= ENV && nby <= ENV) ? K_STAGED : K_CORE;
  // read through shuffles, so that the compiler knows the plan is the same
  // across the warp: wgmma under branches and loops on it is then not taken
  // for divergent code (which ptxas serializes)
  Plan q;
  q.kind = __shfl_sync(FULL, kind, 0);
  q.xmin = __shfl_sync(FULL, xmin, 0);
  q.ymin = __shfl_sync(FULL, ymin, 0);
  q.nbx = __shfl_sync(FULL, nbx, 0);
  q.nby = __shfl_sync(FULL, nby, 0);
  return q;
}

// Producer warp: the resident levels once, then every staged block's
// 64-channel chunks of every tile, in the order the consumers take them.
template <int KC>
__device__ __forceinline__ void tc_produce(const TcParams& p, unsigned char* ring,
                                           unsigned char* res, uint64_t* full, uint64_t* empty,
                                           uint64_t* res_bar, int b, int t0, int t1, int lane) {
  using namespace hopper;
  if (p.resident != 0u && lane == 0) {
    mbar_arrive_expect_tx(res_bar, p.res_bytes);
    for (int l = 0; l < p.d.n_levels; ++l) {
      if (!((p.resident >> l) & 1u)) continue;
      const int rows = p.res_rows[l];
      for (int kc = 0; kc < KC; ++kc)
        for (int i = 0; i < rows; i += 8)
          tma_load_3d(res + p.res_off[l] + ((size_t)kc * rows + i) * 128, &p.res[l], res_bar,
                      64 * kc, i, b);
    }
  }
  // lane w < NCWG feeds the ring of consumer warpgroup w: group g of a
  // level (blocks 2g, 2g + 1) goes to warpgroup g % NCWG; a lane's units
  // (chunks) are counted in `it` in the order that warpgroup takes them
  int it = 0;
  for (int tile = t0; tile < t1; ++tile) {
    TilePix tp;
    load_tile(p, b, tile, lane, tp);
    for (int l = 0; l < p.d.n_levels; ++l) {
      int x0[2], y0[2];
      const Plan q = plan_level(p, l, tp, x0, y0);
      if (q.kind != K_STAGED) continue;
      const int nblk = q.nbx * q.nby;
      if (lane < NCWG) {
        for (int g = lane; 2 * g < nblk; g += NCWG) {
          const int j = 2 * g, nbox = j + 1 < nblk ? 2 : 1;
          for (int kc = 0; kc < KC; ++kc, ++it) {
            const int stage = lane * RING + it % RING;
            unsigned char* dst = ring + stage * STAGE_BYTES;
            mbar_wait(empty + stage, ((it / RING) & 1) ^ 1);
            mbar_arrive_expect_tx(full + stage, nbox * ATOM);
            for (int u = 0; u < nbox; ++u) {
              const int by = (j + u) / q.nbx;
              tma_load_4d(dst + u * ATOM, &p.win[l], full + stage, 64 * kc,
                          q.xmin + BLK * (j + u - by * q.nbx), q.ymin + BLK * by, b);
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// The tile's f1 rows as TERMS bf16 terms into A: atom (term t, chunk kc) at
// A + (t KC + kc) ATOM, rows the tile's pixels, K-major, 128-byte swizzle;
// masked pixels are zero.  Each float4 of a row is read once (16 bytes a
// thread, a row's float4s on neighbouring threads).
template <int D>
__device__ __forceinline__ void write_a(const TcParams& p, unsigned char* A, int b, int tile,
                                        int lt) {
  using namespace hopper;
  constexpr int KC = D / 64, C4 = D / 4;
  int gx0, gy0;
  tile_origin(p, tile, gx0, gy0);
  constexpr int PRO = 4;  // float4 loads in flight a thread (TP * C4 / NCT in all)
  static_assert((TP * C4 / NCT) % PRO == 0, "whole batches of loads");
  for (int base = lt; base < TP * C4; base += NCT * PRO) {
    float4 v[PRO];
#pragma unroll
    for (int u = 0; u < PRO; ++u) {
      const int idx = base + NCT * u, r = idx / C4, c = 4 * (idx - r * C4);
      const int gx = gx0 + (r & 7), gy = gy0 + (r >> 3);
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gx < p.W && gy < p.H)
        v[u] = __ldg(reinterpret_cast<const float4*>(
            p.f1 + ((size_t)b * p.N + (size_t)gy * p.W + gx) * D + c));
    }
#pragma unroll
    for (int u = 0; u < PRO; ++u) {
      const int idx = base + NCT * u, r = idx / C4, c = 4 * (idx - r * C4);
      float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      unsigned char* dst = A + (c >> 6) * ATOM + sw128_offset(r, c & 63);
#pragma unroll
      for (int t = 0; t < TERMS; ++t) {
        bf16 h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = __float2bfloat16_rn(f[e]);
          f[e] -= __bfloat162float(h[e]);  // exact: what the next term carries
        }
        uint2 pk;
        memcpy(&pk, h, 8);
        *reinterpret_cast<uint2*>(dst + (size_t)t * KC * ATOM) = pk;
      }
    }
  }
}

// Select: fragment entry (row m, column n) of group g into pixel m's table
// when position n lies in m's window.  rx, ry: the corners of the thread's
// rows m = 16 wl + lane/4 + 8 h; its columns are n = 8 j + 2 (lane % 4) + e.
// Staged: column 64 u + 8 y + x is (x, y) of block 2 g + u, so a thread's
// x is fixed per (u, e) and the window test on x is made once for its 8 y.
// Resident: column n is position 128 g + n of the level in raster order.
template <bool STAGED>
__device__ __forceinline__ void select_group(float (&acc)[64], const Plan& q, int Wl, int P,
                                             const int (&rx)[2], const int (&ry)[2],
                                             float* tables, int g, int lt) {
  hopper::fence_acc(acc);
  const int lane = lt & 31, t4 = lane & 3, m0 = (lt >> 5) * 16 + (lane >> 2);
  if constexpr (STAGED) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int blk = 2 * g + u, by0 = blk / q.nbx;
      if (blk >= q.nbx * q.nby) continue;
      const int ox = q.xmin + BLK * (blk - by0 * q.nbx), oy = q.ymin + BLK * by0;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ax = ox + 2 * t4 + e - rx[h], d = oy - ry[h];  // window row by = y + d
          if ((unsigned)ax >= (unsigned)K1) continue;
          float* col = tables + (m0 + 8 * h) * (K1 * K1) + ax * K1 + d;
#pragma unroll
          for (int y = 0; y < BLK; ++y)
            if ((unsigned)(y + d) < (unsigned)K1) col[y] = acc[4 * (8 * u + y) + 2 * h + e];
        }
    }
  } else {
#pragma unroll
    for (int j = 0; j < GROUP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = GROUP * g + 8 * j + 2 * t4 + e;
        const int py = pos / Wl, px = pos - py * Wl;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ax = px - rx[h], by = py - ry[h];
          if (pos < P && (unsigned)ax < (unsigned)K1 && (unsigned)by < (unsigned)K1)
            tables[(m0 + 8 * h) * (K1 * K1) + ax * K1 + by] = acc[4 * j + 2 * h + e];
        }
      }
  }
}

// Warpgroup wg's groups of a (tile, level): g = wg, wg + NCWG, ..., so that
// one warpgroup's selection runs under the other's products.  Group g's
// products go into acc, one commit group a 64-channel chunk (chunks in
// order, in each the terms in order).  Staged: the warpgroup's own ring
// holds its chunks in order (`it` counts them); once a chunk is issued the
// one before it is waited for and its stage freed, so the ring refills under
// the products.  Resident: the chunk is rows [128 g, 128 g + 128) of the
// level region's chunk kc (`rows` rows a chunk).  The selection reads acc
// after the last wait: ptxas serializes wgmma when other instructions read
// an accumulator while products are in flight.
template <int KC, bool STAGED>
__device__ __forceinline__ void level_products(const Plan& q, int Wl, int P, const unsigned char* A,
                                               const unsigned char* src, int rows, uint64_t* full,
                                               uint64_t* empty, int& it, const int (&rx)[2],
                                               const int (&ry)[2], float* tables, int wg, int lt) {
  using namespace hopper;
  const int ngrp = STAGED ? (q.nbx * q.nby + 1) / 2 : (P + GROUP - 1) / GROUP;
  float acc[64];
  for (int g = wg; g < ngrp; g += NCWG) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    fence_acc(acc);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const unsigned char* bsrc;
      if constexpr (STAGED) {
        const int u = it + kc, stage = wg * RING + u % RING;
        mbar_wait(full + stage, (u / RING) & 1);
        bsrc = src + stage * STAGE_BYTES;
      } else {
        bsrc = src + ((size_t)kc * rows + GROUP * g) * 128;
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < TERMS; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n128<0, 0>(acc, sw128_desc(A + (t * KC + kc) * ATOM + 32 * k, 16, 1024),
                              sw128_desc(bsrc + 32 * k, 16, 1024));
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();
        if (STAGED && lt == 0) mbar_arrive(empty + wg * RING + (it + kc - 1) % RING);
      }
    }
    wgmma_wait<0>();
    if (STAGED) {
      if (lt == 0) mbar_arrive(empty + wg * RING + (it + KC - 1) % RING);
      it += KC;
    }
    select_group<STAGED>(acc, q, Wl, P, rx, ry, tables, g, lt);
  }
}

// Consumer warpgroups: per tile, A; per level, the tables by the plan's
// route, then the 81 outputs of each real pixel.  Fragment rows: warp wl of
// either warpgroup holds pixels 16 wl .. 16 wl + 15 of each of its groups;
// output, zeroing and the band route: consumer warp W owns pixels 8 W ..
// 8 W + 7 and their tables.  Two barriers a level order the tables' uses.
template <int D>
__device__ __forceinline__ void tc_consume(const TcParams& p, unsigned char* A,
                                           const unsigned char* ring, const unsigned char* res,
                                           float* tables, uint64_t* full, uint64_t* empty,
                                           uint64_t* res_bar, int b, int t0, int t1, int wg) {
  using namespace hopper;
  constexpr int KC = D / 64;
  const int lt = threadIdx.x, wlt = lt & 127, wl = wlt >> 5, W = lt >> 5, lane = lt & 31;
  const int L = p.d.n_levels;
  float* wtab = tables + 8 * W * (K1 * K1);
  if (p.resident != 0u) mbar_wait(res_bar, 0);
  int it = 0;
  for (int tile = t0; tile < t1; ++tile) {
    TilePix tp;
    load_tile(p, b, tile, lane, tp);
    // the last level's barriers ordered every product of the last tile
    // before this point: A is free
    write_a<D>(p, A, b, tile, lt);
    fence_async_smem();
    named_sync(1, NCT);
    int gx0, gy0;
    tile_origin(p, tile, gx0, gy0);
    for (int l = 0; l < L; ++l) {
      const int Hl = p.d.H[l], Wl = p.d.W[l];
      int x0[2], y0[2];
      const Plan q = plan_level(p, l, tp, x0, y0);
      // corners of this thread's fragment rows (slot: uniform in the warp)
      int rx[2], ry[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wl + (lane >> 2) + 8 * h;
        rx[h] = __shfl_sync(FULL, (r >> 5) ? x0[1] : x0[0], r & 31);
        ry[h] = __shfl_sync(FULL, (r >> 5) ? y0[1] : y0[0], r & 31);
      }
      // a staged union and the band route write every entry of a real
      // pixel's table; a resident level writes only positions inside it,
      // an empty level none: zeros first
      if (q.kind == K_RESIDENT || q.kind == K_EMPTY)
        for (int i = lane; i < 8 * K1 * K1; i += 32) wtab[i] = 0.0f;
      named_sync(1, NCT);  // the last level's outputs have read the tables
      if (q.kind == K_STAGED) {
        if (lt == 0 && p.staged != nullptr) atomicAdd(p.staged + l, 1);
        level_products<KC, true>(q, Wl, Hl * Wl, A, ring, 0, full, empty, it, rx, ry, tables,
                                 wg, wlt);
      } else if (q.kind == K_RESIDENT) {
        level_products<KC, false>(q, Wl, Hl * Wl, A, res + p.res_off[l], p.res_rows[l], full,
                                  empty, it, rx, ry, tables, wg, wlt);
      } else if (q.kind == K_CORE) {
        // the band body's window products, two of the warp's pixels at a
        // time (a masked pixel's corner lies outside the level: its table,
        // never read, is written zero)
        const bf16* base = p.d.f2[l] + (size_t)b * Hl * Wl * D;
        for (int i = 0; i < 8; i += 2) {
          uint32_t bf[2][Band<D>::NW][4];
          int cx0[2], cy0[2];
          float* const tab[2] = {wtab + i * (K1 * K1), wtab + (i + 1) * (K1 * K1)};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = 8 * W + i + u, gx = gx0 + (r & 7), gy = gy0 + (r >> 3);
            const bool real = gx < p.W && gy < p.H;
            const size_t pix = (size_t)b * p.N + (size_t)gy * p.W + gx;
            f1_fragments<D>(p.f1 + pix * D, real, lane, bf[u]);
            cx0[u] = cy0[u] = -2 * K1;
            if (real) {
              const Corner c = corner(__ldg(p.coords + 2 * pix), __ldg(p.coords + 2 * pix + 1),
                                      l, Hl, Wl);
              cx0[u] = c.x0;
              cy0[u] = c.y0;
            }
          }
          window_products<D, 2>(base, Hl, Wl, cx0, cy0, bf, tab, lane);
        }
      }
      named_sync(1, NCT);  // every table of the tile is whole
      // the 81 outputs of each of the warp's real pixels; lane i (and
      // i + 8, ...) holds the bilinear weights of pixel 8 W + i
      const int mine = 8 * (W & 3) + (lane & 7);
      const Corner mc = corner(__shfl_sync(FULL, (W >> 2) ? tp.cx[1] : tp.cx[0], mine),
                               __shfl_sync(FULL, (W >> 2) ? tp.cy[1] : tp.cy[0], mine), l,
                               Hl, Wl);
#pragma unroll 4
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * W + i, gx = gx0 + (r & 7), gy = gy0 + (r >> 3);
        const float wx = __shfl_sync(FULL, mc.wx, i), wy = __shfl_sync(FULL, mc.wy, i);
        if (gx >= p.W || gy >= p.H) continue;
        const size_t pix = (size_t)b * p.N + (size_t)gy * p.W + gx;
        table_to_out(wtab + i * (K1 * K1), wx, wy, p.inv_sqrt_d,
                     p.out + pix * L * (K * K) + l * (K * K), lane);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
corr_lookup_tc_kernel(const __grid_constant__ TcParams p) {
  using namespace hopper;
  constexpr int KC = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* A = smem;
  unsigned char* ring = A + tc_a_bytes(D);
  unsigned char* res = ring + TC_STAGES * STAGE_BYTES;
  float* tables = reinterpret_cast<float*>(res + p.res_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(res + p.res_bytes + TC_TABLES);
  uint64_t* empty = full + TC_STAGES;
  uint64_t* res_bar = empty + TC_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_init(res_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int b = blockIdx.y, t0 = blockIdx.x * p.tiles_per_block;
  const int t1 = min(p.ntiles, t0 + p.tiles_per_block);
  const int wg = warpgroup_index();
  if (wg == NCWG) {
    tc_produce<KC>(p, ring, res, full, empty, res_bar, b, t0, t1, threadIdx.x & 31);
    return;
  }
  tc_consume<D>(p, A, ring, res, tables, full, empty, res_bar, b, t0, t1, wg);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum Body { BAND = 0, SHARED = 1, RESIDENT = 2 };

int smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// the shared or resident body (D >= 64)
template <int D>
int launch_tc(int body, const CorrDesc& d, const float* f1, const float* coords, float* out,
              int B, int N, unsigned resident, int tiles_per_block, int* staged,
              cudaStream_t stream) {
  if ((long long)d.H[0] * d.W[0] != N || tiles_per_block < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  TcParams* tp = new TcParams;
  memset(tp, 0, sizeof(TcParams));
  tp->d = d;
  tp->f1 = f1;
  tp->coords = coords;
  tp->out = out;
  tp->staged = staged;
  tp->N = N;
  tp->H = d.H[0];
  tp->W = d.W[0];
  tp->tiles_x = (tp->W + TILE - 1) / TILE;
  tp->ntiles = tp->tiles_x * ((tp->H + TILE - 1) / TILE);
  tp->tiles_per_block = tiles_per_block;
  tp->inv_sqrt_d = 1.0f / sqrtf((float)D);
  if (body != RESIDENT) resident = 0u;
  bool ok = true;
  size_t res_bytes = 0;
  for (int l = 0; l < d.n_levels && ok; ++l) {
    const int Hl = d.H[l], Wl = d.W[l];
    if (Hl < 1 || Wl < 1) {  // an empty level: no map, no products, zeros out
      resident &= ~(1u << l);
      continue;
    }
    const uint64_t P = (uint64_t)Hl * Wl;
    ok = hopper::make_map_nd<4>(&tp->win[l], d.f2[l], {(uint64_t)D, (uint64_t)Wl, (uint64_t)Hl,
                                                       (uint64_t)B},
                                {(uint64_t)D * 2, (uint64_t)Wl * D * 2, P * D * 2},
                                {64u, (uint32_t)BLK, (uint32_t)BLK, 1u});
    if (ok && ((resident >> l) & 1u)) {
      tp->res_rows[l] = (int)((P + 7) / 8 * 8);
      tp->res_off[l] = (unsigned)res_bytes;
      res_bytes += (size_t)tp->res_rows[l] * D * 2;
      ok = hopper::make_map_nd<3>(&tp->res[l], d.f2[l], {(uint64_t)D, P, (uint64_t)B},
                                  {(uint64_t)D * 2, P * D * 2}, {64u, 8u, 1u});
    }
  }
  tp->resident = resident;
  tp->res_bytes = (unsigned)res_bytes;
  const size_t bytes = tc_fixed_bytes(D) + res_bytes;
  int optin = 0;
  int err = ok ? smem_optin(&optin) : (int)cudaErrorInvalidValue;
  if (err == 0 && bytes > (size_t)optin) err = (int)cudaErrorInvalidValue;
  if (err == 0)
    err = (int)cudaFuncSetAttribute(corr_lookup_tc_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) {
    const dim3 grid((unsigned)((tp->ntiles + tiles_per_block - 1) / tiles_per_block),
                    (unsigned)B);
    corr_lookup_tc_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(*tp);
    err = (int)cudaGetLastError();
  }
  delete tp;
  return err;
}

template <int D>
int launch(int body, const CorrDesc& d, const float* f1, const float* coords, float* out, int B,
           int N, unsigned resident, int tiles_per_block, int* staged, cudaStream_t stream) {
  if constexpr (D >= 64) {
    if (body != BAND)
      return launch_tc<D>(body, d, f1, coords, out, B, N, resident, tiles_per_block, staged,
                            stream);
  }
  const long long total = (long long)B * N;
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  const unsigned grid = (unsigned)((total + NWARP - 1) / NWARP);
  corr_lookup_kernel<D><<<grid, NWARP * 32, 0, stream>>>(d, f1, coords, out, total, N,
                                                         inv_sqrt_d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of a block's shared memory the resident body can give to levels on
// the current device: the opt-in maximum less what its kernel takes besides
// them at D = 256 (smaller D leave more; the caller's rule uses this bound);
// < 0 on a CUDA error.
long long corr_resident_capacity(void) {
  int optin = 0;
  if (smem_optin(&optin) != 0) return -1;
  return (long long)optin - (long long)tc_fixed_bytes(256);
}

// Registers, local (spill) bytes a thread and shared memory a block of a
// launch at D: tc = 0, the band kernel (D in {32, 64, 128, 256}); tc = 1,
// the tensor-core kernel of the shared and resident bodies (D in {64, 128,
// 256}), resident levels not counted.
int corr_kernel_attrs(int tc, int D, int* regs, int* local_bytes, int* smem_bytes) {
  const void* fn = nullptr;
  if (tc == 0)
    fn = D == 32 ? (const void*)corr_lookup_kernel<32>
         : D == 64 ? (const void*)corr_lookup_kernel<64>
         : D == 128 ? (const void*)corr_lookup_kernel<128>
         : D == 256 ? (const void*)corr_lookup_kernel<256> : nullptr;
  else if (tc == 1)
    fn = D == 64 ? (const void*)corr_lookup_tc_kernel<64>
         : D == 128 ? (const void*)corr_lookup_tc_kernel<128>
         : D == 256 ? (const void*)corr_lookup_tc_kernel<256> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)((tc ? tc_fixed_bytes(D) : 0) + a.sharedSizeBytes);
  return 0;
}

// f1 (B, N, D) f32, coords (B, N, 2) f32, out (B, N, n_levels * 81) f32, the
// levels as CorrDesc says (level 0 is the H x W grid, N = H W); D in {32,
// 64, 128, 256}, radius 4.  body: 0 band; 1 shared (staged: NULL or
// n_levels ints, each counting the 8 x 8 tiles whose union window staged at
// that level); 2 resident (bit l of `resident` keeps level l, whose bf16
// positions rounded up to 8 take H_l W_l D 2 bytes or a little more, in
// shared memory).  For bodies 1 and 2 a block walks `tiles_per_block`
// consecutive tiles of one batch element; at D = 32 they take the band body.
int corr_lookup(const CorrDesc* d, const float* f1, const float* coords, float* out, int B, int N,
                int D, int radius, int body, unsigned resident, int tiles_per_block, int* staged,
                void* stream) {
  if (!d || d->n_levels < 1 || d->n_levels > CORR_MAX_LEVELS || radius != R || B < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  if (body < BAND || body > RESIDENT) return (int)cudaErrorInvalidValue;
  if (((long long)B * N + NWARP - 1) / NWARP > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(body, *d, f1, coords, out, B, N, resident, tiles_per_block, staged, s);
    case 64: return launch<64>(body, *d, f1, coords, out, B, N, resident, tiles_per_block, staged, s);
    case 128: return launch<128>(body, *d, f1, coords, out, B, N, resident, tiles_per_block, staged, s);
    case 256: return launch<256>(body, *d, f1, coords, out, B, N, resident, tiles_per_block, staged, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
