// Fused IMLP linear-relu chain for Hopper (sm_90a): forward and backward, each
// in a remat and a stash variant.
//
// Replaces the TPU kernels of deflicker_tpu/ops/pallas/imlp_kernel.py:
//   * forward  — `_call_fwd` (:421, pallas_call :435; bodies `_fwd_kernel_pipe`
//     :237 / `_fwd_kernel` :111 through `_layer_fwd` :91, v2 split-skip);
//   * backward — `_chain_bwd` (:470, pallas_call :488; bodies
//     `_bwd_kernel_pipe` :265 / `_bwd_kernel` :127 + `_reverse_pass` :163);
//   * stash forward — `_chain_stash_fwd` (:514, pallas_call :536; body
//     `_fwd_kernel_stash` :334): the same chain, which also writes the bf16
//     post-relu input of layers 1..n-1 to a tensor the caller keeps;
//   * stash backward — `_chain_stash_bwd` (:547, pallas_call :568; body
//     `_bwd_kernel_stash` :355): the reverse pass reading that stash.
// Every launch also takes a video axis: V independent chains of one shape,
// each with its own x, weights, biases, output, stash and scratch at a fixed
// per-video stride, in one launch (the grid's second axis, the dW GEMM's
// third).  It is the counterpart of what `jax.vmap` makes of the Pallas
// chain in deflicker_tpu/atlas/multifit.py through the pallas_call batching
// rule.  A one-video call is the same launch with a grid of one video.
//
// Function computed (pre-tanh chain, bf16 operands, f32 accumulation):
//   h0 = bf16(x)·bf16(W0) + b0
//   h_i = bf16(relu(h_{i-1}))·bf16(W_i) + b_i          (plain layers)
//   h_i = bf16(relu(h_{i-1}))·bf16(W_i[:d]) + bf16(x)·bf16(W_i[d:]) + b_i  (skip)
// Backward, from a_i = bf16(relu(h_{i-1})) (the stash) and g_{n-1} = g:
//   dW_i = bf16(a_i)ᵀ·bf16(g_i), db_i = Σ_rows g_i (f32),
//   g_{i-1} = (bf16(g_i)·bf16(W_i[:d])ᵀ) * (a_i > 0),  dx = bf16(g_0)·bf16(W_0)ᵀ.
// The skip branch gets no gradient (the reference's detached skip input).
//
// Forward (rows 1 and 3): one block owns a 64-row tile and keeps its bf16
// activation tile in shared memory for the whole chain; each layer's W
// streams through 32-deep cp.async slabs; products are mma.sync m16n8k16
// fed by ldmatrix, with bias, relu and the bf16 cast in registers.  The
// stash forward stores the bf16 pairs its epilogue already holds (rows past
// B never stored), so the stash is exactly (B, r16(width)) per layer.
//
// Backward (rows 2 and 4): what bounds it on the H100.  Per row the
// products are about 2 x the forward's (263,424 MACs a row forward for the
// 6x256 mapping: 47 GFLOP forward at 90,000 rows, 0.05 ms of the tensor
// cores), but the pass has to move bytes: it reads the stash as the relu
// mask and writes every layer's bf16 gradient (the dW GEMM's operand), then
// the dW GEMM reads both again.  For the mapping at 90,000 rows that is
// about 0.93 GB, 0.28 ms at 3.35 TB/s: the floor is HBM, not the tensor
// cores.  The first design sat at 6-12 % of the bound: one 8-warp block an
// SM issuing synchronous ldmatrix/mma.sync, two barriers a 32-deep slab,
// and the mask read and the gradient written element by element from the
// epilogue, with nothing resident to cover either.  The design now:
//   (1) Remat = recompute + the stash backward.  The remat backward first
//       runs the stash forward without its output layer
//       (chain_fwd_kernel<true, false>) into the scratch, then the very
//       launches of the stash backward; stash and remat gradients are
//       bit-equal by construction.  (It costs one more read of the
//       activations; the recompute keeps the forward's product routine so
//       its activations are the stash forward's bit for bit.)
//   (2) Reverse pass (chain_reverse_kernel): a 128-row tile a block, two
//       consumer warpgroups of 64 rows and a producer warpgroup
//       (setmaxnreg 232 / 40).  Producer warp 0 keeps W_i's slabs (64
//       contraction columns x 128 kept rows, 16 KB, 128-byte swizzle) in a
//       4-stage TMA ring under full/empty mbarriers, running ahead into the
//       next layer while the consumers finish an epilogue; a fan-out TMA
//       cannot stride (the output layer's 1-3 columns) is written into the
//       same swizzled slab by that warp.  Warps 1-2 bring each warpgroup's
//       relu mask (its 64 rows of the stash layer) by TMA in 64 x 64 boxes,
//       swizzled like the g tile, so that the epilogue's fragment-ordered
//       reads are conflict-free.  Consumers run g_{i-1} = g_i·W_iᵀ as wgmma
//       m64n128k16 (A = the g tile, B = the slab, both K-major in shared
//       memory, f32 in registers), one half of 128 kept columns after the
//       other: half 1's products stay in flight while half 0's epilogue
//       masks, rounds to bf16 and sums columns (a reduce-scatter over the 8
//       lanes that share columns, then 4 warps in order, one db row per 64
//       rows).  Both halves then go back into the g tile in place, swizzled,
//       as the next layer's A, and each warp copies its 16 rows to the
//       scratch in 16-byte coalesced stores.  On the H100 what bounds the
//       pass now is the block's own issue (products, epilogue and their
//       barriers), not its traffic: a build without the mask, weight and
//       gradient traffic kept most of the pass's time.  Shared
//       memory (bytes): g tile 65,536 + ring 65,536 + mask 65,536 + column
//       sums 16,384 + barriers, 214,144 with the alignment slack, of the
//       232,448 a block may have; one block an SM.
//   (3) dW GEMM (dw_kernel): dW_i = Aᵀ·G over all rows, 128 x 128 output
//       tiles, split-K over row slices sized for about two waves of the 132
//       SMs (the slice count depends on the layer shapes and B only, never
//       on V).  Both operands are stored rows-outermost, so TMA lands them
//       as MN-major 128-byte-swizzled blocks (64 rows x 64 columns) and
//       wgmma reads them transposed; a producer thread keeps a 4-stage ring
//       of 32 KB stages full.  Partials go to the scratch and a separate
//       reduction sums slices and db rows in a fixed order: no atomics, the
//       gradients are deterministic, and a V-video call is bit-equal to V
//       one-video calls.
// Narrow and ragged shapes: TMA fills zeros outside a tensor (rows past B,
// columns past a width), the maps' row counts are the real ones (kept rows
// of W, B rows of the stash and gradients), and only real rows and columns
// are stored.
//
// Interface: plain C, loaded with ctypes; every launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#define MAXL 16

namespace {

constexpr int BM = 64;            // rows per block tile
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int KS = 32;            // depth of a streamed weight slab
constexpr int PAD = 8;            // smem row padding (bf16 elements)
constexpr int MAXW = 256;         // widest layer a block tile can hold
constexpr int FWD_MIN_BLOCKS = 2; // forward: 2 blocks/SM (<= 128 registers)

}  // namespace

struct ChainDesc {
  int n_layers;
  int E;                 // real input width
  int in_dim[MAXL];      // real fan-in of layer i (skip layers: hidden + E)
  int out_dim[MAXL];     // real fan-out of layer i
  int skip[MAXL];        // 1 where layer i concatenates the input x
  const bf16* W[MAXL];   // (V, in_dim, out_dim) row-major
  const float* b[MAXL];  // (V, out_dim)
};

namespace {

__host__ __device__ __forceinline__ int r16(int v) { return (v + 15) & ~15; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ size_t align256(size_t v) { return (v + 255) & ~size_t(255); }

// layer l's weights and bias of video v
__device__ __forceinline__ const bf16* layer_w(const ChainDesc& d, int l, int v) {
  return d.W[l] + (size_t)v * d.in_dim[l] * d.out_dim[l];
}
__device__ __forceinline__ const float* layer_b(const ChainDesc& d, int l, int v) {
  return d.b[l] + (size_t)v * d.out_dim[l];
}

struct SmemLayout {
  int xld, ald;           // leading dims of the x tile and the activation tile
  size_t off_xs, off_act, off_slab0, off_slab1, bytes;
};

__host__ __device__ inline SmemLayout smem_layout(const ChainDesc& d) {
  SmemLayout L;
  const int Ep = r16(d.E);
  int H = 16;
  for (int i = 0; i < d.n_layers; ++i) H = imax(H, r16(d.out_dim[i]));
  L.xld = Ep + PAD;
  L.ald = H + PAD;
  const size_t slab = (size_t)KS * (H + PAD) * sizeof(bf16);  // KS x (Np + PAD)
  size_t off = 0;
  L.off_xs = off;    off += (size_t)BM * L.xld * sizeof(bf16); off = (off + 127) & ~size_t(127);
  L.off_act = off;   off += (size_t)BM * L.ald * sizeof(bf16); off = (off + 127) & ~size_t(127);
  L.off_slab0 = off; off += slab;                             off = (off + 127) & ~size_t(127);
  L.off_slab1 = off; off += slab;
  L.bytes = off;
  return L;
}

// Where the bf16 post-relu input of layer i (1..n-1) lives: rows of
// r16(out_dim[i-1]) elements starting at base + off[i].  Rows past B are
// neither stored nor read.
struct StashView {
  bf16* base;
  size_t off[MAXL];
};

// element offsets of a caller-owned stash: B rows per layer, back to back
__host__ __device__ inline size_t stash_offsets(const ChainDesc& d, int B, size_t* off) {
  size_t o = 0;
  for (int i = 1; i < d.n_layers; ++i) {
    if (off != nullptr) off[i] = o;
    o += (size_t)B * r16(d.out_dim[i - 1]);
  }
  return o;
}

// ---------------------------------------------------------------------------
// PTX helpers (layouts: PTX ISA, "Matrix fragments for mma.m16n8k16")
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) · b (16x8, col); c/d: (g, 2t..2t+1) and (g + 8, ...)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; a false `valid` zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float relu_keep_nan(float v) { return (v < 0.0f) ? 0.0f : v; }

// acc[row tile][column tile j][n8 half][fragment element]
typedef float Acc[4][2][2][4];

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int rt = 0; rt < 4; ++rt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rt][j][h][q] = 0.0f;
}

// W[wrow0 + k0 : +KS, 0:N] -> slab [KS][Np + PAD] (zero outside K x N)
__device__ __forceinline__ void load_fwd_slab(bf16* slab, const bf16* __restrict__ W, int wrow0,
                                              int k0, int K, int N) {
  const int Np = r16(N), sld = Np + PAD;
  if ((N & 7) == 0) {
    const int nv = Np >> 3;
    for (int idx = threadIdx.x; idx < KS * nv; idx += NTHREADS) {
      const int kk = idx / nv, c = (idx - kk * nv) << 3;
      const int k = k0 + kk;
      const bool ok = k < K && c < N;
      cp_async16(slab + kk * sld + c, ok ? W + (size_t)(wrow0 + k) * N + c : W, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < KS * Np; idx += NTHREADS) {
      const int kk = idx / Np, c = idx - kk * Np;
      const int k = k0 + kk;
      slab[kk * sld + c] = (k < K && c < N) ? W[(size_t)(wrow0 + k) * N + c]
                                            : __float2bfloat16(0.0f);
    }
  }
}

// acc += A[:, 0:K] · W[wrow0 : wrow0 + K, 0:N]; A is a BM-row bf16 tile in
// smem (columns K..r16(K) zero), W row-major bf16 in global memory.
__device__ __forceinline__ void gemm_fwd_seg(Acc& acc, const bf16* A, int lda, int K,
                                             const bf16* __restrict__ W, int wrow0, int N,
                                             bf16* slab0, bf16* slab1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Np = r16(N), NT = Np >> 4, Kp = r16(K), sld = Np + PAD;
  const int nslab = (Kp + KS - 1) / KS;
  __syncthreads();  // earlier readers of the slabs and writers of A are done
  load_fwd_slab(slab0, W, wrow0, 0, K, N);
  cp_async_commit();
  for (int s = 0; s < nslab; ++s) {
    const bf16* cur = (s & 1) ? slab1 : slab0;
    if (s + 1 < nslab) {
      load_fwd_slab((s & 1) ? slab0 : slab1, W, wrow0, (s + 1) * KS, K, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp < NT) {
      const int k0 = s * KS, kend = imin(KS, Kp - k0);
      for (int kk = 0; kk < kend; kk += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int rt = 0; rt < 4; ++rt)
          ldsm_x4(a[rt], A + (rt * 16 + (lane & 15)) * lda + k0 + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ct = warp + NWARP * j;
          if (ct < NT) {
            uint32_t b[4];
            ldsm_x4_t(b, cur + (kk + (lane & 15)) * sld + ct * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int rt = 0; rt < 4; ++rt) {
              mma16816(acc[rt][j][0], a[rt], b[0], b[1]);
              mma16816(acc[rt][j][1], a[rt], b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // `cur` is refilled two slabs later
  }
}

// Forward over one tile.  STASH: write the bf16 post-relu input of every
// layer 1..n-1 to `sv`.
// OUTPUT: run the last layer and store `out`; the remat backward's recompute
// skips it, since the backward does not need the chain's output.
template <bool STASH, bool OUTPUT>
__device__ __forceinline__ void chain_forward(const ChainDesc& d, const SmemLayout& L, int v,
                                              const float* __restrict__ x, int B, int row0,
                                              float* __restrict__ out, unsigned char* smem,
                                              const StashView& sv) {
  bf16* xs = reinterpret_cast<bf16*>(smem + L.off_xs);
  bf16* act = reinterpret_cast<bf16*>(smem + L.off_act);
  bf16* slab0 = reinterpret_cast<bf16*>(smem + L.off_slab0);
  bf16* slab1 = reinterpret_cast<bf16*>(smem + L.off_slab1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int Ep = r16(d.E);
  for (int idx = threadIdx.x; idx < BM * Ep; idx += NTHREADS) {
    const int r = idx / Ep, c = idx - r * Ep;
    const int gr = row0 + r;
    const float v = (gr < B && c < d.E) ? x[(size_t)gr * d.E + c] : 0.0f;
    xs[r * L.xld + c] = __float2bfloat16(v);
  }

  const int nl = OUTPUT ? d.n_layers : d.n_layers - 1;
  for (int l = 0; l < nl; ++l) {
    const int N = d.out_dim[l], Np = r16(N), NT = Np >> 4;
    Acc acc;
    zero_acc(acc);
    const bf16* __restrict__ Wl = layer_w(d, l, v);
    if (l == 0) {
      gemm_fwd_seg(acc, xs, L.xld, d.E, Wl, 0, N, slab0, slab1);
    } else {
      const int Kh = d.out_dim[l - 1];
      gemm_fwd_seg(acc, act, L.ald, Kh, Wl, 0, N, slab0, slab1);
      if (d.skip[l]) gemm_fwd_seg(acc, xs, L.xld, d.E, Wl, Kh, N, slab0, slab1);
    }
    // gemm_*_seg ends with __syncthreads: nobody reads act any more
    const bool last = (l == d.n_layers - 1);
    bf16* stash = (STASH && !last) ? sv.base + sv.off[l + 1] : nullptr;
    const float* __restrict__ bias = layer_b(d, l, v);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ct = warp + NWARP * j;
      if (ct >= NT) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ct * 16 + h * 8 + 2 * t;
        const float b0 = col < N ? bias[col] : 0.0f;
        const float b1 = col + 1 < N ? bias[col + 1] : 0.0f;
#pragma unroll
        for (int rt = 0; rt < 4; ++rt) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = rt * 16 + g + 8 * hr;
            const float v0 = acc[rt][j][h][2 * hr] + b0;
            const float v1 = acc[rt][j][h][2 * hr + 1] + b1;
            if (last) {
              const int gr = row0 + row;
              if (gr < B) {
                if (col < N) out[(size_t)gr * N + col] = v0;
                if (col + 1 < N) out[(size_t)gr * N + col + 1] = v1;
              }
            } else {
              const bf162 p = __floats2bfloat162_rn(col < N ? relu_keep_nan(v0) : 0.0f,
                                                    col + 1 < N ? relu_keep_nan(v1) : 0.0f);
              *reinterpret_cast<bf162*>(act + row * L.ald + col) = p;
              if (STASH && row0 + row < B)
                *reinterpret_cast<bf162*>(stash + (size_t)(row0 + row) * Np + col) = p;
            }
          }
        }
      }
    }
    // the next layer's gemm starts with __syncthreads before reading act
  }
  __syncthreads();
}

// The forward over one tile of video blockIdx.y.  STASH: the same chain,
// which also fills `stash` (video v's at stash + v * stash_vs); OUTPUT:
// run the last layer into `out`.  <true, false> is the remat backward's
// recompute: the stash forward without its output layer, so the
// activations it writes are bit for bit those a stash forward keeps.
template <bool STASH, bool OUTPUT>
__global__ void __launch_bounds__(NTHREADS, FWD_MIN_BLOCKS)
chain_fwd_kernel(ChainDesc d, const float* __restrict__ x, float* __restrict__ out, int B,
                 bf16* stash, size_t stash_vs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout L = smem_layout(d);
  const int v = blockIdx.y;
  StashView sv{};
  if (STASH) {
    sv.base = stash + v * stash_vs;
    stash_offsets(d, B, sv.off);
  }
  chain_forward<STASH, OUTPUT>(d, L, v, x + (size_t)v * B * d.E, B, blockIdx.x * BM,
                               OUTPUT ? out + (size_t)v * B * d.out_dim[d.n_layers - 1] : nullptr,
                               smem, sv);
}

// ---------------------------------------------------------------------------
// Backward: reverse pass and dW GEMM (wgmma, TMA, mbarrier rings)
// ---------------------------------------------------------------------------

constexpr int RT = 128;                  // rows of a reverse-pass tile: two warpgroups of 64
constexpr int BWD_THREADS = 384;         // consumer warpgroups 0-1, producer warpgroup 2
constexpr int RSTAGES = 4;               // weight-slab ring of the reverse pass
constexpr int SLAB_N = 64;               // contraction columns of a slab (128 bytes a row)
constexpr int SLAB_K = 128;              // kept rows of W in a slab: wgmma N
constexpr int SLAB_BYTES = SLAB_N * SLAB_K * 2;
constexpr int GT_ATOM = RT * 128;        // one 64-column block of the g tile
constexpr int MASK_WG = 4 * 64 * 128;    // a warpgroup's mask rows: 4 blocks of 64 columns
constexpr int CS_WG = 2 * 4 * MAXW * 4;  // column-sum partials: 2 layers x 4 warps x MAXW
constexpr int REV_OFF_RING = 4 * GT_ATOM;
constexpr int REV_OFF_MASK = REV_OFF_RING + RSTAGES * SLAB_BYTES;
constexpr int REV_OFF_CS = REV_OFF_MASK + 2 * MASK_WG;
constexpr int REV_OFF_BAR = REV_OFF_CS + 2 * CS_WG;
constexpr int REV_SMEM = REV_OFF_BAR + 128 + 1024;  // + barriers, + slack to align to 1,024

constexpr int DW_T = 128;                // dW output tile (DW_T x DW_T)
constexpr int DW_RK = 64;                // rows (the contraction) of a dW stage
constexpr int DW_STAGES = 4;
constexpr int DW_ATOM = DW_RK * 128;     // 64 rows x 64 columns, 128-byte swizzle
constexpr int DW_STAGE_BYTES = 4 * DW_ATOM;  // two A blocks, two G blocks
constexpr int DW_SMEM = DW_STAGES * DW_STAGE_BYTES + 128 + 1024;
constexpr int DW_TARGET_BLOCKS = 2 * 132;    // about two waves of the H100's 132 SMs

static_assert(REV_SMEM <= 232448 && DW_SMEM <= 232448, "shared memory of a block");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (hopper::smem_addr(p) & 1023u)) & 1023u);
}

__host__ __device__ __forceinline__ int kept_width(const ChainDesc& d, int i) {
  return i == 0 ? d.E : d.out_dim[i - 1];
}

// Segments of the dW GEMM: layer i's rows fed by its kept input (A = the
// stash layer, or bf16(x) for layer 0) and, for a skip layer, the rows fed
// by x.  Calls f(i, xseg, K, rowoff) in a fixed order.
template <class F>
__host__ inline void for_each_dw_segment(const ChainDesc& d, F f) {
  for (int i = 0; i < d.n_layers; ++i) {
    const int nsub = (i > 0 && d.skip[i]) ? 2 : 1;
    for (int q = 0; q < nsub; ++q) {
      const bool xseg = (i == 0) || q == 1;
      f(i, xseg, xseg ? d.E : d.out_dim[i - 1], q == 1 ? d.out_dim[i - 1] : 0);
    }
  }
}

__host__ inline int dw_tiles(const ChainDesc& d) {
  int tiles = 0;
  for_each_dw_segment(d, [&](int i, bool, int K, int) {
    tiles += ((K + DW_T - 1) / DW_T) * ((d.out_dim[i] + DW_T - 1) / DW_T);
  });
  return tiles;
}

// One video's scratch, byte offsets.  own_stash (remat): the activation
// stash comes first, laid out as a caller's stash; then bf16(x), the bf16
// gradient of every layer's output, the db partials (one row of f32 column
// sums per 64 rows) and the dW partials (one full set per row slice).
struct ScratchLayout {
  int ntiles, S, rows_per_slice, totalW, totalB;
  int woff[MAXL], boff[MAXL];
  size_t stash, stash_x, G[MAXL], dbp, part, bytes;
};

__host__ inline ScratchLayout scratch_layout(const ChainDesc& d, int B, bool own_stash) {
  ScratchLayout S;
  S.ntiles = (B + RT - 1) / RT;
  // split-K: about DW_TARGET_BLOCKS blocks a video, slices of whole stages
  const int tiles = dw_tiles(d), chunks = (B + DW_RK - 1) / DW_RK;
  const int want = imin(chunks, imax(1, (DW_TARGET_BLOCKS + tiles - 1) / tiles));
  S.rows_per_slice = ((chunks + want - 1) / want) * DW_RK;
  S.S = (B + S.rows_per_slice - 1) / S.rows_per_slice;
  S.totalW = 0;
  S.totalB = 0;
  for (int i = 0; i < d.n_layers; ++i) {
    S.woff[i] = S.totalW;
    S.boff[i] = S.totalB;
    S.totalW += d.in_dim[i] * d.out_dim[i];
    S.totalB += d.out_dim[i];
  }
  size_t off = 0;
  S.stash = 0;
  if (own_stash) off += align256(stash_offsets(d, B, nullptr) * sizeof(bf16));
  S.stash_x = off;
  off += align256((size_t)B * r16(d.E) * sizeof(bf16));
  for (int i = 0; i < d.n_layers; ++i) {
    S.G[i] = off;
    off += align256((size_t)B * r16(d.out_dim[i]) * sizeof(bf16));
  }
  S.dbp = off;
  off += align256((size_t)2 * S.ntiles * S.totalB * sizeof(float));
  S.part = off;
  off += align256((size_t)S.S * S.totalW * sizeof(float));
  S.bytes = off;
  return S;
}

struct RevParams {
  CUtensorMap wmap[MAXL];  // W_i[:kept, :] as (out_dim columns, kept rows, videos)
  CUtensorMap mmap[MAXL];  // stash layer i (1..n-1) as (r16 columns, B rows, videos)
  ChainDesc d;
  int wtma[MAXL];          // 1 where layer i's slabs come by TMA, else by hand
  const float* x;
  const float* g;
  float* dx;               // nullptr: no dx, and the pass stops at layer 1
  char* scratch;           // video v's at scratch + v * scratch_vs
  size_t scratch_vs, off_x, off_G[MAXL], off_dbp;
  int B, totalB, boff[MAXL];
};

// Producer warp 0: every weight slab of the pass, in the order the consumers
// take them (layers n-1 .. end, halves of the kept rows, contraction chunks).
__device__ __forceinline__ void rev_produce_slabs(const RevParams& p, unsigned char* ring,
                                                  uint64_t* full, uint64_t* empty, int v,
                                                  int lane) {
  using namespace hopper;
  const ChainDesc& d = p.d;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = d.n_layers - 1; i >= (p.dx != nullptr ? 0 : 1); --i) {
    const int N = d.out_dim[i], Kk = kept_width(d, i);
    const int nchunk = (r16(N) + SLAB_N - 1) / SLAB_N, nhalf = (Kk + SLAB_K - 1) / SLAB_K;
    const bf16* __restrict__ W = layer_w(d, i, v);
    for (int h = 0; h < nhalf; ++h) {
      for (int c = 0; c < nchunk; ++c) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* slab = ring + stage * SLAB_BYTES;
        if (p.wtma[i]) {
          if (lane == 0) {
            mbar_arrive_expect_tx(full + stage, SLAB_BYTES);
            tma_load_3d(slab, &p.wmap[i], full + stage, c * SLAB_N, h * SLAB_K, v);
          }
        } else {
          // a fan-out TMA cannot stride (not a multiple of 8): the same
          // swizzled slab, zero outside kept rows x N, written by the warp;
          // the loads of a pass go out together, then the stores
          for (int idx = lane; idx < SLAB_BYTES / 16; idx += 32)
            *reinterpret_cast<uint4*>(slab + 16 * idx) = make_uint4(0u, 0u, 0u, 0u);
          __syncwarp();
          const int rows = imin(SLAB_K, Kk - h * SLAB_K), cols = imin(SLAB_N, N - c * SLAB_N);
          const bf16* __restrict__ Ws = W + (size_t)h * SLAB_K * N + c * SLAB_N;
          for (int base = 0; base < rows * cols; base += 32 * 4) {
            bf16 vals[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = base + lane + 32 * u, r = e / cols, cc = e - r * cols;
              vals[u] = e < rows * cols ? Ws[(size_t)r * N + cc] : __float2bfloat16(0.0f);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = base + lane + 32 * u, r = e / cols, cc = e - r * cols;
              if (e < rows * cols) *reinterpret_cast<bf16*>(slab + sw128_offset(r, cc)) = vals[u];
            }
          }
          fence_async_smem();
          __syncwarp();
          if (lane == 0) mbar_arrive(full + stage);
        }
        if (++stage == RSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

// Producer warp 1 + w, one lane: the relu mask (stash layer i) of
// warpgroup w's 64 rows for layers n-1 .. 1, by TMA in 64-column boxes,
// swizzled as the g tile (conflict-free reads in fragment order).
__device__ __forceinline__ void rev_produce_masks(const RevParams& p, unsigned char* mask,
                                                  uint64_t* mfull, uint64_t* mempty, int row0,
                                                  int v) {
  using namespace hopper;
  const ChainDesc& d = p.d;
  uint32_t phase = 0;
  for (int i = d.n_layers - 1; i >= 1; --i) {
    const int nbox = row0 < p.B ? (r16(d.out_dim[i - 1]) + 63) / 64 : 0;
    mbar_wait(mempty, phase ^ 1);
    mbar_arrive_expect_tx(mfull, (uint32_t)(nbox * 64 * 128));
    for (int a = 0; a < nbox; ++a) tma_load_3d(mask + a * 64 * 128, &p.mmap[i], mfull, 64 * a, row0, v);
    phase ^= 1;
  }
}

// acc += the g tile's `ksteps` 16-wide contraction steps at a0 times the
// slab at b0 (both K-major, 128-byte swizzle); a whole slab, the common
// case, as four straight-line products
__device__ __forceinline__ void rev_slab_products(float (&acc)[64], const unsigned char* a0,
                                                  const unsigned char* b0, int ksteps) {
  using namespace hopper;
  if (ksteps == SLAB_N / 16) {
#pragma unroll
    for (int k = 0; k < SLAB_N / 16; ++k)
      wgmma_m64n128<0, 0>(acc, sw128_desc(a0 + 32 * k, 16, 1024), sw128_desc(b0 + 32 * k, 16, 1024));
  } else {
    for (int k = 0; k < ksteps; ++k)
      wgmma_m64n128<0, 0>(acc, sw128_desc(a0 + 32 * k, 16, 1024), sw128_desc(b0 + 32 * k, 16, 1024));
  }
}

// The masked epilogue of kept-column half H of a warpgroup's accumulator:
// pk[2j + hr] = bf16 pair of acc * (a > 0) at row 16 wl + lane/4 + 8 hr,
// columns H*128 + 8j + 2(lane%4) + {0, 1}; rows past B and columns past the
// kept width hold stale mask entries, but their products are exactly zero,
// and so is the result.  The f32 column sums of the warp's 16 rows go to
// csl: for each pair of 8-column groups a reduce-scatter over the 8 lanes
// that share columns (lane bit 2 picks the group, bit 3 the column, bit 4
// completes the sum), a fixed order.
template <int H>
__device__ __forceinline__ void rev_half_epilogue(const float (&acc)[64],
                                                  const unsigned char* mask, uint32_t (&pk)[32],
                                                  float* csl, int wl, int lane) {
  using namespace hopper;
  const int gl = lane >> 2, t = lane & 3;
  const bool b0 = gl & 1, b1 = (gl >> 1) & 1;
#pragma unroll
  for (int jp = 0; jp < 8; ++jp) {
    float s[2][2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * jp + jj, col = 8 * j + 2 * t;  // column within the half
      s[jj][0] = s[jj][1] = 0.0f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * wl + gl + 8 * hr;
        const bf162 a = *reinterpret_cast<const bf162*>(
            mask + (2 * H + (col >> 6)) * 64 * 128 + sw128_offset(r, col & 63));
        const float v0 = (__low2float(a) > 0.0f) ? acc[4 * j + 2 * hr] : 0.0f;
        const float v1 = (__high2float(a) > 0.0f) ? acc[4 * j + 2 * hr + 1] : 0.0f;
        const bf162 pr = __floats2bfloat162_rn(v0, v1);
        memcpy(&pk[2 * j + hr], &pr, 4);
        s[jj][0] += v0;
        s[jj][1] += v1;
      }
    }
    float k0 = b0 ? s[1][0] : s[0][0], k1 = b0 ? s[1][1] : s[0][1];
    k0 += __shfl_xor_sync(0xffffffffu, b0 ? s[0][0] : s[1][0], 4);
    k1 += __shfl_xor_sync(0xffffffffu, b0 ? s[0][1] : s[1][1], 4);
    float k = b1 ? k1 : k0;
    k += __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 8);
    k += __shfl_xor_sync(0xffffffffu, k, 16);
    if (gl < 4) csl[H * SLAB_K + 8 * (2 * jp + b0) + 2 * t + b1] = k;
  }
}

// pk of rev_half_epilogue<H> into the warpgroup's rows of the g tile
template <int H>
__device__ __forceinline__ void rev_half_store(unsigned char* gt, const uint32_t (&pk)[32], int w,
                                               int wl, int lane) {
  using namespace hopper;
  const int gl = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int col = 8 * j + 2 * t, r = 64 * w + 16 * wl + gl + 8 * hr;
      *reinterpret_cast<uint32_t*>(gt + (2 * H + (col >> 6)) * GT_ATOM +
                                   sw128_offset(r, col & 63)) = pk[2 * j + hr];
    }
}

// Consumer warpgroup w: rows [row0, row0 + 64) of the tile through the
// whole reverse walk.
__device__ __forceinline__ void rev_consume(const RevParams& p, unsigned char* smem,
                                            uint64_t* full, uint64_t* empty, uint64_t* mfull,
                                            uint64_t* mempty, int w) {
  using namespace hopper;
  const ChainDesc& d = p.d;
  const int tile = blockIdx.x, v = blockIdx.y, n = d.n_layers, B = p.B;
  const int lt = threadIdx.x & 127, wl = lt >> 5, lane = lt & 31, gl = lane >> 2, t = lane & 3;
  const int row0 = tile * RT + 64 * w;
  unsigned char* gt = smem;  // g tile: 4 blocks of [128 rows][64 columns], swizzled
  const unsigned char* ring = smem + REV_OFF_RING;
  const unsigned char* mask = smem + REV_OFF_MASK + w * MASK_WG;
  float* cs = reinterpret_cast<float*>(smem + REV_OFF_CS + w * CS_WG);
  char* scratch = p.scratch + (size_t)v * p.scratch_vs;
  const float* __restrict__ x = p.x + (size_t)v * B * d.E;
  const int O = d.out_dim[n - 1], Op = r16(O);
  const float* __restrict__ g = p.g + (size_t)v * B * O;
  float* dx = p.dx != nullptr ? p.dx + (size_t)v * B * d.E : nullptr;
  float* dbp = reinterpret_cast<float*>(scratch + p.off_dbp) + (size_t)(2 * tile + w) * p.totalB;

  // bf16(x): A of the dW GEMM of layer 0 and of the skip layers; and the
  // incoming gradient as bf16 into the g tile and the scratch.  Each pass
  // issues its loads before any store, so a thread waits once a pass.
  const int Ep = r16(d.E);
  bf16* xs = reinterpret_cast<bf16*>(scratch + p.off_x);
  bf16* Gl = reinterpret_cast<bf16*>(scratch + p.off_G[n - 1]);
  constexpr int PRO = 8;  // elements a thread loads before it stores
  for (int base = 0; base < 64 * Ep; base += 128 * PRO) {
    float vals[PRO];
#pragma unroll
    for (int u = 0; u < PRO; ++u) {
      const int idx = base + lt + 128 * u, r = idx / Ep, c = idx - r * Ep, gr = row0 + r;
      vals[u] = (idx < 64 * Ep && gr < B && c < d.E) ? x[(size_t)gr * d.E + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < PRO; ++u) {
      const int idx = base + lt + 128 * u, r = idx / Ep, c = idx - r * Ep, gr = row0 + r;
      if (idx < 64 * Ep && gr < B) xs[(size_t)gr * Ep + c] = __float2bfloat16(vals[u]);
    }
  }
  for (int base = 0; base < 64 * Op; base += 128 * PRO) {
    float vals[PRO];
#pragma unroll
    for (int u = 0; u < PRO; ++u) {
      const int idx = base + lt + 128 * u, r = idx / Op, c = idx - r * Op, gr = row0 + r;
      vals[u] = (idx < 64 * Op && gr < B && c < O) ? g[(size_t)gr * O + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < PRO; ++u) {
      const int idx = base + lt + 128 * u, r = idx / Op, c = idx - r * Op, gr = row0 + r;
      if (idx >= 64 * Op) continue;
      const bf16 hv = __float2bfloat16(vals[u]);
      *reinterpret_cast<bf16*>(gt + (c >> 6) * GT_ATOM + sw128_offset(64 * w + r, c & 63)) = hv;
      if (gr < B) Gl[(size_t)gr * Op + c] = hv;
    }
  }
  // db of the last layer: warp k sums rows k, k + 4, ... of each column in
  // order, then the four partials are added in order (the layout of the
  // epilogue's partials, in the buffer of parity n & 1)
  float* csn = cs + (n & 1) * 4 * MAXW;
  for (int c0 = 0; c0 < O; c0 += 32) {
    const int c = c0 + lane;
    float sum = 0.0f;
    if (c < O) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int gr = row0 + wl + 4 * k;
        sum += gr < B ? g[(size_t)gr * O + c] : 0.0f;
      }
      csn[wl * MAXW + c] = sum;
    }
  }
  fence_async_smem();
  named_sync(1 + w, 128);
  for (int c = lt; c < O; c += 128)
    dbp[p.boff[n - 1] + c] =
        ((csn[c] + csn[MAXW + c]) + csn[2 * MAXW + c]) + csn[3 * MAXW + c];

  int stage = 0;
  uint32_t phase = 0, mphase = 0;
  for (int i = n - 1; i >= (dx != nullptr ? 0 : 1); --i) {
    const int N = d.out_dim[i], Kk = kept_width(d, i);
    const int Np = r16(N), nchunk = (Np + SLAB_N - 1) / SLAB_N, nhalf = (Kk + SLAB_K - 1) / SLAB_K;
    // acc[h] = g_i · W_i[h*128 : h*128 + 128]ᵀ for the warpgroup's 64 rows
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 64; ++q) acc[h][q] = 0.0f;
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    wgmma_fence();
    // half 0: a slab is freed once the group after it is issued
    int prev = -1;
    for (int c = 0; c < nchunk; ++c) {
      mbar_wait(full + stage, phase);
      const unsigned char* a0 = gt + c * GT_ATOM + w * 64 * 128;
      const unsigned char* b0 = ring + stage * SLAB_BYTES;
      rev_slab_products(acc[0], a0, b0, imin(4, (Np - c * SLAB_N) >> 4));
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lt == 0) mbar_arrive(empty + prev);
      prev = stage;
      if (++stage == RSTAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // half 1: its groups stay in flight through half 0's epilogue (its
    // nchunk <= RSTAGES slabs are all resident once half 0's last is freed)
    const int first1 = stage;
    if (nhalf > 1) {
      for (int c = 0; c < nchunk; ++c) {
        mbar_wait(full + stage, phase);
        const unsigned char* a0 = gt + c * GT_ATOM + w * 64 * 128;
        const unsigned char* b0 = ring + stage * SLAB_BYTES;
        rev_slab_products(acc[1], a0, b0, imin(4, (Np - c * SLAB_N) >> 4));
        wgmma_commit();
        if (c == 0) {
          wgmma_wait<1>();  // half 0 is done
          if (lt == 0) mbar_arrive(empty + prev);
        }
        if (++stage == RSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else {
      wgmma_wait<0>();
      if (lt == 0) mbar_arrive(empty + prev);
    }
    fence_acc(acc[0]);

    if (i == 0) {  // dx = g_0 · W_0ᵀ, f32
      wgmma_wait<0>();
      fence_acc(acc[1]);
      for (int c = 0; c < (nhalf > 1 ? nchunk : 0); ++c)
        if (lt == 0) mbar_arrive(empty + (first1 + c) % RSTAGES);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= nhalf) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int gr = row0 + 16 * wl + gl + 8 * (q >> 1);
            const int col = h * SLAB_K + 8 * j + 2 * t + (q & 1);
            if (gr < B && col < d.E) dx[(size_t)gr * d.E + col] = acc[h][4 * j + q];
          }
      }
      break;
    }

    // g_{i-1} = bf16(acc * (a_i > 0)) into the g tile, f32 column sums;
    // half 0's results wait in registers until half 1's products have read
    // the tile
    mbar_wait(mfull, mphase);
    mphase ^= 1;
    float* csl = cs + (i & 1) * 4 * MAXW + wl * MAXW;
    uint32_t pk[32];
    rev_half_epilogue<0>(acc[0], mask, pk, csl, wl, lane);
    wgmma_wait<0>();
    fence_acc(acc[1]);
    for (int c = 0; c < (nhalf > 1 ? nchunk : 0); ++c)
      if (lt == 0) mbar_arrive(empty + (first1 + c) % RSTAGES);
    rev_half_store<0>(gt, pk, w, wl, lane);
    if (nhalf > 1) {
      rev_half_epilogue<1>(acc[1], mask, pk, csl, wl, lane);
      rev_half_store<1>(gt, pk, w, wl, lane);
    }
    fence_async_smem();
    named_sync(1 + w, 128);  // the tile is whole: the next layer may read it
    if (lt == 0) mbar_arrive(mempty);
    // db_{i-1} over the warpgroup's rows: the four warps' sums in order
    const float* csp = cs + (i & 1) * 4 * MAXW;
    for (int c = lt; c < Kk; c += 128)
      dbp[p.boff[i - 1] + c] = ((csp[c] + csp[MAXW + c]) + csp[2 * MAXW + c]) + csp[3 * MAXW + c];
    // g_{i-1} to the scratch for the dW GEMM: each warp its own 16 rows,
    // 16 bytes a lane, a row's chunks on neighbouring lanes
    const int Kkp = r16(Kk), cpr = Kkp >> 3;
    bf16* Gp = reinterpret_cast<bf16*>(scratch + p.off_G[i - 1]);
    for (int idx = lane; idx < 16 * cpr; idx += 32) {
      const int rr = idx / cpr, ch = idx - rr * cpr;
      const int r = 16 * wl + rr, gr = row0 + r;
      if (gr < B)
        *reinterpret_cast<uint4*>(Gp + (size_t)gr * Kkp + ch * 8) = *reinterpret_cast<const uint4*>(
            gt + (ch >> 3) * GT_ATOM + sw128_offset(64 * w + r, (ch & 7) * 8));
    }
  }
}

// Reverse pass over one 128-row tile of video blockIdx.y (see the note at
// the head of the file).
__global__ void __launch_bounds__(BWD_THREADS, 1)
chain_reverse_kernel(const __grid_constant__ RevParams p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + REV_OFF_BAR);
  uint64_t* empty = full + RSTAGES;
  uint64_t* mfull = empty + RSTAGES;  // one per consumer warpgroup
  uint64_t* mempty = mfull + 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RSTAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(mfull + w, 1);
      mbar_init(mempty + w, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    if (warp == 0) {
      rev_produce_slabs(p, smem + REV_OFF_RING, full, empty, blockIdx.y, lane);
    } else if (warp <= 2 && lane == 0) {
      const int w = warp - 1;
      rev_produce_masks(p, smem + REV_OFF_MASK + w * MASK_WG, mfull + w, mempty + w,
                        blockIdx.x * RT + 64 * w, blockIdx.y);
    }
  } else {
    setmaxnreg_inc<232>();
    rev_consume(p, smem, full, empty, mfull + wg, mempty + wg, wg);
  }
}

struct DwSeg {
  int a_map, g_map;        // tensor maps of A (activations) and G (gradients)
  int K, rowoff, N, woff;  // rows [rowoff, rowoff + K) of the (in, N) dW at woff
  int tiles_n, tile0;
};

struct DwParams {
  CUtensorMap maps[2 * MAXL];  // bf16(x), stash layers 1..n-1, G layers 0..n-1
  DwSeg seg[2 * MAXL];
  int nseg, B, rows_per_slice, totalW;
  float* part;                 // video v's slice s at part + v * part_vs + s * totalW
  size_t part_vs;
};

// dW partial of one DW_T x DW_T output tile over one row slice of video
// blockIdx.z: Aᵀ·G with both operands MN-major (rows are the contraction).
// Consumer warpgroup w owns dW rows m0 + 64w .. + 64.
__global__ void __launch_bounds__(BWD_THREADS, 1)
dw_kernel(const __grid_constant__ DwParams p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + DW_STAGES;
  const int tblk = blockIdx.x, s = blockIdx.y, v = blockIdx.z;
  int si = 0;
  while (si + 1 < p.nseg && tblk >= p.seg[si + 1].tile0) ++si;
  const DwSeg& sg = p.seg[si];
  const int lti = tblk - sg.tile0, tm = lti / sg.tiles_n, tn = lti - tm * sg.tiles_n;
  const int m0 = tm * DW_T, n0 = tn * DW_T;
  const int r0 = s * p.rows_per_slice, r1 = imin(p.B, r0 + p.rows_per_slice);
  const int nchunk = (r1 - r0 + DW_RK - 1) / DW_RK;
  // 64-column blocks that lie inside the operands (the rest are not loaded;
  // their products land in columns that are not stored)
  const int na = (m0 + 64 < r16(sg.K)) ? 2 : 1, ng = (n0 + 64 < r16(sg.N)) ? 2 : 1;
  if (threadIdx.x == 0) {
    for (int st = 0; st < DW_STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < nchunk; ++c) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* st = smem + stage * DW_STAGE_BYTES;
        mbar_arrive_expect_tx(full + stage, (uint32_t)((na + ng) * DW_ATOM));
        const int r = r0 + c * DW_RK;
        for (int a = 0; a < na; ++a)
          tma_load_3d(st + a * DW_ATOM, &p.maps[sg.a_map], full + stage, m0 + 64 * a, r, v);
        for (int b = 0; b < ng; ++b)
          tma_load_3d(st + (2 + b) * DW_ATOM, &p.maps[sg.g_map], full + stage, n0 + 64 * b, r,
                      v);
        if (++stage == DW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  const int lt = threadIdx.x & 127, wl = lt >> 5, lane = lt & 31, gl = lane >> 2, t = lane & 3;
  float acc[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = 0.0f;
  fence_acc(acc);
  wgmma_fence();
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int c = 0; c < nchunk; ++c) {
    mbar_wait(full + stage, phase);
    const unsigned char* st = smem + stage * DW_STAGE_BYTES;
#pragma unroll
    for (int k = 0; k < DW_RK / 16; ++k)
      wgmma_m64n128<1, 1>(acc, sw128_desc(st + wg * DW_ATOM + k * 2048, DW_ATOM, 1024),
                          sw128_desc(st + 2 * DW_ATOM + k * 2048, DW_ATOM, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && lt == 0) mbar_arrive(empty + prev);
    prev = stage;
    if (++stage == DW_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lt == 0 && prev >= 0) mbar_arrive(empty + prev);
  float* dst = p.part + v * p.part_vs + (size_t)s * p.totalW + sg.woff;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + 64 * wg + 16 * wl + gl + 8 * (q >> 1);
      const int nn = n0 + 8 * j + 2 * t + (q & 1);
      if (m < sg.K && nn < sg.N) dst[(size_t)(sg.rowoff + m) * sg.N + nn] = acc[4 * j + q];
    }
}

constexpr int RED_THREADS = 256;

// grads = (Σ_slices part[s][e] for every dW element e, then Σ_rows dbp[r][c]
// for every db column c over the 64-row partials), for video blockIdx.y
// (part and dbp move by `vs` floats a video, grads by totalW + totalB).
// Blocks below `wblocks` take 256 dW elements; the others 32 db columns,
// whose rows warp k sums in the order k, k + 8, ..., the 8 sums then added
// in order.  Every sum has a fixed order.
__global__ void __launch_bounds__(RED_THREADS)
reduce_kernel(const float* __restrict__ part, int S, int totalW, const float* __restrict__ dbp,
              int nrows, int totalB, float* __restrict__ grads, size_t vs, int wblocks) {
  __shared__ float sums[RED_THREADS / 32][32];
  const int v = blockIdx.y;
  part += v * vs;
  dbp += v * vs;
  grads += (size_t)v * (totalW + totalB);
  if ((int)blockIdx.x < wblocks) {
    const int e = blockIdx.x * RED_THREADS + threadIdx.x;
    if (e < totalW) {
      float s = 0.0f;
      for (int k = 0; k < S; ++k) s += part[(size_t)k * totalW + e];
      grads[e] = s;
    }
    return;
  }
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int c = (blockIdx.x - wblocks) * 32 + lane;
  float s = 0.0f;
  if (c < totalB)
    for (int r = k; r < nrows; r += RED_THREADS / 32) s += dbp[(size_t)r * totalB + c];
  sums[k][lane] = s;
  __syncthreads();
  if (k == 0 && c < totalB) {
    float t = sums[0][lane];
    for (int q = 1; q < RED_THREADS / 32; ++q) t += sums[q][lane];
    grads[totalW + c] = t;
  }
}

int check_desc(const ChainDesc* d, int B, int V) {
  if (d == nullptr || d->n_layers < 1 || d->n_layers > MAXL || B < 1) return (int)cudaErrorInvalidValue;
  if (V < 1 || V > 65535) return (int)cudaErrorInvalidValue;
  if (d->E < 1 || d->E > MAXW) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < d->n_layers; ++i) {
    if (d->out_dim[i] < 1 || d->out_dim[i] > MAXW) return (int)cudaErrorInvalidValue;
    const int kept = (i == 0) ? d->E : d->out_dim[i - 1];
    const int want = kept + ((i > 0 && d->skip[i]) ? d->E : 0);
    if (d->in_dim[i] != want || (i == 0 && d->skip[0])) return (int)cudaErrorInvalidValue;
    if (d->W[i] == nullptr || d->b[i] == nullptr) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// cuTensorMapEncodeTiled looked up through the runtime: the library links
// only the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)f;
  }
  return fn;
}

// bf16 (columns, rows, videos) map, 128-byte swizzle, zero outside the tensor
bool make_map(CUtensorMap* m, const void* base, int cols, int rows, int V, size_t row_bytes,
              size_t video_bytes, int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || ((uintptr_t)base & 15) || (row_bytes & 15) || (video_bytes & 15))
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)V};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)video_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// forward launch over V videos, with (STASH) or without a caller-owned stash
template <bool STASH, bool OUTPUT>
int launch_fwd(const ChainDesc* d, const float* x, float* out, bf16* stash, size_t stash_vs,
               int B, int V, cudaStream_t st) {
  const SmemLayout L = smem_layout(*d);
  const int ntiles = (B + BM - 1) / BM;
  cudaError_t err = cudaFuncSetAttribute(chain_fwd_kernel<STASH, OUTPUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  chain_fwd_kernel<STASH, OUTPUT><<<dim3(ntiles, V), NTHREADS, L.bytes, st>>>(*d, x, out, B, stash,
                                                                             stash_vs);
  return (int)cudaGetLastError();
}

// the launches of a backward, as bits of `pieces`
enum { PIECE_RECOMPUTE = 1, PIECE_REVERSE = 2, PIECE_DW = 4, PIECE_REDUCE = 8, PIECE_ALL = 15 };

// backward over V videos: (remat) the recompute into the scratch's stash,
// then the reverse pass reading the stash, the dW GEMM and the reduction;
// `scratch` holds V per-video scratch areas back to back.  `pieces` runs a
// subset on a scratch a whole call has filled (for timing the pieces).
int launch_bwd(const ChainDesc* d, const float* x, const float* g, const bf16* stash, float* dx,
               float* grads, int B, int V, void* scratch, void* stream, bool remat,
               int pieces = PIECE_ALL) {
  const int bad = check_desc(d, B, V);
  if (bad) return bad;
  if (!remat && stash == nullptr && d->n_layers > 1) return (int)cudaErrorInvalidValue;
  const int n = d->n_layers;
  const ScratchLayout S = scratch_layout(*d, B, remat);
  cudaStream_t st = (cudaStream_t)stream;
  char* base = (char*)scratch;
  size_t soff[MAXL] = {};
  const size_t stash_elems = stash_offsets(*d, B, soff);
  size_t stash_vs = stash_elems;
  if (remat) {
    stash = reinterpret_cast<const bf16*>(base + S.stash);
    stash_vs = S.bytes / sizeof(bf16);
    if (n > 1 && (pieces & PIECE_RECOMPUTE)) {
      const int err = launch_fwd<true, false>(d, x, nullptr, const_cast<bf16*>(stash), stash_vs,
                                              B, V, st);
      if (err) return err;
    }
  }
  if ((uintptr_t)stash & 15) return (int)cudaErrorInvalidValue;

  // stash layer i as (r16 width, B rows, videos) in 64 x 64 boxes: the
  // reverse pass's relu mask and the dW GEMM's A
  RevParams* rp = new RevParams;
  memset(rp, 0, sizeof(RevParams));
  bool ok = true;
  for (int i = 1; i < n; ++i) {
    const int w = r16(d->out_dim[i - 1]);
    ok = ok && make_map(&rp->mmap[i], stash + soff[i], w, B, V, (size_t)w * 2, stash_vs * 2, 64,
                        64);
  }
  rp->d = *d;
  for (int i = 0; i < n; ++i) {
    const int N = d->out_dim[i];
    rp->wtma[i] = (N % 8 == 0) &&
                  make_map(&rp->wmap[i], d->W[i], N, kept_width(*d, i), V, (size_t)N * 2,
                           (size_t)d->in_dim[i] * N * 2, SLAB_N, SLAB_K);
    rp->off_G[i] = S.G[i];
    rp->boff[i] = S.boff[i];
  }
  rp->x = x;
  rp->g = g;
  rp->dx = dx;
  rp->scratch = base;
  rp->scratch_vs = S.bytes;
  rp->off_x = S.stash_x;
  rp->off_dbp = S.dbp;
  rp->B = B;
  rp->totalB = S.totalB;
  cudaError_t err = ok ? cudaFuncSetAttribute(chain_reverse_kernel,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              REV_SMEM)
                       : cudaErrorInvalidValue;
  if (err == cudaSuccess && (pieces & PIECE_REVERSE)) {
    chain_reverse_kernel<<<dim3(S.ntiles, V), BWD_THREADS, REV_SMEM, st>>>(*rp);
    err = cudaGetLastError();
  }
  DwParams* dp = new DwParams;
  memset(dp, 0, sizeof(DwParams));
  for (int i = 1; i < n; ++i) dp->maps[i] = rp->mmap[i];
  delete rp;
  if (err != cudaSuccess) {
    delete dp;
    return (int)err;
  }
  static_assert(DW_RK == 64, "the stash maps' 64-row boxes serve the dW GEMM too");
  ok = make_map(&dp->maps[0], base + S.stash_x, r16(d->E), B, V, (size_t)r16(d->E) * 2, S.bytes,
                64, DW_RK);
  for (int i = 0; i < n; ++i) {
    const int w = r16(d->out_dim[i]);
    ok = ok && make_map(&dp->maps[n + i], base + S.G[i], w, B, V, (size_t)w * 2, S.bytes, 64,
                        DW_RK);
  }
  int tiles = 0;
  for_each_dw_segment(*d, [&](int i, bool xseg, int K, int rowoff) {
    DwSeg& sg = dp->seg[dp->nseg++];
    sg.a_map = xseg ? 0 : i;
    sg.g_map = n + i;
    sg.K = K;
    sg.rowoff = rowoff;
    sg.N = d->out_dim[i];
    sg.woff = S.woff[i];
    sg.tiles_n = (sg.N + DW_T - 1) / DW_T;
    sg.tile0 = tiles;
    tiles += ((K + DW_T - 1) / DW_T) * sg.tiles_n;
  });
  dp->B = B;
  dp->rows_per_slice = S.rows_per_slice;
  dp->totalW = S.totalW;
  float* part = reinterpret_cast<float*>(base + S.part);
  dp->part = part;
  dp->part_vs = S.bytes / sizeof(float);
  err = ok ? cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM)
           : cudaErrorInvalidValue;
  if (err == cudaSuccess && (pieces & PIECE_DW)) {
    dw_kernel<<<dim3(tiles, S.S, V), BWD_THREADS, DW_SMEM, st>>>(*dp);
    err = cudaGetLastError();
  }
  delete dp;
  if (err != cudaSuccess) return (int)err;

  if (!(pieces & PIECE_REDUCE)) return 0;
  const int wblocks = (S.totalW + RED_THREADS - 1) / RED_THREADS;
  reduce_kernel<<<dim3(wblocks + (S.totalB + 31) / 32, V), RED_THREADS, 0, st>>>(
      part, S.S, S.totalW, reinterpret_cast<const float*>(base + S.dbp), 2 * S.ntiles, S.totalB,
      grads, S.bytes / sizeof(float), wblocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-video sizes: a V-video call takes V of each, back to back (x, out and
// g as (V, B, .), weights (V, in, out), biases (V, out), grads V x (all dW,
// then all db), stash V x imlp_chain_stash_elems, scratch V x the bytes).
size_t imlp_chain_bwd_scratch_bytes(const ChainDesc* d, int B) {
  return scratch_layout(*d, B, true).bytes;
}

size_t imlp_chain_bwd_stash_scratch_bytes(const ChainDesc* d, int B) {
  return scratch_layout(*d, B, false).bytes;
}

// rows of a split-K slice of the dW GEMM at B rows (the last slice may be shorter)
int imlp_chain_dw_slice_rows(const ChainDesc* d, int B) {
  return scratch_layout(*d, B, false).rows_per_slice;
}

// bf16 elements of the stash of a B-row call: B x sum r16(width of layers 0..n-2)
size_t imlp_chain_stash_elems(const ChainDesc* d, int B) {
  return stash_offsets(*d, B, nullptr);
}

int imlp_chain_fwd(const ChainDesc* d, const float* x, float* out, int B, int V, void* stream) {
  const int bad = check_desc(d, B, V);
  if (bad) return bad;
  return launch_fwd<false, true>(d, x, out, nullptr, 0, B, V, (cudaStream_t)stream);
}

int imlp_chain_fwd_stash(const ChainDesc* d, const float* x, float* out, void* stash, int B,
                         int V, void* stream) {
  const int bad = check_desc(d, B, V);
  if (bad) return bad;
  if (stash == nullptr && d->n_layers > 1) return (int)cudaErrorInvalidValue;
  return launch_fwd<true, true>(d, x, out, (bf16*)stash, stash_offsets(*d, B, nullptr), B, V,
                                (cudaStream_t)stream);
}

int imlp_chain_bwd(const ChainDesc* d, const float* x, const float* g, float* dx, float* grads,
                   int B, int V, void* scratch, void* stream) {
  return launch_bwd(d, x, g, nullptr, dx, grads, B, V, scratch, stream, true);
}

int imlp_chain_bwd_stash(const ChainDesc* d, const float* x, const float* g, const void* stash,
                         float* dx, float* grads, int B, int V, void* scratch, void* stream) {
  return launch_bwd(d, x, g, (const bf16*)stash, dx, grads, B, V, scratch, stream, false);
}

// One piece of a backward on a scratch that a whole call with the same
// operands has filled: PIECE_* bits; remat picks the pair's scratch layout.
int imlp_chain_bwd_pieces(const ChainDesc* d, const float* x, const float* g, const void* stash,
                          float* dx, float* grads, int B, int V, void* scratch, void* stream,
                          int remat, int pieces) {
  return launch_bwd(d, x, g, (const bf16*)stash, dx, grads, B, V, scratch, stream, remat != 0,
                    pieces);
}

// Registers, local (spill) bytes a thread and dynamic shared memory of a
// launch of kernel `which`: 0-2 the forward <false, true>, <true, true>,
// <true, false> (the latter at the widest layer, 256), 3 the reverse pass,
// 4 the dW GEMM, 5 the reduction.
int imlp_chain_kernel_attrs(int which, int* regs, int* local_bytes, int* smem_bytes) {
  const void* fns[6] = {(const void*)chain_fwd_kernel<false, true>,
                        (const void*)chain_fwd_kernel<true, true>,
                        (const void*)chain_fwd_kernel<true, false>,
                        (const void*)chain_reverse_kernel, (const void*)dw_kernel,
                        (const void*)reduce_kernel};
  if (which < 0 || which > 5) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  ChainDesc wide{};
  wide.n_layers = 2;
  wide.E = MAXW;
  wide.out_dim[0] = wide.out_dim[1] = MAXW;
  const int dyn[6] = {(int)smem_layout(wide).bytes, (int)smem_layout(wide).bytes,
                      (int)smem_layout(wide).bytes, REV_SMEM, DW_SMEM, 0};
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = dyn[which] + (int)a.sharedSizeBytes;
  return 0;
}

}  // extern "C"
