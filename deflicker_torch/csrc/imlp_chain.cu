// Fused IMLP linear-relu chain for Hopper (sm_90a): forward and remat backward.
//
// Replaces the TPU kernels of deflicker_tpu/ops/pallas/imlp_kernel.py:
//   * forward  — `_call_fwd` (:421, pallas_call :435; bodies `_fwd_kernel_pipe`
//     :237 / `_fwd_kernel` :111 through `_layer_fwd` :91, v2 split-skip);
//   * backward — `_chain_bwd` (:470, pallas_call :488; bodies
//     `_bwd_kernel_pipe` :265 / `_bwd_kernel` :127 + `_reverse_pass` :163).
//
// Function computed (pre-tanh chain, bf16 operands, f32 accumulation):
//   h0 = bf16(x)·bf16(W0) + b0
//   h_i = bf16(relu(h_{i-1}))·bf16(W_i) + b_i          (plain layers)
//   h_i = bf16(relu(h_{i-1}))·bf16(W_i[:d]) + bf16(x)·bf16(W_i[d:]) + b_i  (skip)
// Backward: recompute the tile's forward, then g_{n-1} = g,
//   dW_i = bf16(a_i)ᵀ·bf16(g_i), db_i = Σ_rows g_i (f32),
//   g_{i-1} = (bf16(g_i)·bf16(W_i[:d])ᵀ) * (a_i > 0),  dx = bf16(g_0)·bf16(W_0)ᵀ.
// The skip branch gets no gradient (the reference's detached skip input).
//
// Bound on the H100: compute.  Per row the chain is Σ in_i·out_i MACs
// (263,424 for the 6x256 mapping, 414,584 for the 8x256 atlas); at the fit's
// 90,000 / 30,000 rows that is 47.4 / 24.9 GFLOP forward, about 3x that
// backward, against a few MB of weights and inputs.
//
// Design, and what it does about that bound:
//   * One block owns a 64-row tile and keeps its bf16 activation tile in
//     shared memory for the whole chain; only x is read and only the output
//     written.  82 KB of shared memory and <= 128 registers a thread let two
//     forward blocks share an SM.  The layers' weights (0.5-0.8 MB in bf16) do not fit a block's
//     227 KB, so each layer's W streams through shared memory in 32-deep
//     slabs, double-buffered with cp.async so the next slab loads (from L2,
//     where every block finds the weights) while the tensor cores work on
//     the current one.
//   * Products are mma.sync m16n8k16 bf16 with f32 accumulators, operands
//     fed by ldmatrix (8 warps; each owns up to two 16-wide output column
//     tiles for all four 16-row tiles).  The accumulator layout is fixed by
//     the PTX ISA, so bias, relu, the bf16 cast, the backward's relu mask and
//     the db column sums all run in registers, written back as bf16 pairs.
//     Narrow widths (E = 3 or 40, O = 2 or 3) are zero-padded to 16 inside
//     the kernel; only real columns are stored.  Ragged batches are masked at
//     the edge (rows >= B read as 0 and are not stored).
//   * Backward: the TPU accumulated dW in a VMEM block across a sequential
//     grid; CUDA blocks run concurrently.  So the backward is three launches:
//     (1) per tile, recompute the forward and walk the chain in reverse,
//     writing the bf16 post-relu activations and bf16 per-layer gradients to
//     an HBM scratch (about 460 MB for the mapping at 90k rows) and per-tile
//     f32 column sums of g for db; (2) dW_i = Aᵀ·G as a split-K tensor-core
//     GEMM (128x128 output tiles over 4096-row slices) into per-slice
//     partials; (3) a reduction over slices and tiles.  Every sum runs in a
//     fixed order, so the gradients are deterministic.  Activations go to
//     HBM, not on chip: the 6-8 layers of a 64-row tile would need up to
//     224 KB of shared memory, and the dW GEMM reads them from HBM anyway.
//
// Interface: plain C, loaded with ctypes; every launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
constexpr int DW_ROWS = 4096;     // rows per split-K slice of the dW GEMM
constexpr int DW_T = 128;         // dW output tile (DW_T x DW_T)
constexpr int DW_RK = 32;         // rows per staged dW chunk
constexpr int DW_LD = DW_T + PAD;

}  // namespace

struct ChainDesc {
  int n_layers;
  int E;                 // real input width
  int in_dim[MAXL];      // real fan-in of layer i (skip layers: hidden + E)
  int out_dim[MAXL];     // real fan-out of layer i
  int skip[MAXL];        // 1 where layer i concatenates the input x
  const bf16* W[MAXL];   // (in_dim, out_dim) row-major
  const float* b[MAXL];  // (out_dim,)
};

namespace {

__host__ __device__ __forceinline__ int r16(int v) { return (v + 15) & ~15; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ size_t align256(size_t v) { return (v + 255) & ~size_t(255); }

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
  // forward slab: KS x (Np + PAD); transposed slab: Kk_p x (KS + PAD)
  const size_t slab = (size_t)imax(KS * (H + PAD), imax(Ep, H) * (KS + PAD)) * sizeof(bf16);
  size_t off = 0;
  L.off_xs = off;    off += (size_t)BM * L.xld * sizeof(bf16); off = (off + 127) & ~size_t(127);
  L.off_act = off;   off += (size_t)BM * L.ald * sizeof(bf16); off = (off + 127) & ~size_t(127);
  L.off_slab0 = off; off += slab;                             off = (off + 127) & ~size_t(127);
  L.off_slab1 = off; off += slab;
  L.bytes = off;
  return L;
}

struct ScratchLayout {
  int ntiles, Bp, S, totalW, totalB;
  int woff[MAXL], boff[MAXL];
  size_t stash_x, stashA[MAXL], G[MAXL], dbp, part, bytes;
};

__host__ __device__ inline ScratchLayout scratch_layout(const ChainDesc& d, int B) {
  ScratchLayout S;
  S.ntiles = (B + BM - 1) / BM;
  S.Bp = S.ntiles * BM;
  S.S = (S.Bp + DW_ROWS - 1) / DW_ROWS;
  S.totalW = 0;
  S.totalB = 0;
  for (int i = 0; i < d.n_layers; ++i) {
    S.woff[i] = S.totalW;
    S.boff[i] = S.totalB;
    S.totalW += d.in_dim[i] * d.out_dim[i];
    S.totalB += d.out_dim[i];
  }
  size_t off = 0;
  S.stash_x = off;
  off += align256((size_t)S.Bp * r16(d.E) * sizeof(bf16));
  S.stashA[0] = 0;
  for (int i = 1; i < d.n_layers; ++i) {
    S.stashA[i] = off;
    off += align256((size_t)S.Bp * r16(d.out_dim[i - 1]) * sizeof(bf16));
  }
  for (int i = 0; i < d.n_layers; ++i) {
    S.G[i] = off;
    off += align256((size_t)S.Bp * r16(d.out_dim[i]) * sizeof(bf16));
  }
  S.dbp = off;
  off += align256((size_t)S.ntiles * S.totalB * sizeof(float));
  S.part = off;
  off += align256((size_t)S.S * S.totalW * sizeof(float));
  S.bytes = off;
  return S;
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

// W[0:Kk, n0 : n0 + KS] -> slab [Kk_p][KS + PAD] (zero outside Kk x N)
__device__ __forceinline__ void load_bwd_slab(bf16* slab, const bf16* __restrict__ W, int n0,
                                              int Kk, int N) {
  const int Kkp = r16(Kk), tld = KS + PAD;
  if ((N & 7) == 0) {
    constexpr int nv = KS / 8;
    for (int idx = threadIdx.x; idx < Kkp * nv; idx += NTHREADS) {
      const int k = idx / nv, nn = (idx - k * nv) << 3;
      const bool ok = k < Kk && n0 + nn < N;
      cp_async16(slab + k * tld + nn, ok ? W + (size_t)k * N + n0 + nn : W, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < Kkp * KS; idx += NTHREADS) {
      const int k = idx / KS, nn = idx - k * KS;
      slab[k * tld + nn] = (k < Kk && n0 + nn < N) ? W[(size_t)k * N + n0 + nn]
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

// acc += G[:, 0:N] · W[0:Kk, 0:N]ᵀ (only the kept rows of W); G is a BM-row
// bf16 tile in smem (columns N..r16(N) zero), W row-major (ld N) in global.
__device__ __forceinline__ void gemm_bwd_seg(Acc& acc, const bf16* G, int ldg, int N,
                                             const bf16* __restrict__ W, int Kk,
                                             bf16* slab0, bf16* slab1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Np = r16(N), KT = r16(Kk) >> 4, tld = KS + PAD;
  const int nslab = (Np + KS - 1) / KS;
  __syncthreads();
  load_bwd_slab(slab0, W, 0, Kk, N);
  cp_async_commit();
  for (int s = 0; s < nslab; ++s) {
    const bf16* cur = (s & 1) ? slab1 : slab0;
    if (s + 1 < nslab) {
      load_bwd_slab((s & 1) ? slab0 : slab1, W, (s + 1) * KS, Kk, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp < KT) {
      const int n0 = s * KS, nend = imin(KS, Np - n0);
      for (int nn = 0; nn < nend; nn += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int rt = 0; rt < 4; ++rt)
          ldsm_x4(a[rt], G + (rt * 16 + (lane & 15)) * ldg + n0 + nn + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ct = warp + NWARP * j;
          if (ct < KT) {
            // element (k = n index, n = kept row) = W[row, n] = slab[row * tld + n]
            uint32_t b[4];
            ldsm_x4(b, cur + (ct * 16 + (lane & 7) + ((lane >> 4) << 3)) * tld + nn +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int rt = 0; rt < 4; ++rt) {
              mma16816(acc[rt][j][0], a[rt], b[0], b[1]);
              mma16816(acc[rt][j][1], a[rt], b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// Forward over one tile.  STASH (backward recompute): write bf16(x) and the
// bf16 post-relu input of every layer 1..n-1 to the scratch, and skip the
// last layer, whose output the backward does not need.
template <bool STASH>
__device__ __forceinline__ void chain_forward(const ChainDesc& d, const SmemLayout& L,
                                              const float* __restrict__ x, int B, int row0,
                                              float* __restrict__ out, unsigned char* smem,
                                              char* scratch, const ScratchLayout& S) {
  bf16* xs = reinterpret_cast<bf16*>(smem + L.off_xs);
  bf16* act = reinterpret_cast<bf16*>(smem + L.off_act);
  bf16* slab0 = reinterpret_cast<bf16*>(smem + L.off_slab0);
  bf16* slab1 = reinterpret_cast<bf16*>(smem + L.off_slab1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int Ep = r16(d.E);
  bf16* stash_x = STASH ? reinterpret_cast<bf16*>(scratch + S.stash_x) : nullptr;
  for (int idx = threadIdx.x; idx < BM * Ep; idx += NTHREADS) {
    const int r = idx / Ep, c = idx - r * Ep;
    const int gr = row0 + r;
    const float v = (gr < B && c < d.E) ? x[(size_t)gr * d.E + c] : 0.0f;
    const bf16 h = __float2bfloat16(v);
    xs[r * L.xld + c] = h;
    if (STASH) stash_x[(size_t)gr * Ep + c] = h;
  }

  const int nl = STASH ? d.n_layers - 1 : d.n_layers;
  for (int l = 0; l < nl; ++l) {
    const int N = d.out_dim[l], Np = r16(N), NT = Np >> 4;
    Acc acc;
    zero_acc(acc);
    if (l == 0) {
      gemm_fwd_seg(acc, xs, L.xld, d.E, d.W[0], 0, N, slab0, slab1);
    } else {
      const int Kh = d.out_dim[l - 1];
      gemm_fwd_seg(acc, act, L.ald, Kh, d.W[l], 0, N, slab0, slab1);
      if (d.skip[l]) gemm_fwd_seg(acc, xs, L.xld, d.E, d.W[l], Kh, N, slab0, slab1);
    }
    // gemm_*_seg ends with __syncthreads: nobody reads act any more
    const bool last = (l == d.n_layers - 1);
    bf16* stash = STASH ? reinterpret_cast<bf16*>(scratch + S.stashA[l + 1]) : nullptr;
    const float* __restrict__ bias = d.b[l];
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
              if (STASH) *reinterpret_cast<bf162*>(stash + (size_t)(row0 + row) * Np + col) = p;
            }
          }
        }
      }
    }
    // the next layer's gemm starts with __syncthreads before reading act
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS, FWD_MIN_BLOCKS)
chain_fwd_kernel(ChainDesc d, const float* __restrict__ x, float* __restrict__ out, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout L = smem_layout(d);
  const ScratchLayout S{};  // unused without a stash
  chain_forward<false>(d, L, x, B, blockIdx.x * BM, out, smem, nullptr, S);
}

// (at 128 registers this kernel spills ~1.6 KB a thread for no gain: it
// keeps the register file to itself, one block per SM)
__global__ void __launch_bounds__(NTHREADS)
chain_bwd_kernel(ChainDesc d, const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ dx, int B, char* scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout L = smem_layout(d);
  const ScratchLayout S = scratch_layout(d, B);
  const int tile = blockIdx.x, row0 = tile * BM;
  chain_forward<true>(d, L, x, B, row0, nullptr, smem, scratch, S);

  bf16* act = reinterpret_cast<bf16*>(smem + L.off_act);
  bf16* slab0 = reinterpret_cast<bf16*>(smem + L.off_slab0);
  bf16* slab1 = reinterpret_cast<bf16*>(smem + L.off_slab1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane >> 2, t = lane & 3;
  float* dbp = reinterpret_cast<float*>(scratch + S.dbp) + (size_t)tile * S.totalB;

  // the incoming gradient of the last layer: bf16 for products, f32 for db
  const int n = d.n_layers;
  const int O = d.out_dim[n - 1], Op = r16(O);
  bf16* Gl = reinterpret_cast<bf16*>(scratch + S.G[n - 1]);
  for (int idx = threadIdx.x; idx < BM * Op; idx += NTHREADS) {
    const int r = idx / Op, c = idx - r * Op;
    const int gr = row0 + r;
    const float v = (gr < B && c < O) ? g[(size_t)gr * O + c] : 0.0f;
    const bf16 h = __float2bfloat16(v);
    act[r * L.ald + c] = h;
    Gl[(size_t)gr * Op + c] = h;
  }
  for (int c = threadIdx.x; c < O; c += NTHREADS) {
    float s = 0.0f;
    for (int r = 0; r < BM && row0 + r < B; ++r) s += g[(size_t)(row0 + r) * O + c];
    dbp[S.boff[n - 1] + c] = s;
  }

  for (int i = n - 1; i >= 0; --i) {
    if (i == 0 && dx == nullptr) break;
    const int N = d.out_dim[i];
    const int Kk = (i == 0) ? d.E : d.out_dim[i - 1];
    const int Kkp = r16(Kk), KT = Kkp >> 4;
    Acc acc;
    zero_acc(acc);
    gemm_bwd_seg(acc, act, L.ald, N, d.W[i], Kk, slab0, slab1);
    // (ends with __syncthreads: g_i in act is no longer read)
    const bf16* Ai = (i > 0) ? reinterpret_cast<const bf16*>(scratch + S.stashA[i]) : nullptr;
    bf16* Gp = (i > 0) ? reinterpret_cast<bf16*>(scratch + S.G[i - 1]) : nullptr;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ct = warp + NWARP * j;
      if (ct >= KT) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ct * 16 + h * 8 + 2 * t;
        float cs0 = 0.0f, cs1 = 0.0f;  // this lane's rows of the two columns
#pragma unroll
        for (int rt = 0; rt < 4; ++rt) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = rt * 16 + gl + 8 * hr;
            const size_t gr = (size_t)(row0 + row);
            float v0 = acc[rt][j][h][2 * hr], v1 = acc[rt][j][h][2 * hr + 1];
            if (i > 0) {
              const bf162 a = *reinterpret_cast<const bf162*>(Ai + gr * Kkp + col);
              v0 = (__low2float(a) > 0.0f) ? v0 : 0.0f;
              v1 = (__high2float(a) > 0.0f) ? v1 : 0.0f;
              const bf162 p = __floats2bfloat162_rn(v0, v1);
              *reinterpret_cast<bf162*>(act + row * L.ald + col) = p;
              *reinterpret_cast<bf162*>(Gp + gr * Kkp + col) = p;
              cs0 += v0;
              cs1 += v1;
            } else if ((int)gr < B) {
              if (col < d.E) dx[gr * d.E + col] = v0;
              if (col + 1 < d.E) dx[gr * d.E + col + 1] = v1;
            }
          }
        }
        if (i > 0) {
          // fixed butterfly over the 8 lanes holding the same columns
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            cs0 += __shfl_xor_sync(0xffffffffu, cs0, m);
            cs1 += __shfl_xor_sync(0xffffffffu, cs1, m);
          }
          if (gl == 0) {
            if (col < Kk) dbp[S.boff[i - 1] + col] = cs0;
            if (col + 1 < Kk) dbp[S.boff[i - 1] + col + 1] = cs1;
          }
        }
      }
    }
    // the next gemm_bwd_seg starts with __syncthreads before reading act
  }
}

struct DwSeg {
  const bf16* A;  // (Bp, lda) activations feeding rows [rowoff, rowoff + K) of dW
  const bf16* G;  // (Bp, ldg) gradients of the layer output
  int lda, K, rowoff, ldg, N, woff, tiles_n, tile0;
};

struct DwDesc {
  int nseg;
  DwSeg seg[2 * MAXL];
};

// one DW_RK-row chunk of A[:, m0 : m0 + DW_T] and G[:, n0 : n0 + DW_T] -> smem
__device__ __forceinline__ void load_dw_chunk(bf16* As, bf16* Gs, const DwSeg& sg, int r,
                                              int m0, int n0) {
  constexpr int nv = DW_T / 8;
  for (int idx = threadIdx.x; idx < DW_RK * nv; idx += NTHREADS) {
    const int k = idx / nv, c = (idx - k * nv) << 3;
    const size_t row = (size_t)(r + k);
    const bool oka = m0 + c < sg.lda, okg = n0 + c < sg.ldg;
    cp_async16(As + k * DW_LD + c, oka ? sg.A + row * sg.lda + m0 + c : sg.A, oka);
    cp_async16(Gs + k * DW_LD + c, okg ? sg.G + row * sg.ldg + n0 + c : sg.G, okg);
  }
}

// dW partial of one DW_T x DW_T output tile over one row slice: Aᵀ·G.
// Warp (wm, wn) owns rows wm*32..+32 and columns wn*64..+64 of the tile.
__global__ void __launch_bounds__(NTHREADS)
dw_kernel(DwDesc dd, int Bp, float* __restrict__ part, int totalW) {
  __shared__ __align__(128) bf16 As[2][DW_RK * DW_LD];
  __shared__ __align__(128) bf16 Gs[2][DW_RK * DW_LD];
  const int tblk = blockIdx.x, s = blockIdx.y;
  int si = 0;
  while (si + 1 < dd.nseg && tblk >= dd.seg[si + 1].tile0) ++si;
  const DwSeg& sg = dd.seg[si];
  const int lt = tblk - sg.tile0;
  const int tm = lt / sg.tiles_n, tn = lt - tm * sg.tiles_n;
  const int m0 = tm * DW_T, n0 = tn * DW_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int Kp = r16(sg.K), Np = r16(sg.N);
  const bool mv0 = m0 + wm * 32 < Kp, mv1 = m0 + wm * 32 + 16 < Kp;
  const bool nv_any = n0 + wn * 64 < Np;

  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.0f;

  const int r0 = s * DW_ROWS, r1 = imin(Bp, r0 + DW_ROWS);
  const int nchunk = (r1 - r0) / DW_RK;
  load_dw_chunk(As[0], Gs[0], sg, r0, m0, n0);
  cp_async_commit();
  for (int c = 0; c < nchunk; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunk) {
      load_dw_chunk(As[buf ^ 1], Gs[buf ^ 1], sg, r0 + (c + 1) * DW_RK, m0, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (mv0 && nv_any) {
#pragma unroll
      for (int ks = 0; ks < DW_RK; ks += 16) {
        uint32_t fa[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)  // element (m, k) = A[k, m]: transposed load
          ldsm_x4_t(fa[mt], As[buf] + (ks + (lane & 7) + ((lane >> 4) << 3)) * DW_LD +
                                wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t fb[4];
          ldsm_x4_t(fb, Gs[buf] + (ks + (lane & 15)) * DW_LD + wn * 64 + np * 16 +
                            (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma16816(acc[mt][2 * np], fa[mt], fb[0], fb[1]);
            mma16816(acc[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!(mv0 && nv_any)) return;
  float* dst = part + (size_t)s * totalW + sg.woff;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt == 1 && !mv1) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * (q >> 1);
        const int nn = n0 + wn * 64 + nt * 8 + 2 * t + (q & 1);
        if (m < sg.K && nn < sg.N) dst[(size_t)(sg.rowoff + m) * sg.N + nn] = acc[mt][nt][q];
      }
    }
  }
}

// grads[e] = Σ_slices part[s][e] (dW), then Σ_tiles dbp[t][e'] (db).
__global__ void reduce_kernel(const float* __restrict__ part, int S, int totalW,
                              const float* __restrict__ dbp, int ntiles, int totalB,
                              float* __restrict__ grads) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < totalW) {
    float s = 0.0f;
    for (int k = 0; k < S; ++k) s += part[(size_t)k * totalW + e];
    grads[e] = s;
  } else if (e < totalW + totalB) {
    const int e2 = e - totalW;
    float s = 0.0f;
    for (int t = 0; t < ntiles; ++t) s += dbp[(size_t)t * totalB + e2];
    grads[e] = s;
  }
}

int check_desc(const ChainDesc* d, int B) {
  if (d == nullptr || d->n_layers < 1 || d->n_layers > MAXL || B < 1) return (int)cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

size_t imlp_chain_bwd_scratch_bytes(const ChainDesc* d, int B) {
  return scratch_layout(*d, B).bytes;
}

int imlp_chain_fwd(const ChainDesc* d, const float* x, float* out, int B, void* stream) {
  const int bad = check_desc(d, B);
  if (bad) return bad;
  const SmemLayout L = smem_layout(*d);
  cudaError_t err = cudaFuncSetAttribute(chain_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (B + BM - 1) / BM;
  chain_fwd_kernel<<<ntiles, NTHREADS, L.bytes, (cudaStream_t)stream>>>(*d, x, out, B);
  return (int)cudaGetLastError();
}

int imlp_chain_bwd(const ChainDesc* d, const float* x, const float* g, float* dx, float* grads,
                   int B, void* scratch, void* stream) {
  const int bad = check_desc(d, B);
  if (bad) return bad;
  const SmemLayout L = smem_layout(*d);
  const ScratchLayout S = scratch_layout(*d, B);
  cudaStream_t st = (cudaStream_t)stream;
  char* base = (char*)scratch;

  cudaError_t err = cudaFuncSetAttribute(chain_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  chain_bwd_kernel<<<S.ntiles, NTHREADS, L.bytes, st>>>(*d, x, g, dx, B, base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  DwDesc dd;
  dd.nseg = 0;
  int tiles = 0;
  const int Ep = r16(d->E);
  for (int i = 0; i < d->n_layers; ++i) {
    const int nsub = (i > 0 && d->skip[i]) ? 2 : 1;
    for (int q = 0; q < nsub; ++q) {
      DwSeg& sg = dd.seg[dd.nseg++];
      const bool xseg = (i == 0) || q == 1;
      sg.A = reinterpret_cast<const bf16*>(base + (xseg ? S.stash_x : S.stashA[i]));
      sg.lda = xseg ? Ep : r16(d->out_dim[i - 1]);
      sg.K = xseg ? d->E : d->out_dim[i - 1];
      sg.rowoff = (q == 1) ? d->out_dim[i - 1] : 0;
      sg.G = reinterpret_cast<const bf16*>(base + S.G[i]);
      sg.ldg = r16(d->out_dim[i]);
      sg.N = d->out_dim[i];
      sg.woff = S.woff[i];
      sg.tiles_n = (r16(sg.N) + DW_T - 1) / DW_T;
      sg.tile0 = tiles;
      tiles += ((r16(sg.K) + DW_T - 1) / DW_T) * sg.tiles_n;
    }
  }
  float* part = reinterpret_cast<float*>(base + S.part);
  dw_kernel<<<dim3(tiles, S.S), NTHREADS, 0, st>>>(dd, S.Bp, part, S.totalW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int total = S.totalW + S.totalB;
  reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(part, S.S, S.totalW,
                                                     reinterpret_cast<const float*>(base + S.dbp),
                                                     S.ntiles, S.totalB, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
