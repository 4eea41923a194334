// GMA's global motion aggregation for Hopper (sm_90a), inference only: the
// softmax attention over the context features, built once a flow solve, and
// the aggregation of the motion features through it, once a GRU iteration.
//
// Replaces no TPU kernel: the JAX package has no GMA.  It was added with
// GMA's flow model (models/gma.py; Jiang et al., ICCV 2021,
// zacjiang/GMA core/gma.py `Attention` and `Aggregate`, content only, one
// head), the first softmax attention the port computes.
//
// Function.  For direction b with N positions (the 1/8-resolution grid in
// raster order), q_i and k_j the two 128-channel halves of row i and j of
// qk (B, N, ld) bf16 (q at column 0, k at column 128), c = log2(e) / sqrt(128):
//   build:      x_ij = c <q_i, k_j>,  m_i = max_j x_ij,  l_i = sum_j 2^(x_ij - m_i),
//               P[b, i, j] = bf16(2^(x_ij - m_i) / l_i)   (j < N; columns N .. Np-1 are 0),
//               stats[b, i] = (m_i, 1 / l_i);
//   aggregate:  out[b, i, :] = mf[b, i, :] + gamma * sum_j P[b, i, j] v[b, j, :],
// the products bf16 x bf16 on the tensor cores (mma.sync m16n8k16), every
// sum and the softmax statistics in f32, mf, gamma and out in the model's
// dtype (bf16 or f32).  P's row stride Np is N rounded up to 64, so every
// tile of a row is whole and 16-byte aligned.  softmax(q k^T / sqrt(128)) =
// 2^(x - m) / l: GMA's attention, with the scale folded into the exponent.
//
// Bound on the H100.  At 1080x1920 frames (N = 32,400) a direction's build
// takes 2 N^2 128 = 268.7 GFLOP of products and each of its 20 aggregations
// as many; q, k, v and the outputs are 8.3 MB each.  So products bound the
// function: 21 x 268.7 GFLOP = 5.7 ms a direction at 989 TFLOP/s
// (`counts/gma.py` `attention_bound_s`), whatever implements it.
//
// Design: P stored once a solve, in bf16.  The build runs QK^T twice, once
// for the row statistics (online max and sum over key tiles, as flash
// attention keeps them) and once to write P, 2.1 GB a direction at 1080p;
// each iteration's aggregation is then one product of P with v, a stream
// of P from HBM (2.1 GB a direction and iteration, 0.63 ms at 3.35 TB/s).
// The other design keeps the statistics and recomputes QK^T every
// iteration: no N^2 memory, but twice the products of the bound, with the
// exponentials between them, every iteration: 0.54 ms a direction and
// iteration at the bf16 peak, about 1.1 ms at the half of it that
// mma.sync reaches.  The stored P's aggregation, a stream of P, took 0.81
// ms a direction and iteration on an H100 (6.49 ms a batch of 8, 77 % of
// HBM's peak; torch.matmul's product of the same P and v 6.31 ms), the
// build 3.3 ms a direction: the stored P is the faster design while the
// device holds it (16.8 GB for the 8 directions of a 1080p batch).
//   * build (`gma_attn_build_kernel<PROBS>`, PROBS = false then true): a
//     block takes 128 rows of q, 16 a warp, their A fragments in registers
//     for the whole launch; k streams through a ring of 3 tiles of 64 keys
//     x 128 channels (cp.async, 16-byte chunks swizzled by the row's low
//     bits, so each ldmatrix phase reads 8 distinct bank groups); a tile's
//     64 x 128 scores per warp come from 64 mma.sync.  Pass 0 folds them
//     into each row's running max and sum (the quad's max by two shuffles
//     a tile; the sums reduced once at the end); pass 1 writes
//     bf16(2^(x - m) / l) as bf16 pairs, the eight pairs of a row and warp
//     one 128-byte line of P, merged in L2.
//   * aggregate (`gma_attn_aggregate_kernel<T>`): a block takes 128 rows of
//     P and all 128 output channels; 8 warps as 4 x 2, each 32 rows x 64
//     channels (64 f32 sums a thread); a ring of 3 stages, each a 128 x 64
//     tile of P and the 64 x 128 tile of v it multiplies (32 KB, cp.async,
//     swizzled), the next two in flight while one is multiplied; A by
//     ldmatrix, B by ldmatrix.trans from v's rows; the epilogue adds mf
//     and scales by gamma, read from the device (a captured solve replays
//     the parameter's value).  v's 8.3 MB stay in L2 while a direction's
//     blocks run.
//
// Interface: plain C, loaded with ctypes; every launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DH = 128;        // q, k, v, mf channels (GMA's dim_head, one head)
constexpr int BM = 128;        // rows a block
constexpr int BN = 64;         // keys a tile
constexpr int THREADS = 256;   // 8 warps
constexpr int STAGES = 3;      // tiles in flight a block
constexpr int KEY_TILE_BYTES = BN * DH * 2;            // 16 KB: 64 keys x 128 channels
constexpr int P_TILE_BYTES = BM * BN * 2;              // 16 KB: 128 rows x 64 keys
constexpr int AGG_STAGE_BYTES = P_TILE_BYTES + KEY_TILE_BYTES;
constexpr int BUILD_SMEM = STAGES * KEY_TILE_BYTES;    // 48 KB
constexpr int AGG_SMEM = STAGES * AGG_STAGE_BYTES;     // 96 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (the
// source is then not read)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of rows of
// `chunks` chunks (a multiple of 8): the chunk index XOR the row's low 3 bits
__device__ __forceinline__ uint32_t swz(int row, int chunk, int chunks) {
  return (uint32_t)(row * chunks * 16 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += A B: A 16 x 16 (fragments a0..a3), B 16 x 8 (b0, b1), bf16 operands,
// f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float scalar(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float scalar(const float* p) { return *p; }

// ---------------------------------------------------------------------------
// build: row statistics (PROBS = false), then P (PROBS = true)
// ---------------------------------------------------------------------------

template <bool PROBS>
__global__ void __launch_bounds__(THREADS, 2)
    gma_attn_build_kernel(const bf16* __restrict__ qk, int ld, int N, int Np, float c,
                          float2* __restrict__ stats, bf16* __restrict__ probs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* q = qk + (size_t)b * N * ld;
  const bf16* k = q + DH;
  const int rows[2] = {(int)blockIdx.x * BM + warp * 16 + g, (int)blockIdx.x * BM + warp * 16 + g + 8};

  // the warp's 16 rows of q as A fragments, read once (zero past N)
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int s = 0; s < DH / 16; ++s) {
    const int col = s * 16 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = rows[h] < N;
      const bf16* row = q + (size_t)(in ? rows[h] : 0) * ld;
      qa[s][h] = in ? ld_pair(row + col) : 0u;
      qa[s][2 + h] = in ? ld_pair(row + col + 8) : 0u;
    }
  }

  const uint32_t base = smem_u32(smem);
  const int nk = Np / BN;
  auto load = [&](int kt) {
    const uint32_t tile = base + (kt % STAGES) * KEY_TILE_BYTES;
#pragma unroll
    for (int i = 0; i < BN * DH / 8 / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx >> 4, ch = idx & 15;
      const int key = kt * BN + r;
      cp16(tile + swz(r, ch, 16), k + (size_t)(key < N ? key : 0) * ld + ch * 8, key < N);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float2 st[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  if (PROBS) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rows[h] < N) st[h] = stats[(size_t)b * N + rows[h]];
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_commit();
    const uint32_t tile = base + (kt % STAGES) * KEY_TILE_BYTES;

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        // matrices: keys 16np + [0, 8) and [8, 16), channels 16ks + [0, 8)
        // and [8, 16): b0, b1 of key tiles 2np and 2np + 1
        const int j = lane >> 3;
        const int key = np * 16 + (j >> 1) * 8 + (lane & 7);
        uint32_t bb[4];
        ldsm4(bb, tile + swz(key, ks * 2 + (j & 1), 16));
        mma16816(s[2 * np], qa[ks], bb[0], bb[1]);
        mma16816(s[2 * np + 1], qa[ks], bb[2], bb[3]);
      }
    }

    // the scores in the exponent's units, -inf past N
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BN + n * 8 + 2 * t + (e & 1);
        const float x = key < N ? s[n][e] * c : -INFINITY;
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }

    if (!PROBS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
        const float mn = fmaxf(m[h], tmax[h]);   // finite: key 0 < N is in tile 0
        l[h] *= exp2f(m[h] - mn);
        m[h] = mn;
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[n][e] - m[e >> 1]);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= N) continue;
        bf16* out = probs + ((size_t)b * N + rows[h]) * Np + kt * BN + 2 * t;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          store2(out + n * 8, exp2f(s[n][2 * h] - st[h].x) * st[h].y,
                 exp2f(s[n][2 * h + 1] - st[h].x) * st[h].y);
      }
    }
  }
  cp_wait<0>();

  if (!PROBS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (t == 0 && rows[h] < N) stats[(size_t)b * N + rows[h]] = make_float2(m[h], 1.f / l[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// aggregate: out = mf + gamma P v
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    gma_attn_aggregate_kernel(const bf16* __restrict__ probs, const bf16* __restrict__ v,
                              const T* __restrict__ mf, const T* __restrict__ gamma,
                              T* __restrict__ out, int N, int Np) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;     // rows 32 wm .., channels 64 wn ..
  const bf16* P = probs + (size_t)b * N * Np;
  const bf16* V = v + (size_t)b * N * DH;

  const uint32_t base = smem_u32(smem);
  const int nk = Np / BN;
  auto load = [&](int kt) {
    const uint32_t ptile = base + (kt % STAGES) * AGG_STAGE_BYTES;
    const uint32_t vtile = ptile + P_TILE_BYTES;
#pragma unroll
    for (int i = 0; i < BM * BN / 8 / THREADS; ++i) {     // P: 128 rows x 8 chunks
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx >> 3, ch = idx & 7;
      const int row = row0 + r;
      cp16(ptile + swz(r, ch, 8), P + (size_t)(row < N ? row : 0) * Np + kt * BN + ch * 8,
           row < N);
    }
#pragma unroll
    for (int i = 0; i < BN * DH / 8 / THREADS; ++i) {     // v: 64 keys x 16 chunks
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx >> 4, ch = idx & 15;
      const int key = kt * BN + r;
      cp16(vtile + swz(r, ch, 16), V + (size_t)(key < N ? key : 0) * DH + ch * 8, key < N);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;

  const int j = lane >> 3, rr = lane & 7;
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_commit();
    const uint32_t ptile = base + (kt % STAGES) * AGG_STAGE_BYTES;
    const uint32_t vtile = ptile + P_TILE_BYTES;
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // matrices: rows [0, 8) and [8, 16) of the m-tile, keys 16ks + [0, 8)
        // and [8, 16): a0, a1, a2, a3
        const int r = wm * 32 + mi * 16 + (j & 1) * 8 + rr;
        ldsm4(a[mi], ptile + swz(r, ks * 2 + (j >> 1), 8));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (transposed): keys 16ks + [0, 8) and [8, 16), channels
        // 64wn + 16np + [0, 8) and [8, 16): b0, b1 of n-tiles 2np, 2np + 1
        const int key = ks * 16 + (j & 1) * 8 + rr;
        uint32_t bb[4];
        ldsm4t(bb, vtile + swz(key, wn * 8 + np * 2 + (j >> 1), 16));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * np], a[mi], bb[0], bb[1]);
          mma16816(acc[mi][2 * np + 1], a[mi], bb[2], bb[3]);
        }
      }
    }
  }
  cp_wait<0>();

  const float gam = scalar(gamma);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * 32 + mi * 16 + g + 8 * h;
      if (row >= N) continue;
      const size_t at = ((size_t)b * N + row) * DH + wn * 64 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 x = load2(mf + at + n * 8);
        store2(out + at + n * 8, x.x + gam * acc[mi][n][2 * h], x.y + gam * acc[mi][n][2 * h + 1]);
      }
    }
}

template <typename K>
int with_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// qk (B, N, ld) bf16, q in columns [0, 128) and k in [128, 256) of each row,
// ld a multiple of 8; stats (B, N) float2; probs (B, N, Np) bf16, Np = N
// rounded up to 64; c = log2(e) / sqrt(128).  Two launches: the statistics,
// then P.
int gma_attention_build(const void* qk, int ld, int B, int N, int Np, float c, void* stats,
                        void* probs, void* stream) {
  if (B < 1 || N < 1 || B > 65535 || Np < N || Np % BN || ld < 2 * DH || ld % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((N + BM - 1) / BM), (unsigned)B);
  int err = with_smem(gma_attn_build_kernel<false>, BUILD_SMEM);
  if (err == 0) err = with_smem(gma_attn_build_kernel<true>, BUILD_SMEM);
  if (err != 0) return err;
  gma_attn_build_kernel<false><<<grid, THREADS, BUILD_SMEM, s>>>(
      (const bf16*)qk, ld, N, Np, c, (float2*)stats, (bf16*)probs);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  gma_attn_build_kernel<true><<<grid, THREADS, BUILD_SMEM, s>>>(
      (const bf16*)qk, ld, N, Np, c, (float2*)stats, (bf16*)probs);
  return (int)cudaGetLastError();
}

// probs (B, N, Np) bf16 as the build writes it, v (B, N, 128) bf16; mf and
// out (B, N, 128) and gamma (one value) in f32 when f32 != 0, else bf16.
int gma_attention_aggregate(const void* probs, const void* v, const void* mf, const void* gamma,
                            void* out, int B, int N, int Np, int f32, void* stream) {
  if (B < 1 || N < 1 || B > 65535 || Np < N || Np % BN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((N + BM - 1) / BM), (unsigned)B);
  int err;
  if (f32) {
    err = with_smem(gma_attn_aggregate_kernel<float>, AGG_SMEM);
    if (err != 0) return err;
    gma_attn_aggregate_kernel<float><<<grid, THREADS, AGG_SMEM, s>>>(
        (const bf16*)probs, (const bf16*)v, (const float*)mf, (const float*)gamma, (float*)out,
        N, Np);
  } else {
    err = with_smem(gma_attn_aggregate_kernel<bf16>, AGG_SMEM);
    if (err != 0) return err;
    gma_attn_aggregate_kernel<bf16><<<grid, THREADS, AGG_SMEM, s>>>(
        (const bf16*)probs, (const bf16*)v, (const bf16*)mf, (const bf16*)gamma, (bf16*)out, N,
        Np);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
