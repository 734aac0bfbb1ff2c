// Grouped expert GEMMs of the MoE FFN for Hopper (sm_90a).
//
// Replaces four TPU kernels of the reference package:
//   K1  repro/kernels/moe_gmm.py:_gmm_swiglu (body _gmm_swiglu_kernel)
//       h[i] = silu(x[i] @ wg[te[t]]) * (x[i] @ wi[te[t]]),  t = i / bn
//   K2  repro/kernels/moe_gmm.py:_gmm_scaled (body _gmm_scaled_kernel)
//       y[i] = (x[i] @ w[te[t]]) * row_scale[i]   (fp32 out)
//   K7  repro/kernels/moe_gmm.py:_gmm_swiglu_fused (body
//       _gmm_swiglu_fused_kernel): K1 on a fused lane pair's tiles
//   K8  repro/kernels/moe_gmm.py:_gmm_scaled_fused (body
//       _gmm_scaled_fused_kernel): K2 on a fused lane pair's tiles
//   K6  repro/kernels/moe_gmm.py:_gmm (body _gmm_kernel)
//       y[i] = x[i] @ w[te[t]]   (x's type, or fp32 out)
// Rows come packed by expert in row tiles of bn rows; tile t uses expert
// te[t]. A tile with tv[t] == 0 does no multiply-adds and writes zeros.
//
// K6 is K2's body with another epilogue: the fp32 sum is stored as it is
// (or rounded once to x's type), not multiplied by a row scale. Its K loop
// is K2's, so its fp32 output equals K2's with row_scale = 1 bit for bit.
//
// K7/K8 (FUSED): a fused pair's two lane runs share tiles, so one
// "straddle" tile may hold rows of two experts. There te2[t] != te[t], and
// row i uses te[t] where sel[i] > 0.5 and te2[t] otherwise. The block runs
// its K loop twice, once per expert, and zeroes the other expert's x rows
// while staging them: a zero row adds exactly 0 to the fp32 accumulator, so
// every row's sum is the one the unfused kernel computes with its own
// expert (the reference multiplies x by sel and by 1 - sel, the same
// thing). Non-straddle tiles (te2 == te) run once and read one weight
// stream, exactly as K1/K2 do.
//
// What bounds them on an H100: the expert weights. At the main path's
// prefill shape (K=4096, F=688, 16 experts, 2048 real rows) K1 does 23 GFLOP
// over 180 MB of weights, K2 11.5 GFLOP over 90 MB of weights plus 50 MB of
// fp32 output: both below the ~295 FLOP/byte ridge, so bytes bound them. At
// decode only the experts of valid tiles are read. K7/K8 at granite's
// prefill plan (K=1536, F=512, 40 experts, 4096 pairs in 5376 packed rows)
// read 126 MB (K7) and 63 MB (K8) of weights for 13 and 6.4 GFLOP: bytes
// bound them too, and a
// straddle tile reads its second expert's stripe once more. K6 at the
// full-width expert_ffn_gmm (2048 real rows of 3072, K=688, F=4096, 16
// experts) reads 90 MB of weights for 11.5 GFLOP: bytes again.
//
// Design, shared by both dtypes: one block per (row tile, 64-column
// stripe), or per (two row tiles, stripe) in some bf16 launches (below); a
// loop over K inside the block replaces the TPU's sequential k
// grid axis, and the fp32 accumulators live in registers. The block reads
// te/tv itself (no scalar prefetch). Ragged K and F edges are masked while
// staging and storing, so the weights are never copied or padded. Every
// tile writes its whole output, zeros for an invalid tile (outputs come
// from torch.empty).
//
// fp32: 256 threads, a 4x4 register tile per thread and stream, CUDA-core
// FMAs over synchronous BK = 32 stages.
//
// bf16 (the served dtype): bytes bound it, so the design keeps enough
// bytes in flight and reads as few as it can. A block has 8 warps and runs
// a ring of 16-byte cp.async.cg copies in dynamic shared memory, stages of
// BK = 64; one __syncthreads per stage both publishes the stage that has
// landed and frees the one the next copy overwrites, so the copies of the
// next stages overlap this stage's math. Two shapes of block, chosen by the
// wrapper from shapes alone (kernels/moe_gmm.py:gemm_ring):
//  - a decode (about one tile per expert; llama: ~10 valid tiles, so ~110
//    working blocks, about one per SM) takes one planner tile per block and
//    a deep ring (GEMM_DEEP_RING = 6 stages, ~120 KB in flight with
//    SwiGLU's two weight streams): by Little's law the card needs a few MB
//    in flight, and each SM has one block to carry it;
//  - a prefill (two or more tiles per expert) takes two planner tiles per
//    block (128 rows), so each weight stage feeds both tiles where they
//    share an expert: it halves the weight traffic from L2 that bounds a
//    prefill; two blocks share an SM (rings of 3-4 stages, 113 KB).
// A block runs one pass per distinct expert among its valid tiles (two on
// a fused pair's straddle tile): each row belongs to one expert, and a
// pass stages only its rows, zero-filling the rest; their products add
// exactly 0, so every row's sum is the one a one-tile block computes.
// Ragged K and F edges, padding rows past N and the other passes' rows are
// zero-filled by the copy itself (cp.async with src-size 0); shapes whose
// rows are not 16-byte multiples stage those chunks with plain loads and
// stores instead. Math: mma.sync m16n8k16 (bf16 in, fp32 accumulate), x
// fragments by ldmatrix, the [K, F] row-major weights by ldmatrix.trans;
// warp tiles of 32 x 16 (one tile) or 32 x 32 (two), and SwiGLU's two
// weight streams share the x fragments of a k step. The epilogue applies
// silu(g) * u (or the row scale) to the fp32 accumulators, writes zeros for
// invalid tiles, stages the tile in the freed ring and stores it with
// 16-byte vectors. BN stays 64 (not 128): llama's decode has F = 688, so
// 128-column stripes would leave ~55 working blocks for 132 SMs. The K
// order is one fixed sequence for every output, with no atomics and no
// split-K, so two launches give the same bits.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;        // rows per block: the planner's row tile bn
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // fp32: reduction depth per shared-memory stage
constexpr int THREADS = 256;  // fp32: 8 warps

// bf16 ring (kernels/moe_gmm.py:gemm_ring follows the same numbers)
constexpr int GEMM_BK = 64;            // reduction depth per ring stage
constexpr int GEMM_THREADS = 256;      // 8 warps
constexpr int GEMM_LDX = GEMM_BK + 8;  // x stage row stride (elements)
constexpr int GEMM_LDW = BN + 8;       // weight stage row stride
constexpr int GEMM_LDC = BN + 4;       // fp32 epilogue tile row stride
// ring bytes per block: two blocks share an SM's 228 KB (1 KB each is
// the system's)
constexpr int GEMM_RING_BYTES = 113 * 1024;

// A block owns TM planner tiles (64 TM rows); its 8 warps tile 64 TM x BN
// as WM x WN warps.
template <int TM>
struct GemmShape {
  static constexpr int ROWS = BM * TM;
  static constexpr int WM = TM == 1 ? 2 : 4;
  static constexpr int WN = 8 / WM;
  static constexpr int MI = ROWS / WM / 16;  // 16-row tiles per warp
  static constexpr int NI = BN / WN / 8;     // 8-column tiles per warp
  static_assert(NI % 2 == 0, "x4.trans loads two 8-column tiles");
};

template <bool SWIGLU, int TM>
__host__ __device__ constexpr int gemm_stage_elems() {
  return BM * TM * GEMM_LDX + (SWIGLU ? 2 : 1) * GEMM_BK * GEMM_LDW;
}

// The ring depth where two blocks share an SM: 4, or 3 where 4 would not
// fit. A grid of few blocks takes GEMM_DEEP_RING stages instead (one
// block per SM; the wrapper's gemm_ring decides).
template <bool SWIGLU, int TM>
__host__ __device__ constexpr int gemm_ring_depth() {
  return 4 * gemm_stage_elems<SWIGLU, TM>() * 2 <= GEMM_RING_BYTES ? 4 : 3;
}

constexpr int GEMM_DEEP_RING = 6;

template <bool SWIGLU, int TM, int STAGES>
__host__ __device__ constexpr int gemm_smem_bytes() {
  return STAGES * gemm_stage_elems<SWIGLU, TM>() * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two floats rounded to bf16 (round to nearest even, as __float2bfloat16),
// lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same<T, float>::value) {
    return 0.0f;
  } else {
    return __float2bfloat16(0.0f);
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16(v);
  }
}

__device__ __forceinline__ float silu(float g) { return g / (1.0f + __expf(-g)); }

// Epilogues: store the fp32 sum in the input type T (K1, K7, K6), store it
// as fp32 (K6 with an fp32 output), or store it times the row scale as
// fp32 (K2, K8).
enum Out { OUT_T = 0, OUT_F32 = 1, OUT_F32_SCALED = 2 };

template <typename T, int OUT>
__device__ __forceinline__ void store(void* out, size_t i, float v,
                                      const float* __restrict__ scale, int gr) {
  if constexpr (OUT == OUT_F32_SCALED) {
    static_cast<float*>(out)[i] = v * scale[gr];
  } else if constexpr (OUT == OUT_F32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<T*>(out)[i] = from_float<T>(v);
  }
}

// Row masks of the fused kernels' x staging: every row, or only the rows
// of the tile's primary (sel > 0.5) or secondary expert.
enum RowMask { ALL_ROWS = 0, PRIMARY_ROWS = 1, SECONDARY_ROWS = 2 };

// Stage a ROWS x COLS tile of a row-major [nrows, ld] matrix, starting at
// (r0, c0), into shared memory with row stride LDS. Elements outside
// [nrows, ncols) read as zero, and so do the rows that `mask` leaves out
// (by sel[row]). Each thread moves chunks of 8 elements; a chunk that lies
// wholly inside and is 16-byte aligned moves as vectors.
template <typename T, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(T* __restrict__ s,
                                          const T* __restrict__ g, int r0,
                                          int c0, int nrows, int ncols,
                                          int ld, bool vec_ok,
                                          const float* __restrict__ sel = nullptr,
                                          int mask = ALL_ROWS) {
  constexpr int CPR = COLS / 8;  // chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR;
    const int cc = (c % CPR) * 8;
    int gr = r0 + r;
    const int gc = c0 + cc;
    T* dst = s + r * LDS + cc;
    if (mask != ALL_ROWS && gr < nrows &&
        (sel[gr] > 0.5f) != (mask == PRIMARY_ROWS)) {
      gr = nrows;  // the other expert's row: stage zeros
    }
    if (vec_ok && gr < nrows && gc + 8 <= ncols) {
      const T* src = g + (size_t)gr * ld + gc;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
        reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[j] = (gr < nrows && gc + j < ncols) ? g[(size_t)gr * ld + gc + j]
                                                : zero_of<T>();
      }
    }
  }
}

// One 16-byte chunk of the bf16 ring: row gr, columns gc..gc+7 of a
// row-major [*, ld] matrix with ncols valid columns. With `vec` (ncols and
// ld multiples of 8, 16-byte aligned base) a chunk lies wholly inside or
// wholly outside, and cp.async copies it or zero-fills it (src-size 0);
// otherwise the chunk is staged element by element with plain stores,
// which the stage's __syncthreads publishes like the copies.
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst,
                                            const __nv_bfloat16* g, int gr,
                                            int gc, int ld, int ncols,
                                            bool row_live, bool vec) {
  if (vec) {
    const bool live = row_live && gc < ncols;
    cp_async16(dst, live ? g + (size_t)gr * ld + gc : g, live ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = (row_live && gc + j < ncols) ? g[(size_t)gr * ld + gc + j]
                                            : __float2bfloat16(0.0f);
  }
}

// The bf16 body of K1, K2, K6, K7 and K8 (see the header): the block of
// TM planner tiles from tile0 and the column stripe c0. Each row belongs
// to its tile's expert te[t], or te2[t] on a straddle tile where
// sel <= 0.5, or to none (invalid tile, past N). The block runs one pass
// per distinct expert of its valid tiles, through one ring; a pass stages
// only its expert's rows and zero-fills the others, whose products then
// add exactly 0 to their accumulators.
template <bool SWIGLU, bool FUSED, int OUT, int TM, int STAGES>
__device__ __forceinline__ void gmm_tc(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w0,
    const __nv_bfloat16* __restrict__ w1, const int* __restrict__ te,
    const int* __restrict__ te2, const int* __restrict__ tv,
    const float* __restrict__ sel, const float* __restrict__ scale,
    void* __restrict__ out, int N, int K, int F, bool vec_x, bool vec_w,
    bool vec_out) {
  using bf16 = __nv_bfloat16;
  using S = GemmShape<TM>;
  constexpr int NW = SWIGLU ? 2 : 1;
  constexpr int X_ELEMS = S::ROWS * GEMM_LDX;
  constexpr int W_ELEMS = GEMM_BK * GEMM_LDW;
  constexpr int STAGE = gemm_stage_elems<SWIGLU, TM>();
  constexpr int CPR = GEMM_BK / 8;  // 16-byte chunks per x row
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ int row_expert[S::ROWS];
  bf16* ring = reinterpret_cast<bf16*>(dsmem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tile0 = blockIdx.y * TM;
  const int r0 = tile0 * BM;
  const int c0 = blockIdx.x * BN;
  const int wr = (warp / S::WN) * (S::ROWS / S::WM);
  const int wc = (warp % S::WN) * (BN / S::WN);

  for (int r = tid; r < S::ROWS; r += GEMM_THREADS) {
    const int gr = r0 + r, t = tile0 + r / BM;
    int e = -1;
    if (gr < N && tv[t] != 0) {
      e = te[t];
      if (FUSED && te2[t] != e && !(sel[gr] > 0.5f)) e = te2[t];
    }
    row_expert[r] = e;
  }
  // the passes: distinct experts of the valid tiles, in tile order
  int e_pass[2 * TM];
  int passes = 0;
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int t = tile0 + j;
    if (t * BM >= N || tv[t] == 0) continue;
#pragma unroll
    for (int k = 0; k < (FUSED ? 2 : 1); ++k) {
      const int e = k == 0 ? te[t] : te2[t];
      bool seen = false;
      for (int i = 0; i < passes; ++i) seen |= e_pass[i] == e;
      if (!seen) e_pass[passes++] = e;
    }
  }
  __syncthreads();

  const int nk = (K + GEMM_BK - 1) / GEMM_BK;
  const int total = passes * nk;

  // ring stage i: pass i / nk, k0 = (i % nk) * GEMM_BK
  auto load_stage = [&](int i) {
    const int p = i / nk;
    const int k0 = (i - p * nk) * GEMM_BK;
    int e = e_pass[0];
#pragma unroll
    for (int j = 1; j < 2 * TM; ++j)
      if (p == j) e = e_pass[j];
    bf16* xs = ring + (i % STAGES) * STAGE;
    bf16* ws = xs + X_ELEMS;
    for (int c = tid; c < S::ROWS * CPR; c += GEMM_THREADS) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      stage_chunk(xs + r * GEMM_LDX + cc, x, r0 + r, k0 + cc, K, K,
                  row_expert[r] == e, vec_x);
    }
    const size_t woff = (size_t)e * K * F;
#pragma unroll
    for (int st = 0; st < NW; ++st) {
      const bf16* wsrc = (st == 0 ? w0 : w1) + woff;
      for (int c = tid; c < GEMM_BK * (BN / 8); c += GEMM_THREADS) {
        const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
        stage_chunk(ws + st * W_ELEMS + r * GEMM_LDW + cc, wsrc, k0 + r,
                    c0 + cc, F, F, k0 + r < K, vec_w);
      }
    }
  };

  float acc[NW][S::MI][S::NI][4];
#pragma unroll
  for (int st = 0; st < NW; ++st)
#pragma unroll
    for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[st][mi][ni][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < total) load_stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();  // stage i has landed
    __syncthreads();  // ... for every thread; stage i - 1 is free again
    if (i + STAGES - 1 < total) load_stage(i + STAGES - 1);
    cp_async_commit();

    const bf16* xs = ring + (i % STAGES) * STAGE;
    const bf16* ws = xs + X_ELEMS;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      unsigned a[S::MI][4];
#pragma unroll
      for (int mi = 0; mi < S::MI; ++mi)
        ldmatrix_x4(a[mi], xs + (wr + mi * 16 + lane % 16) * GEMM_LDX + kk +
                               (lane / 16) * 8);
#pragma unroll
      for (int st = 0; st < NW; ++st) {
#pragma unroll
        for (int nj = 0; nj < S::NI / 2; ++nj) {
          unsigned b[4];
          ldmatrix_x4_trans(
              b, ws + st * W_ELEMS +
                     (kk + lane % 8 + ((lane / 8) % 2) * 8) * GEMM_LDW + wc +
                     nj * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mi = 0; mi < S::MI; ++mi) {
            mma_bf16(acc[st][mi][2 * nj], a[mi], b[0], b[1]);
            mma_bf16(acc[st][mi][2 * nj + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile in it

  float* cs = reinterpret_cast<float*>(dsmem);
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = acc[0][mi][ni][e];
        if constexpr (SWIGLU) v = silu(v) * acc[NW - 1][mi][ni][e];
        const int r = wr + mi * 16 + g + (e / 2) * 8;
        const int c = wc + ni * 8 + 2 * tig + (e % 2);
        cs[r * GEMM_LDC + c] = v;
      }
  __syncthreads();
  for (int idx = tid; idx < S::ROWS * BN / 8; idx += GEMM_THREADS) {
    const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= N || gc >= F) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = cs[r * GEMM_LDC + c + j];
    if (row_expert[r] < 0) {  // invalid tile: zeros, whatever the scale
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.0f;
    } else if constexpr (OUT == OUT_F32_SCALED) {
      const float sc = scale[gr];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= sc;
    }
    const size_t o = (size_t)gr * F + gc;
    if (vec_out && gc + 8 <= F) {
      if constexpr (OUT == OUT_T) {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      } else {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + o);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    } else {
      for (int j = 0; j < 8 && gc + j < F; ++j) {
        if constexpr (OUT == OUT_T) {
          static_cast<bf16*>(out)[o + j] = __float2bfloat16(v[j]);
        } else {
          static_cast<float*>(out)[o + j] = v[j];
        }
      }
    }
  }
}

// The fp32 body: CUDA-core FMAs, a 4x4 output tile per thread and stream,
// synchronous BK = 32 stages; one block per (row tile, stripe).
template <bool SWIGLU, bool FUSED, int OUT>
__device__ __forceinline__ void gmm_f32(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ w1, const int* __restrict__ te,
    const int* __restrict__ te2, const int* __restrict__ tv,
    const float* __restrict__ sel, const float* __restrict__ scale,
    void* __restrict__ out, int N, int K, int F, bool vec_x, bool vec_w) {
  using T = float;
  constexpr int NW = SWIGLU ? 2 : 1;          // weight streams
  const int tile = blockIdx.y;
  const int r0 = tile * BM;
  const int c0 = blockIdx.x * BN;

  if (tv[tile] == 0) {  // invalid tile: no MACs, zeros out
    for (int idx = threadIdx.x; idx < BM * BN; idx += blockDim.x) {
      const int gr = r0 + idx / BN, gc = c0 + idx % BN;
      if (gr < N && gc < F) {
        if constexpr (OUT == OUT_T) {
          static_cast<T*>(out)[(size_t)gr * F + gc] = zero_of<T>();
        } else {
          static_cast<float*>(out)[(size_t)gr * F + gc] = 0.0f;
        }
      }
    }
    return;
  }

  // one pass per expert of the tile: two on a fused pair's straddle tile
  const int e_pass[2] = {te[tile], FUSED ? te2[tile] : te[tile]};
  const int passes = e_pass[1] != e_pass[0] ? 2 : 1;

  constexpr int LDX = BK + 4;
  constexpr int LDW = BN + 4;
  __shared__ __align__(128) unsigned char smem[(BM * LDX + NW * BK * LDW) * 4];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + BM * LDX;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[NW][4][4] = {};
  for (int p = 0; p < passes; ++p) {
    const size_t woff = (size_t)e_pass[p] * K * F;
    const T* wsrc[2] = {w0 + woff, SWIGLU ? w1 + woff : w0 + woff};
    const int mask = passes == 1 ? ALL_ROWS : (p == 0 ? PRIMARY_ROWS : SECONDARY_ROWS);
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tile<T, BM, BK, LDX>(xs, x, r0, k0, N, K, K, vec_x, sel, mask);
#pragma unroll
      for (int s = 0; s < NW; ++s)
        load_tile<T, BK, BN, LDW>(ws + s * BK * LDW, wsrc[s], k0, c0, K, F, F,
                                  vec_w);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(ty * 4 + i) * LDX + kk];
#pragma unroll
        for (int s = 0; s < NW; ++s) {
          float b[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = ws[s * BK * LDW + kk * LDW + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[s][i][j] = fmaf(a[i], b[j], acc[s][i][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + ty * 4 + i;
    if (gr >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + tx * 4 + j;
      if (gc >= F) continue;
      const float v = SWIGLU ? silu(acc[0][i][j]) * acc[NW - 1][i][j]
                             : acc[0][i][j];
      store<T, OUT>(out, (size_t)gr * F + gc, v, scale, gr);
    }
  }
}

// x [N, K]; w0 (and w1 with SWIGLU) [E, K, F]; te/tv (and te2 with FUSED)
// [>= ceil(N/BM)]; sel [N] with FUSED; scale [N] with OUT_F32_SCALED;
// out [N, F] as OUT says.
template <typename T, bool SWIGLU, bool FUSED, int OUT, int TM, int STAGES>
__global__ void __launch_bounds__(std::is_same<T, float>::value ? THREADS
                                                                : GEMM_THREADS)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w0,
           const T* __restrict__ w1, const int* __restrict__ te,
           const int* __restrict__ te2, const int* __restrict__ tv,
           const float* __restrict__ sel, const float* __restrict__ scale,
           void* __restrict__ out, int N, int K, int F, bool vec_x,
           bool vec_w, bool vec_out) {
  if constexpr (std::is_same<T, float>::value) {
    gmm_f32<SWIGLU, FUSED, OUT>(x, w0, w1, te, te2, tv, sel, scale, out, N, K,
                                F, vec_x, vec_w);
  } else {
    gmm_tc<SWIGLU, FUSED, OUT, TM, STAGES>(x, w0, w1, te, te2, tv, sel, scale,
                                           out, N, K, F, vec_x, vec_w,
                                           vec_out);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Lets a kernel use `bytes` of dynamic shared memory, and asks for the
// SM's whole carveout as shared memory: by default the carveout
// may hold one ring where two fit, halving the blocks an SM runs.
template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// The bf16 body with TM planner tiles per block, as the wrapper chose it
// (kernels/moe_gmm.py:gemm_ring): two where the experts average at least
// two tiles each, so a weight stage feeds the 128 rows of two tiles of one
// expert.
template <bool SWIGLU, bool FUSED, int OUT, int TM, int STAGES>
int launch_tc(const void* x, const void* w0, const void* w1, const void* te,
              const void* te2, const void* tv, const void* sel,
              const void* scale, void* out, int N, int K, int F, int ni,
              int stripes, bool vec_x, bool vec_w, bool vec_out,
              cudaStream_t st) {
  using T = __nv_bfloat16;
  constexpr int smem = gemm_smem_bytes<SWIGLU, TM, STAGES>();
  static const cudaError_t attr =
      set_smem(gmm_kernel<T, SWIGLU, FUSED, OUT, TM, STAGES>, smem);
  if (attr != cudaSuccess) return (int)attr;
  gmm_kernel<T, SWIGLU, FUSED, OUT, TM, STAGES>
      <<<dim3(stripes, (ni + TM - 1) / TM), GEMM_THREADS, smem, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(w0),
          static_cast<const T*>(w1), static_cast<const int*>(te),
          static_cast<const int*>(te2), static_cast<const int*>(tv),
          static_cast<const float*>(sel), static_cast<const float*>(scale),
          out, N, K, F, vec_x, vec_w, vec_out);
  return (int)cudaGetLastError();
}

template <typename T, bool SWIGLU, bool FUSED, int OUT>
int launch(const void* x, const void* w0, const void* w1, const void* te,
           const void* te2, const void* tv, const void* sel,
           const void* scale, void* out, int N, int K, int F, int bn, int tm,
           int stages, void* stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  if (bn != BM || N < 0 || K <= 0 || F <= 0 || tm < 1 || tm > (F32 ? 1 : 2))
    return (int)cudaErrorInvalidValue;
  const int ni = (N + BM - 1) / BM;
  if (ni > 65535) return (int)cudaErrorInvalidValue;
  if (ni == 0) return (int)cudaGetLastError();
  const bool vec_x = (K % 8 == 0) && aligned16(x);
  const bool vec_w = (F % 8 == 0) && aligned16(w0) && (!SWIGLU || aligned16(w1));
  const bool vec_out = (F % 8 == 0) && aligned16(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int stripes = (F + BN - 1) / BN;
  if constexpr (F32) {
    gmm_kernel<T, SWIGLU, FUSED, OUT, 1, 1>
        <<<dim3(stripes, ni), THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w0),
        static_cast<const T*>(w1), static_cast<const int*>(te),
        static_cast<const int*>(te2), static_cast<const int*>(tv),
        static_cast<const float*>(sel), static_cast<const float*>(scale), out,
        N, K, F, vec_x, vec_w, vec_out);
  } else if (tm == 2 && stages == gemm_ring_depth<SWIGLU, 2>()) {
    return launch_tc<SWIGLU, FUSED, OUT, 2, gemm_ring_depth<SWIGLU, 2>()>(
        x, w0, w1, te, te2, tv, sel, scale, out, N, K, F, ni, stripes, vec_x,
        vec_w, vec_out, st);
  } else if (tm == 1 && stages == gemm_ring_depth<SWIGLU, 1>()) {
    return launch_tc<SWIGLU, FUSED, OUT, 1, gemm_ring_depth<SWIGLU, 1>()>(
        x, w0, w1, te, te2, tv, sel, scale, out, N, K, F, ni, stripes, vec_x,
        vec_w, vec_out, st);
  } else if (tm == 1 && stages == GEMM_DEEP_RING) {
    return launch_tc<SWIGLU, FUSED, OUT, 1, GEMM_DEEP_RING>(
        x, w0, w1, te, te2, tv, sel, scale, out, N, K, F, ni, stripes, vec_x,
        vec_w, vec_out, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry takes tm, the planner tiles per block, and stages, the ring
// depth: in bf16 the wrapper's kernels/moe_gmm.py:gemm_ring choice (tm 1
// or 2; stages gemm_ring_depth, or GEMM_DEEP_RING with tm 1); fp32 takes
// tm 1 and ignores stages.

// K1: x [N, K], wg/wi [E, K, F], te/tv int32 [tiles] -> out [N, F] (x's type)
int gmm_swiglu_f32(const void* x, const void* wg, const void* wi,
                   const void* te, const void* tv, void* out, int N, int K,
                   int F, int bn, int tm, int stages, void* stream) {
  return launch<float, true, false, OUT_T>(x, wg, wi, te, nullptr, tv, nullptr,
                                           nullptr, out, N, K, F, bn, tm,
                                           stages, stream);
}

int gmm_swiglu_bf16(const void* x, const void* wg, const void* wi,
                    const void* te, const void* tv, void* out, int N, int K,
                    int F, int bn, int tm, int stages, void* stream) {
  return launch<__nv_bfloat16, true, false, OUT_T>(
      x, wg, wi, te, nullptr, tv, nullptr, nullptr, out, N, K, F, bn, tm,
      stages, stream);
}

// K2: x [N, K], w [E, K, F], te/tv int32 [tiles], scale f32 [N]
//     -> out f32 [N, F]
int gmm_scaled_f32(const void* x, const void* w, const void* te,
                   const void* tv, const void* scale, void* out, int N, int K,
                   int F, int bn, int tm, int stages, void* stream) {
  return launch<float, false, false, OUT_F32_SCALED>(
      x, w, nullptr, te, nullptr, tv, nullptr, scale, out, N, K, F, bn, tm,
      stages, stream);
}

int gmm_scaled_bf16(const void* x, const void* w, const void* te,
                    const void* tv, const void* scale, void* out, int N, int K,
                    int F, int bn, int tm, int stages, void* stream) {
  return launch<__nv_bfloat16, false, false, OUT_F32_SCALED>(
      x, w, nullptr, te, nullptr, tv, nullptr, scale, out, N, K, F, bn, tm,
      stages, stream);
}

// K7: K1 plus te2 int32 [tiles] and sel f32 [N] (1.0 = the te row of a
// straddle tile)
int gmm_swiglu_fused_f32(const void* x, const void* wg, const void* wi,
                         const void* te, const void* te2, const void* tv,
                         const void* sel, void* out, int N, int K, int F,
                         int bn, int tm, int stages, void* stream) {
  return launch<float, true, true, OUT_T>(x, wg, wi, te, te2, tv, sel, nullptr,
                                          out, N, K, F, bn, tm, stages, stream);
}

int gmm_swiglu_fused_bf16(const void* x, const void* wg, const void* wi,
                          const void* te, const void* te2, const void* tv,
                          const void* sel, void* out, int N, int K, int F,
                          int bn, int tm, int stages, void* stream) {
  return launch<__nv_bfloat16, true, true, OUT_T>(x, wg, wi, te, te2, tv, sel,
                                                  nullptr, out, N, K, F, bn,
                                                  tm, stages, stream);
}

// K8: K2 plus te2 int32 [tiles] and sel f32 [N]
int gmm_scaled_fused_f32(const void* x, const void* w, const void* te,
                         const void* te2, const void* tv, const void* sel,
                         const void* scale, void* out, int N, int K, int F,
                         int bn, int tm, int stages, void* stream) {
  return launch<float, false, true, OUT_F32_SCALED>(
      x, w, nullptr, te, te2, tv, sel, scale, out, N, K, F, bn, tm, stages,
      stream);
}

int gmm_scaled_fused_bf16(const void* x, const void* w, const void* te,
                          const void* te2, const void* tv, const void* sel,
                          const void* scale, void* out, int N, int K, int F,
                          int bn, int tm, int stages, void* stream) {
  return launch<__nv_bfloat16, false, true, OUT_F32_SCALED>(
      x, w, nullptr, te, te2, tv, sel, scale, out, N, K, F, bn, tm, stages,
      stream);
}

// K6: x [N, K], w [E, K, F], te/tv int32 [tiles] -> out [N, F] in x's type
// (gmm_f32, gmm_bf16) or fp32 (gmm_bf16_out_f32)
int gmm_f32(const void* x, const void* w, const void* te, const void* tv,
            void* out, int N, int K, int F, int bn, int tm, int stages,
            void* stream) {
  return launch<float, false, false, OUT_T>(x, w, nullptr, te, nullptr, tv,
                                            nullptr, nullptr, out, N, K, F, bn,
                                            tm, stages, stream);
}

int gmm_bf16(const void* x, const void* w, const void* te, const void* tv,
             void* out, int N, int K, int F, int bn, int tm, int stages,
             void* stream) {
  return launch<__nv_bfloat16, false, false, OUT_T>(
      x, w, nullptr, te, nullptr, tv, nullptr, nullptr, out, N, K, F, bn, tm,
      stages, stream);
}

int gmm_bf16_out_f32(const void* x, const void* w, const void* te,
                     const void* tv, void* out, int N, int K, int F, int bn,
                     int tm, int stages, void* stream) {
  return launch<__nv_bfloat16, false, false, OUT_F32>(
      x, w, nullptr, te, nullptr, tv, nullptr, nullptr, out, N, K, F, bn, tm,
      stages, stream);
}

}  // extern "C"
