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
// Design: one block per (row tile, 64-column stripe); a loop over K inside
// the block replaces the TPU's sequential k grid axis, and the fp32
// accumulators live in registers (wmma fragments for bf16, a 4x4 register
// tile per thread for fp32). The block reads te/tv itself (no scalar
// prefetch). Ragged K and F edges are masked while loading and storing, so
// the weights are never copied or padded. Every tile writes its whole
// output, zeros for an invalid tile, since outputs come from torch.empty.
// Simple first: no TMA, no wgmma, no pipelining (later work).
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;        // rows per block: the planner's row tile bn
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction depth per shared-memory stage
constexpr int THREADS = 256;  // 8 warps

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

// x [N, K]; w0 (and w1 with SWIGLU) [E, K, F]; te/tv (and te2 with FUSED)
// [>= ceil(N/BM)]; sel [N] with FUSED; scale [N] with OUT_F32_SCALED;
// out [N, F] as OUT says.
template <typename T, bool SWIGLU, bool FUSED, int OUT>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w0,
           const T* __restrict__ w1, const int* __restrict__ te,
           const int* __restrict__ te2, const int* __restrict__ tv,
           const float* __restrict__ sel, const float* __restrict__ scale,
           void* __restrict__ out, int N, int K, int F, bool vec_x,
           bool vec_w) {
  constexpr int NW = SWIGLU ? 2 : 1;          // weight streams
  constexpr int PAD = 16 / (int)sizeof(T);    // keeps rows 16-byte aligned
  constexpr int LDX = BK + PAD;
  constexpr int LDW = BN + PAD;
  constexpr int LDC = BN + 4;
  constexpr int IN_BYTES = (BM * LDX + NW * BK * LDW) * (int)sizeof(T);
  constexpr int C_BYTES = std::is_same<T, float>::value ? 0 : BM * LDC * 4;
  constexpr int SMEM = IN_BYTES > C_BYTES ? IN_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + BM * LDX;

  const int tile = blockIdx.y;
  const int r0 = tile * BM;
  const int c0 = blockIdx.x * BN;

  if (tv[tile] == 0) {  // invalid tile: no MACs, zeros out
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
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

  if constexpr (std::is_same<T, float>::value) {
    // fp32: CUDA-core FMAs, a 4x4 output tile per thread and stream.
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
  } else {
    // bf16: tensor cores through wmma 16x16x16, fp32 accumulators. Warp w
    // owns rows 16*(w/2) .. +16 and columns 32*(w%2) .. +32 of the block.
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wr = (warp / 2) * 16, wc = (warp % 2) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW][2];
#pragma unroll
    for (int s = 0; s < NW; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[s][j], 0.0f);
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
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, xs + wr * LDX + kk, LDX);
#pragma unroll
          for (int s = 0; s < NW; ++s) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
              wmma::load_matrix_sync(b, ws + s * BK * LDW + kk * LDW + wc + j * 16, LDW);
              wmma::mma_sync(acc[s][j], a, b, acc[s][j]);
            }
          }
        }
        __syncthreads();
      }
    }
    // Accumulators of one shape map their elements alike, so the SwiGLU
    // combine runs element-wise on the fragments before staging.
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if constexpr (SWIGLU) {
#pragma unroll
        for (int e = 0; e < acc[0][j].num_elements; ++e)
          acc[0][j].x[e] = silu(acc[0][j].x[e]) * acc[NW - 1][j].x[e];
      }
      wmma::store_matrix_sync(cs + wr * LDC + wc + j * 16, acc[0][j], LDC,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gr = r0 + r, gc = c0 + c;
      if (gr < N && gc < F) {
        store<T, OUT>(out, (size_t)gr * F + gc, cs[r * LDC + c], scale, gr);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool SWIGLU, bool FUSED, int OUT>
int launch(const void* x, const void* w0, const void* w1, const void* te,
           const void* te2, const void* tv, const void* sel,
           const void* scale, void* out, int N, int K, int F, int bn,
           void* stream) {
  if (bn != BM || N < 0 || K <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const int ni = (N + BM - 1) / BM;
  if (ni > 65535) return (int)cudaErrorInvalidValue;
  if (ni == 0) return (int)cudaGetLastError();
  const bool vec_x = (K % 8 == 0) && aligned16(x);
  const bool vec_w = (F % 8 == 0) && aligned16(w0) && (!SWIGLU || aligned16(w1));
  const dim3 grid((F + BN - 1) / BN, ni);
  gmm_kernel<T, SWIGLU, FUSED, OUT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0),
      static_cast<const T*>(w1), static_cast<const int*>(te),
      static_cast<const int*>(te2), static_cast<const int*>(tv),
      static_cast<const float*>(sel), static_cast<const float*>(scale), out, N,
      K, F, vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: x [N, K], wg/wi [E, K, F], te/tv int32 [tiles] -> out [N, F] (x's type)
int gmm_swiglu_f32(const void* x, const void* wg, const void* wi,
                   const void* te, const void* tv, void* out, int N, int K,
                   int F, int bn, void* stream) {
  return launch<float, true, false, OUT_T>(x, wg, wi, te, nullptr, tv, nullptr,
                                           nullptr, out, N, K, F, bn, stream);
}

int gmm_swiglu_bf16(const void* x, const void* wg, const void* wi,
                    const void* te, const void* tv, void* out, int N, int K,
                    int F, int bn, void* stream) {
  return launch<__nv_bfloat16, true, false, OUT_T>(
      x, wg, wi, te, nullptr, tv, nullptr, nullptr, out, N, K, F, bn, stream);
}

// K2: x [N, K], w [E, K, F], te/tv int32 [tiles], scale f32 [N] -> out f32 [N, F]
int gmm_scaled_f32(const void* x, const void* w, const void* te,
                   const void* tv, const void* scale, void* out, int N, int K,
                   int F, int bn, void* stream) {
  return launch<float, false, false, OUT_F32_SCALED>(
      x, w, nullptr, te, nullptr, tv, nullptr, scale, out, N, K, F, bn, stream);
}

int gmm_scaled_bf16(const void* x, const void* w, const void* te,
                    const void* tv, const void* scale, void* out, int N, int K,
                    int F, int bn, void* stream) {
  return launch<__nv_bfloat16, false, false, OUT_F32_SCALED>(
      x, w, nullptr, te, nullptr, tv, nullptr, scale, out, N, K, F, bn, stream);
}

// K7: K1 plus te2 int32 [tiles] and sel f32 [N] (1.0 = the te row of a
// straddle tile)
int gmm_swiglu_fused_f32(const void* x, const void* wg, const void* wi,
                         const void* te, const void* te2, const void* tv,
                         const void* sel, void* out, int N, int K, int F,
                         int bn, void* stream) {
  return launch<float, true, true, OUT_T>(x, wg, wi, te, te2, tv, sel, nullptr,
                                          out, N, K, F, bn, stream);
}

int gmm_swiglu_fused_bf16(const void* x, const void* wg, const void* wi,
                          const void* te, const void* te2, const void* tv,
                          const void* sel, void* out, int N, int K, int F,
                          int bn, void* stream) {
  return launch<__nv_bfloat16, true, true, OUT_T>(x, wg, wi, te, te2, tv, sel,
                                                  nullptr, out, N, K, F, bn,
                                                  stream);
}

// K8: K2 plus te2 int32 [tiles] and sel f32 [N]
int gmm_scaled_fused_f32(const void* x, const void* w, const void* te,
                         const void* te2, const void* tv, const void* sel,
                         const void* scale, void* out, int N, int K, int F,
                         int bn, void* stream) {
  return launch<float, false, true, OUT_F32_SCALED>(
      x, w, nullptr, te, te2, tv, sel, scale, out, N, K, F, bn, stream);
}

int gmm_scaled_fused_bf16(const void* x, const void* w, const void* te,
                          const void* te2, const void* tv, const void* sel,
                          const void* scale, void* out, int N, int K, int F,
                          int bn, void* stream) {
  return launch<__nv_bfloat16, false, true, OUT_F32_SCALED>(
      x, w, nullptr, te, te2, tv, sel, scale, out, N, K, F, bn, stream);
}

// K6: x [N, K], w [E, K, F], te/tv int32 [tiles] -> out [N, F] in x's type
// (gmm_f32, gmm_bf16) or fp32 (gmm_bf16_out_f32)
int gmm_f32(const void* x, const void* w, const void* te, const void* tv,
            void* out, int N, int K, int F, int bn, void* stream) {
  return launch<float, false, false, OUT_T>(x, w, nullptr, te, nullptr, tv,
                                            nullptr, nullptr, out, N, K, F, bn,
                                            stream);
}

int gmm_bf16(const void* x, const void* w, const void* te, const void* tv,
             void* out, int N, int K, int F, int bn, void* stream) {
  return launch<__nv_bfloat16, false, false, OUT_T>(
      x, w, nullptr, te, nullptr, tv, nullptr, nullptr, out, N, K, F, bn,
      stream);
}

int gmm_bf16_out_f32(const void* x, const void* w, const void* te,
                     const void* tv, void* out, int N, int K, int F, int bn,
                     void* stream) {
  return launch<__nv_bfloat16, false, false, OUT_F32>(
      x, w, nullptr, te, nullptr, tv, nullptr, nullptr, out, N, K, F, bn,
      stream);
}

}  // extern "C"
