// The sLSTM sequence for Hopper (sm_90a): the whole recurrence of one sLSTM
// block, S steps, in one launch.
//
// Replaces the TPU kernel K9 of the reference package:
//   repro/kernels/slstm_cell.py:slstm_seq (body _slstm_seq_kernel)
// u [B, S, 4*H*hd] gate pre-activations (gate-major: u_t.reshape(4, H, hd)),
// r [4, H, hd, hd] recurrent weights, block-diagonal by head -> h
// [B, S, H*hd] in u's dtype. Per step, per head, from c = n = m = h = 0:
//   rec[g, i] = sum_j r[g, head, i, j] * h_prev[j]
//   li, lf, z, o = u_t[g, head, i] + rec[g, i]
//   lf = log_sigmoid(lf) = min(lf, 0) - log1p(exp(-|lf|))
//   m_new = max(lf + m, li); fi = exp(lf + m - m_new); ii = exp(li - m_new)
//   c = fi * c + ii * tanh(z); n = fi * n + ii
//   h = sigmoid(o) * c / max(n, 1e-6)
// All arithmetic in fp32 (bf16 r widens exactly on load); expf, tanhf and
// log1pf without fast math; no atomics, so a launch repeats bit for bit.
//
// What bounds it on an H100: neither bytes nor FLOPs but the S serial
// steps. The TPU kernel keeps all of r (4 * H * hd * hd) in VMEM across the
// scan; at xlstm-1.3b's width one head's r alone is 4 * 512 * 512 bf16 =
// 2 MiB, against 227 KB of shared memory per SM, while all four heads
// (8.4 MB) fit in the 50 MB L2. The heads are independent (r is
// block-diagonal), so the grid is (head, batch row): one block per pair,
// which the TPU's grid (B,) could not split. Each block keeps its head's
// state in registers (the thread that owns unit i holds c, n, m) and h_prev
// in shared memory; per step it runs the GEMV over the head's 4 * hd rows
// of r, read from global memory where L2 holds them: a warp per row (4 rows
// a pass, all their loads issued before the first product), lanes along j
// with 16-byte loads, h_prev's columns of each lane in registers, a shuffle
// reduction. Then the owner of unit i runs the cell update, writes h_t, and
// a barrier closes the step. The gate inputs u_t do not depend on h and are
// loaded before the GEMV.
// At B = 4, H = 4 this runs 16 blocks, each re-reading 2 MiB from L2 per
// step: latency- and L2-bound by design. The faster design (a thread-block
// cluster per (row, head), r split over the cluster's shared memory, h
// exchanged through distributed shared memory) is later work.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = launched); hd outside 1..512 returns
// cudaErrorInvalidValue without launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 512;            // 16 warps; the owner of unit i is thread i
constexpr int WARPS = THREADS / 32;
constexpr int MAX_HD = 512;             // units per head (xlstm-1.3b: 2048 / 4)
constexpr int ROWS_PER_PASS = 4;        // rows a warp reads together

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
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

// V consecutive elements of a row of r: one 16-byte load (uint4), or one
// element when V = 1. Loaded raw first, widened to fp32 when used, so that
// all of a pass's loads are in flight together.
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* __restrict__ p) {
  if constexpr (V == 1) {
    return *p;
  } else {
    static_assert(V * sizeof(T) == 16, "a 16-byte load holds V values");
    return *reinterpret_cast<const uint4*>(p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void widen(const Raw<T, V>& raw, float (&w)[V]) {
  if constexpr (V == 1) {
    w[0] = to_float(raw);
  } else if constexpr (std::is_same<T, float>::value) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) w[e] = f[e];
  } else {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float2 f = __bfloat1622float2(b[k]);
      w[2 * k] = f.x;
      w[2 * k + 1] = f.y;
    }
  }
}

template <typename TU, typename TR, int V>
__global__ void __launch_bounds__(THREADS)
slstm_seq_kernel(const TU* __restrict__ u, const TR* __restrict__ r,
                 TU* __restrict__ out, int S, int H, int hd) {
  constexpr int NCH = MAX_HD / (32 * V);     // row chunks per lane
  __shared__ float h_s[MAX_HD];
  __shared__ float rec_s[4 * MAX_HD];
  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long D = (long)H * hd;               // one gate's width in u
  const TU* u_b = u + (long)b * S * 4 * D + (long)head * hd;
  TU* o_b = out + (long)b * S * D + (long)head * hd;
  const TR* r_h = r + (long)head * hd * hd;  // gate g at + g * D * hd
  const bool own = tid < hd;
  const int rows = 4 * hd;
  float c = 0.f, n = 0.f, m = 0.f;
  if (own) h_s[tid] = 0.f;
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    float gin[4] = {0.f, 0.f, 0.f, 0.f};
    if (own) {
      const TU* ut = u_b + (long)t * 4 * D + tid;
#pragma unroll
      for (int g = 0; g < 4; ++g) gin[g] = to_float(ut[g * D]);
    }
    float hreg[NCH * V];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int j = (k * 32 + lane) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) hreg[k * V + e] = j < hd ? h_s[j + e] : 0.f;
    }

    // rows = 4 * hd and row0 steps by multiples of ROWS_PER_PASS (4), so
    // every row of a pass exists; columns past hd are masked per lane
    for (int row0 = warp * ROWS_PER_PASS; row0 < rows;
         row0 += WARPS * ROWS_PER_PASS) {
      Raw<TR, V> raw[ROWS_PER_PASS][NCH];
#pragma unroll
      for (int q = 0; q < ROWS_PER_PASS; ++q) {
        const int row = row0 + q;
        const int g = row / hd, i = row - g * hd;
        const TR* rr = r_h + g * D * hd + (long)i * hd;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const int j = (k * 32 + lane) * V;
          if (j < hd) raw[q][k] = load_raw<TR, V>(rr + j);
        }
      }
#pragma unroll
      for (int q = 0; q < ROWS_PER_PASS; ++q) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          if ((k * 32 + lane) * V < hd) {
            float w[V];
            widen<TR, V>(raw[q][k], w);
#pragma unroll
            for (int e = 0; e < V; ++e) a = fmaf(w[e], hreg[k * V + e], a);
          }
        }
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
        }
        if (lane == 0) rec_s[row0 + q] = a;
      }
    }
    __syncthreads();

    if (own) {
      const int i = tid;
      const float li = gin[0] + rec_s[i];
      float lf = gin[1] + rec_s[hd + i];
      const float z = gin[2] + rec_s[2 * hd + i];
      const float o = gin[3] + rec_s[3 * hd + i];
      lf = fminf(lf, 0.f) - log1pf(expf(-fabsf(lf)));
      const float m_new = fmaxf(lf + m, li);
      const float fi = expf(lf + m - m_new);
      const float ii = expf(li - m_new);
      c = fi * c + ii * tanhf(z);
      n = fi * n + ii;
      const float h = (1.f / (1.f + expf(-o))) * c / fmaxf(n, 1e-6f);
      m = m_new;
      h_s[i] = h;
      o_b[(long)t * D + i] = from_float<TU>(h);
    }
    __syncthreads();
  }
}

template <typename TU, typename TR>
int launch(const void* u, const void* r, void* out, int B, int S, int H,
           int hd, cudaStream_t stream) {
  if (hd < 1 || hd > MAX_HD || H < 1 || B < 1 || S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int VEC = 16 / sizeof(TR);
  const dim3 grid(H, B);
  const TU* pu = static_cast<const TU*>(u);
  const TR* pr = static_cast<const TR*>(r);
  TU* po = static_cast<TU*>(out);
  if (hd % VEC == 0) {
    slstm_seq_kernel<TU, TR, VEC><<<grid, THREADS, 0, stream>>>(pu, pr, po, S,
                                                                 H, hd);
  } else {
    slstm_seq_kernel<TU, TR, 1><<<grid, THREADS, 0, stream>>>(pu, pr, po, S,
                                                               H, hd);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define SLSTM_ENTRY(NAME, TU, TR)                                            \
  extern "C" int NAME(const void* u, const void* r, void* out, int B, int S, \
                      int H, int hd, void* stream) {                         \
    return launch<TU, TR>(u, r, out, B, S, H, hd,                            \
                          static_cast<cudaStream_t>(stream));                \
  }

SLSTM_ENTRY(slstm_seq_f32_f32, float, float)
SLSTM_ENTRY(slstm_seq_f32_bf16, float, __nv_bfloat16)
SLSTM_ENTRY(slstm_seq_bf16_f32, __nv_bfloat16, float)
SLSTM_ENTRY(slstm_seq_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
