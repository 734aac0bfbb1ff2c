// The GO cache's TopKUpdate (paper eq. 4-5) for Hopper (sm_90a): K5 on its
// own, and K5R, the GO decode's router (the gate row, its softmax, the
// TopKUpdate and the selected-pair lane plan in one launch; below K5).
//
// Replaces the TPU kernel of the reference package
//   K5  repro/kernels/go_topk.py:go_topk_update (body _go_topk_kernel)
// For each (batch row b, expert e), over the cached top-k scores
// s[b, e, 0..k):
//   slot     = the first j holding the minimum (a strict < while scanning
//              keeps the first, as the reference's cumsum(is_min) == 1 does)
//   selected = s_new[b, e] >= that minimum
//   where selected, slot j takes s_new[b, e] and the token id.
// It emits selected [B, E] (bool bytes) and slot [B, E] int32.
//
// What bounds it on an H100: nothing but the launch. At llama_moe_4_16's
// decode (B 4, E 16, k 4) it moves ~4.7 KB; its byte bound is ~1.4e-6 ms.
// What it saves is launches: the plain version (argmin, gather, compare,
// one-hot, two wheres, a cast, then the cache's two copies) is about ten
// per layer and tick, this is one.
//
// Design: one thread per (b, e) over ceil(B*E / 256) blocks; the thread
// scans its row of k scores in device memory, then writes the row. Rows
// are disjoint and each is read whole before it is written, so the
// in-place form (outputs aliasing the inputs, the decode path's form) has
// no race. Every output is a copy or a comparison, so it equals the plain
// version bit for bit.
//
// NaN: a row holding a NaN has a NaN minimum, so nothing is selected there
// and the row is unchanged, as in the reference. Its slot is the first NaN,
// as torch.argmin (the plain version's) gives it; the TPU kernel's one-hot
// is empty there and gives slot 0. The cache is the same either way.
//
// The token id is one int for the whole batch (tid_vec null: the static
// batch, passed by value) or one per batch row (the engine's per-slot
// positions, a device array).
//
// C interface: launches on the given stream and returns cudaGetLastError()
// as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int THREADS = 256;

// s_prev/t_prev may alias s_out/t_out (in place), so none is __restrict__.
__global__ void __launch_bounds__(THREADS)
go_topk_kernel(const float* s_prev, const int* t_prev,
               const float* __restrict__ s_new, const int* __restrict__ tid_vec,
               int tid_scalar, float* s_out, int* t_out,
               uint8_t* __restrict__ sel_out, int* __restrict__ slot_out,
               int B, int E, int k) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * E) return;
  const long long row = i * k;
  const float* s = s_prev + row;
  float m = s[0];
  int slot = 0;
  bool nan = isnan(m);
  for (int j = 1; j < k && !nan; ++j) {
    const float v = s[j];
    if (isnan(v)) {
      nan = true;
      m = v;
      slot = j;
    } else if (v < m) {
      m = v;
      slot = j;
    }
  }
  const float sn = s_new[i];
  const bool sel = sn >= m;  // false on a NaN minimum or a NaN s_new
  const int tid = tid_vec ? tid_vec[i / E] : tid_scalar;
  const int* t = t_prev + row;
  for (int j = 0; j < k; ++j) {
    const bool w = sel && j == slot;
    const float sv = s[j];
    const int tv = t[j];
    s_out[row + j] = w ? sn : sv;
    t_out[row + j] = w ? tid : tv;
  }
  sel_out[i] = sel ? 1 : 0;
  slot_out[i] = slot;
}

}  // namespace

extern "C" {

// s_prev/s_out f32 [B, E, k], t_prev/t_out int32 [B, E, k], s_new f32
// [B, E], tid_vec int32 [B] or null (then tid_scalar), sel bool [B, E],
// slot int32 [B, E]. s_out/t_out may be s_prev/t_prev.
int go_topk_update_f32(const void* s_prev, const void* t_prev,
                       const void* s_new, const void* tid_vec, int tid_scalar,
                       void* s_out, void* t_out, void* sel, void* slot, int B,
                       int E, int k, void* stream) {
  if (B < 0 || E < 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * E;
  if (n == 0) return (int)cudaGetLastError();
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  go_topk_kernel<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s_prev), static_cast<const int*>(t_prev),
      static_cast<const float*>(s_new), static_cast<const int*>(tid_vec),
      tid_scalar, static_cast<float*>(s_out), static_cast<int*>(t_out),
      static_cast<uint8_t*>(sel), static_cast<int*>(slot), B, E, k);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// K5R: the GO decode's router, one launch per layer and decode tick.
//
// Replaces, together, the reference's jnp gate row and softmax
// (repro/core/go_cache.py:143-144), K5 (repro/kernels/go_topk.py:43) and
// the selected-pair lane plan of go_selected_ffn (repro/kernels/ops.py),
// which the port ran as a cuBLAS GEMV, a softmax, K5 and ~15 small
// launches. For one layer, x [B, d] (f32 or bf16) and gate_w [d, E] (f32
// or bf16, widened in registers):
//   1. s = x . gate_w in fp32, g = softmax(s) per row (max-subtract, exp,
//      sum, divide);
//   2. K5's TopKUpdate of the cache with g (K5's comparisons);
//   3. the lane plan: per expert e, idx_p[e, :] holds the selected rows in
//      ascending batch order, then the unselected ones in ascending order,
//      then 0 up to Cp; scale[e * Cp + c] = g of a selected row, else 0;
//      tile_valid[e * nt + j] = j * bn < count(e); tile_expert = e.
//
// What bounds it on an H100: the launch and a few round trips to memory.
// At llama_moe_4_16's decode (B 4, d 4096, E 16, k 4; x bf16, gate_w f32)
// it moves ~0.3 MB, ~9e-5 ms at 3.35 TB/s. It saves the ~20 launches
// around K5.
//
// Design. Steps 2 and 3 need the whole [B, E] selection (each lane's count
// and order run over every row), so ONE CTA of 512 threads does them in
// shared memory, B <= 64 and E <= 64 (the wrapper raises otherwise). One SM
// alone streams gate_w slowly (at llama's shape the whole launch on one CTA
// takes ~2.7x the split grid's time: chip_smoke.py's `one_cta_ms`), so step
// 1 is split over `splits` CTAs of `split_rows` rows of gate_w each (about
// 8 KB: kernels/go_topk.py router_splits, from the shapes alone):
//   Gate row: in each CTA a thread owns V consecutive columns (one 16-byte
//   load a row of gate_w when E is a multiple of V and gate_w is 16-byte
//   aligned, else V = 1) and strides over the CTA's rows; its partial sums
//   for 4 batch rows at a time sit in registers. The threads of a column
//   group reduce by xor shuffles within a warp, then through shared memory
//   in the order of the warp; each CTA writes its [B, E] partial to the
//   workspace. The last CTA to arrive (an integer counter, left at 0 for
//   the next launch; K3's combine does the same) sums the partials in CTA
//   order and goes on alone. A fixed order, no float atomics: a repeat
//   gives the same bits. The order differs from cuBLAS's, so g differs
//   from the plain version's in the last bits (checked within a stated
//   tolerance; everything after g is checked bit for bit on the kernel's
//   own g).
//   Softmax: a warp per batch row, E <= 64 values two a lane.
//   TopKUpdate: a thread per (row, expert); the scan has no early exit, so
//   its loads issue together; in place (the decode's form) only the
//   replaced slot is written, else the row is copied with it.
//   Plan: a 64-bit selection mask per expert in shared memory; the row b
//   of lane e lands at popc(mask below b) if selected, else at count(e) +
//   (b - popc(mask below b)), a permutation written straight to idx_p and
//   scale.

namespace {

constexpr int R_THREADS = 512;
constexpr int R_WARPS = R_THREADS / 32;
constexpr int R_MAX = 64;              // bound on B and on E
constexpr int R_BB = 4;                // batch rows per pass over gate_w

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

// V consecutive elements of a row of gate_w: one 16-byte load, or one
// element when V = 1; loaded raw first, widened when used, so that a pass's
// loads are in flight together.
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
    for (int j = 0; j < V / 2; ++j) {
      const float2 f = __bfloat1622float2(b[j]);
      w[2 * j] = f.x;
      w[2 * j + 1] = f.y;
    }
  }
}

// s_prev/t_prev may alias s_out/t_out (in place), so none is __restrict__.
template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(R_THREADS)
go_router_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                 const float* s_prev, const int* t_prev,
                 const void* __restrict__ tid_vec, int tid_bytes,
                 int tid_scalar, float* s_out, int* t_out,
                 float* __restrict__ g_out, uint8_t* __restrict__ sel_out,
                 int* __restrict__ slot_out, int* __restrict__ idx_out,
                 float* __restrict__ scale_out, uint8_t* __restrict__ tv_out,
                 int* __restrict__ te_out, float* __restrict__ ws,
                 int* __restrict__ counter, int B, int E, int k, int d,
                 int split_rows, int Cp, int bn) {
  // 8 loads in flight a thread; 4 for bf16 vectors (their sums take 32
  // registers)
  constexpr int U = V == 8 ? 4 : 8;
  __shared__ float part[R_WARPS][R_BB][R_MAX];   // partial sums
  __shared__ float gs[R_MAX * R_MAX];            // s, then g, [B, E]
  __shared__ uint8_t sel_s[R_MAX * R_MAX];
  __shared__ unsigned long long mask_s[R_MAX];
  __shared__ int cnt_s[R_MAX];
  __shared__ int last_s;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int splits = gridDim.x;
  const int cpr = E / V;                         // column groups of a row
  int cprp = 1;                                  // ... to a power of two
  while (cprp < cpr) cprp <<= 1;
  const int R = R_THREADS / cprp;                // row groups (>= 8)
  const int cg = t % cprp, rg = t / cprp;
  const bool active = cg < cpr;
  const int span = cprp > 32 ? cprp : 32;        // threads behind a partial
  const int np = R_THREADS / span, p = t / span;
  const int r0 = blockIdx.x * split_rows;        // this CTA's rows of gate_w
  const int r1 = min(d, r0 + split_rows);

  // 1a. this CTA's part of the gate row, R_BB batch rows a pass
  for (int b0 = 0; b0 < B; b0 += R_BB) {
    const int nb = min(R_BB, B - b0);
    float acc[R_BB][V];
#pragma unroll
    for (int bb = 0; bb < R_BB; ++bb)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[bb][v] = 0.f;
    if (active) {
      const TW* wc = w + cg * V;
      for (int i0 = r0 + rg; i0 < r1; i0 += R * U) {
        Raw<TW, V> raw[U];
        float xr[U][R_BB];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * R;
          if (i < r1) {
            raw[u] = load_raw<TW, V>(wc + (size_t)i * E);
#pragma unroll
            for (int bb = 0; bb < R_BB; ++bb)
              xr[u][bb] = bb < nb ? to_float(x[(size_t)(b0 + bb) * d + i])
                                  : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + u * R < r1) {
            float wf[V];
            widen<TW, V>(raw[u], wf);
#pragma unroll
            for (int bb = 0; bb < R_BB; ++bb)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[bb][v] = fmaf(xr[u][bb], wf[v], acc[bb][v]);
          }
        }
      }
    }
    // threads of one column group within a warp: lanes cg + j * cprp
#pragma unroll
    for (int bb = 0; bb < R_BB; ++bb)
#pragma unroll
      for (int v = 0; v < V; ++v)
        for (int off = 16; off >= cprp; off >>= 1)
          acc[bb][v] += __shfl_xor_sync(0xffffffffu, acc[bb][v], off);
    if (active && (cprp >= 32 || lane < cprp)) {
#pragma unroll
      for (int bb = 0; bb < R_BB; ++bb)
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (bb < nb) part[p][bb][cg * V + v] = acc[bb][v];
    }
    __syncthreads();
    for (int o = t; o < nb * E; o += R_THREADS) {
      const int bb = o / E, e = o % E;
      float s = part[0][bb][e];
      for (int q = 1; q < np; ++q) s += part[q][bb][e];
      if (splits == 1)
        gs[(b0 + bb) * E + e] = s;
      else
        ws[((size_t)blockIdx.x * B + b0 + bb) * E + e] = s;
    }
    __syncthreads();
  }

  // 1b. the last CTA to arrive sums the partials in CTA order
  if (splits > 1) {
    __threadfence();
    __syncthreads();
    if (t == 0) {
      const int last = atomicAdd(counter, 1) == splits - 1;
      if (last) atomicExch(counter, 0);
      last_s = last;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    for (int o = t; o < B * E; o += R_THREADS) {
      float s = __ldcg(ws + o);
#pragma unroll 8
      for (int c = 1; c < splits; ++c) s += __ldcg(ws + (size_t)c * B * E + o);
      gs[o] = s;
    }
    __syncthreads();
  }

  // 1c. softmax over the E experts of each row
  for (int b = warp; b < B; b += R_WARPS) {
    const bool h0 = lane < E, h1 = lane + 32 < E;
    const float v0 = h0 ? gs[b * E + lane] : -INFINITY;
    const float v1 = h1 ? gs[b * E + lane + 32] : -INFINITY;
    float m = fmaxf(v0, v1);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float e0 = h0 ? expf(v0 - m) : 0.f;
    const float e1 = h1 ? expf(v1 - m) : 0.f;
    float sum = e0 + e1;
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (h0) {
      const float g = e0 / sum;
      gs[b * E + lane] = g;
      g_out[b * E + lane] = g;
    }
    if (h1) {
      const float g = e1 / sum;
      gs[b * E + lane + 32] = g;
      g_out[b * E + lane + 32] = g;
    }
  }
  __syncthreads();

  // 2. the TopKUpdate, a thread per (row, expert): the first minimum (a
  // strict <; a NaN ends the scan at the first NaN, as K5's does)
  const bool in_place = s_out == s_prev && t_out == t_prev;
  for (int i = t; i < B * E; i += R_THREADS) {
    const int b = i / E;
    const int row = i * k;
    const float* s = s_prev + row;
    float m = s[0];
    int slot = 0;
    bool nan = isnan(m);
#pragma unroll 4
    for (int j = 1; j < k; ++j) {
      const float v = s[j];
      if (!nan && isnan(v)) {
        nan = true;
        m = v;
        slot = j;
      } else if (!nan && v < m) {
        m = v;
        slot = j;
      }
    }
    const float sn = gs[i];
    const bool sel = sn >= m;      // false on a NaN minimum or a NaN g
    const int tid = tid_vec == nullptr ? tid_scalar
                    : tid_bytes == 8
                        ? (int)static_cast<const long long*>(tid_vec)[b]
                        : static_cast<const int*>(tid_vec)[b];
    if (in_place) {
      if (sel) {
        s_out[row + slot] = sn;
        t_out[row + slot] = tid;
      }
    } else {
      const int* tp = t_prev + row;
      for (int j = 0; j < k; ++j) {
        const bool wr = sel && j == slot;
        const float sv = s[j];
        const int tv = tp[j];
        s_out[row + j] = wr ? sn : sv;
        t_out[row + j] = wr ? tid : tv;
      }
    }
    sel_s[i] = sel ? 1 : 0;
    sel_out[i] = sel ? 1 : 0;
    slot_out[i] = slot;
  }
  __syncthreads();

  // 3. the lane plan
  if (t < E) {
    unsigned long long mk = 0ull;
    for (int b = 0; b < B; ++b)
      if (sel_s[b * E + t]) mk |= 1ull << b;
    mask_s[t] = mk;
    cnt_s[t] = __popcll(mk);
  }
  __syncthreads();
  for (int i = t; i < E * Cp; i += R_THREADS) {
    const int e = i / Cp, c = i % Cp;
    if (c < B) {                                 // c is the batch row b
      const unsigned long long mk = mask_s[e];
      const int below = __popcll(mk & ((1ull << c) - 1ull));
      const bool sel = (mk >> c) & 1ull;
      const int pos = sel ? below : cnt_s[e] + (c - below);
      idx_out[e * Cp + pos] = c;
      scale_out[e * Cp + pos] = sel ? gs[c * E + e] : 0.f;
    } else {
      idx_out[i] = 0;
      scale_out[i] = 0.f;
    }
  }
  const int nt = Cp / bn;
  for (int i = t; i < E * nt; i += R_THREADS) {
    const int e = i / nt, j = i % nt;
    tv_out[i] = j * bn < cnt_s[e] ? 1 : 0;
    te_out[i] = e;
  }
}

template <typename TX, typename TW>
int launch_router(const void* x, const void* w, const void* s_prev,
                  const void* t_prev, const void* tid_vec, int tid_bytes,
                  int tid_scalar, void* s_out, void* t_out, void* g,
                  void* sel, void* slot, void* idx, void* scale, void* tv,
                  void* te, void* ws, void* counter, int B, int E, int k,
                  int d, int split_rows, int splits, int Cp, int bn,
                  cudaStream_t stream) {
  if (B < 1 || B > R_MAX || E < 1 || E > R_MAX || k < 1 || d < 1 ||
      bn < 1 || Cp < B || Cp % bn != 0 || split_rows < 1 || splits < 1 ||
      (long long)(splits - 1) * split_rows >= d ||
      (long long)splits * split_rows < d ||
      (splits > 1 && (ws == nullptr || counter == nullptr)) ||
      (tid_vec != nullptr && tid_bytes != 4 && tid_bytes != 8))
    return (int)cudaErrorInvalidValue;
  constexpr int VW = 16 / sizeof(TW);
  const bool vec = E % VW == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define GO_ROUTER_ARGS                                                      \
  static_cast<const TX*>(x), static_cast<const TW*>(w),                    \
      static_cast<const float*>(s_prev), static_cast<const int*>(t_prev),  \
      tid_vec, tid_bytes, tid_scalar, static_cast<float*>(s_out),          \
      static_cast<int*>(t_out), static_cast<float*>(g),                    \
      static_cast<uint8_t*>(sel), static_cast<int*>(slot),                 \
      static_cast<int*>(idx), static_cast<float*>(scale),                  \
      static_cast<uint8_t*>(tv), static_cast<int*>(te),                    \
      static_cast<float*>(ws), static_cast<int*>(counter), B, E, k, d,     \
      split_rows, Cp, bn
  if (vec) {
    go_router_kernel<TX, TW, VW><<<splits, R_THREADS, 0, stream>>>(
        GO_ROUTER_ARGS);
  } else {
    go_router_kernel<TX, TW, 1><<<splits, R_THREADS, 0, stream>>>(
        GO_ROUTER_ARGS);
  }
#undef GO_ROUTER_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, d] and gate_w [d, E] contiguous, of the entry's dtypes (DX, DW);
// s_prev/s_out f32 [B, E, k] and t_prev/t_out int32 [B, E, k] (s_out/t_out
// may be s_prev/t_prev); tid_vec [B] of tid_bytes 4 or 8, or null (then
// tid_scalar); g f32 [B, E], sel bool [B, E], slot int32 [B, E], idx int32
// [E, Cp], scale f32 [E * Cp], tv bool and te int32 [E * Cp / bn]; ws f32
// [splits, B, E] and counter one int32 that is 0 (both unused at splits
// 1); gate_w's rows in `splits` spans of `split_rows`.
#define GO_ROUTER_ENTRY(DX, DW, TX, TW)                                      \
  extern "C" int go_router_##DX##_##DW(                                      \
      const void* x, const void* w, const void* s_prev, const void* t_prev,  \
      const void* tid_vec, int tid_bytes, int tid_scalar, void* s_out,       \
      void* t_out, void* g, void* sel, void* slot, void* idx, void* scale,   \
      void* tv, void* te, void* ws, void* counter, int B, int E, int k,      \
      int d, int split_rows, int splits, int Cp, int bn, void* stream) {     \
    return launch_router<TX, TW>(x, w, s_prev, t_prev, tid_vec, tid_bytes,   \
                                 tid_scalar, s_out, t_out, g, sel, slot, idx,\
                                 scale, tv, te, ws, counter, B, E, k, d,     \
                                 split_rows, splits, Cp, bn,                 \
                                 static_cast<cudaStream_t>(stream));         \
  }

GO_ROUTER_ENTRY(f32, f32, float, float)
GO_ROUTER_ENTRY(f32, bf16, float, __nv_bfloat16)
GO_ROUTER_ENTRY(bf16, f32, __nv_bfloat16, float)
GO_ROUTER_ENTRY(bf16, bf16, __nv_bfloat16, __nv_bfloat16)
