// The GO cache's TopKUpdate (paper eq. 4-5) for Hopper (sm_90a).
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

#include <cuda_runtime.h>
#include <stdint.h>

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
