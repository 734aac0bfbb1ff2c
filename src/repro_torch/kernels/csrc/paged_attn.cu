// Paged attention for Hopper (sm_90a): attention that walks a block table
// of fixed-size KV pages instead of a dense [B, max_tokens] cache.
//
// Replaces two TPU kernels of the reference package:
//   K3  repro/kernels/paged_attn.py:_paged_attn_decode (body _decode_kernel)
//       one query per row at position t[b]; keys k_pos <= t, and
//       k_pos > t - window when window > 0
//   K4  repro/kernels/paged_attn.py:_paged_attn_chunk (body _chunk_kernel)
//       a chunk of Cs queries at start..start+Cs-1; keys k_pos < kv_len,
//       k_pos <= q_pos, and k_pos > q_pos - window when window > 0
// A decode is the chunk case with one query at start = t[b] and
// kv_len = t[b] + 1, so one block body (`attend`) serves both kernels,
// `paged_decode_kernel` and `paged_chunk_kernel`. Pages are
// [NP, ps, Hkv, hd] (fp32 or bf16), the block table [B, P] int32 maps a
// row's logical page j to its physical page (0 = the null page); outputs are
// fp32 [B, Cs, Hq, hd], heads grouped as Hq = Hkv * G (GQA).
//
// Arithmetic, as the TPU kernel's: s = (q . k) * (1/sqrt(hd)) in fp32, then
// softcap c * tanh(s / c), then the mask; an online softmax in fp32; p is
// rounded to the page dtype before the PV product (`p.astype(v.dtype)`), l
// sums the unrounded p; out = acc / max(l, 1e-20). A masked key gets p = 0
// exactly (the reference's exp(-1e30 - m) underflows to the same 0 once any
// real key has been seen), so masked or stale page contents never reach
// the sum.
//
// What bounds it on an H100: bytes. A decode reads each live page once per
// kv head (ps * hd * 2 values) for 4 * hd FLOPs per key and query head:
// about 1 FLOP per byte in bf16, far below the ~295 FLOP/byte ridge. The
// design therefore reads only live pages: the page loop runs from the
// first page the window can reach to the last page holding a key <= the
// block's last query (the reference's liveness rule, here applied to the
// query block), so dead pages, the null page behind a short row included,
// cost no load and no FLOPs.
//
// Design: one block of 128 threads per (kv head h, row b, block of query
// rows; a decode has one query per row). A block holds up to 16 (query,
// head) rows: the G query heads of kv head h for each of its queries
// (decode: G rows). Per page it stages
// tiles of KT keys of K[page, :, h, :] and V with 16-byte loads into shared
// memory, computes the KT x rows scores with groups of threads per dot
// product (shuffle-reduced), updates the softmax statistics one warp per
// row, and accumulates PV into fp32 registers (rows x hd spread over the
// threads). Simple first: no TMA, no wgmma, no split-KV (later work).
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = launched); an unsupported head_dim
// returns cudaErrorInvalidValue without launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int THREADS = 128;       // 4 warps
constexpr int MAX_ROWS = 16;       // (query, head) rows per block
constexpr float NEG_INF = -1e30f;  // the reference's finite mask value

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

// p rounded to the page dtype, as the reference's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (std::is_same<T, float>::value) {
    return p;
  } else {
    return __bfloat162float(__float2bfloat16(p));
  }
}

// The body both kernels share: the block of (kv head h, row b, queries
// q0..q0+QB-1) whose first query sits at absolute position pos0; keys at
// positions >= kvl are masked.
template <typename T, int HD>
__device__ __forceinline__ void attend(
    const T* __restrict__ q,            // [B, Cs, Hkv * G, HD]
    const T* __restrict__ k_pages,      // [NP, ps, Hkv, HD]
    const T* __restrict__ v_pages,      // [NP, ps, Hkv, HD]
    const int32_t* __restrict__ bt,     // [B, P]
    float* __restrict__ out,            // [B, Cs, Hkv * G, HD]
    int h, int b, int q0, int pos0, int kvl, int Cs, int Hkv, int G, int QB,
    int ps, int P, int window, float softcap, float scale) {
  constexpr int KT = HD > 128 ? 8 : 16;      // keys per shared-memory tile
  constexpr int CPR = HD * sizeof(T) / 16;   // 16-byte chunks per key row
  // Each key row is padded by 16 bytes, so the rows of a tile start 4
  // banks apart: the score loop reads one column of many rows at once,
  // which unpadded rows (a multiple of 128 bytes) serve from one bank.
  constexpr int KPAD = 16 / sizeof(T);
  constexpr int ACC = MAX_ROWS * HD / THREADS;
  static_assert(KT <= 32, "one warp lane per key in the softmax update");
  static_assert(ACC >= 1, "rows x head_dim must cover the block");

  __shared__ float sq[MAX_ROWS][HD];
  __shared__ __align__(16) T sk[KT][HD + KPAD];
  __shared__ __align__(16) T sv[KT][HD + KPAD];
  __shared__ float sp[MAX_ROWS][KT];         // scores, then rounded p
  __shared__ float sm[MAX_ROWS], sl[MAX_ROWS], sc[MAX_ROWS];

  const int nq = min(QB, Cs - q0);
  const int R = nq * G;                      // rows of this block
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;

  for (int i = tid; i < R * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r / G, g = r % G;
    sq[r][d] = to_float(q[(((size_t)b * Cs + qi) * Hq + h * G + g) * HD + d]);
  }
  if (tid < MAX_ROWS) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.0f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

  // live pages: from the first one the window reaches (for the block's
  // first query) to the last one with a key < kv_len and <= its last query
  const int last_key = min(kvl, pos0 + nq) - 1;
  const int j_hi = last_key < 0 ? -1 : min(P - 1, last_key / ps);
  int j_lo = 0;
  if (window > 0) {
    const int first_key = pos0 - window + 1;
    j_lo = first_key > 0 ? first_key / ps : 0;
  }

  // threads per dot product: a power of two, at most a warp
  int tpd = 1;
  while (tpd < 32 && 2 * tpd * R * KT <= THREADS) tpd *= 2;
  const int groups = THREADS / tpd;
  const int lane_in = tid % tpd;
  const int grp = tid / tpd;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    const int page = bt[(size_t)b * P + j];
    for (int off = 0; off < ps; off += KT) {
      const int n = min(KT, ps - off);
      const int base = j * ps + off;           // position of the tile's key 0
      for (int c = tid; c < n * CPR; c += THREADS) {
        const int row = c / CPR, col = c % CPR;
        const size_t src = (((size_t)page * ps + off + row) * Hkv + h) * HD;
        reinterpret_cast<uint4*>(&sk[row][0])[col] =
            reinterpret_cast<const uint4*>(k_pages + src)[col];
        reinterpret_cast<uint4*>(&sv[row][0])[col] =
            reinterpret_cast<const uint4*>(v_pages + src)[col];
      }
      __syncthreads();

      // scores: dot di covers row di / KT, key di % KT
      for (int d0 = 0; d0 < R * KT; d0 += groups) {
        const int di = d0 + grp;
        const int r = di / KT, kk = di % KT;
        const bool ok = di < R * KT && kk < n;
        float part = 0.0f;
        if (ok) {
          for (int d = lane_in; d < HD; d += tpd)
            part += sq[r][d] * to_float(sk[kk][d]);
        }
        for (int o = tpd / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (ok && lane_in == 0) {
          float s = part * scale;
          if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
          const int kpos = base + kk;
          const int qpos = pos0 + r / G;
          const bool live = kpos < kvl && kpos <= qpos &&
                            (window <= 0 || kpos > qpos - window);
          sp[r][kk] = live ? s : -INFINITY;
        }
      }
      __syncthreads();

      // online softmax, one warp per row, one lane per key
      for (int r = warp; r < R; r += THREADS / 32) {
        const float s = lane < n ? sp[r][lane] : -INFINITY;
        float mx = s;
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = sm[r];
        const float m_new = fmaxf(m_old, mx);
        const float p = expf(s - m_new);       // masked: exp(-inf) = 0
        float ps_sum = p;
        for (int o = 16; o > 0; o >>= 1)
          ps_sum += __shfl_xor_sync(0xffffffffu, ps_sum, o);
        if (lane < n) sp[r][lane] = round_to<T>(p);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          sl[r] = sl[r] * corr + ps_sum;
          sm[r] = m_new;
          sc[r] = corr;
        }
      }
      __syncthreads();

      // acc[r][d] = acc * corr + sum_k p[r][k] * V[k][d]
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int idx = tid + i * THREADS;
        if (idx < R * HD) {
          const int r = idx / HD, d = idx % HD;
          float a = acc[i] * sc[r];
          for (int kk = 0; kk < n; ++kk) a += sp[r][kk] * to_float(sv[kk][d]);
          acc[i] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int idx = tid + i * THREADS;
    if (idx < R * HD) {
      const int r = idx / HD, d = idx % HD;
      const int qi = q0 + r / G, g = r % G;
      out[(((size_t)b * Cs + qi) * Hq + h * G + g) * HD + d] =
          acc[i] / fmaxf(sl[r], 1e-20f);
    }
  }
}

// K3: one block per (kv head, row); its one query sits at t[b].
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ bt,
    const int32_t* __restrict__ t_vec, float* __restrict__ out, int Hkv,
    int G, int ps, int P, int window, float softcap, float scale) {
  const int b = blockIdx.y;
  const int t = t_vec[b];
  attend<T, HD>(q, k_pages, v_pages, bt, out, blockIdx.x, b, 0, t, t + 1, 1,
                Hkv, G, 1, ps, P, window, softcap, scale);
}

// K4: one block per (kv head, row, block of QB queries of the chunk).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) paged_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ bt,
    float* __restrict__ out, int Cs, int Hkv, int G, int QB, int ps, int P,
    int start, int kv_len, int window, float softcap, float scale) {
  const int q0 = blockIdx.z * QB;
  attend<T, HD>(q, k_pages, v_pages, bt, out, blockIdx.x, blockIdx.y, q0,
                start + q0, kv_len, Cs, Hkv, G, QB, ps, P, window, softcap,
                scale);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* kp, const void* vp, const void* bt,
              const void* t, void* out, int B, int Cs, int Hkv, int G, int ps,
              int P, int start, int kv_len, int window, float softcap,
              void* stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const cudaStream_t st = (cudaStream_t)stream;
  if (t != nullptr) {
    paged_decode_kernel<T, HD><<<dim3(Hkv, B), THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const int32_t*>(bt),
        static_cast<const int32_t*>(t), static_cast<float*>(out), Hkv, G, ps,
        P, window, softcap, scale);
  } else {
    const int QB = G >= MAX_ROWS ? 1 : MAX_ROWS / G;   // queries per block
    paged_chunk_kernel<T, HD>
        <<<dim3(Hkv, B, (Cs + QB - 1) / QB), THREADS, 0, st>>>(
            static_cast<const T*>(q), static_cast<const T*>(kp),
            static_cast<const T*>(vp), static_cast<const int32_t*>(bt),
            static_cast<float*>(out), Cs, Hkv, G, QB, ps, P, start, kv_len,
            window, softcap, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int hd, const void* q, const void* kp, const void* vp,
           const void* bt, const void* t, void* out, int B, int Cs, int Hkv,
           int G, int ps, int P, int start, int kv_len, int window,
           float softcap, void* stream) {
  if (G < 1 || G > MAX_ROWS) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, kp, vp, bt, t, out, B, Cs, Hkv, G, ps, P,
                              start, kv_len, window, softcap, stream);
    case 32:
      return launch_hd<T, 32>(q, kp, vp, bt, t, out, B, Cs, Hkv, G, ps, P,
                              start, kv_len, window, softcap, stream);
    case 64:
      return launch_hd<T, 64>(q, kp, vp, bt, t, out, B, Cs, Hkv, G, ps, P,
                              start, kv_len, window, softcap, stream);
    case 128:
      return launch_hd<T, 128>(q, kp, vp, bt, t, out, B, Cs, Hkv, G, ps, P,
                               start, kv_len, window, softcap, stream);
    case 256:
      return launch_hd<T, 256>(q, kp, vp, bt, t, out, B, Cs, Hkv, G, ps, P,
                               start, kv_len, window, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K3: q [B, Hq, hd], pages [NP, ps, Hkv, hd], bt int32 [B, P], t int32 [B]
//     -> out fp32 [B, Hq, hd]
int paged_attn_decode_f32(const void* q, const void* kp, const void* vp,
                          const void* bt, const void* t, void* out, int B,
                          int Hkv, int G, int hd, int ps, int P, int window,
                          float softcap, void* stream) {
  return launch<float>(hd, q, kp, vp, bt, t, out, B, 1, Hkv, G, ps, P, 0, 0,
                       window, softcap, stream);
}

int paged_attn_decode_bf16(const void* q, const void* kp, const void* vp,
                           const void* bt, const void* t, void* out, int B,
                           int Hkv, int G, int hd, int ps, int P, int window,
                           float softcap, void* stream) {
  return launch<__nv_bfloat16>(hd, q, kp, vp, bt, t, out, B, 1, Hkv, G, ps,
                               P, 0, 0, window, softcap, stream);
}

// K4: q [B, Cs, Hq, hd], pages, bt as K3, start / kv_len scalars
//     -> out fp32 [B, Cs, Hq, hd]
int paged_attn_chunk_f32(const void* q, const void* kp, const void* vp,
                         const void* bt, void* out, int B, int Cs, int Hkv,
                         int G, int hd, int ps, int P, int start, int kv_len,
                         int window, float softcap, void* stream) {
  return launch<float>(hd, q, kp, vp, bt, nullptr, out, B, Cs, Hkv, G, ps, P,
                       start, kv_len, window, softcap, stream);
}

int paged_attn_chunk_bf16(const void* q, const void* kp, const void* vp,
                          const void* bt, void* out, int B, int Cs, int Hkv,
                          int G, int hd, int ps, int P, int start, int kv_len,
                          int window, float softcap, void* stream) {
  return launch<__nv_bfloat16>(hd, q, kp, vp, bt, nullptr, out, B, Cs, Hkv, G,
                               ps, P, start, kv_len, window, softcap, stream);
}

}  // extern "C"
