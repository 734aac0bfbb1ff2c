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
// K3 runs a split-KV body of its own (`paged_decode_split_kernel`); the
// fp32 K4 runs the block body `attend` (`paged_chunk_kernel`) and the bf16
// K4 a tensor-core body (`paged_chunk_tc_kernel`). Pages are
// [NP, ps, Hkv, hd] (fp32 or bf16, or int8 with scales: below), the block
// table [B, P] int32 maps a row's logical page j to its physical page (0 =
// the null page); outputs are fp32 [B, Cs, Hq, hd] ([B, Hq, hd] for K3),
// heads grouped as Hq = Hkv * G (GQA).
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
// about 1 FLOP per byte in bf16, far below the ~295 FLOP/byte ridge. A
// chunk of 128 queries does ~128x more FLOPs on the same pages (llama's
// last chunk: ~0.8 GFLOP over ~7.3 MB), still under the ridge, but only if
// the products run on the tensor cores and each K/V tile is reused by many
// query rows. Both kernels read only live pages: the key loop runs from the
// first key the window can reach to the last key < kv_len that the block's
// last query may see (the reference's liveness rule, applied to the block's
// rows), so dead pages, the null page behind a short row included, cost no
// load and no FLOPs.
//
// K3 is flash-decoding (split-KV), templated on the page dtype. A decode
// has one query per row, so a CTA per (kv head, row) walking the row's
// pages in order leaves most SMs idle and serialises a long row. The grid
// is (kv head h, row b, split s): split s is a fixed span of whole pages,
// key positions [s * split_keys, (s + 1) * split_keys) with split_keys =
// pages_per_split * ps, about 64 keys (kernels/paged_attn.py:decode_splits,
// a function of P and ps alone, so a row's result never depends on its
// batch). A CTA of DEC_WARPS warps stages the G <= 16 query heads of its
// kv head (fp32) and the split's block-table entries in shared memory,
// loaded beside t, and spreads the split's keys over its warps in tiles of
// 32, one key per lane: each tile's K and V rows are gathered through the
// staged entries by 16-byte cp.async into the warp's own ring (two slots
// where a warp has more than one tile), keys outside the row's live range
// zero-filled (src-size 0), never read. A lane computes
// its key's G scores as fp32 dot products; each warp keeps its own online
// softmax per head (warp-shuffle max and sum, -inf for a masked key
// against a running max from -1e30) and its PV accumulators, a lane per
// head_dim / 32 output columns. The warps' partials merge through shared
// memory in warp order into the split's partial (m, l, acc[hd]) in a
// workspace [B, Hkv, splits, G, hd + 2]. A CTA whose split lies wholly
// past t or before the window writes the empty partial (m = -1e30, l = 0,
// acc = 0), whose weight in the combine is exactly 0. Then each CTA counts
// itself in an integer counter of its (row, kv head); the last to arrive
// resets it to 0 and combines the splits in index order:
//   M = max_s m_s; out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s,
//   1e-20).
// No float atomics, so a repeated launch gives the same bits.
//
// The fp32 K4 runs the block body (`attend`): one block of 128 threads per
// (kv head h, row b, block of up to 16 (query, head) rows), tiles of KT
// keys staged with 16-byte loads, scores as fp32 dot products from shared
// memory (shuffle-reduced), the softmax one warp per row, PV into fp32
// registers.
//
// The bf16 K4 has a FlashAttention-2-style body of its own
// (`paged_chunk_tc_kernel`). A warp owns 16 (query, head) rows, folded as
// r = qi * G + g so GQA needs no second pass, and keeps their Q fragments
// in registers for the whole key loop. A CTA of W warps (16 W rows; the
// wrapper's chunk_warps picks 4 wherever a chunk has more than 32 rows per
// kv head: every K/V tile then feeds 64 rows, which beat more, smaller
// CTAs at both served chunk shapes) walks key tiles of chunk_kt keys (64,
// or 32 at head_dim 256: several pages of 16), each gathered through the
// block table with 16-byte cp.async copies into a ring of chunk_stages
// (3, or 2 at head_dim 256 and on int8 pages), so later tiles' loads
// overlap this tile's math under one __syncthreads per tile; keys outside
// the block's live range are zero-filled by the copy (src-size 0) and
// never read.
// S = Q K^T runs on mma.sync m16n8k16 (bf16 in, fp32 accumulate; K by
// ldmatrix), then the scale, the softcap and the masks in fp32 registers;
// a masked score is -inf against a running max that starts at the
// reference's -1e30, so a masked key gets p = 0 exactly and a row that has
// seen no live key yet gets no NaN. The online softmax keeps its row max
// and sum in registers (quad shuffles); l sums the unrounded p, and P,
// rounded to bf16 (the reference's p.astype(v.dtype)), is the A operand of
// PV on mma.sync (V by ldmatrix.trans). A warp skips the math of a tile
// that none of its rows can see. The tile range per CTA is
// kernels/paged_attn.py:chunk_tiles.
//
// The int8 page operand (the TPU kernels' `quant` branch, their
// k_scales/v_scales [NP, Hkv] f32 operands gathered through the block
// table beside the pages): pages hold int8 values and one f32 scale per
// (page, kv head), and each body reads the int8 page (half the bytes of a
// bf16 one) and dequantizes it in the kernel, with q fp32 or bf16. As in
// the reference the dequantized V is fp32, so p is not rounded to the page
// dtype before PV. A key's scales are read only where the key is live
// (else 0), so a NaN scale on a dead page or the null page never reaches an
// output. No body converts an int8 value with a conversion instruction
// (I2F runs at an eighth of the FP32 rate on Hopper): i8_f32 flips the
// sign bits of four bytes with one LOP3, puts each byte into the low
// mantissa of 2^23 with one PRMT and subtracts 2^23 + 128 with one FADD,
// which gives exactly (float)x; bf16_pair_exact packs two such floats'
// high halves, their exact bf16, with one PRMT. K3: each warp copies the
// split's per-page K and V scales into shared memory in its first tile's
// cp.async group, after the tile's rows (0 for a page that holds no key
// the row may see), and a lane reads its own key's there; the K scale
// multiplies its fp32 scores, the V scale its p before the PV sum (p *
// s_v, with l summing p). The split is the bf16 pages' (128 keys were no
// faster at llama's decode and ~30% slower at granite's; PERF.md). fp32
// K4: one page per key tile, its two scales loaded once per tile, the same
// two multiplies. bf16 K4: the cp.async ring stages int8 tiles (half the
// bytes of bf16 ones) and each key's two scales (4-byte cp.async,
// zero-filled for dead keys), and each landed tile is widened, with a copy
// of its scales, into one of two bf16 K and V tile pairs that ldmatrix
// reads as before. Widening once per CTA, not in each warp's fragment
// loads, converts each value once instead of once per warp and keeps V's
// transposed fragments on ldmatrix.trans. The CTA has W producer warps
// beside its W attending warps: in the step of tile t the producers load
// tile t + STAGES into the ring slot of tile t (widened a step earlier)
// and widen tile t + 1 into the other bf16 pair while the W warps run S
// and PV on tile t, and one __syncthreads ends the step, freeing the ring
// slot and the bf16 pair. Widening so overlaps the tensor-core work
// instead of preceding it behind a second barrier, at the cost of 4 x KT
// bf16 rows of shared memory (with a 2-slot int8 ring, 123 KiB a CTA at
// head_dim 128) and twice the threads a CTA (an SM holds one such CTA at
// the served chunks either way). The K scale multiplies S
// per key column in fp32 registers before the softcap and masks; the V
// scale is folded into P before P is rounded to bf16, with l summing the
// unscaled p.
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

// int8 -> fp32 without a conversion instruction (Hopper issues I2F at 16 a
// clock per SM, FADD at 128). A word's four bytes x flip to x + 128 in
// 0..255 (one LOP3, i8_flip); byte k of the flipped word becomes the low
// mantissa byte of 2^23 (one PRMT), and one FADD takes 2^23 + 128 off
// (i8_f32). Exact for every byte, the float (float)x gives.
__device__ __forceinline__ unsigned i8_flip(unsigned w) {
  return w ^ 0x80808080u;
}

__device__ __forceinline__ float i8_f32(unsigned flipped, int k) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 | k)) -
         8388736.0f;
}

// two i8_f32 values as a bf16 pair, lo in the low half (one PRMT): an
// integer of magnitude <= 128 has at most 8 significant bits, so the high
// half of its float is its exact bf16
__device__ __forceinline__ unsigned bf16_pair_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, int8_t>::value) {
    return i8_f32(i8_flip((unsigned)(uint8_t)v), 0);
  } else {
    return __bfloat162float(v);
  }
}

// p rounded to the page dtype, as the reference's p.astype(v.dtype); an
// int8 page dequantizes to fp32, so p stays fp32
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(p));
  } else {
    return p;
  }
}

template <typename T>
__host__ __device__ constexpr bool is_i8() {
  return std::is_same<T, int8_t>::value;
}

// p * s_v for a key's PV term; 0 where p is 0 (a masked key), whatever the
// scale holds. A NaN p (a live key whose K scale is NaN) stays NaN, as the
// reference's dequantized attention gives it
__device__ __forceinline__ float scale_p(float p, float sv) {
  return p != 0.0f ? p * sv : 0.0f;
}

// The fp32 K4 body: the block of (kv head h, row b, queries
// q0..q0+QB-1) whose first query sits at absolute position pos0; keys at
// positions >= kvl are masked. Pages of type KV: T, or int8 with scales.
template <typename T, typename KV, int HD>
__device__ __forceinline__ void attend(
    const T* __restrict__ q,            // [B, Cs, Hkv * G, HD]
    const KV* __restrict__ k_pages,     // [NP, ps, Hkv, HD]
    const KV* __restrict__ v_pages,     // [NP, ps, Hkv, HD]
    const float* __restrict__ k_scales, // [NP, Hkv] (int8 pages only)
    const float* __restrict__ v_scales, // [NP, Hkv] (int8 pages only)
    const int32_t* __restrict__ bt,     // [B, P]
    float* __restrict__ out,            // [B, Cs, Hkv * G, HD]
    int h, int b, int q0, int pos0, int kvl, int Cs, int Hkv, int G, int QB,
    int ps, int P, int window, float softcap, float scale) {
  constexpr int KT = HD > 128 ? 8 : 16;      // keys per shared-memory tile
  constexpr int CPR = HD * sizeof(KV) / 16;  // 16-byte chunks per key row
  // Each key row is padded by 16 bytes, so the rows of a tile start 4
  // banks apart: the score loop reads one column of many rows at once,
  // which unpadded rows (a multiple of 128 bytes) serve from one bank.
  constexpr int KPAD = 16 / sizeof(KV);
  constexpr int ACC = MAX_ROWS * HD / THREADS;
  static_assert(KT <= 32, "one warp lane per key in the softmax update");
  static_assert(ACC >= 1, "rows x head_dim must cover the block");

  __shared__ float sq[MAX_ROWS][HD];
  __shared__ __align__(16) KV sk[KT][HD + KPAD];
  __shared__ __align__(16) KV sv[KT][HD + KPAD];
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
    // the page's scales: every page of [j_lo, j_hi] holds a key some query
    // of the block may see
    float ksc = 1.0f, vsc = 1.0f;
    if constexpr (is_i8<KV>()) {
      ksc = k_scales[(size_t)page * Hkv + h];
      vsc = v_scales[(size_t)page * Hkv + h];
    }
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
          float s = part;
          if constexpr (is_i8<KV>()) s *= ksc;
          s *= scale;
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
        if (lane < n)
          sp[r][lane] = is_i8<KV>() ? scale_p(p, vsc) : round_to<KV>(p);
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

// K4 in fp32: one block per (kv head, row, block of QB queries of the
// chunk). The bf16 K4 runs paged_chunk_tc_kernel below.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(THREADS) paged_chunk_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int32_t* __restrict__ bt,
    float* __restrict__ out, int Cs, int Hkv, int G, int QB, int ps, int P,
    int start, int kv_len, int window, float softcap, float scale) {
  const int q0 = blockIdx.z * QB;
  attend<T, KV, HD>(q, k_pages, v_pages, k_scales, v_scales, bt, out,
                    blockIdx.x, blockIdx.y, q0, start + q0, kv_len, Cs, Hkv,
                    G, QB, ps, P, window, softcap, scale);
}

// ----------------------------------------------------------- bf16 chunk body

template <int HD>
__host__ __device__ constexpr int chunk_kt() {  // keys per K/V tile
  return HD > 128 ? 32 : 64;
}

// K/V ring depth: 3, or 2 at head_dim 256 and on int8 pages, whose two
// bf16 tile pairs hold the tile ahead (a third int8 slot made the CTA's
// shared memory 141 KiB at head_dim 128, slower inside the engine's chunk
// tick though faster alone; PERF.md)
template <int HD, typename KV>
__host__ __device__ constexpr int chunk_stages() {
  return HD > 128 || is_i8<KV>() ? 2 : 3;
}

// Q rows, then the K and V rings of KV rows; rows padded by 16 bytes so
// ldmatrix's eight row reads of a matrix fall in distinct banks. int8
// pages add two bf16 K and two bf16 V tiles they widen into, the rings of
// the keys' K and V scales and the two tiles' copies of them.
template <int HD, typename KV>
__host__ __device__ constexpr int chunk_smem_bytes(int warps) {
  constexpr int KT = chunk_kt<HD>(), ST = chunk_stages<HD, KV>();
  if constexpr (is_i8<KV>()) {
    return (16 * warps + 4 * KT) * (HD + 8) * 2 + 2 * ST * KT * (HD + 16) +
           2 * (ST + 2) * KT * 4;
  } else {
    return (16 * warps + 2 * ST * KT) * (HD + 8) * 2;
  }
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

// two floats rounded to bf16 (p.astype(v.dtype)), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// 4 bytes global -> shared (a key's scale); src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 16 int8 values (one 16-byte load) widened to 16 bf16 (two 16-byte
// stores) by i8_f32 and bf16_pair_exact: no conversion instruction, and
// every int8 value is exact in bf16
__device__ __forceinline__ void widen16(const int8_t* src,
                                        __nv_bfloat16* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {i8_flip(v.x), i8_flip(v.y), i8_flip(v.z),
                         i8_flip(v.w)};
  unsigned o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 2 * (i % 2);
    o[i] = bf16_pair_exact(i8_f32(w[i / 2], k), i8_f32(w[i / 2], k + 1));
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
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

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Keys a block of rows [row0, row0 + nrows) may see: [first, last]
// (empty when last < first). chunk_tiles in kernels/paged_attn.py.
__device__ __forceinline__ void chunk_key_range(int row0, int nrows, int G,
                                                int start, int kv_len,
                                                int window, int ps, int P,
                                                int& first, int& last) {
  const int q_first = row0 / G, q_last = (row0 + nrows - 1) / G;
  last = min(min(kv_len - 1, start + q_last), P * ps - 1);
  first = window > 0 ? max(0, start + q_first - window + 1) : 0;
}

// threads of K4's tensor-core CTA: W warps, and on int8 pages as many
// producer warps beside them
template <int W, typename KV>
__host__ __device__ constexpr int chunk_threads() {
  return 32 * W * (is_i8<KV>() ? 2 : 1);
}

// K4, bf16 q: one CTA of W warps per (kv head h, row b, block of 16 W
// (query, head) rows), and on int8 pages W producer warps; see the
// header. Pages of type KV: bf16, or int8 with scales.
template <int HD, int W, typename KV>
__global__ void __launch_bounds__(chunk_threads<W, KV>())
    paged_chunk_tc_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, Cs, Hkv * G, HD]
    const KV* __restrict__ k_pages,            // [NP, ps, Hkv, HD]
    const KV* __restrict__ v_pages,            // [NP, ps, Hkv, HD]
    const float* __restrict__ k_scales,        // [NP, Hkv] (int8 pages)
    const float* __restrict__ v_scales,        // [NP, Hkv] (int8 pages)
    const int32_t* __restrict__ bt,            // [B, P]
    float* __restrict__ out,                   // [B, Cs, Hkv * G, HD]
    int Cs, int Hkv, int G, int ps, int P, int start, int kv_len, int window,
    float softcap, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr bool Q8 = is_i8<KV>();
  constexpr int KT = chunk_kt<HD>();
  constexpr int STAGES = chunk_stages<HD, KV>();
  constexpr int LD = HD + 8;                 // bf16 smem row stride
  constexpr int LDR = HD + 16 / (int)sizeof(KV);  // ring row stride
  constexpr int QCPR = HD / 8;               // 16-byte chunks per Q row
  constexpr int CPR = HD * (int)sizeof(KV) / 16;  // ... per ring row
  constexpr int VE = 16 / (int)sizeof(KV);   // ring elements per chunk
  constexpr int NT = 32 * W;                 // threads of the W warps
  constexpr int DN = HD / 8;                 // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char dsmem[];
  bf16* sq = reinterpret_cast<bf16*>(dsmem);           // [16 W][LD]
  KV* sk = reinterpret_cast<KV*>(sq + 16 * W * LD);     // [STAGES][KT][LDR]
  KV* sv = sk + STAGES * KT * LDR;                      // [STAGES][KT][LDR]
  // int8 pages: two widened bf16 K and V tiles, the keys' scale rings and
  // the two tiles' copies of their scales
  bf16* wk = reinterpret_cast<bf16*>(sv + STAGES * KT * LDR);  // [2][KT][LD]
  bf16* wv = wk + 2 * KT * LD;                                 // [2][KT][LD]
  float* sks = reinterpret_cast<float*>(wv + 2 * KT * LD);  // [STAGES][KT]
  float* svs = sks + STAGES * KT;                           // [STAGES][KT]
  float* wks = svs + STAGES * KT;                           // [2][KT]
  float* wvs = wks + 2 * KT;                                // [2][KT]

  const int h = blockIdx.x, b = blockIdx.y;
  const int Hq = Hkv * G;
  const int R = Cs * G;                      // (query, head) rows of (b, h)
  const int row0 = blockIdx.z * 16 * W;
  const int nrows = min(16 * W, R - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, tig = lane % 4;
  // int8 pages: warps W.. load and widen the tiles (thread ltid of NT),
  // warps 0..W-1 attend; bf16 pages: every warp does both
  const bool producer = Q8 && warp >= W;
  const int ltid = Q8 ? tid - NT : tid;

  int first_key, last_key;
  chunk_key_range(row0, nrows, G, start, kv_len, window, ps, P, first_key,
                  last_key);
  const int t_lo = first_key / KT;
  const int t_hi = last_key < first_key ? t_lo - 1 : last_key / KT;

  // this warp's rows and the keys they may see
  const int wrow0 = row0 + warp * 16;
  const int wrows = min(16, R - wrow0);
  int w_first = 0, w_last = -1;
  if (wrows > 0)
    chunk_key_range(wrow0, wrows, G, start, kv_len, window, ps, P, w_first,
                    w_last);

  // Q rows -> shared (zeros past R)
  for (int c = ltid; c < 16 * W * QCPR && (!Q8 || producer); c += NT) {
    const int r = c / QCPR, cc = (c % QCPR) * 8;
    const int gr = row0 + r;
    const bool live = gr < R;
    const size_t src =
        live ? (((size_t)b * Cs + gr / G) * Hq + h * G + gr % G) * HD + cc : 0;
    cp_async16(sq + r * LD + cc, q + src, live ? 16 : 0);
  }
  auto load_tile = [&](int t, int slot) {
    KV* dk = sk + slot * KT * LDR;
    KV* dv = sv + slot * KT * LDR;
#pragma unroll 4
    for (int c = ltid; c < KT * CPR; c += NT) {
      const int kk = c / CPR, cc = (c % CPR) * VE;
      const int pos = t * KT + kk;
      const bool live = pos >= first_key && pos <= last_key;
      size_t src = 0;
      if (live) {
        const int page = bt[(size_t)b * P + pos / ps];
        src = (((size_t)page * ps + pos % ps) * Hkv + h) * HD + cc;
      }
      cp_async16(dk + kk * LDR + cc, k_pages + src, live ? 16 : 0);
      cp_async16(dv + kk * LDR + cc, v_pages + src, live ? 16 : 0);
    }
    if constexpr (Q8) {
      // each key's scales, zero-filled (never read) for a dead key
      for (int kk = ltid; kk < KT; kk += NT) {
        const int pos = t * KT + kk;
        const bool live = pos >= first_key && pos <= last_key;
        size_t src = 0;
        if (live) src = (size_t)bt[(size_t)b * P + pos / ps] * Hkv + h;
        cp_async4(sks + slot * KT + kk, k_scales + src, live ? 4 : 0);
        cp_async4(svs + slot * KT + kk, v_scales + src, live ? 4 : 0);
      }
    }
  };
  // int8 pages: the landed int8 tile of loop step `it` (ring slot it %
  // STAGES) and its keys' scales, widened into bf16 tile `buf`
  auto widen = [&](int it, int buf) {
    const KV* rk = sk + (it % STAGES) * KT * LDR;
    const KV* rv = sv + (it % STAGES) * KT * LDR;
    bf16* dk = wk + buf * KT * LD;
    bf16* dv = wv + buf * KT * LD;
    for (int c = ltid; c < KT * CPR; c += NT) {
      const int kk = c / CPR, cc = (c % CPR) * VE;
      widen16(reinterpret_cast<const int8_t*>(rk) + kk * LDR + cc,
              dk + kk * LD + cc);
      widen16(reinterpret_cast<const int8_t*>(rv) + kk * LDR + cc,
              dv + kk * LD + cc);
    }
    for (int kk = ltid; kk < KT; kk += NT) {
      wks[buf * KT + kk] = sks[(it % STAGES) * KT + kk];
      wvs[buf * KT + kk] = svs[(it % STAGES) * KT + kk];
    }
  };
  // groups: Q and the first tile, then one tile each. int8 pages: the
  // producers fill every slot of the ring and widen the first tile
  if constexpr (Q8) {
    if (producer) {
#pragma unroll
      for (int j = 0; j < STAGES; ++j) {
        if (t_lo + j <= t_hi) load_tile(t_lo + j, j);
        cp_async_commit();
      }
      cp_async_wait<STAGES - 1>();           // Q and the first tile landed
      if (t_lo <= t_hi) widen(0, 0);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (t_lo + j <= t_hi) load_tile(t_lo + j, j);
      cp_async_commit();
    }
  }

  // per-thread rows: g8 and g8 + 8 of the warp's 16
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = start + (wrow0 + g8 + 8 * i) / G;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};                 // this thread's part of the sum
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  unsigned qa[HD / 16][4];

  for (int t = t_lo; t <= t_hi; ++t) {
    const int it = t - t_lo;
    const bf16* tk;
    const bf16* tvv;
    if constexpr (Q8) {
      // the barrier that ended the previous step: tile t is widened in bf16
      // tile it % 2, its ring slot it % STAGES and bf16 tile (it + 1) % 2
      // are free. The producers load tile t + STAGES and widen tile t + 1
      // while the W warps attend to tile t
      if (producer) {
        if (t + STAGES <= t_hi) load_tile(t + STAGES, it % STAGES);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();         // tile t + 1 has landed
        if (t + 1 <= t_hi) widen(it + 1, (it + 1) % 2);
      }
      tk = wk + (it % 2) * KT * LD;
      tvv = wv + (it % 2) * KT * LD;
    } else {
      cp_async_wait<STAGES - 2>();           // tile t (and Q) have landed
      __syncthreads();   // ... for every thread; slot (it - 1) is free again
      if (t + STAGES - 1 <= t_hi)
        load_tile(t + STAGES - 1, (it + STAGES - 1) % STAGES);
      cp_async_commit();
      tk = sk + (it % STAGES) * KT * LD;
      tvv = sv + (it % STAGES) * KT * LD;
    }
    if (it == 0 && !producer) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        ldmatrix_x4(qa[ks], sq + (warp * 16 + lane % 16) * LD + ks * 16 +
                                (lane / 16) * 8);
    }
    const float* tks = wks + (it % 2) * KT;
    const float* tvs = wvs + (it % 2) * KT;
    const bool sees = !producer && wrows > 0 && t * KT <= w_last &&
                      (t + 1) * KT - 1 >= w_first;
    if (sees) {
      // S = Q K^T: KT / 8 column tiles of 8 keys
      float s[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int nj = 0; nj < KT / 16; ++nj) {
          unsigned kb[4];
          ldmatrix_x4(kb, tk + (nj * 16 + lane % 8 + (lane / 16) * 8) * LD +
                              ks * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * nj], qa[ks], kb[0], kb[1]);
          mma_bf16(s[2 * nj + 1], qa[ks], kb[2], kb[3]);
        }
      }
      // scale, softcap, masks; the row max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[n][e];
          if constexpr (Q8) v *= tks[n * 8 + 2 * tig + (e % 2)];
          v *= scale;
          if (softcap > 0.0f) v = softcap * tanhf(v / softcap);
          const int kpos = t * KT + n * 8 + 2 * tig + (e % 2);
          const int qp = qpos[e / 2];
          const bool live = kpos <= last_key && kpos < kv_len && kpos <= qp &&
                            (window <= 0 || kpos > qp - window);
          s[n][e] = live ? v : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      // p = exp(s - m) (masked: exp(-inf) = 0), l sums it unrounded, the
      // bf16 P fragments feed PV
      unsigned pa[KT / 16][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[n][e] - m[e / 2]);
          l[e / 2] += p[e];
          if constexpr (Q8) p[e] = scale_p(p[e], tvs[n * 8 + 2 * tig + (e % 2)]);
        }
        pa[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        o[dn][0] *= corr[0];
        o[dn][1] *= corr[0];
        o[dn][2] *= corr[1];
        o[dn][3] *= corr[1];
      }
      // O += P V: V fragments by ldmatrix.trans, 16 keys x 16 columns each
#pragma unroll
      for (int kj = 0; kj < KT / 16; ++kj) {
#pragma unroll
        for (int dj = 0; dj < HD / 16; ++dj) {
          unsigned vb[4];
          ldmatrix_x4_trans(
              vb, tvv + (kj * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                      dj * 16 + (lane / 16) * 8);
          mma_bf16(o[2 * dj], pa[kj], vb[0], vb[1]);
          mma_bf16(o[2 * dj + 1], pa[kj], vb[2], vb[3]);
        }
      }
    }
    if constexpr (Q8) __syncthreads();      // the step's one barrier
  }
  cp_async_wait<0>();
  if (producer) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int gr = wrow0 + g8 + 8 * i;
    if (gr >= R) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* dst = out + (((size_t)b * Cs + gr / G) * Hq + h * G + gr % G) * HD;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<float2*>(dst + dn * 8 + 2 * tig) =
          make_float2(o[dn][2 * i] / den, o[dn][2 * i + 1] / den);
  }
}

// ------------------------------------------------ K3: split-KV decode body

constexpr int DEC_WARPS = 2;       // warps per CTA
constexpr int DEC_TILE = 32;       // keys per warp tile: one per lane
constexpr int DEC_MAX_PAGES = 64;  // pages a split (64 keys of pages of 1)

// smem row stride of a K/V tile (elements): 16 bytes of pad put the rows
// of a tile, which the lanes read at once, in distinct bank groups
template <typename T, int HD>
__host__ __device__ constexpr int dec_ld() {
  return HD + 16 / (int)sizeof(T);
}

// K/V ring slots a warp may use: two, or one where two would not fit
// (fp32 at head_dim 256)
template <typename T, int HD>
__host__ __device__ constexpr int dec_max_slots() {
  return HD * (int)sizeof(T) > 512 ? 1 : 2;
}

// the K/V ring, q (fp32), the rounded p and the warps' partials
template <typename T, int HD>
__host__ __device__ constexpr int dec_smem_bytes(int G, int slots) {
  return DEC_WARPS * slots * 2 * DEC_TILE * dec_ld<T, HD>() * (int)sizeof(T) +
         G * HD * 4 + DEC_WARPS * G * DEC_TILE * 4 +
         DEC_WARPS * G * (HD + 2) * 4;
}

// N consecutive elements of a shared-memory row, widened to fp32: one
// aligned load of N * sizeof(T) bytes (two at 32 bytes); int8 in 16-byte,
// 4-byte, 2-byte or 1-byte words, widened by i8_f32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[N]) {
  if constexpr (is_i8<T>()) {
    if constexpr (N % 16 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + i);
        const unsigned w[4] = {i8_flip(v.x), i8_flip(v.y), i8_flip(v.z),
                               i8_flip(v.w)};
#pragma unroll
        for (int k = 0; k < 16; ++k) f[i + k] = i8_f32(w[k / 4], k % 4);
      }
    } else if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const unsigned w =
            i8_flip(*reinterpret_cast<const unsigned*>(p + i));
#pragma unroll
        for (int k = 0; k < 4; ++k) f[i + k] = i8_f32(w, k);
      }
    } else {
      static_assert(N <= 2, "int8 loads of 1, 2 or a multiple of 4");
      unsigned w;
      if constexpr (N == 2) {
        w = i8_flip(*reinterpret_cast<const unsigned short*>(p));
      } else {
        w = i8_flip(*reinterpret_cast<const uint8_t*>(p));
      }
#pragma unroll
      for (int k = 0; k < N; ++k) f[k] = i8_f32(w, k);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + i);
        f[i] = v.x;
        f[i + 1] = v.y;
        f[i + 2] = v.z;
        f[i + 3] = v.w;
      }
    } else if constexpr (N == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      f[0] = v.x;
      f[1] = v.y;
    } else {
      f[0] = p[0];
    }
  } else {
    if constexpr (N == 1) {
      f[0] = __bfloat162float(p[0]);
    } else {
      constexpr int W = N * 2 >= 16 ? 4 : N * 2 / 4;   // 32-bit words a load
      static_assert(N * 2 % 4 == 0, "whole bf16 pairs");
#pragma unroll
      for (int i = 0; i < N; i += 2 * W) {
        unsigned w[W];
        if constexpr (W == 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(p + i);
          w[0] = v.x;
          w[1] = v.y;
          w[2] = v.z;
          w[3] = v.w;
        } else if constexpr (W == 2) {
          const uint2 v = *reinterpret_cast<const uint2*>(p + i);
          w[0] = v.x;
          w[1] = v.y;
        } else {
          w[0] = *reinterpret_cast<const unsigned*>(p + i);
        }
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
          f[i + 2 * k] = x.x;
          f[i + 2 * k + 1] = x.y;
        }
      }
    }
  }
}

// K3: one CTA per (kv head h, row b, split s); see the header. GB >= G
// bounds the per-head register arrays and loops at compile time (1, 4 or
// 16), so a kernel for G = 1 issues no work for absent heads. q of type T,
// pages of type KV: T, or int8 with scales.
template <typename T, typename KV, int HD, int GB>
__global__ void __launch_bounds__(DEC_WARPS * 32) paged_decode_split_kernel(
    const T* __restrict__ q,            // [B, Hkv * G, HD]
    const KV* __restrict__ k_pages,     // [NP, ps, Hkv, HD]
    const KV* __restrict__ v_pages,     // [NP, ps, Hkv, HD]
    const float* __restrict__ k_scales, // [NP, Hkv] (int8 pages only)
    const float* __restrict__ v_scales, // [NP, Hkv] (int8 pages only)
    const int32_t* __restrict__ bt,     // [B, P]
    const int32_t* __restrict__ t_vec,  // [B]
    float* __restrict__ ws,             // [B, Hkv, splits, G, HD + 2]
    int* __restrict__ counters,         // [B * Hkv], 0 between launches
    float* __restrict__ out,            // [B, Hkv * G, HD]
    int Hkv, int G, int ps, int P, int split_pages, int slots, int window,
    float softcap, float scale) {
  constexpr int LD = dec_ld<KV, HD>();
  constexpr int VE = 16 / sizeof(KV);         // elements per 16-byte chunk
  constexpr int CPR = HD / VE;                // chunks per key row
  constexpr int DPL = HD >= 32 ? HD / 32 : 1; // output columns per lane
  constexpr int GMAX = GB;                    // query heads per kv head
  constexpr int PW = HD + 2;                  // a head's partial: acc, m, l
  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ int s_last;
  __shared__ int s_page[DEC_MAX_PAGES];       // the split's physical pages
  // int8 pages: each warp's copy of the split's K and V scales, by page
  __shared__ float s_scale[is_i8<KV>() ? DEC_WARPS * 2 * DEC_MAX_PAGES : 1];
  KV* skv = reinterpret_cast<KV*>(dsmem);     // [W][slots][K, V][TILE][LD]
  float* sq = reinterpret_cast<float*>(skv + DEC_WARPS * slots * 2 *
                                                 DEC_TILE * LD);  // [G][HD]
  float* sp = sq + G * HD;                    // [W][G][TILE] rounded p
  float* sw = sp + DEC_WARPS * G * DEC_TILE;  // [W][G][PW] warp partials

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * G;

  // the split's keys the row may see (kernels/paged_attn.py
  // decode_split_keys): k_pos <= t, k_pos > t - window when window > 0
  const int t = t_vec[b];
  const int split_keys = split_pages * ps;
  const int sb = split * split_keys;
  // the split's block-table entries and q, loaded beside t (neither waits
  // for it), so a live split's gather waits on one round trip, not two
  for (int i = tid; i < split_pages; i += DEC_WARPS * 32) {
    const int j = split * split_pages + i;
    s_page[i] = j < P ? bt[(size_t)b * P + j] : 0;
  }
  for (int i = tid; i < G * HD; i += DEC_WARPS * 32)
    sq[i] = to_float(q[((size_t)b * Hq + h * G) * HD + i]);
  const int khi = min(t, min(sb + split_keys, P * ps) - 1);
  const int klo = window > 0 ? max(sb, t - window + 1) : sb;
  float* part = ws + (((size_t)b * Hkv + h) * splits + split) * G * PW;

  if (klo > khi) {
    for (int i = tid; i < G * PW; i += DEC_WARPS * 32)
      part[i] = i % PW == HD ? NEG_INF : 0.0f;
  } else {

    // this warp's tiles: tile j of the split holds keys sb + 32 j ..;
    // warp w takes the tiles j = w (mod W) that hold a live key
    const int j_lo = (klo - sb) / DEC_TILE, j_hi = (khi - sb) / DEC_TILE;
    const int j0 = j_lo + (warp - j_lo % DEC_WARPS + DEC_WARPS) % DEC_WARPS;
    const int ntiles = j0 > j_hi ? 0 : (j_hi - j0) / DEC_WARPS + 1;
    KV* wkv = skv + warp * slots * 2 * DEC_TILE * LD;

    // gather tile `it` into slot it % slots: lane r finds key r's row,
    // then the warp copies the rows 16 bytes a lane, zero-filling dead keys.
    // int8 pages: the first tile's group also copies the split's per-page
    // K and V scales into the warp's own slice of s_scale, after the rows
    // (copied before them, they made the launch slower than the parent's
    // per-lane global loads; PERF.md); a page that holds no key the row may
    // see gets 0, its scale never read, so a NaN there reaches nothing
    float* wsc = s_scale + (is_i8<KV>() ? warp * 2 * DEC_MAX_PAGES : 0);
    auto issue = [&](int it) {
      const int pos = sb + (j0 + it * DEC_WARPS) * DEC_TILE + lane;
      const bool live = pos >= klo && pos <= khi;
      long long row = 0;
      if (live) {
        const int page = s_page[(pos - sb) / ps];
        row = (((long long)page * ps + pos % ps) * Hkv + h) * HD;
      }
      KV* dk = wkv + (it % slots) * 2 * DEC_TILE * LD;
      KV* dv = dk + DEC_TILE * LD;
#pragma unroll 4
      for (int c = lane; c < DEC_TILE * CPR; c += 32) {
        const int r = c / CPR, cc = (c % CPR) * VE;
        const long long src = __shfl_sync(0xffffffffu, row, r);
        const int ok = __shfl_sync(0xffffffffu, (int)live, r);
        cp_async16(dk + r * LD + cc, k_pages + src + cc, ok ? 16 : 0);
        cp_async16(dv + r * LD + cc, v_pages + src + cc, ok ? 16 : 0);
      }
      if constexpr (is_i8<KV>()) {
        for (int i = lane; i < split_pages && it == 0; i += 32) {
          const int k0 = sb + i * ps;         // the page's first key
          const bool used = k0 <= khi && k0 + ps - 1 >= klo;
          const size_t at = used ? (size_t)s_page[i] * Hkv + h : 0;
          cp_async4(wsc + i, k_scales + at, used ? 4 : 0);
          cp_async4(wsc + DEC_MAX_PAGES + i, v_scales + at, used ? 4 : 0);
        }
      }
      cp_async_commit();
    };

    float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.0f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] = 0.0f;
    }
    __syncthreads();                          // q and pages staged
    int issued = 0;
    for (; issued < min(slots, ntiles); ++issued) issue(issued);

    float* wp = sp + warp * G * DEC_TILE;
    for (int it = 0; it < ntiles; ++it) {
      const int pos = sb + (j0 + it * DEC_WARPS) * DEC_TILE + lane;
      const bool live = pos >= klo && pos <= khi;
      if (issued > it + 1) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      // int8 pages: this lane's key's scales, read only for a live key
      float ksc = 0.0f, vsc = 0.0f;
      if constexpr (is_i8<KV>()) {
        if (live) {
          const int i = (pos - sb) / ps;
          ksc = wsc[i];
          vsc = wsc[DEC_MAX_PAGES + i];
        }
      }
      const KV* tk = wkv + (it % slots) * 2 * DEC_TILE * LD;
      const KV* tv = tk + DEC_TILE * LD;

      // scores of this lane's key for the G heads, fp32
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < HD; d += VE) {
        float kf[VE];
        load_f32<KV, VE>(tk + lane * LD + d, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (GB == 1 || g < G) {
            float qf[VE];
            load_f32<float, VE>(sq + g * HD + d, qf);
#pragma unroll
            for (int e = 0; e < VE; ++e) s[g] = fmaf(qf[e], kf[e], s[g]);
          }
        }
      }
      // scale, softcap, mask; the warp's online softmax per head
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (GB == 1 || g < G) {
          float v = s[g];
          if constexpr (is_i8<KV>()) v *= ksc;
          v *= scale;
          if (softcap > 0.0f) v = softcap * tanhf(v / softcap);
          v = live ? v : -INFINITY;
          float mx = v;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[g], mx);
          const float p = expf(v - m_new);     // masked: exp(-inf) = 0
          float psum = p;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            psum += __shfl_xor_sync(0xffffffffu, psum, o);
          const float corr = expf(m[g] - m_new);
          l[g] = l[g] * corr + psum;
          m[g] = m_new;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
          wp[g * DEC_TILE + lane] =
              is_i8<KV>() ? scale_p(p, vsc) : round_to<KV>(p);
        }
      }
      __syncwarp();
      // acc[g][columns of this lane] += sum_k p[g][k] * V[k][column]
      if (lane * DPL < HD) {
#pragma unroll 4
        for (int k = 0; k < DEC_TILE; ++k) {
          float vf[DPL];
          load_f32<KV, DPL>(tv + k * LD + lane * DPL, vf);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (GB == 1 || g < G) {
              const float pk = wp[g * DEC_TILE + k];
#pragma unroll
              for (int e = 0; e < DPL; ++e)
                acc[g][e] = fmaf(pk, vf[e], acc[g][e]);
            }
          }
        }
      }
      __syncwarp();                           // slot and p free again
      if (issued < ntiles) {
        issue(issued);
        ++issued;
      }
    }

    // the warps' partials, merged in warp order into the split's
    float* mw = sw + warp * G * PW;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (GB == 1 || g < G) {
        if (lane * DPL < HD) {
#pragma unroll
          for (int e = 0; e < DPL; ++e) mw[g * PW + lane * DPL + e] = acc[g][e];
        }
        if (lane == 0) {
          mw[g * PW + HD] = m[g];
          mw[g * PW + HD + 1] = l[g];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += DEC_WARPS * 32) {
      const int g = i / HD, d = i % HD;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w)
        M = fmaxf(M, sw[(w * G + g) * PW + HD]);
      float a = 0.0f, L = 0.0f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float* x = sw + (w * G + g) * PW;
        const float c = expf(x[HD] - M);
        a += c * x[d];
        L += c * x[HD + 1];
      }
      part[g * PW + d] = a;
      if (d == 0) {
        part[g * PW + HD] = M;
        part[g * PW + HD + 1] = L;
      }
    }
  }

  // the last CTA of (row, kv head) to arrive combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + (size_t)b * Hkv + h;
    const int last = atomicAdd(cnt, 1) == splits - 1;
    if (last) atomicExch(cnt, 0);
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* base = ws + ((size_t)b * Hkv + h) * splits * G * PW;
  for (int i = tid; i < G * HD; i += DEC_WARPS * 32) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      M = fmaxf(M, __ldcg(base + ((size_t)s * G + g) * PW + HD));
    float a = 0.0f, L = 0.0f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float* x = base + ((size_t)s * G + g) * PW;
      const float c = expf(__ldcg(x + HD) - M);
      a += c * __ldcg(x + d);
      L += c * __ldcg(x + HD + 1);
    }
    out[((size_t)b * Hq + h * G + g) * HD + d] = a / fmaxf(L, 1e-20f);
  }
}

// Lets a kernel use `bytes` of dynamic shared memory, and asks for the
// SM's whole carveout as shared memory: by default the carveout
// may hold fewer CTAs than fit.
template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int HD, int W, typename KV>
int launch_chunk_tc(const void* q, const void* kp, const void* vp,
                    const void* ks, const void* vs, const void* bt, void* out,
                    int B, int Cs, int Hkv, int G, int ps, int P, int start,
                    int kv_len, int window, float softcap, float scale,
                    cudaStream_t st) {
  constexpr int smem = chunk_smem_bytes<HD, KV>(W);
  static const cudaError_t attr =
      set_smem(paged_chunk_tc_kernel<HD, W, KV>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int ctas = (Cs * G + 16 * W - 1) / (16 * W);
  paged_chunk_tc_kernel<HD, W, KV>
      <<<dim3(Hkv, B, ctas), chunk_threads<W, KV>(), smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(bt),
      static_cast<float*>(out), Cs, Hkv, G, ps, P, start, kv_len, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, HD>) for the head_dims the kernels take
template <typename F>
int with_head_dim(int hd, F&& f) {
  switch (hd) {
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    case 256:
      return f(std::integral_constant<int, 256>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename KV, int HD, int GB>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* bt,
                  const void* t, void* ws, void* counters, void* out, int B,
                  int Hkv, int G, int ps, int P, int split_pages, int splits,
                  int window, float softcap, cudaStream_t st) {
  constexpr int max_smem =
      dec_smem_bytes<KV, HD>(GB, dec_max_slots<KV, HD>());
  static const cudaError_t attr =
      set_smem(paged_decode_split_kernel<T, KV, HD, GB>, max_smem);
  if (attr != cudaSuccess) return (int)attr;
  const int split_keys = split_pages * ps;
  const int tiles = (split_keys + DEC_WARPS * DEC_TILE - 1) /
                    (DEC_WARPS * DEC_TILE);   // per warp, at most
  const int slots = min(dec_max_slots<KV, HD>(), tiles);
  paged_decode_split_kernel<T, KV, HD, GB>
      <<<dim3(Hkv, B, splits), DEC_WARPS * 32,
         dec_smem_bytes<KV, HD>(G, slots), st>>>(
          static_cast<const T*>(q), static_cast<const KV*>(kp),
          static_cast<const KV*>(vp), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int32_t*>(bt),
          static_cast<const int32_t*>(t), static_cast<float*>(ws),
          static_cast<int*>(counters), static_cast<float*>(out), Hkv, G, ps, P,
          split_pages, slots, window, softcap,
          (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int decode(int hd, const void* q, const void* kp, const void* vp,
           const void* ks, const void* vs, const void* bt, const void* t,
           void* ws, void* counters, void* out, int B, int Hkv, int G, int ps,
           int P, int split_pages, int splits, int window, float softcap,
           void* stream) {
  if (G < 1 || G > MAX_ROWS || split_pages < 1 ||
      split_pages > DEC_MAX_PAGES || splits < 1 || splits * split_pages < P)
    return (int)cudaErrorInvalidValue;
  return with_head_dim(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    const auto st = (cudaStream_t)stream;
    if (G == 1)
      return launch_decode<T, KV, HD, 1>(q, kp, vp, ks, vs, bt, t, ws,
                                         counters, out, B, Hkv, G, ps, P,
                                         split_pages, splits, window, softcap,
                                         st);
    if (G <= 4)
      return launch_decode<T, KV, HD, 4>(q, kp, vp, ks, vs, bt, t, ws,
                                         counters, out, B, Hkv, G, ps, P,
                                         split_pages, splits, window, softcap,
                                         st);
    return launch_decode<T, KV, HD, MAX_ROWS>(q, kp, vp, ks, vs, bt, t, ws,
                                              counters, out, B, Hkv, G, ps, P,
                                              split_pages, splits, window,
                                              softcap, st);
  });
}

template <typename T, typename KV, int HD>
int launch_chunk(const void* q, const void* kp, const void* vp,
                 const void* ks, const void* vs, const void* bt, void* out,
                 int B, int Cs, int Hkv, int G, int ps, int P, int start,
                 int kv_len, int window, float softcap, int warps,
                 cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (warps) {
      case 1:
        return launch_chunk_tc<HD, 1, KV>(q, kp, vp, ks, vs, bt, out, B, Cs,
                                          Hkv, G, ps, P, start, kv_len, window,
                                          softcap, scale, st);
      case 2:
        return launch_chunk_tc<HD, 2, KV>(q, kp, vp, ks, vs, bt, out, B, Cs,
                                          Hkv, G, ps, P, start, kv_len, window,
                                          softcap, scale, st);
      case 4:
        return launch_chunk_tc<HD, 4, KV>(q, kp, vp, ks, vs, bt, out, B, Cs,
                                          Hkv, G, ps, P, start, kv_len, window,
                                          softcap, scale, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    const int QB = G >= MAX_ROWS ? 1 : MAX_ROWS / G;   // queries per block
    paged_chunk_kernel<T, KV, HD>
        <<<dim3(Hkv, B, (Cs + QB - 1) / QB), THREADS, 0, st>>>(
            static_cast<const T*>(q), static_cast<const KV*>(kp),
            static_cast<const KV*>(vp), static_cast<const float*>(ks),
            static_cast<const float*>(vs), static_cast<const int32_t*>(bt),
            static_cast<float*>(out), Cs, Hkv, G, QB, ps, P, start, kv_len,
            window, softcap, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, typename KV>
int chunk(int hd, const void* q, const void* kp, const void* vp,
          const void* ks, const void* vs, const void* bt, void* out, int B,
          int Cs, int Hkv, int G, int ps, int P, int start, int kv_len,
          int window, float softcap, int warps, void* stream) {
  if (G < 1 || G > MAX_ROWS) return (int)cudaErrorInvalidValue;
  return with_head_dim(hd, [&](auto c) {
    return launch_chunk<T, KV, decltype(c)::value>(
        q, kp, vp, ks, vs, bt, out, B, Cs, Hkv, G, ps, P, start, kv_len,
        window, softcap, warps, (cudaStream_t)stream);
  });
}

}  // namespace

extern "C" {

// K3: q [B, Hq, hd], pages [NP, ps, Hkv, hd], bt int32 [B, P], t int32 [B]
//     -> out fp32 [B, Hq, hd]. The wrapper passes the split
//     (kernels/paged_attn.py:decode_splits: split_pages pages a split,
//     splits * split_pages >= P), a workspace of B * Hkv * splits * G *
//     (hd + 2) floats, and B * Hkv int counters that are 0 and that each
//     launch leaves 0.
int paged_attn_decode_f32(const void* q, const void* kp, const void* vp,
                          const void* bt, const void* t, void* ws,
                          void* counters, void* out, int B, int Hkv, int G,
                          int hd, int ps, int P, int split_pages, int splits,
                          int window, float softcap, void* stream) {
  return decode<float, float>(hd, q, kp, vp, nullptr, nullptr, bt, t, ws,
                              counters, out, B, Hkv, G, ps, P, split_pages,
                              splits, window, softcap, stream);
}

int paged_attn_decode_bf16(const void* q, const void* kp, const void* vp,
                           const void* bt, const void* t, void* ws,
                           void* counters, void* out, int B, int Hkv, int G,
                           int hd, int ps, int P, int split_pages, int splits,
                           int window, float softcap, void* stream) {
  return decode<__nv_bfloat16, __nv_bfloat16>(
      hd, q, kp, vp, nullptr, nullptr, bt, t, ws, counters, out, B, Hkv, G,
      ps, P, split_pages, splits, window, softcap, stream);
}

// K3 on int8 pages: as above, with k_scales / v_scales f32 [NP, Hkv]; q
// fp32 or bf16
int paged_attn_decode_i8_f32(const void* q, const void* kp, const void* vp,
                             const void* ks, const void* vs, const void* bt,
                             const void* t, void* ws, void* counters,
                             void* out, int B, int Hkv, int G, int hd, int ps,
                             int P, int split_pages, int splits, int window,
                             float softcap, void* stream) {
  return decode<float, int8_t>(hd, q, kp, vp, ks, vs, bt, t, ws, counters,
                               out, B, Hkv, G, ps, P, split_pages, splits,
                               window, softcap, stream);
}

int paged_attn_decode_i8_bf16(const void* q, const void* kp, const void* vp,
                              const void* ks, const void* vs, const void* bt,
                              const void* t, void* ws, void* counters,
                              void* out, int B, int Hkv, int G, int hd,
                              int ps, int P, int split_pages, int splits,
                              int window, float softcap, void* stream) {
  return decode<__nv_bfloat16, int8_t>(hd, q, kp, vp, ks, vs, bt, t, ws,
                                       counters, out, B, Hkv, G, ps, P,
                                       split_pages, splits, window, softcap,
                                       stream);
}

// K4: q [B, Cs, Hq, hd], pages, bt as K3, start / kv_len scalars
//     -> out fp32 [B, Cs, Hq, hd]
int paged_attn_chunk_f32(const void* q, const void* kp, const void* vp,
                         const void* bt, void* out, int B, int Cs, int Hkv,
                         int G, int hd, int ps, int P, int start, int kv_len,
                         int window, float softcap, void* stream) {
  return chunk<float, float>(hd, q, kp, vp, nullptr, nullptr, bt, out, B, Cs,
                             Hkv, G, ps, P, start, kv_len, window, softcap, 0,
                             stream);
}

// the bf16 body takes `warps` (1, 2 or 4) per CTA from the wrapper
// (kernels/paged_attn.py:chunk_warps)
int paged_attn_chunk_bf16(const void* q, const void* kp, const void* vp,
                          const void* bt, void* out, int B, int Cs, int Hkv,
                          int G, int hd, int ps, int P, int start, int kv_len,
                          int window, float softcap, int warps, void* stream) {
  return chunk<__nv_bfloat16, __nv_bfloat16>(
      hd, q, kp, vp, nullptr, nullptr, bt, out, B, Cs, Hkv, G, ps, P, start,
      kv_len, window, softcap, warps, stream);
}

// K4 on int8 pages, with k_scales / v_scales f32 [NP, Hkv]: q fp32 (the
// fp32 body) or bf16 (the tensor-core body, `warps` as above)
int paged_attn_chunk_i8_f32(const void* q, const void* kp, const void* vp,
                            const void* ks, const void* vs, const void* bt,
                            void* out, int B, int Cs, int Hkv, int G, int hd,
                            int ps, int P, int start, int kv_len, int window,
                            float softcap, void* stream) {
  return chunk<float, int8_t>(hd, q, kp, vp, ks, vs, bt, out, B, Cs, Hkv, G,
                              ps, P, start, kv_len, window, softcap, 0,
                              stream);
}

int paged_attn_chunk_i8_bf16(const void* q, const void* kp, const void* vp,
                             const void* ks, const void* vs, const void* bt,
                             void* out, int B, int Cs, int Hkv, int G, int hd,
                             int ps, int P, int start, int kv_len, int window,
                             float softcap, int warps, void* stream) {
  return chunk<__nv_bfloat16, int8_t>(hd, q, kp, vp, ks, vs, bt, out, B, Cs,
                                      Hkv, G, ps, P, start, kv_len, window,
                                      softcap, warps, stream);
}

}  // extern "C"
