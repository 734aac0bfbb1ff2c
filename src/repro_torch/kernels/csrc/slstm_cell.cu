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
// steps, and how fast each step reads r. The TPU kernel keeps all of r
// (4 * H * hd * hd) in VMEM across the scan; at xlstm-1.3b's width one
// head's r alone is 4 * 512 * 512 bf16 = 2 MiB, against 227 KB of shared
// memory per SM. The heads are independent (r is block-diagonal), so each
// head gets its own thread-block cluster (`slstm_cluster_kernel`), which
// holds all B batch rows, so each element of r read from shared memory
// serves B rows per step:
//   - CTA c of a cluster of CL owns the units [c hd / CL, (c + 1) hd / CL)
//     (hd need not divide evenly) and keeps their four gate rows of r
//     (4 hd / CL rows x hd, rows padded to 16 bytes) in its shared memory,
//     loaded once before step 0; at full width (hd 512, bf16 r) CL = 16,
//     128 KB of r a CTA, 64 CTAs.
//   - Each step, rec = r_slice . h_prev for the CTA's rows and all B rows:
//     a warp takes 8 rows at a time, a lane 16-byte pieces of the columns
//     with h_prev of those columns for 4 batch rows in registers, fp32
//     FMAs (bf16 r widens exactly; h is never rounded), and the 32 sums
//     (8 rows x 4 batch rows) reduce across the lanes in one butterfly
//     that leaves one finished sum on each lane (31 shuffles).
//   - The owner of each (batch row, unit) cell runs the cell update with
//     c, n and m in registers, writes h_t, and pushes it into every CTA's
//     h buffer through distributed shared memory; the buffer is
//     double-buffered by step parity, so one cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire) closes each step.
//     u_{t+1} is loaded into registers during step t, behind its
//     products.
// kernels/slstm_cell.py:slstm_cluster picks CL from the shapes: the
// smallest power of two <= 16 whose r slice and h buffers fit a CTA's
// shared memory, or none; a shape with none (fp32 r at hd 512 needs 256 KB
// a CTA even at CL = 16) keeps the per-(head, batch row) body
// `slstm_seq_kernel`. That body keeps the state in registers (the thread
// that owns unit i holds c, n, m) and h_prev in shared memory, and per
// step runs the GEMV over the head's 4 * hd rows of r, read from global
// memory where L2 holds them: a warp per row (4 rows a pass, all their
// loads issued before the first product), lanes along j with 16-byte
// loads, a shuffle reduction; then the owner of unit i runs the cell
// update, writes h_t, and a barrier closes the step. At B = 4, H = 4 it
// runs 16 blocks, each re-reading 2 MiB from L2 per step.
//
// C interface: each entry point launches on the given stream and returns
// the launch's error as an int (0 = launched); hd outside 1..512, or a
// cluster size the shapes do not fit, returns cudaErrorInvalidValue
// without launching. `slstm_cluster_capacity_*` reports how many clusters
// of a size can be resident at once (cudaOccupancyMaxActiveClusters).

#include <cooperative_groups.h>
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

// ------------------------------------------------------- the cluster body

constexpr int CL_THREADS = 256;     // 8 warps
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int CL_ROWS = 8;          // rows of r a warp sums together
constexpr int CL_BATCH = 4;         // batch rows a pass: 8 x 4 = 32 sums
constexpr int CL_CELLS = 4;         // (batch row, unit) cells a thread holds
constexpr int CL_MAX = 16;          // CTAs a cluster (non-portable above 8)
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a CTA may use

// a row of r or h in shared memory: hd rounded up to 16 bytes of r
__host__ __device__ constexpr int cl_ld(int hd, int r_bytes) {
  return (hd + 16 / r_bytes - 1) / (16 / r_bytes) * (16 / r_bytes);
}

// the r slice [4 ceil(hd / CL)][ld], h [2][B][ld] and rec [B][4 ceil(hd /
// CL)], fp32; kernels/slstm_cell.py:slstm_cluster_smem
__host__ __device__ constexpr int cl_smem(int B, int hd, int r_bytes,
                                          int CL) {
  return 4 * ((hd + CL - 1) / CL) * cl_ld(hd, r_bytes) * r_bytes +
         2 * B * cl_ld(hd, r_bytes) * 4 + 4 * ((hd + CL - 1) / CL) * B * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();        // the .aligned barrier wants whole, converged warps
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 32 partial sums a lane -> lane l holds the warp's total of sum l: at
// step N (16, 8, .., 1) keep the half of the 2N sums left that this lane's
// bit N selects, adding the partner lane's copy of it (31 shuffles)
template <int N>
__device__ __forceinline__ void butterfly(float (&a)[32], int lane) {
  const bool upper = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? a[i] : a[i + N];
    const float keep = upper ? a[i + N] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
  if constexpr (N > 1) butterfly<N / 2>(a, lane);
}

// One cluster per head (blockIdx.y), CTA rank c of CL along x; see the
// header.
template <typename TU, typename TR>
__global__ void __launch_bounds__(CL_THREADS, 1)
slstm_cluster_kernel(const TU* __restrict__ u, const TR* __restrict__ r,
                     TU* __restrict__ out, int B, int S, int H, int hd,
                     int CL) {
  constexpr int V = 16 / sizeof(TR);         // r elements per 16 bytes
  constexpr int NCH = MAX_HD / (32 * V);     // 16-byte pieces a lane, at most
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = blockIdx.x, head = blockIdx.y;   // cluster (CL, 1, 1)
  const int lo = rank * hd / CL, U = (rank + 1) * hd / CL - lo;
  const int rows = 4 * U, umax = (hd + CL - 1) / CL;
  const int ld = cl_ld(hd, sizeof(TR));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long D = (long)H * hd;               // one gate's width in u
  extern __shared__ __align__(16) unsigned char dsmem[];
  TR* r_s = reinterpret_cast<TR*>(dsmem);                      // [4 umax][ld]
  float* h_s = reinterpret_cast<float*>(r_s + 4 * umax * ld);  // [2][B][ld]
  float* rec_s = h_s + 2 * B * ld;                             // [B][4 umax]

  // r slice: row g U + i holds r[g, head, lo + i, :]; pad columns are 0
  if (hd * (int)sizeof(TR) % 16 == 0) {
    const int cpr = hd / V;
    for (int c = tid; c < rows * cpr; c += CL_THREADS) {
      const int row = c / cpr, cc = (c % cpr) * V;
      const int g = row / U, i = row % U;
      cp_async16(r_s + (long)row * ld + cc,
                 r + (((long)g * H + head) * hd + lo + i) * hd + cc);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int c = tid; c < rows * ld; c += CL_THREADS) {
      const int row = c / ld, j = c % ld, g = row / U, i = row % U;
      r_s[(long)row * ld + j] =
          j < hd ? r[(((long)g * H + head) * hd + lo + i) * hd + j]
                 : from_float<TR>(0.f);
    }
  }
  for (int i = tid; i < 2 * B * ld; i += CL_THREADS) h_s[i] = 0.f;

  // cells: ci = tid + k * CL_THREADS is (batch row ci / U, unit lo + ci % U)
  const int ncell = B * U;
  float c[CL_CELLS], n[CL_CELLS], m[CL_CELLS], gin[CL_CELLS][4];
  auto load_u = [&](int t) {
#pragma unroll
    for (int k = 0; k < CL_CELLS; ++k) {
      const int ci = tid + k * CL_THREADS;
      if (ci < ncell) {
        const TU* ut = u + ((long)(ci / U) * S + t) * 4 * D + (long)head * hd +
                       lo + ci % U;
#pragma unroll
        for (int g = 0; g < 4; ++g) gin[k][g] = to_float(ut[g * D]);
      }
    }
  };
#pragma unroll
  for (int k = 0; k < CL_CELLS; ++k) c[k] = n[k] = m[k] = 0.f;
  load_u(0);
  asm volatile("cp.async.wait_group 0;\n" ::);
  cluster_barrier();   // every CTA running, its r slice and h buffers set

  for (int t = 0; t < S; ++t) {
    const float* hp = h_s + (t & 1) * B * ld;
    for (int b0 = 0; b0 < B; b0 += CL_BATCH) {
      // h_prev of this lane's columns for batch rows b0 .. b0 + 3
      float hreg[NCH * V][CL_BATCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int j = (k * 32 + lane) * V;
#pragma unroll
        for (int bb = 0; bb < CL_BATCH; ++bb) {
          const bool ok = j < hd && b0 + bb < B;
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            const float4 x = ok ? *reinterpret_cast<const float4*>(
                                      hp + (long)(b0 + bb) * ld + j + e)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            hreg[k * V + e][bb] = x.x;
            hreg[k * V + e + 1][bb] = x.y;
            hreg[k * V + e + 2][bb] = x.z;
            hreg[k * V + e + 3][bb] = x.w;
          }
        }
      }
      for (int p0 = warp * CL_ROWS; p0 < rows; p0 += CL_WARPS * CL_ROWS) {
        float acc[CL_ROWS * CL_BATCH];
#pragma unroll
        for (int i = 0; i < CL_ROWS * CL_BATCH; ++i) acc[i] = 0.f;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const int j = (k * 32 + lane) * V;
          if (j < hd) {
            uint4 raw[CL_ROWS];
#pragma unroll
            for (int q = 0; q < CL_ROWS; ++q)
              raw[q] = p0 + q < rows ? *reinterpret_cast<const uint4*>(
                                           r_s + (long)(p0 + q) * ld + j)
                                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int q = 0; q < CL_ROWS; ++q) {
              float w[V];
              widen<TR, V>(raw[q], w);
#pragma unroll
              for (int e = 0; e < V; ++e)
#pragma unroll
                for (int bb = 0; bb < CL_BATCH; ++bb)
                  acc[q * CL_BATCH + bb] =
                      fmaf(w[e], hreg[k * V + e][bb], acc[q * CL_BATCH + bb]);
            }
          }
        }
        butterfly<16>(acc, lane);
        const float sum = acc[0];
        const int row = p0 + lane / CL_BATCH, b = b0 + lane % CL_BATCH;
        if (row < rows && b < B) rec_s[b * 4 * umax + row] = sum;
      }
    }
    __syncthreads();

    float* hn = h_s + ((t + 1) & 1) * B * ld;
#pragma unroll
    for (int k = 0; k < CL_CELLS; ++k) {
      const int ci = tid + k * CL_THREADS;
      if (ci < ncell) {
        const int b = ci / U, i = ci % U;
        const float* rec = rec_s + b * 4 * umax;
        const float li = gin[k][0] + rec[i];
        float lf = gin[k][1] + rec[U + i];
        const float z = gin[k][2] + rec[2 * U + i];
        const float o = gin[k][3] + rec[3 * U + i];
        lf = fminf(lf, 0.f) - log1pf(expf(-fabsf(lf)));
        const float m_new = fmaxf(lf + m[k], li);
        const float fi = expf(lf + m[k] - m_new);
        const float ii = expf(li - m_new);
        c[k] = fi * c[k] + ii * tanhf(z);
        n[k] = fi * n[k] + ii;
        const float h = (1.f / (1.f + expf(-o))) * c[k] / fmaxf(n[k], 1e-6f);
        m[k] = m_new;
        out[((long)b * S + t) * D + (long)head * hd + lo + i] =
            from_float<TU>(h);
        float* dst = hn + (long)b * ld + lo + i;
        for (int q = 0; q < CL; ++q) *cluster.map_shared_rank(dst, q) = h;
      }
    }
    if (t + 1 < S) load_u(t + 1);
    cluster_barrier();   // h_t in every CTA; rec_s and h_s[t & 1] free
  }
}

// The cluster kernel's attributes, set once: non-portable cluster sizes
// (16) and all of a CTA's dynamic shared memory
template <typename TU, typename TR>
cudaError_t cluster_attrs() {
  const auto k = slstm_cluster_kernel<TU, TR>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_MAX);
}

// Launch the cluster body (capacity == nullptr), or report in *capacity
// how many of its clusters can be resident at once.
template <typename TU, typename TR>
int launch_cluster(const void* u, const void* r, void* out, int B, int S,
                   int H, int hd, int CL, cudaStream_t stream,
                   int* capacity) {
  const int smem = cl_smem(B, hd, sizeof(TR), CL);
  if (CL < 1 || CL > CL_MAX || (CL & (CL - 1)) || smem > SMEM_MAX ||
      B * ((hd + CL - 1) / CL) > CL_THREADS * CL_CELLS) {
    return (int)cudaErrorInvalidValue;
  }
  static const cudaError_t attr = cluster_attrs<TU, TR>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, H);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (capacity != nullptr) {
    return (int)cudaOccupancyMaxActiveClusters(
        capacity, slstm_cluster_kernel<TU, TR>, &cfg);
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, slstm_cluster_kernel<TU, TR>, static_cast<const TU*>(u),
      static_cast<const TR*>(r), static_cast<TU*>(out), B, S, H, hd, CL);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TU, typename TR>
int launch(const void* u, const void* r, void* out, int B, int S, int H,
           int hd, int CL, cudaStream_t stream) {
  if (hd < 1 || hd > MAX_HD || H < 1 || B < 1 || S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (CL > 0) {
    return launch_cluster<TU, TR>(u, r, out, B, S, H, hd, CL, stream,
                                  nullptr);
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

// slstm_seq_<u>_<r>: CL = 0 runs the per-(head, batch row) body, CL > 0 the
// cluster body with CL CTAs a head (kernels/slstm_cell.py:slstm_cluster).
#define SLSTM_ENTRY(DU, DR, TU, TR)                                          \
  extern "C" int slstm_seq_##DU##_##DR(const void* u, const void* r,         \
                                        void* out, int B, int S, int H,      \
                                        int hd, int CL, void* stream) {      \
    return launch<TU, TR>(u, r, out, B, S, H, hd, CL,                        \
                          static_cast<cudaStream_t>(stream));                \
  }                                                                          \
  extern "C" int slstm_cluster_capacity_##DU##_##DR(int B, int hd, int CL) { \
    int n = 0;                                                               \
    const int e = launch_cluster<TU, TR>(nullptr, nullptr, nullptr, B, 1, 1, \
                                         hd, CL, nullptr, &n);               \
    return e != 0 ? -e : n;                                                  \
  }

SLSTM_ENTRY(f32, f32, float, float)
SLSTM_ENTRY(f32, bf16, float, __nv_bfloat16)
SLSTM_ENTRY(bf16, f32, __nv_bfloat16, float)
SLSTM_ENTRY(bf16, bf16, __nv_bfloat16, __nv_bfloat16)
