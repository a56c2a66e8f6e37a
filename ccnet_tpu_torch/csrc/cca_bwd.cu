// Criss-cross attention backward for Hopper (sm_90a): K3 cca_bwd_col, K4 cca_bwd_row.
//
// Replaces the TPU kernels of ccnet_tpu/ops/cc_attention_pallas.py:
//   K3 cca_bwd_col  <- _bwd_col_kernel  (column path, self slot masked)
//   K4 cca_bwd_row  <- _bwd_row_kernel  (row path, adds K3's grads in-kernel)
// For one path, with the joint softmax stats (m, L) of the forward and
// delta = sum_c out * g computed by the caller:
//   p_ij  = exp(q_i.k_j - m_i) / L_i        (0 on the column self slot)
//   dp_ij = g_i . v_j,   de_ij = p_ij (dp_ij - delta_i)
//   dq_i = sum_j de_ij k_j,   dk_j = sum_i de_ij q_i,   dv_j = sum_i p_ij g_i
// i and j run over one line: a column (H pixels at stride W) for K3, a row
// (W pixels at stride 1) for K4. q, k (B, H, W, Cq) and v, g (B, H, W, Cv)
// are NHWC contiguous in one dtype (f32 or bf16); m, L, delta are
// (B, H, W) f32. K3 writes f32 column grads; K4 adds them to the row grads
// and writes dq, dk, dv in the input dtype, so each final grad is written
// once, as _bwd_row_kernel does.
//
// Each wrapper call launches two kernels, split as FlashAttention-2's
// backward splits (no atomics, deterministic):
//   1. query-major (cca_bwd_query_kernel): one block per (line, 16 queries).
//      It streams the line's keys in chunks of 32, recomputes e and p,
//      forms dp (the dot over all Cv) and de, accumulates dq, and writes p
//      and de of the line to f32 scratch P, DE of shape (lines, N, N).
//   2. key-major (cca_bwd_key_kernel): one block per (line, 32 keys, 256
//      value channels). It streams the line's queries in chunks of 32,
//      reads p and de back, and accumulates dv (one value channel per
//      thread) and, in the first channel slice, dk.
// The scratch is the per-path affinity, B*H*W*N floats each for P and DE
// (counted from the shapes: 58 MB for both paths at 8 x 97 x 97): storing
// it spends that much memory traffic to skip a second dp = g.v^T product,
// the largest term.
//
// What bounds it on the H100. At the training shape (8, 97, 97, 64/512)
// one path needs ~18 GFLOP (dp and dv are 7.5 GFLOP each) and moves
// ~0.1 GB, both counted from the shapes, so on tensor cores it would be
// memory-bound; this first version
// multiplies in f32 on the CUDA cores and is bound by FMA issue and
// shared-memory reads. The dp product is register-tiled (2 queries x 1 key
// per thread, float4 reads along the channels from padded rows so that a
// warp's reads do not conflict); g rows stay in shared memory for the
// block's 16 queries while v streams through in 128-channel slices, which
// keeps the block at ~64 KB of shared memory at Cv = 512 (three blocks per
// SM; query_smem_floats gives the exact size).
// Tensor cores (wgmma) and TMA are later work.
//
// Any line length works (queries and keys are both streamed): 97 in
// training, 129 x 257 for the whole image, H = 1 (the column path is all
// self slot: p = 0, every column grad is 0) and W = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int QT = 2 * NWARPS;  // queries per query-major block (2 per warp)
constexpr int KT = 32;          // keys per chunk of the query-major pass (1 per lane)
constexpr int VC = 128;         // value channels per streamed v slice
constexpr int KB = 32;          // keys per key-major block
constexpr int QC = 32;          // queries per chunk of the key-major pass
constexpr int MAX_CQ = 128;
constexpr int DQ_PER_THREAD = QT * MAX_CQ / THREADS;  // 8
constexpr int DK_PER_THREAD = KB * MAX_CQ / THREADS;  // 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row stride (floats) of a shared tile whose rows hold `c4` (a multiple of
// 4) values and are read as float4 by the lanes of a warp, one row per lane:
// stride / 4 odd puts 8 consecutive rows in 8 distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int padded_stride(int c4) {
  return 4 * ((c4 / 4) | 1);
}

__host__ __device__ __forceinline__ int round4(int c) { return (c + 3) & ~3; }

// Pixel index of position t of line `line` is base + t * step.
__device__ __forceinline__ void line_geometry(bool col, int line, int H, int W,
                                              long long& base, long long& step) {
  if (col) {
    const int b = line / W, w = line - b * W;
    base = (long long)b * H * W + w;
    step = W;
  } else {
    base = (long long)line * W;
    step = 1;
  }
}

size_t query_smem_floats(int Cq, int Cv) {
  const int sq = padded_stride(round4(Cq)), sg = padded_stride(round4(Cv));
  const int sv = padded_stride(VC);
  return size_t(QT) * sq + size_t(QT) * sg + size_t(KT) * sq + size_t(KT) * sv +
         size_t(QT) * (KT + 1) + 4 * QT;
}

size_t key_smem_floats(int Cq) {
  return size_t(QC) * KB * 2 + size_t(QC) * Cq;
}

// Query-major pass of one path: dq, and the path's p and de into scratch.
// Replaces the dq half of _bwd_col_kernel (COL) / _bwd_row_kernel (!COL).
// Bound by FMA issue and shared-memory reads of the dp = g.v^T product;
// see the file comment for the tiling.
template <typename T, bool COL>
__global__ void __launch_bounds__(THREADS)
cca_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ m_in,
                     const float* __restrict__ L_in, const float* __restrict__ d_in,
                     float* __restrict__ P, float* __restrict__ DE,
                     const float* __restrict__ dq_col, float* __restrict__ dq_f32,
                     T* __restrict__ dq_out, int H, int W, int Cq, int Cv) {
  extern __shared__ __align__(16) float smem[];
  const int cq4 = round4(Cq), cv4 = round4(Cv);
  const int sq = padded_stride(cq4), sg = padded_stride(cv4), sv = padded_stride(VC);
  float* s_q = smem;                   // [QT][sq]
  float* s_g = s_q + QT * sq;          // [QT][sg]
  float* s_k = s_g + QT * sg;          // [KT][sq]
  float* s_v = s_k + KT * sq;          // [KT][sv], one VC-channel slice
  float* s_de = s_v + KT * sv;         // [QT][KT + 1]
  float* s_m = s_de + QT * (KT + 1);   // [QT]
  float* s_L = s_m + QT;
  float* s_d = s_L + QT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int line = blockIdx.x;
  const int i0 = blockIdx.y * QT;
  const int N = COL ? H : W;
  long long base, step;
  line_geometry(COL, line, H, W, base, step);

  for (int e = tid; e < QT * cq4; e += THREADS) {
    const int i = e / cq4, c = e - i * cq4, t = i0 + i;
    s_q[i * sq + c] = (t < N && c < Cq) ? to_f32(q[(base + t * step) * Cq + c]) : 0.f;
  }
  for (int e = tid; e < QT * cv4; e += THREADS) {
    const int i = e / cv4, c = e - i * cv4, t = i0 + i;
    s_g[i * sg + c] = (t < N && c < Cv) ? to_f32(g[(base + t * step) * Cv + c]) : 0.f;
  }
  if (tid < QT) {
    const int t = i0 + tid;
    const bool ok = t < N;
    const long long p = base + (long long)t * step;
    s_m[tid] = ok ? m_in[p] : 0.f;
    s_L[tid] = ok ? L_in[p] : 1.f;
    s_d[tid] = ok ? d_in[p] : 0.f;
  }

  float acc[DQ_PER_THREAD];
#pragma unroll
  for (int r = 0; r < DQ_PER_THREAD; ++r) acc[r] = 0.f;

  const int ia = warp, ib = warp + NWARPS;  // this thread's two query rows
  const int ta = i0 + ia, tb = i0 + ib;
  for (int k0 = 0; k0 < N; k0 += KT) {
    __syncthreads();  // the previous chunk's readers of s_k and s_de are done
    for (int e = tid; e < KT * cq4; e += THREADS) {
      const int j = e / cq4, c = e - j * cq4, t = k0 + j;
      s_k[j * sq + c] = (t < N && c < Cq) ? to_f32(k[(base + t * step) * Cq + c]) : 0.f;
    }
    __syncthreads();

    // logits of (ia, lane) and (ib, lane), in the forward kernels' order
    const float4* kj = reinterpret_cast<const float4*>(s_k + lane * sq);
    const float4* qa = reinterpret_cast<const float4*>(s_q + ia * sq);
    const float4* qb = reinterpret_cast<const float4*>(s_q + ib * sq);
    float ea = 0.f, eb = 0.f;
    for (int c4 = 0; c4 < cq4 / 4; ++c4) {
      const float4 kk = kj[c4], a = qa[c4], b = qb[c4];
      ea = fmaf(a.x, kk.x, ea); ea = fmaf(a.y, kk.y, ea);
      ea = fmaf(a.z, kk.z, ea); ea = fmaf(a.w, kk.w, ea);
      eb = fmaf(b.x, kk.x, eb); eb = fmaf(b.y, kk.y, eb);
      eb = fmaf(b.z, kk.z, eb); eb = fmaf(b.w, kk.w, eb);
    }

    // dp = g . v over all Cv, v streamed in VC-channel slices
    float dpa = 0.f, dpb = 0.f;
    for (int c0 = 0; c0 < cv4; c0 += VC) {
      const int nc = min(VC, cv4 - c0);
      __syncthreads();  // the previous slice's readers are done
      for (int e = tid; e < KT * nc; e += THREADS) {
        const int j = e / nc, c = e - j * nc, t = k0 + j;
        s_v[j * sv + c] =
            (t < N && c0 + c < Cv) ? to_f32(v[(base + t * step) * Cv + c0 + c]) : 0.f;
      }
      __syncthreads();
      const float4* vj = reinterpret_cast<const float4*>(s_v + lane * sv);
      const float4* ga = reinterpret_cast<const float4*>(s_g + ia * sg + c0);
      const float4* gb = reinterpret_cast<const float4*>(s_g + ib * sg + c0);
      for (int c4 = 0; c4 < nc / 4; ++c4) {
        const float4 vv = vj[c4], a = ga[c4], b = gb[c4];
        dpa = fmaf(a.x, vv.x, dpa); dpa = fmaf(a.y, vv.y, dpa);
        dpa = fmaf(a.z, vv.z, dpa); dpa = fmaf(a.w, vv.w, dpa);
        dpb = fmaf(b.x, vv.x, dpb); dpb = fmaf(b.y, vv.y, dpb);
        dpb = fmaf(b.z, vv.z, dpb); dpb = fmaf(b.w, vv.w, dpb);
      }
    }

    const int tj = k0 + lane;
    const bool key_ok = tj < N;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int ii = s ? ib : ia, ti = s ? tb : ta;
      const float e = s ? eb : ea, dp = s ? dpb : dpa;
      const bool ok = key_ok && ti < N && !(COL && tj == ti);
      const float p = ok ? expf(e - s_m[ii]) / s_L[ii] : 0.f;
      const float de = p * (dp - s_d[ii]);
      if (key_ok && ti < N) {
        const size_t idx = ((size_t)line * N + ti) * N + tj;
        P[idx] = p;
        DE[idx] = de;
      }
      s_de[ii * (KT + 1) + lane] = de;
    }
    __syncthreads();

    // dq[i][c] += sum_j de[i][j] k[j][c]
#pragma unroll
    for (int r = 0; r < DQ_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      if (e < QT * Cq) {
        const int i = e / Cq, c = e - i * Cq;
        float a = acc[r];
        for (int j = 0; j < KT; ++j) a = fmaf(s_de[i * (KT + 1) + j], s_k[j * sq + c], a);
        acc[r] = a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < DQ_PER_THREAD; ++r) {
    const int e = tid + r * THREADS;
    if (e < QT * Cq) {
      const int i = e / Cq, c = e - i * Cq, t = i0 + i;
      if (t < N) {
        const long long o = (base + (long long)t * step) * Cq + c;
        if (COL) dq_f32[o] = acc[r];
        else dq_out[o] = from_f32<T>(acc[r] + dq_col[o]);
      }
    }
  }
}

// Key-major pass of one path: dv (one value channel per thread) and, in the
// first channel slice, dk, from the p and de the query-major pass wrote.
// Replaces the dk/dv half of _bwd_col_kernel (COL) / _bwd_row_kernel (!COL).
// Bound by FMA issue (dv = p^T g is the 7.5 GFLOP term at the training
// shape); p is read from shared memory as float4 broadcasts, g straight
// from device memory into registers, coalesced across the channel threads.
template <typename T, bool COL>
__global__ void __launch_bounds__(THREADS)
cca_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ g,
                   const float* __restrict__ P, const float* __restrict__ DE,
                   const float* __restrict__ dk_col, const float* __restrict__ dv_col,
                   float* __restrict__ dk_f32, float* __restrict__ dv_f32,
                   T* __restrict__ dk_out, T* __restrict__ dv_out,
                   int H, int W, int Cq, int Cv) {
  extern __shared__ __align__(16) float smem[];
  float* s_p = smem;               // [QC][KB]
  float* s_de = s_p + QC * KB;     // [QC][KB]
  float* s_q = s_de + QC * KB;     // [QC][Cq]

  const int tid = threadIdx.x;
  const int line = blockIdx.x;
  const int j0 = blockIdx.y * KB;
  const int c = blockIdx.z * THREADS + tid;
  const bool has_c = c < Cv;
  const bool do_dk = blockIdx.z == 0;
  const int N = COL ? H : W;
  long long base, step;
  line_geometry(COL, line, H, W, base, step);

  float dv[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) dv[j] = 0.f;
  float dk[DK_PER_THREAD];
#pragma unroll
  for (int r = 0; r < DK_PER_THREAD; ++r) dk[r] = 0.f;

  for (int i0 = 0; i0 < N; i0 += QC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < QC * KB; e += THREADS) {
      const int i = e / KB, j = e - i * KB, ti = i0 + i, tj = j0 + j;
      const bool ok = ti < N && tj < N;
      const size_t idx = ((size_t)line * N + ti) * N + tj;
      s_p[e] = ok ? P[idx] : 0.f;
      s_de[e] = ok ? DE[idx] : 0.f;
    }
    if (do_dk) {
      for (int e = tid; e < QC * Cq; e += THREADS) {
        const int i = e / Cq, cc = e - i * Cq, t = i0 + i;
        s_q[e] = t < N ? to_f32(q[(base + t * step) * Cq + cc]) : 0.f;
      }
    }
    float gr[QC];
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      const int t = i0 + i;
      gr[i] = (has_c && t < N) ? to_f32(g[(base + t * step) * Cv + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < QC; ++i) {
      const float4* pi = reinterpret_cast<const float4*>(s_p + i * KB);
#pragma unroll
      for (int j4 = 0; j4 < KB / 4; ++j4) {
        const float4 p = pi[j4];
        dv[4 * j4 + 0] = fmaf(p.x, gr[i], dv[4 * j4 + 0]);
        dv[4 * j4 + 1] = fmaf(p.y, gr[i], dv[4 * j4 + 1]);
        dv[4 * j4 + 2] = fmaf(p.z, gr[i], dv[4 * j4 + 2]);
        dv[4 * j4 + 3] = fmaf(p.w, gr[i], dv[4 * j4 + 3]);
      }
    }
    if (do_dk) {
#pragma unroll
      for (int r = 0; r < DK_PER_THREAD; ++r) {
        const int e = tid + r * THREADS;
        if (e < KB * Cq) {
          const int j = e / Cq, cc = e - j * Cq;
          float a = dk[r];
          for (int i = 0; i < QC; ++i) a = fmaf(s_de[i * KB + j], s_q[i * Cq + cc], a);
          dk[r] = a;
        }
      }
    }
  }

  if (has_c) {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int t = j0 + j;
      if (t < N) {
        const long long o = (base + (long long)t * step) * Cv + c;
        if (COL) dv_f32[o] = dv[j];
        else dv_out[o] = from_f32<T>(dv[j] + dv_col[o]);
      }
    }
  }
  if (do_dk) {
#pragma unroll
    for (int r = 0; r < DK_PER_THREAD; ++r) {
      const int e = tid + r * THREADS;
      if (e < KB * Cq) {
        const int j = e / Cq, cc = e - j * Cq, t = j0 + j;
        if (t < N) {
          const long long o = (base + (long long)t * step) * Cq + cc;
          if (COL) dk_f32[o] = dk[r];
          else dk_out[o] = from_f32<T>(dk[r] + dk_col[o]);
        }
      }
    }
  }
}

template <typename T, bool COL>
int launch(const void* q, const void* k, const void* v, const void* g, const void* m,
           const void* L, const void* delta, void* P, void* DE, const void* dq_col,
           const void* dk_col, const void* dv_col, void* dq, void* dk, void* dv, int B, int H,
           int W, int Cq, int Cv, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || Cq < 1 || Cq > MAX_CQ || Cv < 1) return (int)cudaErrorInvalidValue;
  const int lines = COL ? B * W : B * H;
  const int n = COL ? H : W;
  const size_t smem_q = sizeof(float) * query_smem_floats(Cq, Cv);
  const size_t smem_k = sizeof(float) * key_smem_floats(Cq);
  cudaError_t err = cudaFuncSetAttribute(cca_bwd_query_kernel<T, COL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(lines, (n + QT - 1) / QT);
  cca_bwd_query_kernel<T, COL><<<grid_q, THREADS, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(m), static_cast<const float*>(L),
      static_cast<const float*>(delta), static_cast<float*>(P), static_cast<float*>(DE),
      static_cast<const float*>(dq_col), static_cast<float*>(dq), static_cast<T*>(dq), H, W, Cq,
      Cv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k(lines, (n + KB - 1) / KB, (Cv + THREADS - 1) / THREADS);
  cca_bwd_key_kernel<T, COL><<<grid_k, THREADS, smem_k, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), static_cast<const float*>(P),
      static_cast<const float*>(DE), static_cast<const float*>(dk_col),
      static_cast<const float*>(dv_col), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<T*>(dk), static_cast<T*>(dv), H, W, Cq, Cv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the query-major kernel needs (the wrapper
// checks it against the card's limit before launching).
long long cca_bwd_query_smem_bytes(int Cq, int Cv) {
  return (long long)(sizeof(float) * query_smem_floats(Cq, Cv));
}

// K3. Column-path grads as f32 (B, H, W, C) scratch. P and DE are f32
// scratch of B*W*H*H floats each. Returns cudaGetLastError().
int cca_bwd_col(const void* q, const void* k, const void* v, const void* g, const void* m,
                const void* L, const void* delta, void* P, void* DE, void* dq_c, void* dk_c,
                void* dv_c, int B, int H, int W, int Cq, int Cv, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(q, k, v, g, m, L, delta, P, DE, nullptr, nullptr,
                                       nullptr, dq_c, dk_c, dv_c, B, H, W, Cq, Cv, st);
  return launch<float, true>(q, k, v, g, m, L, delta, P, DE, nullptr, nullptr, nullptr, dq_c,
                             dk_c, dv_c, B, H, W, Cq, Cv, st);
}

// K4. Row-path grads plus K3's column grads, written in the input dtype.
// P and DE are f32 scratch of B*H*W*W floats each. Returns cudaGetLastError().
int cca_bwd_row(const void* q, const void* k, const void* v, const void* g, const void* m,
                const void* L, const void* delta, void* P, void* DE, const void* dq_c,
                const void* dk_c, const void* dv_c, void* dq, void* dk, void* dv, int B, int H,
                int W, int Cq, int Cv, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(q, k, v, g, m, L, delta, P, DE, dq_c, dk_c, dv_c, dq,
                                        dk, dv, B, H, W, Cq, Cv, st);
  return launch<float, false>(q, k, v, g, m, L, delta, P, DE, dq_c, dk_c, dv_c, dq, dk, dv, B,
                              H, W, Cq, Cv, st);
}

}  // extern "C"
