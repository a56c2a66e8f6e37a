// Criss-cross attention forward for Hopper (sm_90a): K1 cca_fwd_col, K2 cca_fwd_row.
//
// Replaces the TPU kernels of ccnet_tpu/ops/cc_attention_pallas.py:
//   K1 cca_fwd_col  <- _fwd_col_kernel  (column path, self slot at -1e9)
//   K2 cca_fwd_row  <- _fwd_row_kernel  (row path + joint-softmax combine)
// Same decomposition as the Pallas pair: the column kernel writes the
// unnormalised column aggregate o_col = sum_j exp(e_j - m_col) v_j with its
// stats (m_col, l_col); the row kernel computes the row path and combines
//   m = max(m_c, m_r), L = l_c e^{m_c-m} + l_r e^{m_r-m},
//   out = (o_c e^{m_c-m} + o_r e^{m_r-m}) / L,
// which is exactly one softmax over the concatenated H+W axis. The
// (B, H, W, H+W) affinity never reaches device memory.
//
// Layout: q, k (B, H, W, Cq), v (B, H, W, Cv), NHWC contiguous; a "line" is
// one column (K1: H pixels at stride W) or one row (K2: W pixels at stride 1).
// o_col is f32 scratch (B, H, W, Cv); m, l, L are (B, H, W) f32.
//
// What bounds it on the H100. At the sliding-window shape (8, 97, 97, 64/512)
// both paths together do ~17 GFLOP (the p.v aggregation is 7.5 GFLOP per
// path) and move ~0.5 GB (q/k/v read twice, the f32 o_col round trip):
// about 34 FLOP per byte, below the card's bf16 tensor-core balance point,
// so a tensor-core version would be bound by device memory. This first
// version multiplies in f32 on the CUDA cores instead, so it is bound by
// FMA issue, shared-memory reads and latency, not by device memory.
//
// What the design does about it. One block per (line, tile of TQ queries,
// slice of 256 value channels). Keys stream through in tiles of KT = 32 with
// an online softmax (running max and sum per query), so any line length
// works: 97 (sliding tiles), 129 x 257 (whole image), and H = 1 or W = 1.
// Each thread owns one value channel and accumulates TQ outputs in
// registers; its KT value loads for a key tile are issued together, and
// the probabilities are read back from shared memory four at a time. The
// cheap Cq = 64 logits are recomputed by each channel slice (two slices at
// Cv = 512). Tensor cores (wgmma), TMA and padding n = 97 for them are later
// work.
//
// Masking. The column self slot is set to -1e9 like the JAX op, not -inf.
// Keys past the line end are dropped (p = 0). At H = 1 the column path is
// all self slot: m_col = -1e9, l_col = 1, and exp(-1e9 - m) in the combine
// is exactly 0, never NaN.

#include <math_constants.h>

#include "cca_common.cuh"

namespace {

constexpr int TQ = 16;                  // queries of one line per block
constexpr int KT = 32;                  // keys per streamed tile (one per lane)
constexpr int THREADS = 256;            // = value channels per block
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = TQ / NWARPS;
constexpr int MAX_CQ = 128;
constexpr float MASK = -1e9f;           // NEG_INF of ccnet_tpu/ops/cc_attention.py

size_t smem_bytes(int Cq) {
  return sizeof(float) * (size_t(KT) * TQ + 3 * TQ + size_t(TQ + KT) * (Cq + 1));
}

// COL = true is K1 (column path, self-masked, writes o_col/m_col/l_col);
// COL = false is K2 (row path, combines with K1's outputs, writes out/m/L).
template <typename T, bool COL>
__global__ void __launch_bounds__(THREADS)
cca_line_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ o_col_in, const float* __restrict__ m_col_in,
                const float* __restrict__ l_col_in, float* __restrict__ o_col_out,
                T* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                int H, int W, int Cq, int Cv) {
  extern __shared__ __align__(16) float smem[];
  float* s_p = smem;                     // [KT][TQ] probabilities, key-major
  float* s_alpha = s_p + KT * TQ;        // [TQ] rescale of the running sums
  float* s_m = s_alpha + TQ;             // [TQ] final running max
  float* s_l = s_m + TQ;                 // [TQ] final running sum
  float* s_q = s_l + TQ;                 // [TQ][Cq + 1] (padded: no bank conflicts)
  float* s_k = s_q + TQ * (Cq + 1);      // [KT][Cq + 1]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * TQ;
  const int c = blockIdx.z * THREADS + tid;
  const bool has_c = c < Cv;
  const int N = COL ? H : W;
  const int cq1 = Cq + 1;

  // pixel index of line position t is base + t * stride
  long long base, stride;
  if (COL) {
    const int b = blockIdx.x / W, w = blockIdx.x % W;
    base = (long long)b * H * W + w;
    stride = W;
  } else {
    base = (long long)blockIdx.x * W;
    stride = 1;
  }

  for (int e = tid; e < TQ * Cq; e += THREADS) {
    const int i = e / Cq, cc = e - i * Cq, t = q0 + i;
    s_q[i * cq1 + cc] = t < N ? to_f32(q[(base + t * stride) * Cq + cc]) : 0.f;
  }

  float acc[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) acc[i] = 0.f;
  // every lane of a warp carries the same running stats for its rows
  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += KT) {
    for (int e = tid; e < KT * Cq; e += THREADS) {
      const int j = e / Cq, cc = e - j * Cq, t = k0 + j;
      s_k[j * cq1 + cc] = t < N ? to_f32(k[(base + t * stride) * Cq + cc]) : 0.f;
    }
    float vr[KT];  // this thread's value channel for the tile's keys
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int t = k0 + j;
      vr[j] = (has_c && t < N) ? to_f32(v[(base + t * stride) * Cv + c]) : 0.f;
    }
    __syncthreads();

    // logits and online softmax: warp owns rows warp + r*NWARPS, lane = key
    const int t = k0 + lane;
    const bool valid = t < N;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int i = warp + r * NWARPS;
      float s = 0.f;
      for (int cc = 0; cc < Cq; ++cc) s = fmaf(s_q[i * cq1 + cc], s_k[lane * cq1 + cc], s);
      if (COL && t == q0 + i) s = MASK;
      const float m_new = fmaxf(m_run[r], warp_max(valid ? s : -CUDART_INF_F));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
      s_p[lane * TQ + i] = p;
      if (lane == 0) s_alpha[i] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TQ; ++i) acc[i] *= s_alpha[i];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float4* pj = reinterpret_cast<const float4*>(s_p + j * TQ);
#pragma unroll
      for (int i4 = 0; i4 < TQ / 4; ++i4) {
        const float4 p = pj[i4];
        acc[4 * i4 + 0] = fmaf(p.x, vr[j], acc[4 * i4 + 0]);
        acc[4 * i4 + 1] = fmaf(p.y, vr[j], acc[4 * i4 + 1]);
        acc[4 * i4 + 2] = fmaf(p.z, vr[j], acc[4 * i4 + 2]);
        acc[4 * i4 + 3] = fmaf(p.w, vr[j], acc[4 * i4 + 3]);
      }
    }
    __syncthreads();  // s_k, s_p, s_alpha are rewritten by the next tile
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      s_m[warp + r * NWARPS] = m_run[r];
      s_l[warp + r * NWARPS] = l_run[r];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int t = q0 + i;
    if (!has_c || t >= N) continue;
    const long long p = base + t * stride;
    if (COL) {
      o_col_out[p * Cv + c] = acc[i];
    } else {
      const float mc = m_col_in[p], lc = l_col_in[p], mr = s_m[i], lr = s_l[i];
      const float m = fmaxf(mc, mr);
      const float ac = expf(mc - m), ar = expf(mr - m);
      const float L = lc * ac + lr * ar;
      out[p * Cv + c] = from_f32<T>((o_col_in[p * Cv + c] * ac + acc[i] * ar) / L);
    }
  }
  if (blockIdx.z == 0 && tid < TQ && q0 + tid < N) {
    const long long p = base + (long long)(q0 + tid) * stride;
    if (COL) {
      m_out[p] = s_m[tid];
      l_out[p] = s_l[tid];
    } else {
      const float mc = m_col_in[p], lc = l_col_in[p], mr = s_m[tid], lr = s_l[tid];
      const float m = fmaxf(mc, mr);
      m_out[p] = m;
      l_out[p] = lc * expf(mc - m) + lr * expf(mr - m);
    }
  }
}

template <typename T, bool COL>
int launch(const void* q, const void* k, const void* v, const void* o_col_in,
           const void* m_col_in, const void* l_col_in, void* o_col_out, void* out, void* m_out,
           void* l_out, int B, int H, int W, int Cq, int Cv, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || Cq < 1 || Cq > MAX_CQ || Cv < 1) return (int)cudaErrorInvalidValue;
  const int lines = COL ? B * W : B * H;
  const int n = COL ? H : W;
  const dim3 grid(lines, (n + TQ - 1) / TQ, (Cv + THREADS - 1) / THREADS);
  cca_line_kernel<T, COL><<<grid, THREADS, smem_bytes(Cq), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(o_col_in), static_cast<const float*>(m_col_in),
      static_cast<const float*>(l_col_in), static_cast<float*>(o_col_out),
      static_cast<T*>(out), static_cast<float*>(m_out), static_cast<float*>(l_out), H, W, Cq, Cv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. is_bf16 selects bf16 q/k/v (else f32). Returns cudaGetLastError().
int cca_fwd_col(const void* q, const void* k, const void* v, void* o_col, void* m_col,
                void* l_col, int B, int H, int W, int Cq, int Cv, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(q, k, v, nullptr, nullptr, nullptr, o_col, nullptr,
                                       m_col, l_col, B, H, W, Cq, Cv, st);
  return launch<float, true>(q, k, v, nullptr, nullptr, nullptr, o_col, nullptr, m_col, l_col,
                             B, H, W, Cq, Cv, st);
}

// K2. out has q/k/v's dtype; m and L are f32. Returns cudaGetLastError().
int cca_fwd_row(const void* q, const void* k, const void* v, const void* o_col,
                const void* m_col, const void* l_col, void* out, void* m, void* L, int B, int H,
                int W, int Cq, int Cv, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(q, k, v, o_col, m_col, l_col, nullptr, out, m, L, B, H,
                                        W, Cq, Cv, st);
  return launch<float, false>(q, k, v, o_col, m_col, l_col, nullptr, out, m, L, B, H, W, Cq, Cv,
                              st);
}

}  // extern "C"
