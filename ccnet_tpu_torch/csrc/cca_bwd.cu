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
// (B, H, W) f32. K3 writes the column grads in the input dtype, as
// _bwd_natural does; K4 adds them to the row grads and writes the final
// dq, dk, dv in the input dtype, so each grad is written once per kernel.
//
// Two designs, chosen by the wrapper from the dtype and the line length:
//
// 1. Tensor cores, one block per line (cca_bwd_tc_kernel): bf16 lines of
//    N <= 128, which at the model's widths are every call
//    CrissCrossAttentionFn sends here (the JAX package's route leaves K3/K4
//    past H = 99 or W = 106). It computes what the TPU kernels compute
//    under the JAX package's default precision: bf16 operands, f32 sums, p
//    and de rounded to bf16 before the products that consume them, de from
//    the f32 p. The block holds a whole line, padded to N_p = 16
//    ceil(N / 16) with zeros, and has N_p / 16 warps; warp w owns queries
//    (and keys) 16w .. 16w + 15. All five products run on mma.sync
//    m16n8k16 (mma_bf16.cuh):
//      A. stage q, k (N_p x Cq, bf16); s = q.k^T per warp; p -> shared (bf16);
//      B. stream g and v through shared memory in chunks of 32 channels
//         (double-buffered with cp.async): dp += g_c.v_c^T stays in f32
//         registers, dv_c = p^T.g_c is written at once;
//      C. recompute s, form de = p (dp - delta) in f32, round it into the
//         shared tile p held; dq = de.k, dk = de^T.q.
//    p^T, de^T and the key-major k, q and g operands are read with
//    ldmatrix.trans, so no transposed copy is staged. Every input of the
//    line is read from device memory once, every output written once; no
//    scratch, no atomics, deterministic. Shared memory: q, k, the p/de
//    tile and two g/v chunks, 93 KB at N = 97, Cq = 64 (two blocks per SM).
//    Column lines are read in place through their stride.
//
// 2. CUDA cores, two passes (cca_bwd_query_kernel, cca_bwd_key_kernel): f32
//    (the counterpart of the JAX package's "highest" precision, f32 FMAs)
//    and bf16 lines longer than 128 (natural-route calls at small widths
//    only; p and de are then not rounded). Split
//    as FlashAttention-2's backward: a query-major pass per (line, 16
//    queries) recomputes p, dp = g.v^T and de, accumulates dq and writes p
//    and de to f32 scratch P, DE (B*H*W*N floats each); a key-major pass per
//    (line, 32 keys, 256 value channels) reads them back for dv and dk.
//    Any line length works.
//
// What bounds it on the H100. At the training shape (8, 97, 97, 64/512,
// bf16) one path moves 271 MB (K3) or 367 MB (K4) if each input is read
// once and each output written once: 0.081 / 0.110 ms at 3.35 TB/s. Its
// 17.8 GFLOP (24 once padded to 112) take 0.02 ms at the 989 TFLOP/s of
// the bf16 tensor cores, so it is memory-bound. The tensor-core design
// moves exactly those bytes; what it loses to the bound is the latency of
// its three dependent phases per line (the card holds two lines per SM).
// H = 1 and W = 1 work on both: the column path is then all self slot, so
// p = 0 and every column grad is exactly 0.

#include "cca_tc.cuh"

namespace {

// ------------------------------------------------ tensor cores, line per block

constexpr int TC_CH = 32;  // value channels per streamed chunk of g and v

// bf16 elements of the block's shared memory: q, k [np][cqp + PAD], the p /
// de tile [np][np + PAD], two stages of g and v chunks [np][CH + PAD]
size_t tc_smem_elems(int np, int cqp) {
  return size_t(2) * np * (cqp + TC_PAD) + size_t(np) * (np + TC_PAD) +
         size_t(4) * np * (TC_CH + TC_PAD);
}

struct TcArgs {
  const bf16 *q, *k, *v, *g;
  const float *m, *L, *delta;
  const bf16 *dq_col, *dk_col, *dv_col;  // K4: K3's grads to add; K3: null
  bf16 *dq, *dk, *dv;
  int H, W, Cq, Cv;
};

// p of query i and key j from their logit s and the query's stats; exactly
// 0 past the line and on the column self slot (the TPU kernel's -1e9)
template <bool COL>
__device__ __forceinline__ float prob(float s, int i, int j, int N, float m, float L) {
  return (i < N && j < N && !(COL && j == i)) ? expf(s - m) / L : 0.f;
}

// out rows r0 .. r0 + 15 of the line, C channels: acc = A.B over the line's
// N_p positions, A = the de tile (dq: de as stored; dk: its transpose), B =
// X[position][channel] (k for dq, q for dk); plus add (K4), stored bf16.
// Channels go 64 at a time, so the sums take 32 registers.
template <int NP, bool TRANS_A>
__device__ __forceinline__ void line_grad(bf16* out, const bf16* add, const bf16* sDE,
                                          const bf16* X, int lx, int cqp, int r0, int N,
                                          long long base, long long step, int C, int lane) {
  constexpr int LP = NP + TC_PAD, CG = 64;
  const int gid = lane >> 2, tig = lane & 3;
  for (int c0 = 0; c0 < cqp; c0 += CG) {
    float acc[CG / 8][4];
#pragma unroll
    for (int n = 0; n < CG / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NP; kk += 16) {
      uint32_t a[4];
      if (TRANS_A)
        load_a_trans(a, sDE, LP, kk, r0, lane);  // A[j][i] = de[i][j]
      else
        load_a(a, sDE, LP, r0, kk, lane);
#pragma unroll
      for (int n = 0; n < CG / 16; ++n) {
        if (c0 + n * 16 < cqp) {
          uint32_t b[4];
          load_b2_trans(b, X, lx, kk, c0 + n * 16, lane);  // B[position][channel]
          mma_2(acc[2 * n], acc[2 * n + 1], a, b);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < CG / 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r0 + gid + 8 * h, c = c0 + n * 8 + 2 * tig;
        if (t < N)
          store_pair(out, add, (base + t * step) * C + c, c, C, acc[n][2 * h],
                     acc[n][2 * h + 1]);
      }
    }
  }
}

template <bool COL, int NW>
__global__ void __launch_bounds__(NW * 32, 2) cca_bwd_tc_kernel(const TcArgs a) {
  constexpr int NP = NW * 16, NT = NW * 2;
  constexpr int LP = NP + TC_PAD, LC = TC_CH + TC_PAD;
  extern __shared__ __align__(16) bf16 tc_smem[];
  const int cqp = round16(a.Cq), lq = cqp + TC_PAD;
  bf16* sQ = tc_smem;           // [NP][lq]
  bf16* sK = sQ + NP * lq;      // [NP][lq]
  bf16* sP = sK + NP * lq;      // [NP][LP]: p in phases A and B, de in phase C
  bf16* sG = sP + NP * LP;      // [2][NP][LC]
  bf16* sV = sG + 2 * NP * LC;  // [2][NP][LC]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int N = COL ? a.H : a.W;
  const int Cv = a.Cv;
  long long base, step;
  line_geometry(COL, blockIdx.x, a.H, a.W, base, step);
  const int r0 = warp * 16;

  stage(sQ, lq, a.q, base, step, N, a.Cq, 0, NP, cqp);
  stage(sK, lq, a.k, base, step, N, a.Cq, 0, NP, cqp);
  cp_async_commit();
  stage(sG, LC, a.g, base, step, N, Cv, 0, NP, TC_CH);
  stage(sV, LC, a.v, base, step, N, Cv, 0, NP, TC_CH);
  cp_async_commit();

  // stats of this thread's two queries r0 + gid and r0 + gid + 8
  float mi[2], Li[2], di[2];
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = r0 + gid + 8 * h;
    const bool ok = qi[h] < N;
    const long long p = base + (long long)qi[h] * step;
    mi[h] = ok ? a.m[p] : 0.f;
    Li[h] = ok ? a.L[p] : 1.f;
    di[h] = ok ? a.delta[p] : 0.f;
  }
  cp_async_wait<1>();  // q and k have landed
  __syncthreads();

  // A: p = exp(q.k^T - m) / L for this warp's queries, to shared as bf16
#pragma unroll 1
  for (int jp = 0; jp < NW; ++jp) {
    float s[2][4];
    scores(s, sQ, sK, lq, cqp, r0, jp * 16, lane);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jp * 16 + t * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(sP + qi[h] * LP + j) =
            pack_bf16(prob<COL>(s[t][2 * h], qi[h], j, N, mi[h], Li[h]),
                      prob<COL>(s[t][2 * h + 1], qi[h], j + 1, N, mi[h], Li[h]));
      }
    }
  }

  // B: chunks of TC_CH value channels. dp += g_c.v_c^T for this warp's
  // queries (f32 registers); dv_c = p^T.g_c for this warp's keys, stored.
  float dp[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
  const int nch = (Cv + TC_CH - 1) / TC_CH;
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < nch) {  // the other buffer's readers passed the last barrier
      stage(sG + (buf ^ 1) * NP * LC, LC, a.g, base, step, N, Cv, (ch + 1) * TC_CH, NP, TC_CH);
      stage(sV + (buf ^ 1) * NP * LC, LC, a.v, base, step, N, Cv, (ch + 1) * TC_CH, NP, TC_CH);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk ch has landed (this thread's copies) ...
    __syncthreads();     // ... and everyone's; p is in shared memory
    const bf16* G = sG + buf * NP * LC;
    const bf16* V = sV + buf * NP * LC;
#pragma unroll
    for (int kk = 0; kk < TC_CH; kk += 16) {
      uint32_t ag[4];
      load_a(ag, G, LC, r0, kk, lane);
#pragma unroll
      for (int jp = 0; jp < NW; ++jp) {
        uint32_t b[4];
        load_b2(b, V, LC, jp * 16, kk, lane);  // B[c][j] = v[j][c]
        mma_2(dp[2 * jp], dp[2 * jp + 1], ag, b);
      }
    }
    float acc[TC_CH / 8][4];
#pragma unroll
    for (int n = 0; n < TC_CH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NP; kk += 16) {
      uint32_t ap[4];
      load_a_trans(ap, sP, LP, kk, r0, lane);  // A[j][i] = p[i][j]
#pragma unroll
      for (int n = 0; n < TC_CH; n += 16) {
        uint32_t b[4];
        load_b2_trans(b, G, LC, kk, n, lane);  // B[i][c] = g[i][c]
        mma_2(acc[n / 8], acc[n / 8 + 1], ap, b);
      }
    }
#pragma unroll
    for (int n = 0; n < TC_CH / 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = r0 + gid + 8 * h, c = ch * TC_CH + n * 8 + 2 * tig;
        if (j < N)
          store_pair(a.dv, COL ? nullptr : a.dv_col, (base + j * step) * Cv + c, c, Cv,
                     acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
    __syncthreads();  // this chunk's buffer and p are free
  }

  // C: de = p (dp - delta) with p recomputed in f32, rounded to bf16 into
  // the tile p held; then dq = de.k (this warp's queries), dk = de^T.q
  // (this warp's keys)
#pragma unroll
  for (int jp = 0; jp < NW; ++jp) {
    float s[2][4];
    scores(s, sQ, sK, lq, cqp, r0, jp * 16, lane);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jp * 16 + t * 8 + 2 * tig;
        const float p0 = prob<COL>(s[t][2 * h], qi[h], j, N, mi[h], Li[h]);
        const float p1 = prob<COL>(s[t][2 * h + 1], qi[h], j + 1, N, mi[h], Li[h]);
        *reinterpret_cast<uint32_t*>(sP + qi[h] * LP + j) =
            pack_bf16(p0 * (dp[2 * jp + t][2 * h] - di[h]),
                      p1 * (dp[2 * jp + t][2 * h + 1] - di[h]));
      }
    }
  }
  __syncthreads();
  line_grad<NP, false>(a.dq, COL ? nullptr : a.dq_col, sP, sK, lq, cqp, r0, N, base, step, a.Cq,
                       lane);
  line_grad<NP, true>(a.dk, COL ? nullptr : a.dk_col, sP, sQ, lq, cqp, r0, N, base, step, a.Cq,
                      lane);
}

template <bool COL, int NW>
int launch_tc_lines(const TcArgs& a, int lines, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * tc_smem_elems(NW * 16, round16(a.Cq));
  cudaError_t err = cudaFuncSetAttribute(cca_bwd_tc_kernel<COL, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cca_bwd_tc_kernel<COL, NW><<<lines, NW * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool COL>
int launch_tc(const TcArgs& a, int B, cudaStream_t stream) {
  const int n = COL ? a.H : a.W;
  if (B < 1 || a.H < 1 || a.W < 1 || a.Cq < 1 || a.Cq > MAX_CQ || a.Cv < 1 || n > TC_MAX_N)
    return (int)cudaErrorInvalidValue;
  const int lines = COL ? B * a.W : B * a.H;
  switch ((n + 15) / 16) {  // warps per block
    case 1: return launch_tc_lines<COL, 1>(a, lines, stream);
    case 2: return launch_tc_lines<COL, 2>(a, lines, stream);
    case 3: return launch_tc_lines<COL, 3>(a, lines, stream);
    case 4: return launch_tc_lines<COL, 4>(a, lines, stream);
    case 5: return launch_tc_lines<COL, 5>(a, lines, stream);
    case 6: return launch_tc_lines<COL, 6>(a, lines, stream);
    case 7: return launch_tc_lines<COL, 7>(a, lines, stream);
    default: return launch_tc_lines<COL, 8>(a, lines, stream);
  }
}

// ------------------------------------------------------ CUDA cores, two passes

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int QT = 2 * NWARPS;  // queries per query-major block (2 per warp)
constexpr int KT = 32;          // keys per chunk of the query-major pass (1 per lane)
constexpr int VC = 128;         // value channels per streamed v slice
constexpr int KB = 32;          // keys per key-major block
constexpr int QC = 32;          // queries per chunk of the key-major pass
constexpr int DQ_PER_THREAD = QT * MAX_CQ / THREADS;  // 8
constexpr int DK_PER_THREAD = KB * MAX_CQ / THREADS;  // 16

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
// Bound by the FMA rate and shared-memory reads of the dp = g.v^T product:
// 2 queries x 1 key per thread, float4 reads along the channels from padded
// rows (no bank conflicts), g rows of the block's 16 queries in shared
// memory while v streams through in VC-channel slices.
template <typename T, bool COL>
__global__ void __launch_bounds__(THREADS)
cca_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ m_in,
                     const float* __restrict__ L_in, const float* __restrict__ d_in,
                     float* __restrict__ P, float* __restrict__ DE,
                     const T* __restrict__ dq_col, T* __restrict__ dq_out, int H, int W, int Cq,
                     int Cv) {
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
        dq_out[o] = from_f32<T>(COL ? acc[r] : acc[r] + to_f32(dq_col[o]));
      }
    }
  }
}

// Key-major pass of one path: dv (one value channel per thread) and, in the
// first channel slice, dk, from the p and de the query-major pass wrote.
// Bound by FMA issue (dv = p^T g is the 7.5 GFLOP term at the training
// shape); p is read from shared memory as float4 broadcasts, g straight
// from device memory into registers, coalesced across the channel threads.
template <typename T, bool COL>
__global__ void __launch_bounds__(THREADS)
cca_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ g,
                   const float* __restrict__ P, const float* __restrict__ DE,
                   const T* __restrict__ dk_col, const T* __restrict__ dv_col,
                   T* __restrict__ dk_out, T* __restrict__ dv_out, int H, int W, int Cq, int Cv) {
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
        dv_out[o] = from_f32<T>(COL ? dv[j] : dv[j] + to_f32(dv_col[o]));
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
          dk_out[o] = from_f32<T>(COL ? dk[r] : dk[r] + to_f32(dk_col[o]));
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
      static_cast<const T*>(dq_col), static_cast<T*>(dq), H, W, Cq, Cv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k(lines, (n + KB - 1) / KB, (Cv + THREADS - 1) / THREADS);
  cca_bwd_key_kernel<T, COL><<<grid_k, THREADS, smem_k, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), static_cast<const float*>(P),
      static_cast<const float*>(DE), static_cast<const T*>(dk_col),
      static_cast<const T*>(dv_col), static_cast<T*>(dk), static_cast<T*>(dv), H, W, Cq, Cv);
  return (int)cudaGetLastError();
}

TcArgs tc_args(const void* q, const void* k, const void* v, const void* g, const void* m,
               const void* L, const void* delta, const void* dq_col, const void* dk_col,
               const void* dv_col, void* dq, void* dk, void* dv, int H, int W, int Cq, int Cv) {
  return TcArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                static_cast<const float*>(m), static_cast<const float*>(L),
                static_cast<const float*>(delta), static_cast<const bf16*>(dq_col),
                static_cast<const bf16*>(dk_col), static_cast<const bf16*>(dv_col),
                static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                H, W, Cq, Cv};
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the CUDA-core query-major kernel needs (the
// wrapper checks it against the card's limit before launching).
long long cca_bwd_query_smem_bytes(int Cq, int Cv) {
  return (long long)(sizeof(float) * query_smem_floats(Cq, Cv));
}

// K3 on the CUDA cores. Column-path grads in the input dtype. P and DE are
// f32 scratch of B*W*H*H floats each. Returns cudaGetLastError().
int cca_bwd_col(const void* q, const void* k, const void* v, const void* g, const void* m,
                const void* L, const void* delta, void* P, void* DE, void* dq_c, void* dk_c,
                void* dv_c, int B, int H, int W, int Cq, int Cv, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16, true>(q, k, v, g, m, L, delta, P, DE, nullptr, nullptr, nullptr, dq_c,
                              dk_c, dv_c, B, H, W, Cq, Cv, st);
  return launch<float, true>(q, k, v, g, m, L, delta, P, DE, nullptr, nullptr, nullptr, dq_c,
                             dk_c, dv_c, B, H, W, Cq, Cv, st);
}

// K4 on the CUDA cores. Row-path grads plus K3's column grads, written in the
// input dtype. P and DE are f32 scratch of B*H*W*W floats each.
int cca_bwd_row(const void* q, const void* k, const void* v, const void* g, const void* m,
                const void* L, const void* delta, void* P, void* DE, const void* dq_c,
                const void* dk_c, const void* dv_c, void* dq, void* dk, void* dv, int B, int H,
                int W, int Cq, int Cv, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16, false>(q, k, v, g, m, L, delta, P, DE, dq_c, dk_c, dv_c, dq, dk, dv, B,
                               H, W, Cq, Cv, st);
  return launch<float, false>(q, k, v, g, m, L, delta, P, DE, dq_c, dk_c, dv_c, dq, dk, dv, B,
                              H, W, Cq, Cv, st);
}

// K3 on the tensor cores: bf16, H <= 128, Cq <= 128. Column-path grads in
// bf16. Returns cudaGetLastError() (cudaErrorInvalidValue for other shapes).
int cca_bwd_col_tc(const void* q, const void* k, const void* v, const void* g, const void* m,
                   const void* L, const void* delta, void* dq_c, void* dk_c, void* dv_c, int B,
                   int H, int W, int Cq, int Cv, void* stream) {
  return launch_tc<true>(tc_args(q, k, v, g, m, L, delta, nullptr, nullptr, nullptr, dq_c, dk_c,
                                 dv_c, H, W, Cq, Cv),
                         B, static_cast<cudaStream_t>(stream));
}

// K4 on the tensor cores: bf16, W <= 128, Cq <= 128. Row-path grads plus
// K3's (bf16), the final grads in bf16. Returns cudaGetLastError().
int cca_bwd_row_tc(const void* q, const void* k, const void* v, const void* g, const void* m,
                   const void* L, const void* delta, const void* dq_c, const void* dk_c,
                   const void* dv_c, void* dq, void* dk, void* dv, int B, int H, int W, int Cq,
                   int Cv, void* stream) {
  return launch_tc<false>(tc_args(q, k, v, g, m, L, delta, dq_c, dk_c, dv_c, dq, dk, dv, H, W,
                                  Cq, Cv),
                          B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
