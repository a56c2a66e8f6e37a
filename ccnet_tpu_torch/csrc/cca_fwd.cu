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
// o_col (B, H, W, Cv) is in the input dtype on both designs, as the TPU
// function writes it (v's dtype; f32 under "highest"); m, l, L are (B, H, W)
// f32. Column lines are read and written in place through their stride.
//
// What bounds it on the H100. At the sliding-window shape (8, 97, 97,
// 64/512, bf16) K1 must move 174.0 MB (q, k, v in, o_col out, stats) and K2
// 251.7 MB (q, k, v, o_col and the stats in, out and m, L out): 0.0519 and
// 0.0751 ms at 3.35 TB/s. Each path does 8.4 GFLOP (the p.v aggregation is
// 7.5 of it), 0.008 ms at the 989 TFLOP/s of the bf16 tensor cores: both
// kernels are bound by device memory, so the design reads every input once
// and writes every output once, and keeps p out of memory.
//
// Two designs, chosen by the wrapper from the dtype and the line length:
//
// 1. Tensor cores, one block per line (cca_fwd_tc_kernel): bf16 lines of
//    N <= 128, which at the model's widths are every call
//    CrissCrossAttentionFn sends here but the forward at H = 129-130 (the
//    JAX package's route choice). It computes what the TPU kernels compute
//    under the JAX package's default precision: bf16 operands, f32 sums, m
//    and l from the f32 p, p rounded to bf16 before p.v, o_col written in
//    bf16. The block holds the line padded to N_p = 16 ceil(N / 16) and has
//    N_p / 16 warps; warp w owns queries 16w .. 16w + 15 (cca_tc.cuh):
//      A. stage q and k (N_p x Cq, bf16, cp.async); each warp computes its
//         queries' logits against every key on mma.sync m16n8k16 (2 N_p / 16
//         n-tiles of f32 accumulators, 56 registers at N_p = 112), masks
//         them, and takes the row max and sum over the quad of lanes that
//         shares a row (shfl_xor 1 and 2);
//      B. p rounded to bf16 goes straight from the C fragments of q.k^T into
//         the A fragments of p.v (as FlashAttention-2 does: a0 = c0,c1 of
//         n-tile 2t, a1 = c2,c3 of 2t, a2/a3 the same of 2t + 1), so p never
//         touches shared memory; v streams through shared memory in chunks of
//         64 channels (cp.async double buffer, read with ldmatrix.trans), the
//         chunk's sums in 32 f32 registers;
//      epilogue: K1 stores o_col (bf16) and m_col, l_col; K2 loads K1's o_col
//         pairs for the chunk before its products (their latency hides behind
//         them), combines in f32 and stores out (bf16) and the joint m, L.
//    Masks: the column self slot j == i is -1e9, as the JAX op; keys past the
//    line end get p = 0 exactly. The two stay apart: at H = 1 the column is
//    all self slot, m_col = -1e9, l_col = 1 and o_col = v_self, and the 15
//    padded keys (p = exp(-1e9 - m) = 1 if they were masked like the self
//    slot) add nothing.
//    Occupancy: 776 lines at 8 x 97^2 per path, one block each (two waves
//    of the card); 64.5 KB of shared memory per block at N_p = 112, Cq = 64
//    (q, k and two v chunks). The register budget is fixed per kernel
//    (__launch_bounds__): K1 for 3 blocks per SM (80 registers for the 7-warp
//    kernel), K2 for 2 (128). Measured on one H100 80GB HBM3 at 700 W,
//    8 x 97^2, with the kernel compiled for both budgets: K1 0.1214 ms at 3
//    blocks per SM against 0.1313 at 2 (at 80 registers it spills 32 to
//    96 bytes); K2 0.1639 ms at 2 against 0.2734 at 3, where the K1 o_col
//    pairs it loads ahead push it to 448 bytes of spills. Splitting Cv over
//    2 blocks per line (each recomputing the Cq = 64 logits and reading q, k
//    again) lost for both: K1 0.1318 / 0.1457 ms, K2 0.3171 / 0.1792 ms at
//    3 / 2 blocks per SM.
//
// 2. CUDA cores (cca_line_kernel): f32 (the counterpart of the JAX package's
//    "highest" precision, f32 FMAs) and bf16 lines longer than 128 (where
//    the route stays natural past them; p is then not rounded, unlike the
//    TPU kernels). One block per (line, 16 queries, 256 value
//    channels); keys stream through in tiles of 32 with an online softmax,
//    so any line length works; each thread owns one value channel. p is not
//    rounded (f32 throughout); o_col is stored in the input dtype.
//    H = 1 and W = 1 work on both: exp(-1e9 - m) in the combine is exactly 0,
//    never NaN.

#include <math_constants.h>

#include "cca_tc.cuh"

namespace {

// ------------------------------------------------ tensor cores, line per block

constexpr int FWD_CH = 64;  // value channels per streamed chunk of v

struct FwdArgs {
  const bf16 *q, *k, *v;
  const bf16* o_col;           // K2: K1's column aggregate; K1: null
  const float *m_col, *l_col;  // K2: K1's column stats; K1: null
  bf16* o;                     // K1: o_col; K2: out
  float *m, *l;                // K1: m_col, l_col; K2: the joint m, L
  int H, W, Cq, Cv;
};

// bytes of the block's shared memory: q, k [np][cqp + PAD], two v chunks
// [np][FWD_CH + PAD], all bf16
size_t fwd_tc_smem_bytes(int np, int cqp) {
  return sizeof(bf16) * (size_t(2) * np * (cqp + TC_PAD) + size_t(2) * np * (FWD_CH + TC_PAD));
}

// x[o], x[o + 1] (bf16, o = pixel * C + c with c < C) as one fragment
// register; 0 for c + 1 past the channels
__device__ __forceinline__ uint32_t load_bf16_pair(const bf16* x, long long o, int c, int C) {
  if (c + 1 < C && (C & 1) == 0) return pair(x + o);
  const uint32_t lo = __bfloat16_as_ushort(x[o]);
  return c + 1 < C ? lo | (uint32_t(__bfloat16_as_ushort(x[o + 1])) << 16) : lo;
}

// the two f32 values of a fragment register of bf16 (low half first)
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return make_float2(__uint_as_float(r << 16), __uint_as_float(r & 0xffff0000u));
}

// registers budgeted for 3 blocks per SM (K1) or 2 (K2): see Occupancy above
template <bool COL, int NW>
__global__ void __launch_bounds__(NW * 32, COL ? 3 : 2) cca_fwd_tc_kernel(const FwdArgs a) {
  constexpr int NP = NW * 16, LC = FWD_CH + TC_PAD, NG = FWD_CH / 8;
  extern __shared__ __align__(16) bf16 fwd_smem[];
  const int cqp = round16(a.Cq), lq = cqp + TC_PAD;
  bf16* sQ = fwd_smem;        // [NP][lq]
  bf16* sK = sQ + NP * lq;    // [NP][lq]
  bf16* sV = sK + NP * lq;    // [2][NP][LC]

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
  stage(sV, LC, a.v, base, step, N, Cv, 0, NP, FWD_CH);
  cp_async_commit();
  cp_async_wait<1>();  // q and k have landed
  __syncthreads();

  // A: logits of this warp's queries r0 + gid (h = 0) and r0 + gid + 8
  // (h = 1) against every key; element e of n-tile (jp, t) is key
  // jp * 16 + t * 8 + 2 tig + (e & 1) of query half h = e >> 1
  float s[NW][2][4];
#pragma unroll
  for (int jp = 0; jp < NW; ++jp) scores(s[jp], sQ, sK, lq, cqp, r0, jp * 16, lane);
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int jp = 0; jp < NW; ++jp) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, j = jp * 16 + t * 8 + 2 * tig + (e & 1);
        if (COL && j == r0 + gid + 8 * h) s[jp][t][e] = MASK;
        if (j < N) mx[h] = fmaxf(mx[h], s[jp][t][e]);
      }
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the quad of lanes that shares a row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  // B's A operand: p of keys jp * 16 .. + 15 in bf16, straight from the C
  // fragments (p[jp][2t + h] = the pair of n-tile t, query half h)
  uint32_t p[NW][4];
#pragma unroll
  for (int jp = 0; jp < NW; ++jp) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jp * 16 + t * 8 + 2 * tig;
        const float p0 = j < N ? expf(s[jp][t][2 * h] - mx[h]) : 0.f;
        const float p1 = j + 1 < N ? expf(s[jp][t][2 * h + 1] - mx[h]) : 0.f;
        l[h] += p0 + p1;  // from the f32 p, as _fwd_col_kernel
        p[jp][2 * t + h] = pack_bf16(p0, p1);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // the stats of this thread's two queries; K2's combine weights
  int qi[2];
  long long px[2];
  float wc[2], wr[2], Lj[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = r0 + gid + 8 * h;
    px[h] = base + (long long)qi[h] * step;
    if (COL) {
      if (tig == 0 && qi[h] < N) {
        a.m[px[h]] = mx[h];
        a.l[px[h]] = l[h];
      }
    } else {
      const bool ok = qi[h] < N;
      const float mc = ok ? a.m_col[px[h]] : 0.f, lc = ok ? a.l_col[px[h]] : 0.f;
      const float m = fmaxf(mc, mx[h]);
      wc[h] = expf(mc - m);
      wr[h] = expf(mx[h] - m);
      Lj[h] = lc * wc[h] + l[h] * wr[h];
      if (tig == 0 && ok) {
        a.m[px[h]] = m;
        a.l[px[h]] = Lj[h];
      }
    }
  }

  // B: o[i][c] = sum_j p[i][j] v[j][c], FWD_CH channels at a time
  const int nch = (Cv + FWD_CH - 1) / FWD_CH;
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1, c0 = ch * FWD_CH;
    if (ch + 1 < nch)  // the other buffer's readers passed the last barrier
      stage(sV + (buf ^ 1) * NP * LC, LC, a.v, base, step, N, Cv, c0 + FWD_CH, NP, FWD_CH);
    cp_async_commit();
    uint32_t oc[NG][2];  // K2: K1's o_col pairs of this chunk, loaded ahead
    if (!COL) {
#pragma unroll
      for (int n = 0; n < NG; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + n * 8 + 2 * tig;
          oc[n][h] = (qi[h] < N && c < Cv) ? load_bf16_pair(a.o_col, px[h] * Cv + c, c, Cv) : 0u;
        }
      }
    }
    cp_async_wait<1>();  // chunk ch has landed (this thread's copies) ...
    __syncthreads();     // ... and everyone's
    const bf16* V = sV + buf * NP * LC;
    float acc[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < NW; ++jp) {
#pragma unroll
      for (int n = 0; n < FWD_CH; n += 16) {
        uint32_t b[4];
        load_b2_trans(b, V, LC, jp * 16, n, lane);  // B[j][c] = v[j][c]
        mma_2(acc[n / 8], acc[n / 8 + 1], p[jp], b);
      }
    }
#pragma unroll
    for (int n = 0; n < NG; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + n * 8 + 2 * tig;
        if (qi[h] >= N) continue;
        float x0 = acc[n][2 * h], x1 = acc[n][2 * h + 1];
        if (!COL) {
          const float2 o = unpack_bf16(oc[n][h]);
          x0 = (o.x * wc[h] + x0 * wr[h]) / Lj[h];
          x1 = (o.y * wc[h] + x1 * wr[h]) / Lj[h];
        }
        store_pair(a.o, nullptr, px[h] * Cv + c, c, Cv, x0, x1);
      }
    }
    __syncthreads();  // this chunk's buffer is free
  }
}

template <bool COL, int NW>
int fwd_tc_lines(const FwdArgs& a, int lines, size_t smem, cudaStream_t stream) {
  const auto kernel = cca_fwd_tc_kernel<COL, NW>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<lines, NW * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// one block per line, N_p / 16 warps
template <bool COL>
int launch_fwd_tc(const FwdArgs& a, int B, cudaStream_t stream) {
  const int n = COL ? a.H : a.W;
  if (B < 1 || a.H < 1 || a.W < 1 || a.Cq < 1 || a.Cq > MAX_CQ || a.Cv < 1 || n > TC_MAX_N)
    return (int)cudaErrorInvalidValue;
  const int nw = (n + 15) / 16, lines = COL ? B * a.W : B * a.H;
  const size_t smem = fwd_tc_smem_bytes(nw * 16, round16(a.Cq));
  switch (nw) {  // warps per block
    case 1: return fwd_tc_lines<COL, 1>(a, lines, smem, stream);
    case 2: return fwd_tc_lines<COL, 2>(a, lines, smem, stream);
    case 3: return fwd_tc_lines<COL, 3>(a, lines, smem, stream);
    case 4: return fwd_tc_lines<COL, 4>(a, lines, smem, stream);
    case 5: return fwd_tc_lines<COL, 5>(a, lines, smem, stream);
    case 6: return fwd_tc_lines<COL, 6>(a, lines, smem, stream);
    case 7: return fwd_tc_lines<COL, 7>(a, lines, smem, stream);
    default: return fwd_tc_lines<COL, 8>(a, lines, smem, stream);
  }
}

FwdArgs fwd_args(const void* q, const void* k, const void* v, const void* o_col,
                 const void* m_col, const void* l_col, void* o, void* m, void* l, int H, int W,
                 int Cq, int Cv) {
  return FwdArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(o_col),
                 static_cast<const float*>(m_col), static_cast<const float*>(l_col),
                 static_cast<bf16*>(o), static_cast<float*>(m), static_cast<float*>(l),
                 H, W, Cq, Cv};
}

// ------------------------------------------------------------------ CUDA cores

constexpr int TQ = 16;                  // queries of one line per block
constexpr int KT = 32;                  // keys per streamed tile (one per lane)
constexpr int THREADS = 256;            // = value channels per block
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = TQ / NWARPS;

size_t smem_bytes(int Cq) {
  return sizeof(float) * (size_t(KT) * TQ + 3 * TQ + size_t(TQ + KT) * (Cq + 1));
}

// COL = true is K1 (column path, self-masked, writes o_col/m_col/l_col);
// COL = false is K2 (row path, combines with K1's outputs, writes out/m/L).
template <typename T, bool COL>
__global__ void __launch_bounds__(THREADS)
cca_line_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ o_col_in, const float* __restrict__ m_col_in,
                const float* __restrict__ l_col_in, T* __restrict__ o_col_out,
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
  long long base, stride;
  line_geometry(COL, blockIdx.x, H, W, base, stride);

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
      o_col_out[p * Cv + c] = from_f32<T>(acc[i]);
    } else {
      const float mc = m_col_in[p], lc = l_col_in[p], mr = s_m[i], lr = s_l[i];
      const float m = fmaxf(mc, mr);
      const float ac = expf(mc - m), ar = expf(mr - m);
      const float L = lc * ac + lr * ar;
      out[p * Cv + c] = from_f32<T>((to_f32(o_col_in[p * Cv + c]) * ac + acc[i] * ar) / L);
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
      static_cast<const T*>(o_col_in), static_cast<const float*>(m_col_in),
      static_cast<const float*>(l_col_in), static_cast<T*>(o_col_out),
      static_cast<T*>(out), static_cast<float*>(m_out), static_cast<float*>(l_out), H, W, Cq, Cv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 on the CUDA cores. is_bf16 selects bf16 q/k/v (else f32); o_col in the
// same dtype. Returns cudaGetLastError().
int cca_fwd_col(const void* q, const void* k, const void* v, void* o_col, void* m_col,
                void* l_col, int B, int H, int W, int Cq, int Cv, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16, true>(q, k, v, nullptr, nullptr, nullptr, o_col, nullptr, m_col, l_col,
                              B, H, W, Cq, Cv, st);
  return launch<float, true>(q, k, v, nullptr, nullptr, nullptr, o_col, nullptr, m_col, l_col,
                             B, H, W, Cq, Cv, st);
}

// K2 on the CUDA cores. o_col and out have q/k/v's dtype; m and L are f32.
int cca_fwd_row(const void* q, const void* k, const void* v, const void* o_col,
                const void* m_col, const void* l_col, void* out, void* m, void* L, int B, int H,
                int W, int Cq, int Cv, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16, false>(q, k, v, o_col, m_col, l_col, nullptr, out, m, L, B, H, W, Cq, Cv,
                               st);
  return launch<float, false>(q, k, v, o_col, m_col, l_col, nullptr, out, m, L, B, H, W, Cq, Cv,
                              st);
}

// K1 on the tensor cores: bf16, H <= 128, Cq <= 128; o_col in bf16. Returns
// cudaGetLastError() (cudaErrorInvalidValue for other shapes).
int cca_fwd_col_tc(const void* q, const void* k, const void* v, void* o_col, void* m_col,
                   void* l_col, int B, int H, int W, int Cq, int Cv, void* stream) {
  return launch_fwd_tc<true>(
      fwd_args(q, k, v, nullptr, nullptr, nullptr, o_col, m_col, l_col, H, W, Cq, Cv), B,
      static_cast<cudaStream_t>(stream));
}

// K2 on the tensor cores: bf16, W <= 128, Cq <= 128; K1's bf16 o_col and f32
// stats in, out (bf16) and the joint m, L (f32) out.
int cca_fwd_row_tc(const void* q, const void* k, const void* v, const void* o_col,
                   const void* m_col, const void* l_col, void* out, void* m, void* L, int B,
                   int H, int W, int Cq, int Cv, void* stream) {
  return launch_fwd_tc<false>(fwd_args(q, k, v, o_col, m_col, l_col, out, m, L, H, W, Cq, Cv),
                              B, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
