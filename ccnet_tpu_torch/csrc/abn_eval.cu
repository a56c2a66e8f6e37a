// Eval-mode activated batch norm in one pass, for Hopper (sm_90a): abn_eval.
//
//   y = act(x * scale[c] + shift[c] (+ r)),
//   scale = w * rsqrt(running_var + eps), shift = b - running_mean * scale,
//   act = identity, ReLU or leaky-ReLU(slope),
// over a contiguous NCHW or channels_last x (bf16 or f32) and an optional
// residual r of x's shape, layout and type; the per-channel parameters f32.
// The arithmetic is f32 and y is rounded once to x's type.
//
// Replaces no TPU kernel. On the TPU, XLA fuses eval BN's affine map, the
// bottleneck's residual add and the activation into one elementwise loop.
// In eager PyTorch they were four passes over memory: BN's mul and add,
// each with a broadcast operand (PyTorch's unvectorised elementwise
// kernel), then the residual add and ReLU. At the sliding-window serving
// shapes those passes took 61 % of the card's time
// (ccnet_tpu_torch/nn/layers.py ABN and models/backbone.py call this).
//
// What bounds it on the H100: HBM. A bf16 element costs 2 bytes read and 2
// written, plus 2 read for a residual, against a few f32 operations, so
// the bound is bytes / 3.35 TB/s: 0.138 ms at (8, 1024, 97, 97) with a
// residual. The design keeps everything but the 16-byte loads and stores
// off that path:
//   * 16-byte vectors of the flat tensor (8 bf16 or 4 f32 values), one tile
//     of THREADS x UNROLL vectors per block, each thread loading its UNROLL
//     vectors of x (and r) before it computes and stores. Timed in turns
//     at the three serving shapes of chip_smoke.ABN_SHAPES on an H100 80GB
//     HBM3 at 700 W (PERF.md), a grid of one wave of resident blocks
//     striding over the tiles reached 82.8 / 75.9 / 74.1 % of the bound,
//     four waves 86.5 / 83.5 / 80.1 %, one tile per block 88.9 / 85.4 /
//     81.7 % (torch's own add and relu at the same bytes: 90.3 / 86.6 /
//     84.4 %); 4 or 8 loads a thread, 128 or 512 threads a block and
//     streaming loads bought nothing. So a block does one tile, no loop;
//   * each block first computes scale and shift of every channel into
//     shared memory (2 C floats), so a value costs one FMA beside its load;
//   * NCHW: the channel of element e is (e / HW) % C. A plane of HW = 97^2
//     or 385^2 values does not start on a 16-byte boundary, so a vector may
//     straddle planes: the thread divides once per vector (multiply-shift,
//     FastDiv) and steps the plane offset and the channel across the vector,
//     reading scale and shift again only where a plane ends (all lanes of a
//     warp mostly read one channel: a shared-memory broadcast);
//   * channels_last: the channel of element e is e % C; with C a multiple
//     of the vector width, a vector holds the consecutive channels c .. c +
//     V - 1, read as float4s of scale and shift. With any other C it is the
//     NCHW case with planes of one value (the channel steps every value);
//   * the n % V values past the last vector go one to a thread.
// Indices are 32-bit: the wrapper takes tensors of fewer than 2^31 values
// (the multiply-shift division holds below 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;    // 16-byte vectors a thread loads before it computes
constexpr int MAX_C = 6144;  // 2 C floats of table fit the default 48 KB
constexpr int IDENTITY = 0, RELU = 1, LEAKY = 2;

// i / d == (umulhi(i, mul) + i) >> shift for 0 <= i < 2^31 and 1 <= d < 2^31
// (ccnet_tpu_torch/ops/probes.py fast_divider: shift = ceil(log2 d),
// mul = floor(2^32 (2^shift - d) / d) + 1).
struct FastDiv {
  unsigned mul, shift;
};

FastDiv make_div(unsigned d) {
  unsigned shift = 0;
  while ((1ull << shift) < d) ++shift;
  return {(unsigned)((1ull << 32) * ((1ull << shift) - d) / d + 1), shift};
}

__device__ __forceinline__ unsigned fdiv(unsigned i, FastDiv f) {
  return (__umulhi(i, f.mul) + i) >> f.shift;
}

__device__ __forceinline__ float activate(float v, int act, float slope) {
  // NaN passes through, as torch's relu and where(y >= 0, y, y * slope) let it
  if (act == RELU) return v < 0.f ? 0.f : v;
  if (act == LEAKY) return v >= 0.f ? v : v * slope;
  return v;
}

// 16 bytes of T as floats and back, rounding once to nearest even
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ static float scalar(const void* p, unsigned i) {
    return static_cast<const float*>(p)[i];
  }
  __device__ static void put(void* p, unsigned i, float v) { static_cast<float*>(p)[i] = v; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float (&f)[N]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the low half is the lower address
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static unsigned pair(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo at the lower address
    return *reinterpret_cast<const unsigned*>(&p);
  }
  __device__ static uint4 store(const float (&f)[N]) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
  __device__ static float scalar(const void* p, unsigned i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  __device__ static void put(void* p, unsigned i, float v) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  }
};

struct Args {
  const void* x;
  const void* r;  // null without a residual
  void* y;
  const float *w, *b, *mean, *var;
  float eps, slope;
  unsigned n, C, inner;  // inner = H W (NCHW) or 1 (channels_last)
  FastDiv by_inner, by_c;
  int act;
};

// One vector of V values starting at element e (a multiple of V).
template <typename T, bool CL, bool RES>
__device__ __forceinline__ uint4 vector(const Args& a, const float* scale, const float* shift,
                                        uint4 xv, uint4 rv, unsigned e) {
  using L = Vec<T>;
  constexpr int V = L::N;
  float v[V], res[V];
  L::load(xv, v);
  if (RES) L::load(rv, res);
  if (CL) {
    const unsigned c = e - fdiv(e, a.by_c) * a.C;  // a multiple of V: C % V == 0
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 s = *reinterpret_cast<const float4*>(scale + c + k);
      const float4 t = *reinterpret_cast<const float4*>(shift + c + k);
      v[k] = fmaf(v[k], s.x, t.x);
      v[k + 1] = fmaf(v[k + 1], s.y, t.y);
      v[k + 2] = fmaf(v[k + 2], s.z, t.z);
      v[k + 3] = fmaf(v[k + 3], s.w, t.w);
    }
  } else {
    const unsigned q = fdiv(e, a.by_inner);  // the plane (image, channel) of e
    unsigned p = e - q * a.inner;            // e's offset in it
    unsigned c = q - fdiv(q, a.by_c) * a.C;
    float s = scale[c], t = shift[c];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (p == a.inner) {  // the next plane: the next channel
        p = 0;
        c = c + 1 == a.C ? 0 : c + 1;
        s = scale[c];
        t = shift[c];
      }
      v[k] = fmaf(v[k], s, t);
      ++p;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = activate(RES ? v[k] + res[k] : v[k], a.act, a.slope);
  return L::store(v);
}

template <typename T, bool CL, bool RES>
__global__ void __launch_bounds__(THREADS) abn_eval_kernel(const Args a) {
  using L = Vec<T>;
  constexpr int V = L::N;
  extern __shared__ float table[];  // scale[C], then shift[C]
  float* scale = table;
  float* shift = table + a.C;
  for (unsigned c = threadIdx.x; c < a.C; c += THREADS) {
    const float s = a.w[c] * rsqrtf(a.var[c] + a.eps);
    scale[c] = s;
    shift[c] = a.b[c] - a.mean[c] * s;
  }
  __syncthreads();

  const uint4* x = static_cast<const uint4*>(a.x);
  const uint4* r = static_cast<const uint4*>(a.r);
  uint4* y = static_cast<uint4*>(a.y);
  const unsigned nvec = a.n / V;
  const unsigned base = blockIdx.x * THREADS * UNROLL + threadIdx.x;  // this block's tile
  uint4 xv[UNROLL], rv[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = base + u * THREADS;
    if (i < nvec) {
      xv[u] = x[i];
      if (RES) rv[u] = r[i];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const unsigned i = base + u * THREADS;
    if (i < nvec) y[i] = vector<T, CL, RES>(a, scale, shift, xv[u], RES ? rv[u] : xv[u], i * V);
  }

  // the values past the last whole vector
  const unsigned e = nvec * V + threadIdx.x;
  if (blockIdx.x == 0 && e < a.n) {
    const unsigned c = CL ? e - fdiv(e, a.by_c) * a.C
                          : fdiv(e, a.by_inner) - fdiv(fdiv(e, a.by_inner), a.by_c) * a.C;
    float v = fmaf(L::scalar(a.x, e), scale[c], shift[c]);
    if (RES) v += L::scalar(a.r, e);
    L::put(a.y, e, activate(v, a.act, a.slope));
  }
}

// One block a tile of THREADS x UNROLL vectors (at least one block, for the
// values past the last vector).
template <typename T, bool CL, bool RES>
cudaError_t launch(const Args& a, void* stream) {
  constexpr unsigned per_block = THREADS * UNROLL;
  const unsigned nvec = a.n / Vec<T>::N;
  const unsigned blocks = nvec ? (nvec + per_block - 1) / per_block : 1;
  abn_eval_kernel<T, CL, RES><<<blocks, THREADS, 2 * a.C * sizeof(float),
                                static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, bool channels_last, void* stream) {
  if (channels_last)
    return a.r ? launch<T, true, true>(a, stream) : launch<T, true, false>(a, stream);
  return a.r ? launch<T, false, true>(a, stream) : launch<T, false, false>(a, stream);
}

}  // namespace

extern "C" {

// y = act(x * scale[c] + shift[c] (+ r)) over n values of x (bf16 when bf16
// is 1, else f32), contiguous NCHW with planes of inner = H W values, or
// channels_last (inner 1); r (null: none)
// and y of x's layout and type; x, r, y 16-byte aligned; w, b, mean, var
// (C,) f32; act 0 identity, 1 ReLU, 2 leaky-ReLU(slope). Returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
int abn_eval(const void* x, const void* r, void* y, const void* w, const void* b,
             const void* mean, const void* var, float eps, float slope, long long n, int C,
             int inner, int bf16, int channels_last, int act, void* stream) {
  const int V = bf16 ? 8 : 4;
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)r % 16 == 0 &&
                       (uintptr_t)y % 16 == 0;
  if (n < 1 || n >= (1ll << 31) || C < 1 || C > MAX_C || inner < 1 ||
      n % ((long long)C * inner) != 0 || !aligned || act < IDENTITY || act > LEAKY ||
      (channels_last && inner != 1) || !w || !b || !mean || !var)
    return (int)cudaErrorInvalidValue;
  Args a{x, r, y, static_cast<const float*>(w), static_cast<const float*>(b),
         static_cast<const float*>(mean), static_cast<const float*>(var), eps, slope,
         (unsigned)n, (unsigned)C, (unsigned)inner, make_div(inner), make_div(C), act};
  const bool by_vector = channels_last && C % V == 0;  // else planes of one value
  return (int)(bf16 ? dispatch<__nv_bfloat16>(a, by_vector, stream)
                    : dispatch<float>(a, by_vector, stream));
}

}  // extern "C"
