// Row normalisations for Hopper (sm_90a), float32 arithmetic, output in
// x's dtype:
//   layernorm: y = (x - mu) * rsqrt(var + eps) * gamma + beta, with
//              mu = sum(x) / D and the centred var = sum((x - mu)^2) / D
//   rmsnorm:   y = x * rsqrt(sum(x^2) / D + eps) * gamma
// x [R, D] in float32 or bfloat16; gamma / beta [D] in float32 or bfloat16
// (both the same), whatever x's dtype.
//
// Replaces: src/repro/kernels/layernorm.py `layernorm` and `rmsnorm` (the
// Pallas `_ln_kernel` / `_rms_kernel`): one row block whole in VMEM, the
// four passes of the paper's LN unit fused into one read and one write,
// the row padded to 128 lanes in HBM and the pad masked.
//
// Bound on the H100: bytes.  R x D is read once and written once, gamma and
// beta once, a few operations per element (128 x 1024 bf16: 0.5 MB, 0.16 us
// at 3.35 TB/s; 16384 x 1024: 67 MB, 20 us).
//
// Design: the row lives in registers.  A thread holds up to 4 units of a
// row as loaded, neighbouring lanes on neighbouring units, and widens each
// value to float32 where it is used: the sum, LayerNorm's centred second
// pass and the output all run over the registers, so the row is read from
// device memory once and written once.  A unit is 16 bytes (8 bf16 or 4
// float32 values, 16-byte loads and stores), or one element where the rows
// are not 16-byte aligned (D not a multiple of 16 bytes, an x, gamma or
// beta pointer off 16 bytes).  The launch plan (kernels/layernorm.py
// `norm_plan`) picks the layout from (R, D):
//   - rows of one warp (`norm_regs`, wpr = 1): a warp owns a row, the sums
//     are warp shuffles, no barrier at all;
//   - rows of wpr <= 16 warps (`norm_regs`, the CTA is one row group): the
//     warps' partial sums meet once per sum in shared memory;
//   - streaming (`norm_stream`): a CTA walks a row too wide for 16 warps'
//     registers; the centred pass and the output read it again, from L2.
// The grid is persistent: at most SMs x resident CTAs, each row group
// walking rows with a grid stride.  Gamma and beta are loaded into
// registers once per row group and kept across its rows, and a group
// issues its next row's loads before it reduces the current one, so two
// rows are in flight.  The kernel allocates nothing and reads nothing on
// the host; the wrapper hands it the plan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dtype.cuh"

namespace {

constexpr int kRowThreads = 512;     // norm_regs: at most 16 warps a CTA
constexpr int kStreamThreads = 512;  // norm_stream: at most 16 warps a CTA
constexpr int kMaxWarps = 16;
constexpr int kMaxUnits = 4;         // units a thread holds of a row

// float32 value k of 32-bit words holding E-typed values (little endian:
// the lower bf16 of a word is the lower address)
template <typename E>
__device__ __forceinline__ float word_elem(const uint32_t* w, int k) {
  if constexpr (sizeof(E) == 4) {
    return __uint_as_float(w[k]);
  } else {
    const uint32_t v = w[k >> 1];
    return __uint_as_float((k & 1) ? (v & 0xffff0000u) : (v << 16));
  }
}

// One unit of a row: 16 bytes of T (VEC) or a single T.
template <typename T, bool VEC>
struct Unit;

template <typename T>
struct Unit<T, true> {
  static constexpr int N = 16 / sizeof(T);
  uint32_t w[4];
  __device__ __forceinline__ void load(const T* p) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
  __device__ __forceinline__ float get(int k) const {
    return word_elem<T>(w, k);
  }
  __device__ __forceinline__ static void store(T* p, const float (&o)[N]) {
    uint32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (sizeof(T) == 4) {
        r[q] = __float_as_uint(o[q]);
      } else {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(o[2 * q], o[2 * q + 1]);
        r[q] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  }
};

template <typename T>
struct Unit<T, false> {
  static constexpr int N = 1;
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ float get(int) const { return to_f(v); }
  __device__ __forceinline__ static void store(T* p, const float (&o)[1]) {
    *p = from_f<T>(o[0]);
  }
};

// N parameter values from p[0, N) as float32: 16- or 8-byte loads (VEC:
// p 16-byte aligned at unit 0, so every unit's share is aligned), else one
// element.
template <typename P, int N, bool VEC>
__device__ __forceinline__ void load_params(const P* p, float (&f)[N]) {
  if constexpr (VEC) {
    constexpr int kWords = N * static_cast<int>(sizeof(P)) / 4;
    uint32_t w[kWords];
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int q = 0; q < kWords / 4; ++q) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
        w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z,
        w[4 * q + 3] = v.w;
      }
    } else {
      static_assert(kWords == 2, "a unit's parameters are 8 or 16k bytes");
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = word_elem<P>(w, k);
  } else {
    f[0] = to_f(p[0]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;   // the xor butterfly leaves the same bits in every lane
}

// Sum over the row's `warps` warps (the whole CTA when warps > 1); every
// thread gets the total, the warps' partials added in warp order.  `red`
// alternates between its two halves (`phase`), so one barrier per sum
// suffices: a half is written again only after the next sum's barrier,
// which every thread reaches after reading it.
__device__ __forceinline__ float row_sum(float v, float (*red)[kMaxWarps],
                                         int warps, int& phase) {
  v = warp_sum(v);
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[phase][threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < warps; ++w) t += red[phase][w];
  phase ^= 1;
  return t;
}

// The row's units this thread holds: unit t + j * tpr for j < NU, where it
// lies inside the row.
template <typename T, bool VEC, int NU>
__device__ __forceinline__ void load_row(Unit<T, VEC> (&dst)[NU],
                                         const T* xr, int t, int tpr,
                                         int units) {
  constexpr int N = Unit<T, VEC>::N;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = t + j * tpr;
    if (u < units) dst[j].load(xr + static_cast<size_t>(u) * N);
  }
}

// One row held in registers (units t + j * tpr of it, NU a thread):
// sum, LayerNorm's centred pass, then the normalised units stored to yr.
template <bool RMS, typename T, bool VEC, int NU, int N, int NB>
__device__ __forceinline__ void norm_row(const Unit<T, VEC> (&x)[NU],
                                         const float (&g)[NU][N],
                                         const float (&b)[NB][N], T* yr,
                                         int t, int tpr, int units, float d,
                                         float eps, float (*red)[kMaxWarps],
                                         int wpr, int& phase) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    if (t + j * tpr < units) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = x[j].get(k);
        s += RMS ? v * v : v;
      }
    }
  }
  s = row_sum(s, red, wpr, phase);
  float mu = 0.f, r;
  if constexpr (RMS) {
    r = rsqrtf(s / d + eps);
  } else {
    mu = s / d;
    float c2 = 0.f;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      if (t + j * tpr < units) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float c = x[j].get(k) - mu;
          c2 += c * c;
        }
      }
    }
    r = rsqrtf(row_sum(c2, red, wpr, phase) / d + eps);
  }
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = t + j * tpr;
    if (u < units) {
      float o[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = x[j].get(k);
        if constexpr (RMS) {
          o[k] = v * r * g[j][k];
        } else {
          o[k] = (v - mu) * r * g[j][k] + b[j][k];
        }
      }
      Unit<T, VEC>::store(yr + static_cast<size_t>(u) * N, o);
    }
  }
}

// Register layouts: a row group of wpr warps owns a row, a CTA holds
// blockDim / (32 wpr) groups (one when wpr > 1); NU units a thread, of
// 16 bytes (VEC) or one element.  At most 128 registers a thread, as
// __launch_bounds__(256, 2) would give: two CTAs of 256 threads on an SM.
template <typename T, typename P, bool RMS, bool VEC, int NU>
__global__ void __launch_bounds__(kRowThreads, 1)
    norm_regs(const T* __restrict__ x, const P* __restrict__ gamma,
              const P* __restrict__ beta, T* __restrict__ y, int R, int D,
              int wpr, float eps) {
  using U = Unit<T, VEC>;
  constexpr int N = U::N;
  __shared__ float red[2][kMaxWarps];
  const int warp = threadIdx.x >> 5;
  const int groups = (blockDim.x >> 5) / wpr;
  const int tpr = wpr * 32;
  const int t = (warp % wpr) * 32 + (threadIdx.x & 31);
  const int units = D / N;
  const float d = static_cast<float>(D);

  float g[NU][N], b[RMS ? 1 : NU][N];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = t + j * tpr;
    if (u < units) {
      load_params<P, N, VEC>(gamma + static_cast<size_t>(u) * N, g[j]);
      if constexpr (!RMS)
        load_params<P, N, VEC>(beta + static_cast<size_t>(u) * N, b[j]);
    }
  }

  const size_t stride = static_cast<size_t>(gridDim.x) * groups;
  size_t row = static_cast<size_t>(blockIdx.x) * groups + warp / wpr;
  const size_t rows = static_cast<size_t>(R);
  // two row buffers in turn: the next row's loads go out before the
  // current row is reduced, so two rows are in flight at every wait
  U a[NU], c[NU];
  if (row < rows) load_row(a, x + row * D, t, tpr, units);
  int phase = 0;
  for (; row < rows; row += 2 * stride) {
    if (row + stride < rows)
      load_row(c, x + (row + stride) * D, t, tpr, units);
    norm_row<RMS>(a, g, b, y + row * D, t, tpr, units, d, eps, red, wpr,
                  phase);
    if (row + stride >= rows) break;
    if (row + 2 * stride < rows)
      load_row(a, x + (row + 2 * stride) * D, t, tpr, units);
    norm_row<RMS>(c, g, b, y + (row + stride) * D, t, tpr, units, d, eps,
                  red, wpr, phase);
  }
}

// Streaming: a CTA per row (grid stride), units of 16 bytes (VEC) or one
// element; the centred pass and the output read the row again (from L2).
template <typename T, typename P, bool RMS, bool VEC>
__global__ void __launch_bounds__(kStreamThreads, 2)
    norm_stream(const T* __restrict__ x, const P* __restrict__ gamma,
                const P* __restrict__ beta, T* __restrict__ y, int R, int D,
                float eps) {
  using U = Unit<T, VEC>;
  constexpr int N = U::N;
  __shared__ float red[2][kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int units = D / N;
  const float d = static_cast<float>(D);
  int phase = 0;
  for (size_t row = blockIdx.x; row < static_cast<size_t>(R);
       row += gridDim.x) {
    const T* xr = x + row * D;
    T* yr = y + row * D;
    float s = 0.f;
#pragma unroll 4
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      U a;
      a.load(xr + static_cast<size_t>(u) * N);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = a.get(k);
        s += RMS ? v * v : v;
      }
    }
    s = row_sum(s, red, warps, phase);
    float mu = 0.f, r;
    if constexpr (RMS) {
      r = rsqrtf(s / d + eps);
    } else {
      mu = s / d;
      float c2 = 0.f;
#pragma unroll 4
      for (int u = threadIdx.x; u < units; u += blockDim.x) {
        U a;
        a.load(xr + static_cast<size_t>(u) * N);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float c = a.get(k) - mu;
          c2 += c * c;
        }
      }
      r = rsqrtf(row_sum(c2, red, warps, phase) / d + eps);
    }
#pragma unroll 2
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const size_t off = static_cast<size_t>(u) * N;
      U a;
      a.load(xr + off);
      float g[N], b[N], o[N];
      load_params<P, N, VEC>(gamma + off, g);
      if constexpr (!RMS) load_params<P, N, VEC>(beta + off, b);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = a.get(k);
        o[k] = RMS ? v * r * g[k] : (v - mu) * r * g[k] + b[k];
      }
      U::store(yr + off, o);
    }
  }
}

// layout codes shared with kernels/layernorm.py (`layout_code`): a
// register layout or streaming, in 16-byte units or element by element
enum Layout { kRegs = 0, kStream = 1, kRegsScalar = 2, kStreamScalar = 3 };

template <typename T, typename P, bool RMS, bool VEC>
cudaError_t launch_regs(const T* x, const P* g, const P* b, T* y, int R,
                        int D, int nu, int wpr, int threads, int grid,
                        float eps, cudaStream_t s) {
  // a plan that leaves a unit of the row uncovered, or mixes row groups
  // with a CTA-wide barrier, is refused rather than run
  constexpr int N = Unit<T, VEC>::N;
  const int warps = threads / 32;
  if (threads > kRowThreads || wpr < 1 || D % N ||
      (wpr > 1 && warps != wpr) || warps % wpr || D / N > nu * 32 * wpr)
    return cudaErrorInvalidValue;
  switch (nu) {
    case 1: norm_regs<T, P, RMS, VEC, 1><<<grid, threads, 0, s>>>(
                x, g, b, y, R, D, wpr, eps); break;
    case 2: norm_regs<T, P, RMS, VEC, 2><<<grid, threads, 0, s>>>(
                x, g, b, y, R, D, wpr, eps); break;
    case 4: norm_regs<T, P, RMS, VEC, kMaxUnits><<<grid, threads, 0, s>>>(
                x, g, b, y, R, D, wpr, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename P, bool RMS>
cudaError_t launch(const void* xv, const void* gv, const void* bv, void* yv,
                   int R, int D, int layout, int nu, int wpr, int threads,
                   int grid, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const P* g = static_cast<const P*>(gv);
  const P* b = static_cast<const P*>(bv);
  T* y = static_cast<T*>(yv);
  constexpr int N = 16 / sizeof(T);
  if (grid <= 0 || threads <= 0 || threads % 32) return cudaErrorInvalidValue;
  if (layout == kRegs)
    return launch_regs<T, P, RMS, true>(x, g, b, y, R, D, nu, wpr, threads,
                                        grid, eps, s);
  if (layout == kRegsScalar)
    return launch_regs<T, P, RMS, false>(x, g, b, y, R, D, nu, wpr, threads,
                                         grid, eps, s);
  if (threads > kStreamThreads) {
    return cudaErrorInvalidValue;
  } else if (layout == kStream) {
    if (D % N) return cudaErrorInvalidValue;
    norm_stream<T, P, RMS, true><<<grid, threads, 0, s>>>(x, g, b, y, R, D,
                                                          eps);
  } else if (layout == kStreamScalar) {
    norm_stream<T, P, RMS, false><<<grid, threads, 0, s>>>(x, g, b, y, R, D,
                                                           eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool RMS>
int dispatch(const void* x, const void* gamma, const void* beta, void* y,
             int R, int D, int dtype, int p_dtype, int layout, int nu,
             int wpr, int threads, int grid, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || D <= 0) return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
#define REPRO_NORM(T, P)                                                   \
  return launch<T, P, RMS>(x, gamma, beta, y, R, D, layout, nu, wpr,     \
                           threads, grid, eps, s)
  if (dtype == 0 && p_dtype == 0) REPRO_NORM(float, float);
  if (dtype == 0 && p_dtype == 1) REPRO_NORM(float, bf16);
  if (dtype == 1 && p_dtype == 0) REPRO_NORM(bf16, float);
  if (dtype == 1 && p_dtype == 1) REPRO_NORM(bf16, bf16);
#undef REPRO_NORM
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype / p_dtype: 0 = float32, 1 = bfloat16 (x and y share dtype; gamma
// and beta share p_dtype).  layout, nu, wpr, threads, grid: the launch
// plan of kernels/layernorm.py `norm_plan`.
extern "C" int layernorm(const void* x, const void* gamma, const void* beta,
                         void* y, int R, int D, int dtype, int p_dtype,
                         int layout, int nu, int wpr, int threads, int grid,
                         float eps, void* stream) {
  return dispatch<false>(x, gamma, beta, y, R, D, dtype, p_dtype, layout, nu,
                         wpr, threads, grid, eps, stream);
}

extern "C" int rmsnorm(const void* x, const void* gamma, void* y, int R,
                       int D, int dtype, int p_dtype, int layout, int nu,
                       int wpr, int threads, int grid, float eps,
                       void* stream) {
  return dispatch<true>(x, gamma, nullptr, y, R, D, dtype, p_dtype, layout,
                        nu, wpr, threads, grid, eps, stream);
}
