// Row LayerNorm backward for Hopper (sm_90a).
//
// Replaces the TPU kernel dinov3_tpu/ops/fused_norm.py `_ln_2d_bwd` (body
// `_bwd_kernel`). Per row of x [R, D] and its output gradient g [R, D], with
// the statistics recomputed from x in the forward's two-pass order (mean,
// then the mean of squared centred values; nothing is saved by the forward):
//   xhat = (x - mean) * rstd,  gs = g * scale
//   dx   = rstd * (gs - mean(gs) - xhat * mean(gs * xhat))
//   dscale = sum over rows of g * xhat,  dbias = sum over rows of g
// in fp32, dx written in x's dtype and dscale/dbias in scale's dtype.
//
// What bounds it: it reads x and g and writes dx (3 * R * D elements) with
// about 14 flops per element, far below the card's operations-per-byte
// line: device memory bytes bound it (at a student block's norm, [15957,
// 1024] bf16, 98 MB: 0.029 ms at 3.35 TB/s).
//
// What the design does: the TPU kernel carries dscale/dbias across its
// ordered grid; CUDA blocks run in no order, so the column sums take two
// passes, both launched by one call.
// - Row pass, vector path (D a whole number of 16-byte vectors, D <= 2048,
//   16-byte aligned x, g and dx; chosen in Python): one warp a row, 8 rows
//   of a CTA in flight, a fixed grid of CTAs each over a fixed contiguous
//   run of rows. A lane reads its 16-byte vectors of x and g (at D = 1024
//   bf16, 4 each) and keeps them in registers; mean, variance and the pair
//   (sum gs, sum gs * xhat) are reduced by warp shuffles alone, with no
//   barrier in the row loop; dx is written as 16-byte vectors. A lane owns
//   the same columns in every row, so it adds g * xhat and g over its
//   warp's rows without any exchange, in a per-warp fp32 strip of shared
//   memory laid out so that each quarter warp's 16-byte accesses cover 128
//   contiguous bytes (no bank conflicts): 8 KB a warp at D = 1024, 80
//   registers a thread, two CTAs an SM. (Keeping the sums in registers,
//   64 a lane at D = 1024, took the 128 registers that two CTAs an SM
//   allow and was slower.) At the end the CTA adds its 8 warps' strips in
//   warp order into one fp32 partial row of each sum.
// - Row pass, general path (every other width up to 4096): the body of the
//   first port, one row at a time per CTA of 256 threads with block-wide
//   reductions, per-thread column sums in registers.
// - Column pass: one CTA of 8 warps per 32 columns; warp w adds the
//   partials of CTAs w, w + 8, ... in order, and warp 0 folds the 8 warp
//   sums in order.
// The row runs and every summation order depend only on the shape, so two
// runs give the same bits; nothing is atomic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;  // general path: D <= 4096

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ------------------------------------------------ general path (row pass)

// Sums (a, b) over the CTA; every thread gets the totals. `sh` holds one
// slot pair a warp.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    total.x += sh[w].x;
    total.y += sh[w].y;
  }
  __syncthreads();  // sh is reused by the next reduction
  return total;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_rows(const T* __restrict__ x, const P* __restrict__ scale,
                       const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                       int R, int D, int rows_per_cta, float eps) {
  __shared__ float2 sh[kWarps];
  const int row0 = blockIdx.x * rows_per_cta;
  const int row1 = min(R, row0 + rows_per_cta);

  float s[kMaxPerThread], ds[kMaxPerThread], db[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    s[i] = c < D ? load_f(scale + c) : 0.f;
    ds[i] = db[i] = 0.f;
  }
  for (int row = row0; row < row1; ++row) {
    const T* xr = x + static_cast<long long>(row) * D;
    const T* gr = g + static_cast<long long>(row) * D;
    float xv[kMaxPerThread], gv[kMaxPerThread];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      xv[i] = c < D ? load_f(xr + c) : 0.f;
      gv[i] = c < D ? load_f(gr + c) : 0.f;
      sum += xv[i];
    }
    const float mean = block_sum2(sum, 0.f, sh).x / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < D) {
        xv[i] -= mean;
        sq += xv[i] * xv[i];
      }
    }
    const float rstd = rsqrtf(block_sum2(sq, 0.f, sh).x / D + eps);
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      xv[i] *= rstd;  // xhat (0 past D)
      const float gs = gv[i] * s[i];
      c1 += gs;
      c2 += gs * xv[i];
    }
    const float2 cs = block_sum2(c1, c2, sh);
    const float m1 = cs.x / D, m2 = cs.y / D;
    T* dxr = dx + static_cast<long long>(row) * D;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < D) {
        store_f(dxr + c, rstd * (gv[i] * s[i] - m1 - xv[i] * m2));
        ds[i] += gv[i] * xv[i];
        db[i] += gv[i];
      }
    }
  }
  float* pds = part + static_cast<long long>(blockIdx.x) * D;
  float* pdb = part + (static_cast<long long>(gridDim.x) + blockIdx.x) * D;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < D) {
      pds[c] = ds[i];
      pdb[c] = db[i];
    }
  }
}

// ------------------------------------------------- vector path (row pass)

// Values of x's dtype in one 16-byte vector.
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
};
template <>
struct Vec<float> {
  static constexpr int kN = 4;
};

__device__ __forceinline__ void to_f32(const uint4& u, float (&f)[8]) {  // 8 bf16
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void to_f32(const uint4& u, float (&f)[4]) {  // 4 fp32
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint4 from_f32(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ uint4 from_f32(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A lane holds values j of its vectors i, i.e. columns (32 i + lane) kN + j.
// Their shared-memory slot (in the staged scale and in the sum strips) is
// [i][j / 4][lane][j % 4]: the four values of one 16-byte access are
// contiguous, and a quarter warp's accesses cover 128 contiguous bytes.
template <int kN>
__device__ __forceinline__ int slot(int i, int j, int lane) {
  return ((i * (kN / 4) + j / 4) * 32 + lane) * 4 + (j & 3);
}
template <int kN>
__device__ __forceinline__ int column_slot(int c) {
  const int v = c / kN;
  return slot<kN>(v >> 5, c % kN, v & 31);
}

// Shared memory of the vector path: the staged scale, then one strip a
// warp of the two column sums.
template <int kVpl, int kN>
__host__ __device__ constexpr int vec_smem_floats() {
  return 32 * kVpl * kN * (1 + 2 * kWarps);
}

template <typename T, int kVpl>
__global__ void __launch_bounds__(kThreads, 2)
    layernorm_bwd_vec(const T* __restrict__ x, const void* __restrict__ scale, int p_bf16,
                      const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
                      int R, int D, int rows_per_cta, float eps) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kSlots = 32 * kVpl * kN;  // a row padded to whole lane vectors
  extern __shared__ float4 smem4[];
  float* s_scale = reinterpret_cast<float*>(smem4);
  float* s_sum = s_scale + kSlots;  // warp w's strip: [2][kSlots] at 2 w kSlots
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_vec = D / kN;

  // scale staged as fp32 in slot order, the strips zeroed; the one barrier
  // before the row loop
  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    const int e = s & 3, ln = (s >> 2) & 31, rest = s >> 7;
    const int c = ((rest / (kN / 4)) * 32 + ln) * kN + (rest % (kN / 4)) * 4 + e;
    float v = 0.f;
    if (c < D)
      v = p_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[c])
                 : static_cast<const float*>(scale)[c];
    s_scale[s] = v;
  }
  for (int s = threadIdx.x; s < 2 * kWarps * kSlots; s += kThreads) s_sum[s] = 0.f;
  __syncthreads();
  float* strip_ds = s_sum + warp * 2 * kSlots;
  float* strip_db = strip_ds + kSlots;

  const int row1 = min(R, (blockIdx.x + 1) * rows_per_cta);
  for (int row = blockIdx.x * rows_per_cta + warp; row < row1; row += kWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * D);
    const uint4* gr = reinterpret_cast<const uint4*>(g + static_cast<long long>(row) * D);
    uint4 xv[kVpl], gv[kVpl];
#pragma unroll
    for (int i = 0; i < kVpl; ++i) {
      const int v = 32 * i + lane;
      xv[i] = gv[i] = make_uint4(0u, 0u, 0u, 0u);  // zero bits are 0.0f
      if (v < n_vec) {
        xv[i] = __ldg(xr + v);
        gv[i] = __ldg(gr + v);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVpl; ++i) {
      float f[kN];
      to_f32(xv[i], f);
#pragma unroll
      for (int j = 0; j < kN; ++j) sum += f[j];
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVpl; ++i) {
      if (32 * i + lane < n_vec) {
        float f[kN];
        to_f32(xv[i], f);
#pragma unroll
        for (int j = 0; j < kN; ++j) sq += (f[j] - mean) * (f[j] - mean);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVpl; ++i) {
      if (32 * i + lane < n_vec) {
        float xf[kN], gf[kN];
        to_f32(xv[i], xf);
        to_f32(gv[i], gf);
#pragma unroll
        for (int j4 = 0; j4 < kN; j4 += 4) {
          const float4 s4 = *reinterpret_cast<const float4*>(s_scale + slot<kN>(i, j4, lane));
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gs = gf[j4 + e] * sv[e];
            c1 += gs;
            c2 += gs * ((xf[j4 + e] - mean) * rstd);
          }
        }
      }
    }
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    const float m1 = c1 / D, m2 = c2 / D;
    uint4* dxr = reinterpret_cast<uint4*>(dx + static_cast<long long>(row) * D);
#pragma unroll
    for (int i = 0; i < kVpl; ++i) {
      if (32 * i + lane < n_vec) {
        float xf[kN], gf[kN], out[kN];
        to_f32(xv[i], xf);
        to_f32(gv[i], gf);
#pragma unroll
        for (int j4 = 0; j4 < kN; j4 += 4) {
          const int sl = slot<kN>(i, j4, lane);
          const float4 s4 = *reinterpret_cast<const float4*>(s_scale + sl);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          float a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xh = (xf[j4 + e] - mean) * rstd;
            out[j4 + e] = rstd * (gf[j4 + e] * sv[e] - m1 - xh * m2);
            a[e] = gf[j4 + e] * xh;
          }
          float4* pa = reinterpret_cast<float4*>(strip_ds + sl);
          float4* pb = reinterpret_cast<float4*>(strip_db + sl);
          float4 ta = *pa, tb = *pb;
          ta.x += a[0];
          ta.y += a[1];
          ta.z += a[2];
          ta.w += a[3];
          tb.x += gf[j4];
          tb.y += gf[j4 + 1];
          tb.z += gf[j4 + 2];
          tb.w += gf[j4 + 3];
          *pa = ta;
          *pb = tb;
        }
        dxr[32 * i + lane] = from_f32(out);
      }
    }
  }

  // the CTA's partial rows: the warps' strips added in warp order
  __syncthreads();
  float* pds = part + static_cast<long long>(blockIdx.x) * D;
  float* pdb = part + (static_cast<long long>(gridDim.x) + blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const int sl = column_slot<kN>(c);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += s_sum[w * 2 * kSlots + sl];
      b += s_sum[w * 2 * kSlots + kSlots + sl];
    }
    pds[c] = a;
    pdb[c] = b;
  }
}

// ------------------------------------------------------------ column pass

// dscale[c] = sum_k part[k, c], dbias[c] = sum_k part[n_cta + k, c]: warp w
// of the CTA over 32 columns adds k = w, w + 8, ... in order, then warp 0
// adds the 8 warp sums in order.
template <typename P>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_cols(const float* __restrict__ part, int n_cta, int D,
                       P* __restrict__ dscale, P* __restrict__ dbias) {
  __shared__ float2 sh[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int k = warp; k < n_cta; k += kWarps) {
      a += part[static_cast<long long>(k) * D + c];
      b += part[static_cast<long long>(n_cta + k) * D + c];
    }
  }
  sh[warp][lane] = make_float2(a, b);
  __syncthreads();
  if (warp == 0 && c < D) {
    float2 t = sh[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      t.x += sh[w][lane].x;
      t.y += sh[w][lane].y;
    }
    store_f(dscale + c, t.x);
    store_f(dbias + c, t.y);
  }
}

// ----------------------------------------------------------------- launch

template <typename T, int kVpl>
cudaError_t launch_vec(const void* x, const void* s, int p_bf16, const void* g, void* dx,
                       float* part, int R, int D, int n_cta, int rows_per_cta, float eps,
                       cudaStream_t st) {
  constexpr size_t kSmem = sizeof(float) * vec_smem_floats<kVpl, Vec<T>::kN>();
  static bool configured = false;
  if (!configured && kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        layernorm_bwd_vec<T, kVpl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
  }
  configured = true;
  layernorm_bwd_vec<T, kVpl><<<n_cta, kThreads, kSmem, st>>>(
      static_cast<const T*>(x), s, p_bf16, static_cast<const T*>(g), static_cast<T*>(dx), part,
      R, D, rows_per_cta, eps);
  return cudaGetLastError();
}

// The row pass of the vector path, kVpl = vec vectors a lane.
template <typename T>
cudaError_t rows_vec(int vec, const void* x, const void* s, int p_bf16, const void* g, void* dx,
                     float* part, int R, int D, int n_cta, int rows_per_cta, float eps,
                     cudaStream_t st) {
  constexpr int kN = Vec<T>::kN;
  if (D % kN != 0 || D > 2048 || D > 32 * kN * vec) return cudaErrorInvalidValue;
  switch (vec) {
    case 1: return launch_vec<T, 1>(x, s, p_bf16, g, dx, part, R, D, n_cta, rows_per_cta, eps, st);
    case 2: return launch_vec<T, 2>(x, s, p_bf16, g, dx, part, R, D, n_cta, rows_per_cta, eps, st);
    case 4: return launch_vec<T, 4>(x, s, p_bf16, g, dx, part, R, D, n_cta, rows_per_cta, eps, st);
    case 8: return launch_vec<T, 8>(x, s, p_bf16, g, dx, part, R, D, n_cta, rows_per_cta, eps, st);
    case 16:
      if constexpr (kN == 4)
        return launch_vec<T, 16>(x, s, p_bf16, g, dx, part, R, D, n_cta, rows_per_cta, eps, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename P>
cudaError_t rows_general(const void* x, const void* s, const void* g, void* dx, float* part,
                         int R, int D, int n_cta, int rows_per_cta, float eps, cudaStream_t st) {
  layernorm_bwd_rows<T, P><<<n_cta, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const P*>(s), static_cast<const T*>(g),
      static_cast<T*>(dx), part, R, D, rows_per_cta, eps);
  return cudaGetLastError();
}

template <typename P>
cudaError_t cols(const float* part, int n_cta, int D, void* ds, void* db, cudaStream_t st) {
  layernorm_bwd_cols<P><<<(D + 31) / 32, kThreads, 0, st>>>(part, n_cta, D, static_cast<P*>(ds),
                                                           static_cast<P*>(db));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dx [R, D], dscale and dbias [D] of y = LayerNorm(x) given dy = g, on
// `stream`; returns cudaGetLastError(). x_dtype / p_dtype: 0 = fp32,
// 1 = bf16 (x, g and dx share x_dtype; scale, dscale and dbias p_dtype).
// `part` is fp32 scratch of 2 * n_cta * D; CTA k takes rows
// [k * rows_per_cta, (k + 1) * rows_per_cta). `vec` is the vector path's
// 16-byte vectors a lane (1, 2, 4, 8; 16 for fp32 x: D <= 2048, D a
// multiple of one vector, x, g and dx 16-byte aligned) or 0 for the
// general path (D <= 4096).
int dinov3_layernorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                         void* dscale, void* dbias, float* part, int R, int D,
                         int n_cta, int rows_per_cta, float eps, int x_dtype,
                         int p_dtype, int vec, void* stream) {
  if (D < 1 || D > kThreads * kMaxPerThread || R < 1 || n_cta < 1 || rows_per_cta < 1 ||
      static_cast<long long>(n_cta) * rows_per_cta < R || (x_dtype != 0 && x_dtype != 1) ||
      (p_dtype != 0 && p_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec) {
    err = x_dtype == 1
              ? rows_vec<__nv_bfloat16>(vec, x, scale, p_dtype, g, dx, part, R, D, n_cta,
                                        rows_per_cta, eps, st)
              : rows_vec<float>(vec, x, scale, p_dtype, g, dx, part, R, D, n_cta, rows_per_cta,
                                eps, st);
  } else if (x_dtype == 1) {
    err = p_dtype == 1 ? rows_general<__nv_bfloat16, __nv_bfloat16>(x, scale, g, dx, part, R, D,
                                                                     n_cta, rows_per_cta, eps, st)
                       : rows_general<__nv_bfloat16, float>(x, scale, g, dx, part, R, D, n_cta,
                                                            rows_per_cta, eps, st);
  } else {
    err = p_dtype == 1 ? rows_general<float, __nv_bfloat16>(x, scale, g, dx, part, R, D, n_cta,
                                                            rows_per_cta, eps, st)
                       : rows_general<float, float>(x, scale, g, dx, part, R, D, n_cta,
                                                    rows_per_cta, eps, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = p_dtype == 1 ? cols<__nv_bfloat16>(part, n_cta, D, dscale, dbias, st)
                     : cols<float>(part, n_cta, D, dscale, dbias, st);
  return static_cast<int>(err);
}

const char* dinov3_layernorm_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
