// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dinov3_tpu/ops/fused_norm.py `_ln_2d_fwd` (body
// `_fwd_kernel`): per row of x [R, D], mean in fp32, then the mean of the
// squared centred values (the reference's two-pass `_stats`, not
// E[x^2] - E[x]^2), rstd = rsqrt(var + eps), and
// y = (x - mean) * rstd * scale + bias written once in x's dtype. scale and
// bias are upcast to fp32.
//
// What bounds it: it moves 2*R*D elements and does ~8 flops per element,
// far below the card's operations-per-byte line, so it is bound by device
// memory bytes (at the serve shape [8200, 1024] bf16: 33.6 MB).
//
// What the design does about it:
// - The vector path (D a multiple of one 16-byte vector, 8 bf16 or 4 fp32
//   values; 16-byte aligned pointers; D <= 2048): one warp per row, 8 warps
//   a CTA, a grid sized to the card's resident CTAs that walks the rows by
//   grid stride. Each lane loads its part of the row with 16-byte loads
//   (at D = 1024 in bf16, 4 vectors a lane) and keeps it in registers;
//   both reductions are warp shuffles, with no shared memory and no
//   barrier; y leaves in 16-byte stores. Each lane loads its scale and
//   bias vectors once and reuses them for every row its warp handles.
// - The general path (any other width up to 4096, or misaligned
//   pointers): one CTA of 256 threads per row, scalar loads at a stride of
//   256, CTA-wide reductions through shared memory.
// Both read every element once and write y once, the least the function
// allows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------- vector path

constexpr int kVecThreads = 256;  // 8 rows in flight a CTA

// n consecutive values at p (16-byte aligned for 16 bytes, 8 for 8) as fp32.
template <int n>
__device__ __forceinline__ void load_vals(const float* p, float (&f)[n]) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = u.x;
    f[i + 1] = u.y;
    f[i + 2] = u.z;
    f[i + 3] = u.w;
  }
}

template <int n>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float (&f)[n]) {
  static_assert(n == 4 || n == 8, "bf16 groups are 4 or 8 values");
  uint32_t w[n / 2];
  if constexpr (n == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x, w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store_vals(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_vals(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&t);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// kVecs: 16-byte vectors of x each lane holds for one row (vector v of the
// row is held by lane v % 32, slot v / 32).
template <typename T, typename P, int kVecs>
__global__ void __launch_bounds__(kVecThreads)
    layernorm_fwd_vec(const T* __restrict__ x, const P* __restrict__ scale,
                      const P* __restrict__ bias, T* __restrict__ y, long long R, int D,
                      float eps) {
  constexpr int kEpv = 16 / sizeof(T);  // values in one vector
  const int lane = threadIdx.x & 31;
  const int nvec = D / kEpv;
  float sc[kVecs][kEpv], bi[kVecs][kEpv];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < kEpv; ++e) sc[i][e] = bi[i][e] = 0.f;
    if (v < nvec) {
      load_vals(scale + v * kEpv, sc[i]);
      load_vals(bias + v * kEpv, bi[i]);
    }
  }
  const long long warps = static_cast<long long>(gridDim.x) * (kVecThreads / 32);
  for (long long row = static_cast<long long>(blockIdx.x) * (kVecThreads / 32) + (threadIdx.x >> 5);
       row < R; row += warps) {
    const T* xr = x + row * D;
    T* yr = y + row * D;
    float v[kVecs][kEpv];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = (lane + 32 * i) * kEpv;
      if (c < D) {
        load_vals(xr + c, v[i]);
#pragma unroll
        for (int e = 0; e < kEpv; ++e) sum += v[i][e];
      }
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if ((lane + 32 * i) * kEpv < D) {
#pragma unroll
        for (int e = 0; e < kEpv; ++e) {
          v[i][e] -= mean;
          sq += v[i][e] * v[i][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = (lane + 32 * i) * kEpv;
      if (c < D) {
        float out[kEpv];
#pragma unroll
        for (int e = 0; e < kEpv; ++e) out[e] = v[i][e] * rstd * sc[i][e] + bi[i][e];
        store_vals(yr + c, out);
      }
    }
  }
}

template <typename T, typename P, int kVecs>
cudaError_t launch_vec(const void* x, const void* s, const void* b, void* y, int R, int D,
                       float eps, cudaStream_t st) {
  // resident CTAs on the card, read once per instance
  static int max_ctas = 0;
  if (max_ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layernorm_fwd_vec<T, P, kVecs>,
                                                          kVecThreads, 0);
    if (err != cudaSuccess) return err;
    max_ctas = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (static_cast<long long>(R) + kVecThreads / 32 - 1) / (kVecThreads / 32);
  const int grid = static_cast<int>(need < max_ctas ? need : max_ctas);
  layernorm_fwd_vec<T, P, kVecs><<<grid, kVecThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const P*>(s), static_cast<const P*>(b),
      static_cast<T*>(y), R, D, eps);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_vec(int vecs, const void* x, const void* s, const void* b, void* y, int R,
                         int D, float eps, cudaStream_t st) {
  switch (vecs) {
    case 1: return launch_vec<T, P, 1>(x, s, b, y, R, D, eps, st);
    case 2: return launch_vec<T, P, 2>(x, s, b, y, R, D, eps, st);
    case 4: return launch_vec<T, P, 4>(x, s, b, y, R, D, eps, st);
    case 8: return launch_vec<T, P, 8>(x, s, b, y, R, D, eps, st);
    case 16:
      if constexpr (sizeof(T) == 4) return launch_vec<T, P, 16>(x, s, b, y, R, D, eps, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ general path

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 16;  // D <= 4096

// Sum over the CTA; every thread gets the total. `sh` holds one slot a warp.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += sh[w];
  __syncthreads();  // sh is reused by the next reduction
  return total;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    layernorm_fwd(const T* __restrict__ x, const P* __restrict__ scale,
                  const P* __restrict__ bias, T* __restrict__ y, int D, float eps) {
  __shared__ float sh[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;

  float v[kMaxPerThread];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = c < D ? load_f(xr + c) : 0.f;
    sum += v[i];
  }
  const float mean = block_sum(sum, sh) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < D) {
      v[i] -= mean;
      sq += v[i] * v[i];
    }
  }
  const float rstd = rsqrtf(block_sum(sq, sh) / D + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < D) store_f(yr + c, v[i] * rstd * load_f(scale + c) + load_f(bias + c));
  }
}

template <typename T, typename P>
cudaError_t launch(int vecs, const void* x, const void* s, const void* b, void* y, int R, int D,
                   float eps, cudaStream_t st) {
  if (vecs > 0) {
    constexpr int kEpv = 16 / sizeof(T);
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(s) |
          reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    if (D % kEpv || D / kEpv > 32 * vecs || !aligned) return cudaErrorInvalidValue;
    return dispatch_vec<T, P>(vecs, x, s, b, y, R, D, eps, st);
  }
  layernorm_fwd<T, P><<<R, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const P*>(s), static_cast<const P*>(b),
      static_cast<T*>(y), D, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y[R, D] = LayerNorm(x[R, D]) on `stream`; returns cudaGetLastError().
// x_dtype / p_dtype: 0 = fp32, 1 = bf16 (x and y share x_dtype; scale and
// bias share p_dtype). vecs: 0 takes the general path (D <= 4096); 1, 2,
// 4, 8 (or 16 for fp32 x) the vector path with that many 16-byte vectors
// a lane, which needs D a multiple of one vector, D <= 32 * vecs vectors
// and 16-byte aligned pointers.
int dinov3_layernorm_fwd(const void* x, const void* scale, const void* bias, void* y,
                         int R, int D, float eps, int x_dtype, int p_dtype, int vecs,
                         void* stream) {
  if (D < 1 || D > kThreads * kMaxPerThread || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 1 && p_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(vecs, x, scale, bias, y, R, D, eps, st);
  } else if (x_dtype == 1 && p_dtype == 0) {
    err = launch<__nv_bfloat16, float>(vecs, x, scale, bias, y, R, D, eps, st);
  } else if (x_dtype == 0 && p_dtype == 1) {
    err = launch<float, __nv_bfloat16>(vecs, x, scale, bias, y, R, D, eps, st);
  } else if (x_dtype == 0 && p_dtype == 0) {
    err = launch<float, float>(vecs, x, scale, bias, y, R, D, eps, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* dinov3_layernorm_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
