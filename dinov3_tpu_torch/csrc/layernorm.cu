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
// What the design does about it: one CTA of 256 threads per row reads the
// row once into registers (up to 16 values a thread, D <= 4096), reduces
// the sum and then the centred sum of squares in fp32 through warp shuffles
// and one shared-memory exchange, and writes y once: one read and one write
// of every element, the least the function allows. Row tails need no
// masking because every CTA owns exactly one row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 16;  // D <= 4096

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sum over the CTA; every thread gets the total. `sh` holds one slot a warp.
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
void launch(const void* x, const void* s, const void* b, void* y, int R, int D, float eps,
            cudaStream_t st) {
  layernorm_fwd<T, P><<<R, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const P*>(s), static_cast<const P*>(b),
      static_cast<T*>(y), D, eps);
}

}  // namespace

extern "C" {

// y[R, D] = LayerNorm(x[R, D]) on `stream`; returns cudaGetLastError().
// x_dtype / p_dtype: 0 = fp32, 1 = bf16 (x and y share x_dtype; scale and
// bias share p_dtype). D must be at most 4096.
int dinov3_layernorm_fwd(const void* x, const void* scale, const void* bias, void* y,
                         int R, int D, float eps, int x_dtype, int p_dtype, void* stream) {
  if (D < 1 || D > kThreads * kMaxPerThread || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && p_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, y, R, D, eps, st);
  } else if (x_dtype == 1 && p_dtype == 0) {
    launch<__nv_bfloat16, float>(x, scale, bias, y, R, D, eps, st);
  } else if (x_dtype == 0 && p_dtype == 1) {
    launch<float, __nv_bfloat16>(x, scale, bias, y, R, D, eps, st);
  } else if (x_dtype == 0 && p_dtype == 0) {
    launch<float, float>(x, scale, bias, y, R, D, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dinov3_layernorm_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
