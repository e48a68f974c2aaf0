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
// about 12 flops per element, far below the card's operations-per-byte
// line: device memory bytes bound it (at the training shape [22852, 1024]
// bf16, 140 MB).
//
// What the design does: the TPU kernel carries dscale/dbias across its
// ordered grid; CUDA blocks run in no order, so the column sums take two
// passes. Pass 1: each CTA of 256 threads owns a fixed run of rows; per
// row it reads x and g once into registers (up to 16 values a thread,
// D <= 4096), reduces mean, variance and the two dx terms in fp32 through
// warp shuffles and one shared-memory exchange each, writes dx, and adds
// g * xhat and g into per-thread column sums in registers; at the end each
// CTA writes its fp32 partial row [D] of both sums. Pass 2: one thread per
// column adds the CTAs' partials in CTA order and writes dscale and dbias.
// The row runs and the summation order depend only on the shape, so two
// runs give the same bits. Both passes are one launch of this function.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 16;  // D <= 4096

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
  for (int w = 0; w < kThreads / 32; ++w) {
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
  __shared__ float2 sh[kThreads / 32];
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

// dscale[c] = sum_k part[k, c], dbias[c] = sum_k part[n_cta + k, c], in k
// order.
template <typename P>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_cols(const float* __restrict__ part, int n_cta, int D,
                       P* __restrict__ dscale, P* __restrict__ dbias) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < n_cta; ++k) {
    a += part[static_cast<long long>(k) * D + c];
    b += part[static_cast<long long>(n_cta + k) * D + c];
  }
  store_f(dscale + c, a);
  store_f(dbias + c, b);
}

template <typename T, typename P>
void launch(const void* x, const void* s, const void* g, void* dx, void* ds, void* db,
            float* part, int R, int D, int n_cta, int rows_per_cta, float eps,
            cudaStream_t st) {
  layernorm_bwd_rows<T, P><<<n_cta, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const P*>(s), static_cast<const T*>(g),
      static_cast<T*>(dx), part, R, D, rows_per_cta, eps);
  layernorm_bwd_cols<P><<<(D + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, n_cta, D, static_cast<P*>(ds), static_cast<P*>(db));
}

}  // namespace

extern "C" {

// dx [R, D], dscale and dbias [D] of y = LayerNorm(x) given dy = g, on
// `stream`; returns cudaGetLastError(). x_dtype / p_dtype: 0 = fp32,
// 1 = bf16 (x, g and dx share x_dtype; scale, dscale and dbias p_dtype).
// `part` is fp32 scratch of 2 * n_cta * D; CTA k takes rows
// [k * rows_per_cta, (k + 1) * rows_per_cta). D must be at most 4096.
int dinov3_layernorm_bwd(const void* x, const void* scale, const void* g, void* dx,
                         void* dscale, void* dbias, float* part, int R, int D,
                         int n_cta, int rows_per_cta, float eps, int x_dtype,
                         int p_dtype, void* stream) {
  if (D < 1 || D > kThreads * kMaxPerThread || R < 1 || n_cta < 1 ||
      static_cast<long long>(n_cta) * rows_per_cta < R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && p_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, g, dx, dscale, dbias, part, R, D, n_cta,
                                         rows_per_cta, eps, st);
  } else if (x_dtype == 1 && p_dtype == 0) {
    launch<__nv_bfloat16, float>(x, scale, g, dx, dscale, dbias, part, R, D, n_cta,
                                 rows_per_cta, eps, st);
  } else if (x_dtype == 0 && p_dtype == 1) {
    launch<float, __nv_bfloat16>(x, scale, g, dx, dscale, dbias, part, R, D, n_cta,
                                 rows_per_cta, eps, st);
  } else if (x_dtype == 0 && p_dtype == 0) {
    launch<float, float>(x, scale, g, dx, dscale, dbias, part, R, D, n_cta, rows_per_cta,
                         eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dinov3_layernorm_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
