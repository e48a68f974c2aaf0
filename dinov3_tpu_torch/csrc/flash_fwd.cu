// Flash-attention forward with segment ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel dinov3_tpu/ops/flash_attention.py `_flash_fwd`
// (body `_fwd_kernel`): non-causal attention with an online softmax that
// writes O in the input dtype and the row log-sum-exp (LSE) in fp32.
// Token q attends token k iff k < N and, when segment ids are given,
// seg[b, q] == seg[b, k]. Masked logits take -1e30, as in the reference,
// and the running max starts there, so a row whose first key tiles are all
// masked is wiped by the first real logit (every real token matches itself).
//
// What bounds it: at the serve shapes ([4 rows x 16 heads, 2050, 64] bf16)
// the dense work is 4*B*h*N^2*d = 68.9 GFLOP against 2 MB of q/k/v per
// head-row, so the kernel is bound by tensor-core operations, not bytes.
//
// What the design does about it:
// - bf16: FlashAttention-2 on `mma.sync.m16n8k16` (fp32 accumulate). One
//   CTA of 4 warps per (64-row q tile, head, batch row); each warp owns 16
//   q rows whose Q fragments stay in registers. K and V tiles of 64 keys
//   are staged through padded shared memory (row pitch d+8 halves, so the
//   fragment loads are bank-conflict free). S = Q K^T, the masked online
//   softmax and O += P V all stay in registers; P is rounded to bf16 for
//   the second product, the running max, sum and O accumulator are fp32.
// - fp32: one thread per q row with the row of q and the accumulator in
//   registers, K/V tiles of 32 keys in shared memory, scalar FMAs. It keeps
//   the reference's order (q scaled in fp32 before the dot product).
// - q, k, v are read in the [B, N, h, d] layout the qkv projection makes,
//   through their strides (v may be a view of the fused qkv output), and O
//   is written as [B, N, h, d], so no head transposes are needed. Segment
//   ids are read once per batch row as [B, N] int32 (b = the CTA's batch
//   index), not as a per-head broadcast copy. The ragged edge (N not a
//   multiple of the tile) is masked in the kernel; nothing is padded on the
//   host.
// Later work (not here): wgmma + TMA pipelining, and skipping the K tiles
// whose segment ids cannot match any of the q tile's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // [B, N] int32, or nullptr
  void* o;         // [B, N, H, D] contiguous, input dtype
  float* lse;      // [B, H, N] contiguous fp32
  int B, N, H;
  long long q_sb, q_sn, q_sh;  // element strides of q, k, v (last dim 1)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  float scale;
};

// ---------------------------------------------------------------- bf16 path

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) of one head of a [*, N, *, D] bf16 tensor into
// shared memory with row pitch LD; rows past N are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile(uint16_t* s, const uint16_t* base,
                                          long long sn, int row0, int N) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int n = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) val = *reinterpret_cast<const uint4*>(base + n * sn + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Args a) {
  constexpr int kBQ = 64, kBK = 64, LD = D + 8;
  __shared__ __align__(16) uint16_t sK[kBK * LD];
  __shared__ __align__(16) uint16_t sV[kBK * LD];
  __shared__ int sSeg[kBK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.N;
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;

  // Q tile staged through sK, then kept as A fragments in registers.
  load_tile<D, LD>(sK, qb, a.q_sn, q0, N);
  __syncthreads();
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint16_t* p = sK + kc * 16 + 2 * t;
    qf[kc][0] = ld_pair(p + r_lo * LD);
    qf[kc][1] = ld_pair(p + r_hi * LD);
    qf[kc][2] = ld_pair(p + r_lo * LD + 8);
    qf[kc][3] = ld_pair(p + r_hi * LD + 8);
  }
  __syncthreads();

  const int n_lo = q0 + r_lo, n_hi = q0 + r_hi;
  // rows past N get id -2, which matches no key (keys carry >= -1)
  int sq_lo = -2, sq_hi = -2;
  if (segb) {
    if (n_lo < N) sq_lo = segb[n_lo];
    if (n_hi < N) sq_hi = segb[n_hi];
  }
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    load_tile<D, LD>(sK, kb, a.k_sn, k0, N);
    load_tile<D, LD>(sV, vb, a.v_sn, k0, N);
    if (threadIdx.x < kBK) {
      const int n = k0 + threadIdx.x;
      sSeg[threadIdx.x] = n < N ? (segb ? segb[n] : 0) : 0;
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint16_t* p = sK + (j * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[j], qf[kc], ld_pair(p), ld_pair(p + 8));
      }
    }

    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool in = k0 + col < N;
        const int sk = sSeg[col];
        float x_lo = s[j][e] * a.scale, x_hi = s[j][2 + e] * a.scale;
        if (!in || (segb && sk != sq_lo)) x_lo = kNegInf;
        if (!in || (segb && sk != sq_hi)) x_hi = kNegInf;
        s[j][e] = x_lo;
        s[j][2 + e] = x_hi;
        mx_lo = fmaxf(mx_lo, x_lo);
        mx_hi = fmaxf(mx_hi, x_hi);
      }
    }
    // the four threads of a quad share rows g and g + 8
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float alpha_lo = exp2f((m_lo - mx_lo) * kLog2e);
    const float alpha_hi = exp2f((m_hi - mx_hi) * kLog2e);
    m_lo = mx_lo;
    m_hi = mx_hi;

    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f((s[j][e] - m_lo) * kLog2e);
        s[j][2 + e] = exp2f((s[j][2 + e] - m_hi) * kLog2e);
        rs_lo += s[j][e];
        rs_hi += s[j][2 + e];
      }
    }
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 1);
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 2);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 1);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 2);
    l_lo = l_lo * alpha_lo + rs_lo;
    l_hi = l_hi * alpha_hi + rs_hi;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha_lo;
      acc[i][1] *= alpha_lo;
      acc[i][2] *= alpha_hi;
      acc[i][3] *= alpha_hi;
    }

    // O += P V: the S accumulators of key columns [16kk, 16kk + 16) are
    // exactly the A fragment of P for that k-step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        // B[k][n] = V[16kk + k][8i + n]: keys 2t, 2t+1 and 2t+8, 2t+9
        const uint16_t* p = sV + (kk * 16 + 2 * t) * LD + i * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[LD]) << 16);
        const uint32_t b1 =
            static_cast<uint32_t>(p[8 * LD]) | (static_cast<uint32_t>(p[9 * LD]) << 16);
        mma_bf16(acc[i], pa, b0, b1);
      }
    }
    __syncthreads();
  }

  const int HD = a.H * D;
  uint16_t* ob = static_cast<uint16_t*>(a.o) + static_cast<long long>(b) * N * HD + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (n_lo < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(n_lo) * HD + col) =
          pack_bf16(acc[i][0] / l_lo, acc[i][1] / l_lo);
    if (n_hi < N)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(n_hi) * HD + col) =
          pack_bf16(acc[i][2] / l_hi, acc[i][3] / l_hi);
  }
  if (t == 0) {
    float* lb = a.lse + (static_cast<long long>(b) * a.H + h) * N;
    if (n_lo < N) lb[n_lo] = m_lo + logf(l_lo);
    if (n_hi < N) lb[n_hi] = m_hi + logf(l_hi);
  }
}

// ---------------------------------------------------------------- fp32 path

template <int D>
__global__ void __launch_bounds__(64) flash_fwd_f32(Args a) {
  constexpr int kBQ = 64, kBK = 32;
  __shared__ float sK[kBK][D];
  __shared__ float sV[kBK][D];
  __shared__ int sSeg[kBK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int n_q = blockIdx.x * kBQ + threadIdx.x;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;

  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = n_q < N ? qb[n_q * a.q_sn + d] * a.scale : 0.f;
    acc[d] = 0.f;
  }
  const int sq = (segb && n_q < N) ? segb[n_q] : -2;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int r = i / D, c = i % D, n = k0 + r;
      sK[r][c] = n < N ? kb[n * a.k_sn + c] : 0.f;
      sV[r][c] = n < N ? vb[n * a.v_sn + c] : 0.f;
    }
    if (threadIdx.x < kBK) {
      const int n = k0 + threadIdx.x;
      sSeg[threadIdx.x] = n < N ? (segb ? segb[n] : 0) : 0;
    }
    __syncthreads();

    float s[kBK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q[d], sK[j][d], dot);
      const bool ok = (k0 + j < N) && (!segb || sSeg[j] == sq);
      s[j] = ok ? dot : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m);
      rs += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, sV[j][d], acc[d]);
    }
    l = l * alpha + rs;
    __syncthreads();
  }

  if (n_q < N) {
    float* orow = static_cast<float*>(a.o) + (static_cast<long long>(b) * N + n_q) * a.H * D + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / l;
    a.lse[(static_cast<long long>(b) * a.H + h) * N + n_q] = m + logf(l);
  }
}

}  // namespace

extern "C" {

// Launches one forward on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). dtype: 0 = fp32, 1 = bf16. D must be 64 or 128.
int dinov3_flash_fwd(const void* q, const void* k, const void* v, const int* seg,
                     void* o, float* lse, int B, int N, int H, int D, int dtype,
                     long long q_sb, long long q_sn, long long q_sh,
                     long long k_sb, long long k_sn, long long k_sh,
                     long long v_sb, long long v_sn, long long v_sh,
                     float scale, void* stream) {
  Args a{q, k, v, seg, o, lse, B, N, H,
         q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 63) / 64, H, B);
  if (dtype == 1 && D == 64) {
    flash_fwd_bf16<64><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 1 && D == 128) {
    flash_fwd_bf16<128><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 0 && D == 64) {
    flash_fwd_f32<64><<<grid, 64, 0, st>>>(a);
  } else if (dtype == 0 && D == 128) {
    flash_fwd_f32<128><<<grid, 64, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dinov3_flash_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
