// Flash-attention backward, dQ part (and the row term Delta), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dinov3_tpu/ops/flash_attention.py `_bwd_pallas`'s
// first pallas_call (body `_dq_kernel`), together with the Delta it takes as
// an input (`jnp.sum(do * o, -1)` in `_bwd_pallas`). For each q row:
//   Delta = sum_d dO * O                               (fp32)
//   P     = exp(S * scale - LSE), S = Q K^T            (masked keys: P = 0)
//   dS    = P * (dO V^T - Delta)
//   dQ    = scale * dS K
// A key is masked when it lies past N or, with segment ids, when its id is
// not the q row's (the forward's -1e30 logits, whose exp(-1e30 - LSE) is 0).
// Delta is written to a [B, H, N] fp32 buffer for the dK/dV kernel
// (csrc/flash_bwd_dkv.cu), which runs after this one on the same stream.
//
// What bounds it: the three products over the segment pairs (S, dO V^T and
// dS K: 6 * d * pairs per head) against the bytes of q, k, v, O, dO, LSE and
// dQ. At the training shapes ([81 rows x 16 heads, 197, 64] bf16, packed
// segments) the tensor-core work and the 24 MB of operands take about the
// same least time, a few tens of microseconds; this first kernel is far from
// either, bound in practice by its un-pipelined tile loads and the
// exponentials of the masked tiles it does not skip.
//
// What the design does:
// - bf16: `mma.sync.m16n8k16` (fp32 accumulate), one CTA of 4 warps per
//   (64-row q tile, head, batch row), each warp owning 16 q rows. Q and dO
//   stay in registers as A fragments; K and V tiles of 64 keys are staged
//   through padded shared memory (row pitch d + 8 halves). S and dO V^T are
//   two products over the same fragments, the masked softmax and dS stay in
//   registers, and dS is rounded to bf16 to be the A operand of dS K, as the
//   forward rounds P for P V. Delta comes from the dO fragments already in
//   registers times O read once, reduced over the quad of threads that holds
//   a row.
// - fp32: one thread per q row, q, dO and the dQ accumulator in registers,
//   K/V tiles of 32 keys in shared memory, scalar FMAs, fp32 throughout.
// - q, k, v, O and dO are read through their strides in the [B, N, h, d]
//   layout (v may be a view of the fused qkv output); dQ is written as a
//   contiguous [B, N, h, d]. Segment ids are read as [B, N] int32.
// Later work (not here): wgmma + TMA, and skipping the key tiles whose
// segment ids cannot meet the q tile's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int* seg;     // [B, N] int32, or nullptr
  const float* lse;   // [B, H, N] fp32
  float* delta;       // [B, H, N] fp32, written
  void* dq;           // [B, N, H, D] contiguous, input dtype
  int B, N, H;
  long long q_sb, q_sn, q_sh;  // element strides (last dim 1)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  long long d_sb, d_sn, d_sh;
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

__device__ __forceinline__ float2 bf16_pair(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
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

// A fragments of a warp's 16 rows (r_lo = warp*16 + g, r_hi = r_lo + 8) of
// a staged [64, D] tile.
template <int D, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const uint16_t* s,
                                             int r_lo, int t) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint16_t* p = s + kc * 16 + 2 * t;
    f[kc][0] = ld_pair(p + r_lo * LD);
    f[kc][1] = ld_pair(p + (r_lo + 8) * LD);
    f[kc][2] = ld_pair(p + r_lo * LD + 8);
    f[kc][3] = ld_pair(p + (r_lo + 8) * LD + 8);
  }
}

// acc[j] += A (16 x D) . Bt^T for the 64 rows of Bt staged in shared memory:
// B[k][n] = Bt[8j + n][k] (the K-of-S = Q K^T pattern).
template <int D, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                         const uint16_t* sB, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint16_t* p = sB + (j * 8 + g) * LD + kc * 16 + 2 * t;
      mma_bf16(acc[j], a[kc], ld_pair(p), ld_pair(p + 8));
    }
  }
}

// acc[i] += A (16 x 64, the fp32 values x[8][4] rounded to bf16) . Bm, with
// Bm [64, D] staged in shared memory (the V-of-P V pattern).
template <int D, int LD>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4], const float (&x)[8][4],
                                         const uint16_t* sB, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const uint16_t* p = sB + (kk * 16 + 2 * t) * LD + i * 8 + g;
      const uint32_t b0 = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[LD]) << 16);
      const uint32_t b1 =
          static_cast<uint32_t>(p[8 * LD]) | (static_cast<uint32_t>(p[9 * LD]) << 16);
      mma_bf16(acc[i], pa, b0, b1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(Args a) {
  constexpr int kBK = 64, LD = D + 8;
  __shared__ __align__(16) uint16_t sK[kBK * LD];
  __shared__ __align__(16) uint16_t sV[kBK * LD];
  __shared__ int sSeg[kBK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.N;
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const uint16_t* ob = static_cast<const uint16_t*>(a.o) + b * a.o_sb + h * a.o_sh;
  const uint16_t* db = static_cast<const uint16_t*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  // Q and dO tiles staged through sK and sV, then kept as A fragments
  load_tile<D, LD>(sK, qb, a.q_sn, q0, N);
  load_tile<D, LD>(sV, db, a.d_sn, q0, N);
  __syncthreads();
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags<D, LD>(qf, sK, r_lo, t);
  load_a_frags<D, LD>(df, sV, r_lo, t);
  __syncthreads();

  const int n_lo = q0 + r_lo, n_hi = q0 + r_hi;
  // Delta of the two rows: this thread's dO columns times O, summed over
  // the quad that holds the row
  float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    if (n_lo < N) {
      const uint16_t* orow = ob + n_lo * a.o_sn + c;
      const float2 o0 = bf16_pair(ld_pair(orow)), o1 = bf16_pair(ld_pair(orow + 8));
      const float2 d0 = bf16_pair(df[kc][0]), d1 = bf16_pair(df[kc][2]);
      dl_lo += d0.x * o0.x + d0.y * o0.y + d1.x * o1.x + d1.y * o1.y;
    }
    if (n_hi < N) {
      const uint16_t* orow = ob + n_hi * a.o_sn + c;
      const float2 o0 = bf16_pair(ld_pair(orow)), o1 = bf16_pair(ld_pair(orow + 8));
      const float2 d0 = bf16_pair(df[kc][1]), d1 = bf16_pair(df[kc][3]);
      dl_hi += d0.x * o0.x + d0.y * o0.y + d1.x * o1.x + d1.y * o1.y;
    }
  }
  dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 1);
  dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 2);
  dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 1);
  dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 2);
  if (t == 0) {
    if (n_lo < N) a.delta[bh * N + n_lo] = dl_lo;
    if (n_hi < N) a.delta[bh * N + n_hi] = dl_hi;
  }
  const float ls_lo = n_lo < N ? a.lse[bh * N + n_lo] : 0.f;
  const float ls_hi = n_hi < N ? a.lse[bh * N + n_hi] : 0.f;
  // rows past N get id -2, which matches no key (keys carry >= -1)
  int sq_lo = -2, sq_hi = -2;
  if (segb) {
    if (n_lo < N) sq_lo = segb[n_lo];
    if (n_hi < N) sq_hi = segb[n_hi];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    load_tile<D, LD>(sK, kb, a.k_sn, k0, N);
    load_tile<D, LD>(sV, vb, a.v_sn, k0, N);
    if (threadIdx.x < kBK) {
      const int n = k0 + threadIdx.x;
      sSeg[threadIdx.x] = n < N ? (segb ? segb[n] : 0) : 0;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_rows<D, LD>(s, qf, sK, g, t);   // S = Q K^T
    mma_rows<D, LD>(dp, df, sV, g, t);  // dP = dO V^T

    // dS = P * (dP - Delta), in place of s
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const bool in = k0 + col < N;
        const int sk = sSeg[col];
        const bool ok_lo = in && (!segb || sk == sq_lo);
        const bool ok_hi = in && (!segb || sk == sq_hi);
        const float p_lo = ok_lo ? exp2f((s[j][e] * a.scale - ls_lo) * kLog2e) : 0.f;
        const float p_hi = ok_hi ? exp2f((s[j][2 + e] * a.scale - ls_hi) * kLog2e) : 0.f;
        s[j][e] = p_lo * (dp[j][e] - dl_lo);
        s[j][2 + e] = p_hi * (dp[j][2 + e] - dl_hi);
      }
    }
    mma_cols<D, LD>(acc, s, sK, g, t);  // dQ += dS K
    __syncthreads();
  }

  const int HD = a.H * D;
  uint16_t* out = static_cast<uint16_t*>(a.dq) + static_cast<long long>(b) * N * HD + h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (n_lo < N)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(n_lo) * HD + col) =
          pack_bf16(acc[i][0] * a.scale, acc[i][1] * a.scale);
    if (n_hi < N)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(n_hi) * HD + col) =
          pack_bf16(acc[i][2] * a.scale, acc[i][3] * a.scale);
  }
}

// ---------------------------------------------------------------- fp32 path

template <int D>
__global__ void __launch_bounds__(64) flash_bwd_dq_f32(Args a) {
  constexpr int kBK = 32;
  __shared__ float sK[kBK][D];
  __shared__ float sV[kBK][D];
  __shared__ int sSeg[kBK];

  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int n_q = blockIdx.x * 64 + threadIdx.x;
  const bool row_in = n_q < N;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ob = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* db = static_cast<const float*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  float q[D], dout[D], dq[D];
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = row_in ? qb[n_q * a.q_sn + d] : 0.f;
    dout[d] = row_in ? db[n_q * a.d_sn + d] : 0.f;
    if (row_in) delta = fmaf(dout[d], ob[n_q * a.o_sn + d], delta);
    dq[d] = 0.f;
  }
  if (row_in) a.delta[bh * N + n_q] = delta;
  const float lse = row_in ? a.lse[bh * N + n_q] : 0.f;
  const int sq = (segb && row_in) ? segb[n_q] : -2;

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
    for (int j = 0; j < kBK; ++j) {
      const bool ok = row_in && (k0 + j < N) && (!segb || sSeg[j] == sq);
      if (!ok) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d], sK[j][d], s);
        dp = fmaf(dout[d], sV[j][d], dp);
      }
      const float ds = expf(s * a.scale - lse) * (dp - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, sK[j][d], dq[d]);
    }
    __syncthreads();
  }

  if (row_in) {
    float* out = static_cast<float*>(a.dq) + (static_cast<long long>(b) * N + n_q) * a.H * D + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = dq[d] * a.scale;
  }
}

}  // namespace

extern "C" {

// Launches the dQ backward on `stream` and returns cudaGetLastError() (0
// when the launch was accepted). dtype: 0 = fp32, 1 = bf16. D must be 64 or
// 128. Writes dq [B, N, H, D] and delta [B, H, N].
int dinov3_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const int* seg, const float* lse, float* delta,
                        void* dq, int B, int N, int H, int D, int dtype,
                        long long q_sb, long long q_sn, long long q_sh,
                        long long k_sb, long long k_sn, long long k_sh,
                        long long v_sb, long long v_sn, long long v_sh,
                        long long o_sb, long long o_sn, long long o_sh,
                        long long d_sb, long long d_sn, long long d_sh,
                        float scale, void* stream) {
  Args a{q, k, v, o, dout, seg, lse, delta, dq, B, N, H,
         q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
         o_sb, o_sn, o_sh, d_sb, d_sn, d_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 63) / 64, H, B);
  if (dtype == 1 && D == 64) {
    flash_bwd_dq_bf16<64><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 1 && D == 128) {
    flash_bwd_dq_bf16<128><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 0 && D == 64) {
    flash_bwd_dq_f32<64><<<grid, 64, 0, st>>>(a);
  } else if (dtype == 0 && D == 128) {
    flash_bwd_dq_f32<128><<<grid, 64, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dinov3_flash_bwd_dq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
