// Flash-attention backward, dK/dV part, for Hopper (sm_90a).
//
// Replaces the TPU kernel dinov3_tpu/ops/flash_attention.py `_bwd_pallas`'s
// second pallas_call (body `_dkv_kernel`). For each key, over every q row
// that may attend it:
//   P  = exp(S * scale - LSE), S = Q K^T               (masked: P = 0)
//   dV = sum_q P^T dO
//   dS = P * (dO V^T - Delta)
//   dK = scale * sum_q dS^T Q
// LSE comes from the forward (csrc/flash_fwd.cu) and Delta = sum_d dO * O
// from the dQ kernel (csrc/flash_bwd_dq.cu), launched before this one. A
// pair is masked when the q row lies past N (the reference's out-of-range
// row mask) or, with segment ids, when the ids differ. A pad token (id -1)
// meets its own pad segment, so every softmax row is non-empty and P stays
// finite; exp(-1e30 - LSE) of the forward's masked logits is exactly the 0
// written here.
//
// What bounds it: the four products over the segment pairs (S, dO V^T,
// P^T dO and dS^T Q: 8 * d * pairs per head) against the bytes of q, k, v,
// dO, LSE, Delta, dK and dV; at the training shapes the two least times are
// of one order, a few tens of microseconds, and this first kernel is bound
// by its un-pipelined tile loads and the masked tiles it does not skip.
//
// What the design does:
// - bf16: `mma.sync.m16n8k16` (fp32 accumulate), one CTA of 4 warps per
//   (64-key tile, head, batch row), each warp owning 16 keys. K and V stay
//   in registers as A fragments; q tiles of 64 rows of Q and dO, with their
//   LSE, Delta and segment ids, are staged through padded shared memory.
//   S^T = K Q^T and dP^T = V dO^T come out in the accumulator layout, which
//   is the A-fragment layout of the next products, so P^T and dS^T are
//   rounded to bf16 in registers and fed straight into dV += P^T dO and
//   dK += dS^T Q. The dK and dV sums stay in fp32 registers for the whole
//   q loop: no atomics, so two runs give the same bits.
// - fp32: one thread per key, k, v and both sums in registers, q/dO tiles of
//   32 rows in shared memory, scalar FMAs, fp32 throughout.
// - q, k, v and dO are read through their strides in the [B, N, h, d]
//   layout; dK and dV are written as contiguous [B, N, h, d].
// Later work (not here): wgmma + TMA, and skipping the q tiles whose
// segment ids cannot meet the key tile's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* seg;      // [B, N] int32, or nullptr
  const float* lse;    // [B, H, N] fp32
  const float* delta;  // [B, H, N] fp32
  void* dk;            // [B, N, H, D] contiguous, input dtype
  void* dv;
  int B, N, H;
  long long q_sb, q_sn, q_sh;  // element strides (last dim 1)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
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

// A fragments of a warp's 16 rows (r_lo and r_lo + 8) of a staged tile.
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

// acc[j] += A (16 x D) . Bt^T over the 64 staged rows of Bt.
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

// acc[i] += A (16 x 64, x rounded to bf16) . Bm over the staged [64, D] Bm.
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
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(Args a) {
  constexpr int kBQ = 64, LD = D + 8;
  __shared__ __align__(16) uint16_t sQ[kBQ * LD];
  __shared__ __align__(16) uint16_t sD[kBQ * LD];
  __shared__ float sLse[kBQ], sDelta[kBQ];
  __shared__ int sSeg[kBQ];

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.N;
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const uint16_t* db = static_cast<const uint16_t*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  // K and V tiles staged through sQ and sD, then kept as A fragments
  load_tile<D, LD>(sQ, kb, a.k_sn, k0, N);
  load_tile<D, LD>(sD, vb, a.v_sn, k0, N);
  __syncthreads();
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D, LD>(kf, sQ, r_lo, t);
  load_a_frags<D, LD>(vf, sD, r_lo, t);
  __syncthreads();

  const int n_lo = k0 + r_lo, n_hi = k0 + r_hi;
  // keys past N get id -3, which matches no q row (rows carry >= -2); their
  // sums are never written
  int sk_lo = -3, sk_hi = -3;
  if (n_lo < N) sk_lo = segb ? segb[n_lo] : 0;
  if (n_hi < N) sk_hi = segb ? segb[n_hi] : 0;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += kBQ) {
    load_tile<D, LD>(sQ, qb, a.q_sn, q0, N);
    load_tile<D, LD>(sD, db, a.d_sn, q0, N);
    if (threadIdx.x < kBQ) {
      const int n = q0 + threadIdx.x;
      const bool in = n < N;
      sLse[threadIdx.x] = in ? a.lse[bh * N + n] : 0.f;
      sDelta[threadIdx.x] = in ? a.delta[bh * N + n] : 0.f;
      // q rows past N carry -2: masked against every key below
      sSeg[threadIdx.x] = in ? (segb ? segb[n] : 0) : -2;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_rows<D, LD>(s, kf, sQ, g, t);   // S^T = K Q^T
    mma_rows<D, LD>(dp, vf, sD, g, t);  // dP^T = V dO^T

    // P^T in s, dS^T in dp
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const int sq = sSeg[col];
        const float ls = sLse[col], dl = sDelta[col];
        const float p_lo = sq == sk_lo ? exp2f((s[j][e] * a.scale - ls) * kLog2e) : 0.f;
        const float p_hi = sq == sk_hi ? exp2f((s[j][2 + e] * a.scale - ls) * kLog2e) : 0.f;
        s[j][e] = p_lo;
        s[j][2 + e] = p_hi;
        dp[j][e] = p_lo * (dp[j][e] - dl);
        dp[j][2 + e] = p_hi * (dp[j][2 + e] - dl);
      }
    }
    mma_cols<D, LD>(dv, s, sD, g, t);   // dV += P^T dO
    mma_cols<D, LD>(dk, dp, sQ, g, t);  // dK += dS^T Q
    __syncthreads();
  }

  const int HD = a.H * D;
  const long long base = static_cast<long long>(b) * N * HD + h * D;
  uint16_t* dkb = static_cast<uint16_t*>(a.dk) + base;
  uint16_t* dvb = static_cast<uint16_t*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (n_lo < N) {
      const long long o = static_cast<long long>(n_lo) * HD + col;
      *reinterpret_cast<uint32_t*>(dkb + o) = pack_bf16(dk[i][0] * a.scale, dk[i][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + o) = pack_bf16(dv[i][0], dv[i][1]);
    }
    if (n_hi < N) {
      const long long o = static_cast<long long>(n_hi) * HD + col;
      *reinterpret_cast<uint32_t*>(dkb + o) = pack_bf16(dk[i][2] * a.scale, dk[i][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + o) = pack_bf16(dv[i][2], dv[i][3]);
    }
  }
}

// ---------------------------------------------------------------- fp32 path

template <int D>
__global__ void __launch_bounds__(64) flash_bwd_dkv_f32(Args a) {
  constexpr int kBQ = 32;
  __shared__ float sQ[kBQ][D];
  __shared__ float sD[kBQ][D];
  __shared__ float sLse[kBQ], sDelta[kBQ];
  __shared__ int sSeg[kBQ];

  const int h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int n_k = blockIdx.x * 64 + threadIdx.x;
  const bool key_in = n_k < N;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* db = static_cast<const float*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * N : nullptr;
  const long long bh = static_cast<long long>(b) * a.H + h;

  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = key_in ? kb[n_k * a.k_sn + d] : 0.f;
    vr[d] = key_in ? vb[n_k * a.v_sn + d] : 0.f;
    dk[d] = dv[d] = 0.f;
  }
  const int sk = key_in ? (segb ? segb[n_k] : 0) : -3;

  for (int q0 = 0; q0 < N; q0 += kBQ) {
    for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
      const int r = i / D, c = i % D, n = q0 + r;
      sQ[r][c] = n < N ? qb[n * a.q_sn + c] : 0.f;
      sD[r][c] = n < N ? db[n * a.d_sn + c] : 0.f;
    }
    if (threadIdx.x < kBQ) {
      const int n = q0 + threadIdx.x;
      const bool in = n < N;
      sLse[threadIdx.x] = in ? a.lse[bh * N + n] : 0.f;
      sDelta[threadIdx.x] = in ? a.delta[bh * N + n] : 0.f;
      sSeg[threadIdx.x] = in ? (segb ? segb[n] : 0) : -2;
    }
    __syncthreads();
    for (int j = 0; j < kBQ; ++j) {
      if (sSeg[j] != sk) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(sQ[j][d], kr[d], s);
        dp = fmaf(sD[j][d], vr[d], dp);
      }
      const float p = expf(s * a.scale - sLse[j]);
      const float ds = p * (dp - sDelta[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(p, sD[j][d], dv[d]);
        dk[d] = fmaf(ds, sQ[j][d], dk[d]);
      }
    }
    __syncthreads();
  }

  if (key_in) {
    const long long o = (static_cast<long long>(b) * N + n_k) * a.H * D + h * D;
    float* dkr = static_cast<float*>(a.dk) + o;
    float* dvr = static_cast<float*>(a.dv) + o;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkr[d] = dk[d] * a.scale;
      dvr[d] = dv[d];
    }
  }
}

}  // namespace

extern "C" {

// Launches the dK/dV backward on `stream` and returns cudaGetLastError().
// dtype: 0 = fp32, 1 = bf16. D must be 64 or 128. Writes dk, dv [B, N, H, D].
int dinov3_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const int* seg, const float* lse, const float* delta, void* dk,
                         void* dv, int B, int N, int H, int D, int dtype,
                         long long q_sb, long long q_sn, long long q_sh,
                         long long k_sb, long long k_sn, long long k_sh,
                         long long v_sb, long long v_sn, long long v_sh,
                         long long d_sb, long long d_sn, long long d_sh,
                         float scale, void* stream) {
  Args a{q, k, v, dout, seg, lse, delta, dk, dv, B, N, H,
         q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
         d_sb, d_sn, d_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 63) / 64, H, B);
  if (dtype == 1 && D == 64) {
    flash_bwd_dkv_bf16<64><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 1 && D == 128) {
    flash_bwd_dkv_bf16<128><<<grid, 128, 0, st>>>(a);
  } else if (dtype == 0 && D == 64) {
    flash_bwd_dkv_f32<64><<<grid, 64, 0, st>>>(a);
  } else if (dtype == 0 && D == 128) {
    flash_bwd_dkv_f32<128><<<grid, 64, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dinov3_flash_bwd_dkv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
