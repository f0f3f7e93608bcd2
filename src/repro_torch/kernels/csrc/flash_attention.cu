// Blocked online-softmax attention, forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (body _attn_kernel): o = softmax(q k^T / sqrt(D) + mask) v with GQA (kv
// head = h / (H/K)), optional causal and sliding-window masks, running max,
// sum and accumulator in f32, output in q's dtype.
//
// Bound on the H100: operations.  At the DiT shape (S = 4608, D = 128) the
// two products do 4 S^2 D flops per head against 4 S D elements moved, some
// 600 flops per byte, above the card's ~295: the floor is the tensor cores'
// 989 TFLOP/s.
//
// Two kernels.  bf16 inputs with 16-byte aligned rows (the DiT path) run
// attn_fwd_mma below: mma.sync bf16 products with f32 accumulators, from
// registers and padded shared-memory tiles, without the asynchronous TMA /
// wgmma pipeline that the full rate needs (later work).  f32 inputs, and
// bf16 ones whose strides break that alignment, run attn_fwd: every
// multiply-add in f32 on the CUDA cores (67 TFLOP/s peak), exact to f32
// rounding.
//
// attn_fwd design.  One block of 256 threads owns 64 query rows of one (batch, head)
// and walks the key/value sequence in tiles of 64, the loop standing in for
// the TPU's sequential kv grid dimension.  Q and K tiles sit in shared memory
// transposed ([d][row]) so that each thread's 4x4 score micro-tile reads two
// float4 per step of the d loop; V sits row-major and each thread owns the
// output columns tx + 16c, so its reads of a V row hit 16 consecutive banks.
// A query row's 64 scores live in the 16 lanes of one half-warp, so its max
// and sum are two shuffle trees, with no shared-memory round trip.  Inputs
// are read by stride in the (B, S, H, D) layout (no transpose copies); only
// D must be contiguous.  Sq and Sk need not be multiples of 64: rows and
// keys past the end are loaded as zeros and masked in the kernel.  Key tiles
// that no row of the block may see (causal, window) are skipped.  A query
// row that sees no key at all (only possible with Sq > Sk + window) is not
// defined.
//
// Both kernels optionally write each row's log-sum-exp of the scaled, masked
// scores (f32, (B, H, Sq)), which the backward (flash_attention_bwd.cu)
// uses to recompute the probabilities; the output does not depend on it.
// The LSE epilogue is a template variant (kLse), so the serving path's
// kernel compiles without it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPitch = 68;   // padded row of a transposed tile (16B aligned)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return D * kPitch + D * kPitch + kBK * D + kBK * kPitch;
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
         int Sq, int Sk, int G,
         long long qb, long long qs, long long qh, long long kb, long long ks,
         long long kh, long long vb, long long vs, long long vh, long long ob,
         long long os, long long oh, int causal, int window, float scale) {
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kPitch]
  float* Kt = Qt + D * kPitch;                   // [D][kPitch]
  float* Vs = Kt + D * kPitch;                   // [kBK][D]
  float* Pt = Vs + kBK * D;                      // [kBK][kPitch]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + kvh * kh;
  const T* vp = v + b * vb + kvh * vh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qt[d * kPitch + r] = (q0 + r < Sq) ? to_f32(qp[(q0 + r) * qs + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // key range any row of this block may see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int hi = causal ? min(Sk, q_last + 1) : Sk;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  if (lo >= hi) { lo = 0; hi = Sk; }

  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();   // Q stored; the previous tile's K/V/P readers done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Sk) {
        kv = to_f32(kp[(k0 + r) * ks + d]);
        vv = to_f32(vp[(k0 + r) * vs + d]);
      }
      Kt[d * kPitch + r] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kPitch + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * kPitch + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kPitch + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[j * kPitch + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* op = o + b * ob + h * oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (kLse && tx == 0)
      lse[((long long)b * gridDim.y + h) * Sq + r] = m[i] + logf(den);
#pragma unroll
    for (int c = 0; c < DC; ++c) op[r * os + tx + 16 * c] = from_f32<T>(acc[i][c] / den);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulators.
//
// One block of 4 warps owns 64 query rows of one (batch, head); each warp
// owns 16 of them and keeps its Q fragments, its 16 x 64 score tile and its
// 16 x D output accumulator in registers.  K and V tiles of 64 keys sit in
// shared memory row-major with rows padded by 8 halves, so the 32-bit K
// fragment loads and the ldmatrix.trans V loads hit 32 distinct banks.  The
// score tile's accumulator layout is the A-operand layout of the P.V
// product, so P goes from registers to the tensor cores as bf16 without a
// shared-memory round trip (p is rounded to bf16 there, the only rounding
// beyond the f32 kernel's).  Softmax runs in base 2 with the scale folded
// in; each thread keeps a partial row sum, reduced over its quad at the end.
// Loads are synchronous 16-byte copies (no cp.async/TMA pipeline yet), so
// the tensor cores idle while a tile arrives.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* smem_row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

#define ATTN_MMA_PARAMS                                                      \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k,  \
      const __nv_bfloat16 *__restrict__ v, __nv_bfloat16 *__restrict__ o,    \
      float *__restrict__ lse, int Sq, int Sk, int G, long long qb,          \
      long long qs, long long qh, long long kb, long long ks, long long kh,  \
      long long vb, long long vs, long long vh, long long ob, long long os,  \
      long long oh, int causal, int window, float scale_log2
#define ATTN_MMA_ARGS                                                        \
  q, k, v, o, lse, Sq, Sk, G, qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, \
      causal, window, scale_log2

template <int D, bool kLse>
__device__ __forceinline__ void attn_fwd_mma_body(ATTN_MMA_PARAMS) {
  constexpr int P = D + 8;          // padded row of a K/V tile, in halves
  constexpr int KC = D / 16;        // k-chunks of the score product
  constexpr int NT = kBK / 8;       // n-tiles of a score row block
  constexpr int DT = D / 8;         // n-tiles of the output
  constexpr int CH = D / 8;         // 16-byte chunks of one K/V row
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * P];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * P];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const __nv_bfloat16* qp = q + b * qb + h * qh;
  const __nv_bfloat16* kp = k + b * kb + kvh * kh;
  const __nv_bfloat16* vp = v + b * vb + kvh * vh;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  unsigned qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + tig * 2;
    qa[kc][0] = row0 < Sq ? *reinterpret_cast<const unsigned*>(qp + row0 * qs + c) : 0u;
    qa[kc][1] = row1 < Sq ? *reinterpret_cast<const unsigned*>(qp + row1 * qs + c) : 0u;
    qa[kc][2] = row0 < Sq ? *reinterpret_cast<const unsigned*>(qp + row0 * qs + c + 8) : 0u;
    qa[kc][3] = row1 < Sq ? *reinterpret_cast<const unsigned*>(qp + row1 * qs + c + 8) : 0u;
  }

  float acc[DT][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int hi = causal ? min(Sk, q_last + 1) : Sk;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  if (lo >= hi) { lo = 0; hi = Sk; }

  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kp + (k0 + r) * ks + c);
        vv = *reinterpret_cast<const uint4*>(vp + (k0 + r) * vs + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * P + c]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * P + c]) = vv;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = &Ks[(nt * 8 + g) * P + kc * 16 + tig * 2];
        mma_bf16(s[nt], qa[kc], *reinterpret_cast<const unsigned*>(kr),
                 *reinterpret_cast<const unsigned*>(kr + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qpos = c < 2 ? row0 : row1;
        const int kpos = k0 + nt * 8 + tig * 2 + (c & 1);
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[nt][c] = ok ? s[nt][c] * scale_log2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = al0 * l0 + rs0;
    l1 = al1 * l1 + rs1;
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nt = 0; nt < DT; nt += 2) {
        unsigned vb4[4];
        ldmatrix_x4_trans(vb4, &Vs[vrow * P + (nt + (lane >> 4)) * 8]);
        mma_bf16(acc[nt], pa, vb4[0], vb4[1]);
        mma_bf16(acc[nt + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (kLse && tig == 0) {
    // natural-log LSE of the scaled scores: ln 2 (m + log2 l) in base 2
    float* lp = lse + ((long long)b * gridDim.y + h) * Sq;
    if (row0 < Sq) lp[row0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * kLn2;
    if (row1 < Sq) lp[row1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * kLn2;
  }
  __nv_bfloat16* op = o + b * ob + h * oh;
#pragma unroll
  for (int nt = 0; nt < DT; ++nt) {
    const int c = nt * 8 + tig * 2;
    if (row0 < Sq)
      *reinterpret_cast<unsigned*>(op + row0 * os + c) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<unsigned*>(op + row1 * os + c) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

// One kernel per variant, so that each gets its own register bound.  At
// D = 128 the body needs 168 registers a thread, and registers are granted
// in steps of 8: the LSE variant compiles to 170 unbounded, which leaves
// room for two blocks per SM instead of three (about 40 % slower on an
// H100 at the DiT shape), so it is held at three blocks.  The variant
// without the LSE fits three blocks unbounded; bounding it at three makes
// it spill, and an explicit one block per SM lets it grow to 202.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_mma(ATTN_MMA_PARAMS) {
  attn_fwd_mma_body<D, false>(ATTN_MMA_ARGS);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
attn_fwd_mma_lse(ATTN_MMA_PARAMS) {
  attn_fwd_mma_body<D, true>(ATTN_MMA_ARGS);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Sk, int H, int K,
               const long long* st, int causal, int window, float scale,
               cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  auto kernel = lse ? attn_fwd_mma_lse<D> : attn_fwd_mma<D>;
  kernel<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      Sq, Sk, H / K, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// The tensor-core kernel reads 16-byte chunks of K and V rows and 4-byte
// pairs of Q and O: every base pointer 16-byte aligned and every stride a
// multiple of 8 elements.
bool mma_aligned(const void* q, const void* k, const void* v, const void* o,
                 const long long* st) {
  for (const void* p : {q, k, v, o})
    if (reinterpret_cast<unsigned long long>(p) % 16) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8) return false;
  return true;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int K, const long long* st,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = lse ? attn_fwd<T, D, true> : attn_fwd<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H / K, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int Sq, int Sk, int H, int K, int D, const long long* st,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, K, st, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, K, st, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, K, st, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are in
// elements, in the order q (batch, seq, head), k (...), v (...), o (...); the
// D axis is contiguous.  lse is null or a contiguous (B, H, Sq) float32
// array that receives each row's log-sum-exp of the scaled, masked scores
// (the backward's softmax statistic); writing it changes nothing else, so o
// is bitwise the same with and without it.  Returns cudaGetLastError() after
// the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse_out,
    int dtype, int B,
    int Sq, int Sk, int H, int K, int D, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    int causal, int window, float scale, void* stream) {
  const long long st[12] = {qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse, B, Sq, Sk, H, K, D, st, causal, window, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (mma_aligned(q, k, v, o, st)) {
    switch (D) {
      case 32: return launch_mma<32>(q, k, v, o, lse, B, Sq, Sk, H, K, st, causal, window, scale, s);
      case 64: return launch_mma<64>(q, k, v, o, lse, B, Sq, Sk, H, K, st, causal, window, scale, s);
      case 128: return launch_mma<128>(q, k, v, o, lse, B, Sq, Sk, H, K, st, causal, window, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return launch_d<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, K, D, st, causal, window, scale, s);
}
