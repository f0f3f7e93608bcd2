// Blocked online-softmax attention, forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (body _attn_kernel): o = softmax(q k^T / sqrt(D) + mask) v with GQA (kv
// head = h / (H/K)), optional causal and sliding-window masks, running max,
// sum and accumulator in f32, output in q's dtype.  As in the TPU kernel the
// value dim DV is free of the query/key dim D: q, k are (.., D), v and o
// (.., DV), and the scale stays D^-1/2 (the wrapper passes it).
//
// Bound on the H100: operations.  At the DiT shape (S = 4608, D = 128) the
// two products do 4 S^2 D flops per head against 4 S D elements moved, some
// 600 flops per byte, above the card's ~295: the floor is the tensor cores'
// 989 TFLOP/s.  The softmax's S^2 exponentials run on the special-function
// units at 16 a clock per SM, about half the products' time, so they have to
// run under the products.
//
// (D, DV) pairs: (32, 32), (64, 64), (80, 80), (128, 128), and (192, 128),
// DeepSeek-V2's latent attention (128 + 64 rope dims of query and key, 128
// of value).  At (192, 128) S = Q K^T runs 12 k16 steps over three 64-column
// blocks, O += P V runs at n = 128, and the ring holds 2 stages of K (48 KB)
// and V (32 KB) beside Q (48 KB) where the equal dims hold 3: three would
// take 288 KB of the 227 KB a block may have (FwdLayout::kStages).
//
// At D = 80 (zamba2-2.7b's shared attention) the bf16 kernel stores its
// tiles padded to 96 columns (hopper.cuh: three 32-column blocks, TMA
// filling columns 80-95 with zeros): S = Q K^T runs the
// 5 real k16 steps, O += P V runs at n = 96 (a whole number of 32-column
// swizzle atoms, which the MN-major descriptor needs) and the epilogue
// stores columns < 80, so the tensor work is 1.2x the useful work.  The
// scale is 80^-1/2 from the wrapper, never from the padded width.
//
// Two kernels, chosen by dtype and layout (mma_aligned).  bf16 inputs whose
// base pointers are 16-byte aligned and whose strides are multiples of 8
// elements (what TMA needs; the DiT path) run attn_fwd_wgmma: TMA loads into
// an mbarrier ring, wgmma products (design below).  f32 inputs, and bf16
// ones that break that alignment, run attn_fwd: every multiply-add in f32 on
// the CUDA cores (67 TFLOP/s peak), exact to f32 rounding.  That is the f32
// kernel, not a fallback: the bf16 path has no other kernel.
//
// What holds attn_fwd_wgmma back now (measured on an H100 SXM, PERF.md):
// at the DiT shape it runs at ~65 % of the tensor cores' peak, as fast as
// PyTorch's fused attention there.  Without the softmax the same loop ran
// at ~80 %: the exponentials and the products overlap only in part, and
// the two consumer warpgroups run in near lockstep.
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
#include "hopper.cuh"

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

template <int D, int DV>
constexpr int smem_floats() {
  return D * kPitch + D * kPitch + kBK * DV + kBK * kPitch;
}

template <typename T, int D, int DV, bool kLse>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
         int Sq, int Sk, int G,
         long long qb, long long qs, long long qh, long long kb, long long ks,
         long long kh, long long vb, long long vs, long long vh, long long ob,
         long long os, long long oh, int causal, int window, float scale) {
  constexpr int DC = DV / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kPitch]
  float* Kt = Qt + D * kPitch;                   // [D][kPitch]
  float* Vs = Kt + D * kPitch;                   // [kBK][DV]
  float* Pt = Vs + kBK * DV;                     // [kBK][kPitch]

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
        if constexpr (D == DV) vv = to_f32(vp[(k0 + r) * vs + d]);
      }
      Kt[d * kPitch + r] = kv;
      if constexpr (D == DV) Vs[r * D + d] = vv;
    }
    if constexpr (D != DV) {
      for (int i = tid; i < kBK * DV; i += kThreads) {
        const int r = i / DV, d = i % DV;
        Vs[r * DV + d] = k0 + r < Sk ? to_f32(vp[(k0 + r) * vs + d]) : 0.f;
      }
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
        const float vv = Vs[j * DV + tx + 16 * c];
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
// bf16 on Hopper's tensor cores: TMA ring, wgmma, one producer warp.
//
// A block of three warpgroups owns kWgBQ = 128 query rows of one (batch,
// head).  Warpgroup 0 is the producer: after giving most of its registers
// to the others (setmaxnreg), one thread TMA-loads the Q tile once and then
// the K and V tiles of kWgBK = 128 keys into a ring of kStages = 3 stages
// (2 at D = 192, where 3 do not fit).
// Each operand of a stage has a "full" barrier (the copy completes it) and
// an "empty" one, on which the consumers' eight warps arrive: K's once S is
// formed, V's once P V is, so the next K is loaded while V is still read.
// Warpgroups 1 and 2 each own 64 rows.  Per key tile a consumer starts
// S = Q K^T (shared-memory wgmma m64n128k16, Q and K K-major) and the
// previous tile's O += P V (register-A wgmma, V read MN-major), waits for S
// only, and runs the online softmax (base 2, the scale folded into one FMA
// before each exponential, masks only on tiles that cross a boundary)
// while P V runs; then it rescales O and rounds P to bf16 in place (an
// m64nN accumulator is already the A-fragment layout).  At D = 128, 64 and
// 192 the tiles use the 128-byte swizzle, at D = 32 and 80 the 64-byte one;
// V's tiles are laid out for DV, Q's and K's for D.  Nothing
// orders the two consumers: making them take turns (the FA3 ping-pong) or
// starting one half a tile late measured slower on the H100.
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 384;
constexpr int kWgBQ = 128;   // query rows of a block, 64 a consumer
constexpr int kWgBK = 128;   // keys of a ring stage
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may have

struct FwdParams {
  CUtensorMap tq, tk, tv;   // (D, heads, S, B) views, 64-row boxes
  __nv_bfloat16* o;
  float* lse;
  long long ob, os, oh;
  int Sq, Sk, H, G, causal, window;
  float scale_log2;
};

// Q, then the K ring and the V ring, then the barriers; 3 stages where they
// fit, else 2
template <int D, int DV, int kS = 3>
struct FwdLayoutS {
  using QT = hopper::Tile<D, kWgBQ>;
  using KT = hopper::Tile<D, kWgBK>;
  using VT = hopper::Tile<DV, kWgBK>;
  static constexpr int kStages = kS;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + QT::kBytes;
  static constexpr int kV = kK + kStages * KT::kBytes;
  static constexpr int kBar = kV + kStages * VT::kBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

template <int D, int DV>
using FwdLayout = FwdLayoutS<D, DV,
                             FwdLayoutS<D, DV, 3>::kBytes <= kSmemMax ? 3 : 2>;

template <int D, int DV, bool kLse>
__device__ __forceinline__ void attn_fwd_wgmma_body(const FwdParams& p) {
  using L = FwdLayout<D, DV>;
  constexpr int kStages = L::kStages;
  static_assert(L::kBytes <= kSmemMax, "the ring does not fit");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;   // S of the stage is done
  uint64_t* empty_v = empty_k + kStages;  // P V of the stage is done

  const int q0 = blockIdx.x * kWgBQ, h = blockIdx.y, b = blockIdx.z;
  // key tiles any row of this block may see
  const int q_last = min(q0 + kWgBQ, p.Sq) - 1;
  int hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  if (lo >= hi) { lo = 0; hi = p.Sk; }
  const int t0 = lo / kWgBK, t1 = (hi + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty_k[s], 8);
      hopper::mbar_init(&empty_v[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int kvh = h / p.G;
      hopper::mbar_expect_tx(full_q, L::QT::kBytes);
      hopper::load_tile<D, kWgBQ>(sm + L::kQ, &p.tq, full_q, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t) {
        unsigned char* kt = sm + L::kK + stage * L::KT::kBytes;
        unsigned char* vt = sm + L::kV + stage * L::VT::kBytes;
        hopper::mbar_wait(&empty_k[stage], phase ^ 1);
        hopper::mbar_expect_tx(&full_k[stage], L::KT::kBytes);
        hopper::load_tile<D, kWgBK>(kt, &p.tk, &full_k[stage], kvh, t * kWgBK, b);
        hopper::mbar_wait(&empty_v[stage], phase ^ 1);
        hopper::mbar_expect_tx(&full_v[stage], L::VT::kBytes);
        hopper::load_tile<DV, kWgBK>(vt, &p.tv, &full_v[stage], kvh, t * kWgBK, b);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<240>();

  constexpr int NO = L::VT::DP / 2;  // output accumulator registers
  constexpr int NS = kWgBK / 2;      // score accumulator registers
  const int tid = threadIdx.x & 127, w = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int qw = q0 + 64 * w;                 // this warpgroup's first row
  const int row0 = qw + warp * 16 + g, row1 = row0 + 8;
  const float sl2 = p.scale_log2;

  float o[NO];   // first written by the first P V (scale_d = 0)
  // running max in scaled base-2 units, running sum
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  uint32_t pa[kWgBK / 16][4];   // the previous tile's P, bf16

  hopper::mbar_wait(full_q, 0);
  int stage = 0, prev = 0;
  uint32_t phase = 0, prev_phase = 0;
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kWgBK;
    const unsigned char* kt = sm + L::kK + stage * L::KT::kBytes;
    hopper::mbar_wait(&full_k[stage], phase);
    if (t > t0) hopper::mbar_wait(&full_v[prev], prev_phase);
    // S = Q K^T of this tile, then O += P V of the previous one: the
    // softmax below overlaps the second product
    float s[NS];
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      hopper::wgmma_ss(s, hopper::desc_k<D, kWgBQ>(sm + L::kQ, 64 * w, kc),
                       hopper::desc_k<D, kWgBK>(kt, 0, kc), kc > 0);
    hopper::wgmma_commit();
    if (t > t0) {
      const unsigned char* vt = sm + L::kV + prev * L::VT::kBytes;
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        hopper::wgmma_rs_tb(o, pa[kk], hopper::desc_mn<DV, kWgBK>(vt, kk),
                            t - 1 > t0 || kk > 0);
      hopper::wgmma_commit();
    }
    if (t > t0) hopper::wgmma_wait<1>(); else hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty_k[stage]);

    // masks only where some (row, key) pair of this warpgroup is hidden
    const bool masked = k0 + kWgBK > p.Sk || (p.causal && k0 + kWgBK - 1 > qw) ||
                        (p.window > 0 && k0 <= qw + 63 - p.window);
    if (masked) {
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qpos = c < 2 ? row0 : row1;
          const int kpos = k0 + j * 8 + tg * 2 + (c & 1);
          bool ok = kpos < p.Sk;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          if (!ok) s[4 * j + c] = kNegInf;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    const float al0 = hopper::ex2(m0 - mn0), al1 = hopper::ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // A row that has seen only masked keys so far (its first tile lies
    // wholly outside its window) has mn = kNegInf * sl2 rounded, and
    // fma(kNegInf, sl2, -mn) is that product's rounding error, up to 1e22:
    // its exponential would be inf.  Such a tile's probabilities are 0, so
    // any finite base gives them: take 0.
    const float b0 = mx0 == kNegInf ? 0.f : mn0;
    const float b1 = mx1 == kNegInf ? 0.f : mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      s[4 * j + 0] = hopper::ex2(fmaf(s[4 * j + 0], sl2, -b0));
      s[4 * j + 1] = hopper::ex2(fmaf(s[4 * j + 1], sl2, -b0));
      s[4 * j + 2] = hopper::ex2(fmaf(s[4 * j + 2], sl2, -b1));
      s[4 * j + 3] = hopper::ex2(fmaf(s[4 * j + 3], sl2, -b1));
      rs0 += s[4 * j + 0] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = al0 * l0 + rs0;
    l1 = al1 * l1 + rs1;
    if (t > t0) {   // O holds the products up to the previous tile
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty_v[prev]);
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        o[4 * j + 0] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) hopper::acc_to_a(pa[kk], s, kk);
    prev = stage;
    prev_phase = phase;
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
  {   // the last tile's O += P V
    const unsigned char* vt = sm + L::kV + prev * L::VT::kBytes;
    hopper::mbar_wait(&full_v[prev], prev_phase);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      hopper::wgmma_rs_tb(o, pa[kk], hopper::desc_mn<DV, kWgBK>(vt, kk),
                          t1 - 1 > t0 || kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (kLse && tg == 0) {
    // natural-log LSE of the scaled scores: ln 2 (m + log2 l) in base 2
    float* lp = p.lse + ((long long)b * p.H + h) * p.Sq;
    if (row0 < p.Sq) lp[row0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * kLn2;
    if (row1 < p.Sq) lp[row1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * kLn2;
  }
  __nv_bfloat16* op = p.o + b * p.ob + h * p.oh;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {   // the DV real columns, not the padding
    const int c = j * 8 + tg * 2;
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(op + row0 * p.os + c) =
          hopper::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(op + row1 * p.os + c) =
          hopper::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// One kernel per variant, so that the serving path's carries no LSE code;
// both run the same body, so o is bitwise the same.
template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_fwd_wgmma(const __grid_constant__ FwdParams p) {
  attn_fwd_wgmma_body<D, DV, false>(p);
}

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_fwd_wgmma_lse(const __grid_constant__ FwdParams p) {
  attn_fwd_wgmma_body<D, DV, true>(p);
}

template <int D, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Sk, int H, int K,
                 const long long* st, int causal, int window, float scale,
                 cudaStream_t stream) {
  FwdParams p;
  CUresult cr = encode_bshd(&p.tq, q, D, H, Sq, B, st[0], st[1], st[2]);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&p.tk, k, D, K, Sk, B, st[3], st[4], st[5]);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&p.tv, v, DV, K, Sk, B, st[6], st[7], st[8]);
  if (cr != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.ob = st[9]; p.os = st[10]; p.oh = st[11];
  p.Sq = Sq; p.Sk = Sk; p.H = H; p.G = H / K;
  p.causal = causal; p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  auto kernel = lse ? attn_fwd_wgmma_lse<D, DV> : attn_fwd_wgmma<D, DV>;
  constexpr int smem = FwdLayout<D, DV>::kBytes;
  static bool sized[2] = {false, false};
  const int rc = size_once(kernel, smem, &sized[lse != nullptr]);
  if (rc) return rc;
  dim3 grid((Sq + kWgBQ - 1) / kWgBQ, H, B);
  kernel<<<grid, kWgThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// TMA reads the tiles: every base pointer 16-byte aligned and every stride a
// multiple of 8 elements (16 bytes); o is written in 4-byte pairs
bool mma_aligned(const void* q, const void* k, const void* v, const void* o,
                 const long long* st) {
  for (const void* p : {q, k, v, o})
    if (reinterpret_cast<unsigned long long>(p) % 16) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8) return false;
  return true;
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int K, const long long* st,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D, DV>();
  auto kernel = lse ? attn_fwd<T, D, DV, true> : attn_fwd<T, D, DV, false>;
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
             int B, int Sq, int Sk, int H, int K, int D, int DV,
             const long long* st, int causal, int window, float scale,
             cudaStream_t stream) {
#define FA_FMA(d, dv) \
  if (D == d && DV == dv) \
    return launch<T, d, dv>(q, k, v, o, lse, B, Sq, Sk, H, K, st, causal, window, scale, stream);
  FA_FMA(32, 32) FA_FMA(64, 64) FA_FMA(80, 80) FA_FMA(128, 128) FA_FMA(192, 128)
#undef FA_FMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  q and k are
// (.., D), v and o (.., Dv), (D, Dv) one of the pairs above.  Strides are in
// elements, in the order q (batch, seq, head), k (...), v (...), o (...); the
// D axis is contiguous.  lse is null or a contiguous (B, H, Sq) float32
// array that receives each row's log-sum-exp of the scaled, masked scores
// (the backward's softmax statistic); writing it changes nothing else, so o
// is bitwise the same with and without it.  Returns cudaGetLastError() after
// the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse_out,
    int dtype, int B,
    int Sq, int Sk, int H, int K, int D, int Dv, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    int causal, int window, float scale, void* stream) {
  const long long st[12] = {qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse, B, Sq, Sk, H, K, D, Dv, st, causal, window, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (mma_aligned(q, k, v, o, st)) {
#define FA_WG(d, dv) \
    if (D == d && Dv == dv) \
      return launch_wgmma<d, dv>(q, k, v, o, lse, B, Sq, Sk, H, K, st, causal, window, scale, s);
    FA_WG(32, 32) FA_WG(64, 64) FA_WG(80, 80) FA_WG(128, 128) FA_WG(192, 128)
#undef FA_WG
    return (int)cudaErrorInvalidValue;
  }
  return launch_d<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, K, D, Dv, st, causal, window, scale, s);
}
