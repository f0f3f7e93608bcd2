// Blocked attention, backward: dq, dk, dv of o = softmax(q k^T / sqrt(D) +
// mask) v under the forward's masks (causal, sliding window, ragged tails)
// and GQA, with dk and dv summed over the query heads of each kv head.
//
// The TPU package has no Pallas counterpart: its model calls the jnp
// attention_chunked (src/repro/models/attention.py:71) and JAX differentiates
// it.  This kernel is the backward of the port's forward kernel
// (flash_attention.cu), which the training path needs because the GRPO loss
// differentiates the velocity through it.
//
// Bound on the H100: operations.  The two forward products are recomputed
// (S = q k^T, dP = dO v^T) and three more are formed (dV = P^T dO, dK =
// dS^T q, dQ = dS k): 2.5 times the forward's 4 S^2 D flops per head, at
// the DiT shape (S = 4608, D = 128) far above the card's ~295 flops per byte.
//
// Passes, in order, all on the caller's stream:
//   1. delta: D_i = sum_d dO_i,d O_i,d per query row (one warp per row).
//   2. dK/dV: one block per (batch, kv head, key tile); it loops over the G
//      query heads of its group and over the query tiles, recomputing
//      P = exp(S - LSE) from the forward's log-sum-exp and dS = P (dP - D),
//      and keeps dK and dV in registers.
//   3. dQ: one block per (batch, head, query tile); it loops over the key
//      tiles and keeps dQ in registers.
// Every output element is summed by one thread in a fixed order: no float
// atomics, so the gradient is the same from run to run.
//
// bf16 inputs with 16-byte aligned rows (the DiT path) run the mma.sync
// kernels (m16n8k16, f32 accumulators; P and dS are rounded to bf16 for the
// second products, as the forward rounds P).  f32 inputs, and bf16 ones whose
// strides break that alignment, run FMA kernels on the CUDA cores, exact to
// f32 rounding.  Loads are synchronous (no cp.async/TMA pipeline, no wgmma).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Str {
  long long b, s, h;   // element strides of the batch, sequence, head axes
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;    // (B, H, Sq), natural log
  float* delta;        // (B, H, Sq), written by pass 1
  Str sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, Sq, Sk, H, K, G, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the forward's mask predicate, plus the ragged row/key tails
__device__ __forceinline__ bool visible(int qpos, int kpos, const Args& a) {
  bool ok = qpos < a.Sq && kpos < a.Sk;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && kpos > qpos - a.window;
  return ok;
}

// whether any query of [q0, q1] sees any key of [k0, k1]
__device__ __forceinline__ bool tiles_meet(int q0, int q1, int k0, int k1,
                                           const Args& a) {
  q1 = min(q1, a.Sq - 1);
  k1 = min(k1, a.Sk - 1);
  if (q0 > q1 || k0 > k1) return false;
  if (a.causal && k0 > q1) return false;
  if (a.window > 0 && k1 <= q0 - a.window) return false;
  return true;
}

// ---------------------------------------------------------------- pass 1
template <typename T>
__global__ void __launch_bounds__(256) bwd_delta(Args a, int D) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Sq * a.H) return;     // whole warp together
  const int h = (int)(row % a.H);
  const long long bi = row / a.H;
  const int i = (int)(bi % a.Sq), b = (int)(bi / a.Sq);
  const T* op = static_cast<const T*>(a.o) + b * a.so.b + i * a.so.s + h * a.so.h;
  const T* gp = static_cast<const T*>(a.dout) + b * a.sdo.b + i * a.sdo.s +
                h * a.sdo.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(op[d]), to_f32(gp[d]), acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[((long long)b * a.H + h) * a.Sq + i] = acc;
}

// ---------------------------------------------------------------------------
// FMA kernels (any input type, every product in f32 on the CUDA cores).
// 256 threads; 64-row query and key tiles in shared memory, transposed
// ([d][row], rows padded to 68) so that each thread's 4 x 4 micro-tile of S
// and dP reads float4s, as in the forward's FMA kernel.  The thread that
// accumulates dK/dV (or dQ) owns one tile row and the columns cg + 4c.
// ---------------------------------------------------------------------------
constexpr int kT = 64;
constexpr int kPitch = 68;
constexpr int kThreads = 256;

template <int D>
constexpr int dkdv_fma_floats() { return 4 * D * kPitch + 2 * kT * kPitch + 2 * kT; }
template <int D>
constexpr int dq_fma_floats() { return 4 * D * kPitch + kT * kPitch + 2 * kT; }

// S and dP micro-tiles: rows ty*4+i of A/G (queries), columns tx*4+j of
// B/V (keys), from transposed tiles
template <int D>
__device__ __forceinline__ void micro_tiles(const float* At, const float* Bt,
                                            const float* Gt, const float* Vt,
                                            int ty, int tx, float (&s)[4][4],
                                            float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 qa = *reinterpret_cast<const float4*>(&At[d * kPitch + ty * 4]);
    const float4 kb = *reinterpret_cast<const float4*>(&Bt[d * kPitch + tx * 4]);
    const float4 ga = *reinterpret_cast<const float4*>(&Gt[d * kPitch + ty * 4]);
    const float4 vb = *reinterpret_cast<const float4*>(&Vt[d * kPitch + tx * 4]);
    const float q4[4] = {qa.x, qa.y, qa.z, qa.w}, k4[4] = {kb.x, kb.y, kb.z, kb.w};
    const float g4[4] = {ga.x, ga.y, ga.z, ga.w}, v4[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(q4[i], k4[j], s[i][j]);
        dp[i][j] = fmaf(g4[i], v4[j], dp[i][j]);
      }
  }
}

// rows [r0, r0 + kT) of a (B, S, heads, D) tensor into a transposed tile,
// zeros past n
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long rs,
                                       int r0, int n) {
  for (int i = threadIdx.x; i < kT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[d * kPitch + r] = (r0 + r < n) ? to_f32(src[(r0 + r) * rs + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_fma(Args a) {
  constexpr int DC = D / 4;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);   // [D][kPitch] keys
  float* Vt = Kt + D * kPitch;
  float* Qt = Vt + D * kPitch;                   // [D][kPitch] queries
  float* Gt = Qt + D * kPitch;                   // dO
  float* Ps = Gt + D * kPitch;                   // [query][kPitch]
  float* Ss = Ps + kT * kPitch;                  // dS, [query][kPitch]
  float* Ls = Ss + kT * kPitch;                  // lse of the tile's queries
  float* Ds = Ls + kT;                           // delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int jr = tid >> 2, cg = tid & 3;
  const int k0 = blockIdx.x * kT, kvh = blockIdx.y, b = blockIdx.z;
  load_t<T, D>(Kt, static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h,
               a.sk.s, k0, a.Sk);
  load_t<T, D>(Vt, static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h,
               a.sv.s, k0, a.Sk);

  float dk[DC], dv[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dk[c] = dv[c] = 0.f;

  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
    const T* gp = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    const float* lp = a.lse + ((long long)b * a.H + h) * a.Sq;
    const float* dl = a.delta + ((long long)b * a.H + h) * a.Sq;
    for (int q0 = 0; q0 < a.Sq; q0 += kT) {
      if (!tiles_meet(q0, q0 + kT - 1, k0, k0 + kT - 1, a)) continue;
      __syncthreads();   // K/V stored; the previous tile's readers done
      load_t<T, D>(Qt, qp, a.sq.s, q0, a.Sq);
      load_t<T, D>(Gt, gp, a.sdo.s, q0, a.Sq);
      if (tid < kT) {
        const bool in = q0 + tid < a.Sq;
        Ls[tid] = in ? lp[q0 + tid] : 0.f;
        Ds[tid] = in ? dl[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      micro_tiles<D>(Qt, Kt, Gt, Vt, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float p4[4], s4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = visible(q0 + r, k0 + tx * 4 + j, a)
                              ? expf(s[i][j] * a.scale - Ls[r]) : 0.f;
          p4[j] = p;
          s4[j] = p * (dp[i][j] - Ds[r]);
        }
        *reinterpret_cast<float4*>(&Ps[r * kPitch + tx * 4]) =
            make_float4(p4[0], p4[1], p4[2], p4[3]);
        *reinterpret_cast<float4*>(&Ss[r * kPitch + tx * 4]) =
            make_float4(s4[0], s4[1], s4[2], s4[3]);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        const float p = Ps[i * kPitch + jr], ds = Ss[i * kPitch + jr];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = cg + 4 * c;
          dv[c] = fmaf(p, Gt[d * kPitch + i], dv[c]);
          dk[c] = fmaf(ds, Qt[d * kPitch + i], dk[c]);
        }
      }
    }
  }
  if (k0 + jr < a.Sk) {
    T* dkp = static_cast<T*>(a.dk) + b * a.sdk.b + (k0 + jr) * a.sdk.s + kvh * a.sdk.h;
    T* dvp = static_cast<T*>(a.dv) + b * a.sdv.b + (k0 + jr) * a.sdv.s + kvh * a.sdv.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkp[cg + 4 * c] = from_f32<T>(dk[c] * a.scale);
      dvp[cg + 4 * c] = from_f32<T>(dv[c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_fma(Args a) {
  constexpr int DC = D / 4;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kPitch] queries
  float* Gt = Qt + D * kPitch;                   // dO
  float* Kt = Gt + D * kPitch;                   // [D][kPitch] keys
  float* Vt = Kt + D * kPitch;
  float* Ss = Vt + D * kPitch;                   // dS, [query][kPitch]
  float* Ls = Ss + kT * kPitch;
  float* Ds = Ls + kT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ir = tid >> 2, cg = tid & 3;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  load_t<T, D>(Qt, static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h,
               a.sq.s, q0, a.Sq);
  load_t<T, D>(Gt, static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h,
               a.sdo.s, q0, a.Sq);
  if (tid < kT) {
    const bool in = q0 + tid < a.Sq;
    const long long base = ((long long)b * a.H + h) * a.Sq + q0 + tid;
    Ls[tid] = in ? a.lse[base] : 0.f;
    Ds[tid] = in ? a.delta[base] : 0.f;
  }
  const T* kp = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  float dq[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dq[c] = 0.f;

  for (int k0 = 0; k0 < a.Sk; k0 += kT) {
    if (!tiles_meet(q0, q0 + kT - 1, k0, k0 + kT - 1, a)) continue;
    __syncthreads();   // Q/dO stored; the previous tile's readers done
    load_t<T, D>(Kt, kp, a.sk.s, k0, a.Sk);
    load_t<T, D>(Vt, vp, a.sv.s, k0, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    micro_tiles<D>(Qt, Kt, Gt, Vt, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float s4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(q0 + r, k0 + tx * 4 + j, a)
                            ? expf(s[i][j] * a.scale - Ls[r]) : 0.f;
        s4[j] = p * (dp[i][j] - Ds[r]);
      }
      *reinterpret_cast<float4*>(&Ss[r * kPitch + tx * 4]) =
          make_float4(s4[0], s4[1], s4[2], s4[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      const float ds = Ss[ir * kPitch + j];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        dq[c] = fmaf(ds, Kt[(cg + 4 * c) * kPitch + j], dq[c]);
    }
  }
  if (q0 + ir < a.Sq) {
    T* dqp = static_cast<T*>(a.dq) + b * a.sdq.b + (q0 + ir) * a.sdq.s + h * a.sdq.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) dqp[cg + 4 * c] = from_f32<T>(dq[c] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulators, 4 warps.
//
// dK/dV: a block owns 64 keys (16 per warp) of one (batch, kv head) and walks
// 32-query steps.  Per step each warp forms S^T = K Q^T and dP^T = V dO^T for
// its 16 keys (K and V A-fragments read from padded shared tiles, Q and dO
// B-fragments as 32-bit row reads), turns them into P^T and dS^T in
// registers, and feeds those, as bf16 A-fragments straight from the
// accumulator layout, to dV += P^T dO and dK += dS^T Q with dO and Q read by
// ldmatrix.trans.  dQ: a block owns 64 queries (16 per warp) with their Q and
// dO fragments in registers and walks 32-key steps: S = Q K^T, dP = dO V^T,
// dS, then dQ += dS K with K read by ldmatrix.trans.  Shared rows are padded
// by 8 halves so that fragment loads hit 32 distinct banks.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;
constexpr int kKeyTile = 64;   // dK/dV block: keys
constexpr int kQStep = 32;     // dK/dV block: queries per step
constexpr int kQTile = 64;     // dQ block: queries
constexpr int kKStep = 32;     // dQ block: keys per step

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
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

// rows [r0, r0 + n_rows) of a (B, S, heads, D) bf16 tensor into a padded
// row-major tile, 16 bytes at a time, zeros past n
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long rs, int r0, int n_rows,
                                          int n) {
  constexpr int CH = D / 8, P = D + 8;
  for (int i = threadIdx.x; i < n_rows * CH; i += kMmaThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(&dst[r * P + c]) = val;
  }
}

// the A-fragments (rows r, r + 8; columns kc*16 + tig*2 (+8)) of a padded tile
template <int D>
__device__ __forceinline__ void frag_a(unsigned* f, const bf16* tile, int r,
                                       int kc, int tig) {
  constexpr int P = D + 8;
  const bf16* p0 = tile + r * P + kc * 16 + tig * 2;
  const bf16* p1 = p0 + 8 * P;
  f[0] = ld32(p0);
  f[1] = ld32(p1);
  f[2] = ld32(p0 + 8);
  f[3] = ld32(p1 + 8);
}

// bf16 A-fragments of a 16 x 16 chunk of an accumulator tile (n-tiles 2kk
// and 2kk + 1)
__device__ __forceinline__ void acc_to_a(unsigned* f, float (*acc)[4],
                                         int kk) {
  f[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  f[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  f[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  f[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

template <int D>
constexpr int dkdv_mma_bytes() {
  return (2 * kKeyTile + 2 * kQStep) * (D + 8) * 2 + 2 * kQStep * 4;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dkdv_mma(Args a,
                                                            float scale_log2) {
  constexpr int P = D + 8, KC = D / 16, NT = kQStep / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [kKeyTile][P]
  bf16* Vs = Ks + kKeyTile * P;
  bf16* Qs = Vs + kKeyTile * P;                    // [kQStep][P]
  bf16* Gs = Qs + kQStep * P;                      // dO
  float* L2 = reinterpret_cast<float*>(Gs + kQStep * P);   // lse * log2 e
  float* Dl = L2 + kQStep;                                 // delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kKeyTile, kvh = blockIdx.y, b = blockIdx.z;
  const int kr = warp * 16 + g;                 // this thread's key rows kr, kr + 8
  const int kpos0 = k0 + kr, kpos1 = kpos0 + 8;
  load_rows<D>(Ks, static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h,
               a.sk.s, k0, kKeyTile, a.Sk);
  load_rows<D>(Vs, static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h,
               a.sv.s, k0, kKeyTile, a.Sk);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[nt][c] = dv[nt][c] = 0.f;

  for (int gh = 0; gh < a.G; ++gh) {
    const int h = kvh * a.G + gh;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
    const bf16* gp = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    const float* lp = a.lse + ((long long)b * a.H + h) * a.Sq;
    const float* dl = a.delta + ((long long)b * a.H + h) * a.Sq;
    for (int q0 = 0; q0 < a.Sq; q0 += kQStep) {
      if (!tiles_meet(q0, q0 + kQStep - 1, k0, k0 + kKeyTile - 1, a)) continue;
      __syncthreads();   // K/V stored; the previous step's readers done
      load_rows<D>(Qs, qp, a.sq.s, q0, kQStep, a.Sq);
      load_rows<D>(Gs, gp, a.sdo.s, q0, kQStep, a.Sq);
      if (tid < kQStep) {
        const bool in = q0 + tid < a.Sq;
        L2[tid] = in ? lp[q0 + tid] * kLog2e : 0.f;
        Dl[tid] = in ? dl[q0 + tid] : 0.f;
      }
      __syncthreads();

      float st[NT][4], dpt[NT][4];   // S^T and dP^T: rows keys, columns queries
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[nt][c] = dpt[nt][c] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        unsigned ka[4], va[4];
        frag_a<D>(ka, Ks, kr, kc, tig);
        frag_a<D>(va, Vs, kr, kc, tig);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* qr = &Qs[(nt * 8 + g) * P + kc * 16 + tig * 2];
          const bf16* gr = &Gs[(nt * 8 + g) * P + kc * 16 + tig * 2];
          mma_bf16(st[nt], ka, ld32(qr), ld32(qr + 8));
          mma_bf16(dpt[nt], va, ld32(gr), ld32(gr + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = nt * 8 + tig * 2 + (c & 1);
          const float p = visible(q0 + qi, c < 2 ? kpos0 : kpos1, a)
                              ? exp2f(st[nt][c] * scale_log2 - L2[qi]) : 0.f;
          st[nt][c] = p;
          dpt[nt][c] = p * (dpt[nt][c] - Dl[qi]);
        }

#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk) {
        unsigned pa[4], sa[4];
        acc_to_a(pa, st, kk);
        acc_to_a(sa, dpt, kk);
        const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int nt = 0; nt < DT; nt += 2) {
          unsigned b4[4];
          ldmatrix_x4_trans(b4, &Gs[vrow * P + (nt + (lane >> 4)) * 8]);
          mma_bf16(dv[nt], pa, b4[0], b4[1]);
          mma_bf16(dv[nt + 1], pa, b4[2], b4[3]);
          ldmatrix_x4_trans(b4, &Qs[vrow * P + (nt + (lane >> 4)) * 8]);
          mma_bf16(dk[nt], sa, b4[0], b4[1]);
          mma_bf16(dk[nt + 1], sa, b4[2], b4[3]);
        }
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h;
#pragma unroll
  for (int nt = 0; nt < DT; ++nt) {
    const int c = nt * 8 + tig * 2;
    if (kpos0 < a.Sk) {
      *reinterpret_cast<unsigned*>(dkp + kpos0 * a.sdk.s + c) =
          pack_bf16(dk[nt][0] * a.scale, dk[nt][1] * a.scale);
      *reinterpret_cast<unsigned*>(dvp + kpos0 * a.sdv.s + c) =
          pack_bf16(dv[nt][0], dv[nt][1]);
    }
    if (kpos1 < a.Sk) {
      *reinterpret_cast<unsigned*>(dkp + kpos1 * a.sdk.s + c) =
          pack_bf16(dk[nt][2] * a.scale, dk[nt][3] * a.scale);
      *reinterpret_cast<unsigned*>(dvp + kpos1 * a.sdv.s + c) =
          pack_bf16(dv[nt][2], dv[nt][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma(Args a,
                                                          float scale_log2) {
  constexpr int P = D + 8, KC = D / 16, NT = kKStep / 8, DT = D / 8;
  __shared__ __align__(16) bf16 Ks[kKStep * P];
  __shared__ __align__(16) bf16 Vs[kKStep * P];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* gp = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  unsigned qa[KC][4], ga[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + tig * 2;
    qa[kc][0] = row0 < a.Sq ? ld32(qp + row0 * a.sq.s + c) : 0u;
    qa[kc][1] = row1 < a.Sq ? ld32(qp + row1 * a.sq.s + c) : 0u;
    qa[kc][2] = row0 < a.Sq ? ld32(qp + row0 * a.sq.s + c + 8) : 0u;
    qa[kc][3] = row1 < a.Sq ? ld32(qp + row1 * a.sq.s + c + 8) : 0u;
    ga[kc][0] = row0 < a.Sq ? ld32(gp + row0 * a.sdo.s + c) : 0u;
    ga[kc][1] = row1 < a.Sq ? ld32(gp + row1 * a.sdo.s + c) : 0u;
    ga[kc][2] = row0 < a.Sq ? ld32(gp + row0 * a.sdo.s + c + 8) : 0u;
    ga[kc][3] = row1 < a.Sq ? ld32(gp + row1 * a.sdo.s + c + 8) : 0u;
  }
  const long long stat = ((long long)b * a.H + h) * a.Sq;
  const float l0 = row0 < a.Sq ? a.lse[stat + row0] * kLog2e : 0.f;
  const float l1 = row1 < a.Sq ? a.lse[stat + row1] * kLog2e : 0.f;
  const float d0 = row0 < a.Sq ? a.delta[stat + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.delta[stat + row1] : 0.f;

  float dq[DT][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[nt][c] = 0.f;

  for (int k0 = 0; k0 < a.Sk; k0 += kKStep) {
    if (!tiles_meet(q0, q0 + kQTile - 1, k0, k0 + kKStep - 1, a)) continue;
    __syncthreads();   // the previous step's readers are done
    load_rows<D>(Ks, kp, a.sk.s, k0, kKStep, a.Sk);
    load_rows<D>(Vs, vp, a.sv.s, k0, kKStep, a.Sk);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kr = &Ks[(nt * 8 + g) * P + kc * 16 + tig * 2];
        const bf16* vr = &Vs[(nt * 8 + g) * P + kc * 16 + tig * 2];
        mma_bf16(s[nt], qa[kc], ld32(kr), ld32(kr + 8));
        mma_bf16(dp[nt], ga[kc], ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool top = c < 2;
        const int kpos = k0 + nt * 8 + tig * 2 + (c & 1);
        const float p = visible(top ? row0 : row1, kpos, a)
                            ? exp2f(s[nt][c] * scale_log2 - (top ? l0 : l1)) : 0.f;
        s[nt][c] = p * (dp[nt][c] - (top ? d0 : d1));   // dS
      }
#pragma unroll
    for (int kk = 0; kk < kKStep / 16; ++kk) {
      unsigned sa[4];
      acc_to_a(sa, s, kk);
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nt = 0; nt < DT; nt += 2) {
        unsigned b4[4];
        ldmatrix_x4_trans(b4, &Ks[vrow * P + (nt + (lane >> 4)) * 8]);
        mma_bf16(dq[nt], sa, b4[0], b4[1]);
        mma_bf16(dq[nt + 1], sa, b4[2], b4[3]);
      }
    }
  }

  bf16* dqp = static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int nt = 0; nt < DT; ++nt) {
    const int c = nt * 8 + tig * 2;
    if (row0 < a.Sq)
      *reinterpret_cast<unsigned*>(dqp + row0 * a.sdq.s + c) =
          pack_bf16(dq[nt][0] * a.scale, dq[nt][1] * a.scale);
    if (row1 < a.Sq)
      *reinterpret_cast<unsigned*>(dqp + row1 * a.sdq.s + c) =
          pack_bf16(dq[nt][2] * a.scale, dq[nt][3] * a.scale);
  }
}

// ---------------------------------------------------------------- launch
int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

template <typename T>
int launch_delta(const Args& a, int D, cudaStream_t s) {
  bwd_delta<T><<<cdiv((long long)a.B * a.Sq * a.H, 8), 256, 0, s>>>(a, D);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fma(const Args& a, cudaStream_t s) {
  const int sm1 = (int)sizeof(float) * dkdv_fma_floats<D>();
  const int sm2 = (int)sizeof(float) * dq_fma_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      bwd_dq_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm2);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_delta<T>(a, D, s);
  if (rc) return rc;
  bwd_dkdv_fma<T, D><<<dim3(cdiv(a.Sk, kT), a.K, a.B), kThreads, sm1, s>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bwd_dq_fma<T, D><<<dim3(cdiv(a.Sq, kT), a.H, a.B), kThreads, sm2, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const Args& a, cudaStream_t s) {
  const int sm = dkdv_mma_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = a.scale * kLog2e;
  int rc = launch_delta<bf16>(a, D, s);
  if (rc) return rc;
  bwd_dkdv_mma<D><<<dim3(cdiv(a.Sk, kKeyTile), a.K, a.B), kMmaThreads, sm, s>>>(
      a, scale_log2);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bwd_dq_mma<D><<<dim3(cdiv(a.Sq, kQTile), a.H, a.B), kMmaThreads, 0, s>>>(
      a, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma_d(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch_fma<T, 32>(a, s);
    case 64: return launch_fma<T, 64>(a, s);
    case 128: return launch_fma<T, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the tensor-core kernels read 16-byte chunks of K, V, Q and dO rows and
// 4-byte pairs elsewhere: every base pointer 16-byte aligned and every
// stride a multiple of 8 elements
bool mma_aligned(const Args& a) {
  for (const void* p : {a.q, a.k, a.v, a.o, a.dout,
                        static_cast<const void*>(a.dq),
                        static_cast<const void*>(a.dk),
                        static_cast<const void*>(a.dv)})
    if (reinterpret_cast<unsigned long long>(p) % 16) return false;
  for (const Str& t : {a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq, a.sdk, a.sdv})
    if (t.b % 8 || t.s % 8 || t.h % 8) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv share it).
// q, o, dout, dq are (B, Sq, H, D); k, v, dk, dv are (B, Sk, K, D); lse and
// delta are contiguous (B, H, Sq) float32 (lse from the forward, delta
// scratch).  strides holds 24 element strides: (batch, seq, head) of q, k,
// v, o, dout, dq, dk, dv in that order; the D axis is contiguous.  dk and dv
// are written whole (one block per key tile), so they need no zeroing.
// Returns the first CUDA error of the three launches, or 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int K, int D,
    const long long* strides, int causal, int window, float scale,
    void* stream) {
  if (K <= 0 || H % K != 0 || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  Str* st[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i)
    *st[i] = Str{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.K = K; a.G = H / K;
  a.causal = causal; a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fma_d<float>(a, D, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (mma_aligned(a)) {
    switch (D) {
      case 32: return launch_mma<32>(a, s);
      case 64: return launch_mma<64>(a, s);
      case 128: return launch_mma<128>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return launch_fma_d<bf16>(a, D, s);
}
