// Blocked attention, backward: dq, dk, dv of o = softmax(q k^T / sqrt(D) +
// mask) v under the forward's masks (causal, sliding window, ragged tails)
// and GQA, with dk and dv summed over the query heads of each kv head.  q,
// k, dq, dk are (.., D); v, o, dout, dv (.., DV), as in the forward.
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
//      tiles, recomputing S, dP and dS, and keeps dQ in registers.
// Every output element is summed by one thread in a fixed order: no float
// atomics, so the gradient is the same from run to run.
//
// Why a separate dQ pass.  Accumulating dQ inside the dK/dV pass would
// save the recomputed S and dP (the passes run 14 S^2 D flops a head
// against the bound's 10), but every key tile adds into every query tile's
// dQ: without float atomics that needs a global f32 accumulator, a turn
// counter per query tile so that key tile j adds only after j - 1, and
// blocks that spin on blocks that may not be resident yet, plus 2 B H Sq D
// f32 of read-modify-write traffic through L2 per key tile.  The separate
// pass keeps the determinism of one owner per output with no inter-block
// waits, for 40 % more tensor work.
//
// (D, DV) pairs: (32, 32), (64, 64), (80, 80), (128, 128) and (192, 128)
// (DeepSeek-V2's latent attention).  At (192, 128) the rings hold 3 stages
// where the equal dims hold 4 (DkdvLayout, DqLayout: 4 would take 244 and 240
// KB of the 227 KB a block may have), and the dK/dV pass runs as two
// kernels over the same key tiles (kPart below): dK at 64 keys x 192 columns
// is 96 f32 registers a thread and dV 64 more, which with S^T, dP^T and
// their bf16 copies (96) passes the 240 a consumer thread may hold.  The
// first kernel accumulates dV and dK's columns 0-63, the second dK's columns
// 64-191; each recomputes S^T and dP^T, so the pass does 1.5 times the
// tensor work of one kernel.  The dQ product runs at n = 192.
//
// At D = 80 the bf16 kernels store tiles
// padded to 96 columns (hopper.cuh), reduce over D in its 5 real k16 steps
// (S^T, dP^T, S, dP), run the products whose N is D (dV, dK, dQ) at n = 96
// and store columns < 80, as the forward does.
//
// bf16 inputs whose base pointers (and LSE and delta) are 16-byte aligned,
// whose strides are multiples of 8 elements (the DiT path) and whose LSE
// and delta rows start on 16 bytes (a row pitch that is a multiple of 4;
// the wrapper pads the rows of a ragged Sq, such as the dense path's 4609)
// run the TMA / wgmma kernels below (P and dS are rounded to bf16 for the
// second products, as the forward rounds P).  f32 inputs, and bf16 ones that break
// that alignment, run FMA kernels on the CUDA cores, exact to f32 rounding.
//
// What holds the wgmma kernels back now (measured on an H100 SXM,
// PERF.md): the dK/dV pass takes about two thirds of the time and runs its
// products at ~55 % of the tensor cores' peak, the dQ pass at ~70 %.  With
// its exponentials and dS removed the dK/dV pass's products alone ran at
// ~65 %: its two m64n64 shared-memory products read 128 bytes of shared
// memory a clock at the full rate, and the softmax-like work between
// dependent products (S^T before P^T dO, dP^T before dS^T Q) runs in both
// consumer warpgroups at once.
#include "hopper.cuh"

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
  const float* lse;    // (B, H, Sp), natural log, rows of Sq values
  float* delta;        // (B, H, Sp), written by pass 1
  Str sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, Sq, Sk, H, K, G, causal, window;
  int Sp;              // the row pitch of lse and delta, >= Sq
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
  if (lane == 0) a.delta[((long long)b * a.H + h) * a.Sp + i] = acc;
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

template <int D, int DV>
constexpr int dkdv_fma_floats() {
  return 2 * (D + DV) * kPitch + 2 * kT * kPitch + 2 * kT;
}
template <int D, int DV>
constexpr int dq_fma_floats() { return 2 * (D + DV) * kPitch + kT * kPitch + 2 * kT; }

// S and dP micro-tiles: rows ty*4+i of A/G (queries), columns tx*4+j of
// B/V (keys), from transposed tiles (A, B of D rows; G, V of DV)
template <int D, int DV>
__device__ __forceinline__ void micro_tiles(const float* At, const float* Bt,
                                            const float* Gt, const float* Vt,
                                            int ty, int tx, float (&s)[4][4],
                                            float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  constexpr int DM = D < DV ? D : DV;
#pragma unroll 4
  for (int d = 0; d < DM; ++d) {
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
  // the rest of the wider of the two reductions (none at equal dims)
#pragma unroll 4
  for (int d = DM; d < D; ++d) {
    const float4 qa = *reinterpret_cast<const float4*>(&At[d * kPitch + ty * 4]);
    const float4 kb = *reinterpret_cast<const float4*>(&Bt[d * kPitch + tx * 4]);
    const float q4[4] = {qa.x, qa.y, qa.z, qa.w}, k4[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(q4[i], k4[j], s[i][j]);
  }
#pragma unroll 4
  for (int d = DM; d < DV; ++d) {
    const float4 ga = *reinterpret_cast<const float4*>(&Gt[d * kPitch + ty * 4]);
    const float4 vb = *reinterpret_cast<const float4*>(&Vt[d * kPitch + tx * 4]);
    const float g4[4] = {ga.x, ga.y, ga.z, ga.w}, v4[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(g4[i], v4[j], dp[i][j]);
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

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_fma(Args a) {
  constexpr int DC = D / 4, DCV = DV / 4;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);   // [D][kPitch] keys
  float* Vt = Kt + D * kPitch;                   // [DV][kPitch]
  float* Qt = Vt + DV * kPitch;                  // [D][kPitch] queries
  float* Gt = Qt + D * kPitch;                   // dO, [DV][kPitch]
  float* Ps = Gt + DV * kPitch;                  // [query][kPitch]
  float* Ss = Ps + kT * kPitch;                  // dS, [query][kPitch]
  float* Ls = Ss + kT * kPitch;                  // lse of the tile's queries
  float* Ds = Ls + kT;                           // delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int jr = tid >> 2, cg = tid & 3;
  const int k0 = blockIdx.x * kT, kvh = blockIdx.y, b = blockIdx.z;
  load_t<T, D>(Kt, static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h,
               a.sk.s, k0, a.Sk);
  load_t<T, DV>(Vt, static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h,
                a.sv.s, k0, a.Sk);

  float dk[DC], dv[DCV];
#pragma unroll
  for (int c = 0; c < DC; ++c) dk[c] = 0.f;
#pragma unroll
  for (int c = 0; c < DCV; ++c) dv[c] = 0.f;

  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
    const T* gp = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    const float* lp = a.lse + ((long long)b * a.H + h) * a.Sp;
    const float* dl = a.delta + ((long long)b * a.H + h) * a.Sp;
    for (int q0 = 0; q0 < a.Sq; q0 += kT) {
      if (!tiles_meet(q0, q0 + kT - 1, k0, k0 + kT - 1, a)) continue;
      __syncthreads();   // K/V stored; the previous tile's readers done
      load_t<T, D>(Qt, qp, a.sq.s, q0, a.Sq);
      load_t<T, DV>(Gt, gp, a.sdo.s, q0, a.Sq);
      if (tid < kT) {
        const bool in = q0 + tid < a.Sq;
        Ls[tid] = in ? lp[q0 + tid] : 0.f;
        Ds[tid] = in ? dl[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      micro_tiles<D, DV>(Qt, Kt, Gt, Vt, ty, tx, s, dp);
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
        for (int c = 0; c < DCV; ++c)
          dv[c] = fmaf(p, Gt[(cg + 4 * c) * kPitch + i], dv[c]);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          dk[c] = fmaf(ds, Qt[(cg + 4 * c) * kPitch + i], dk[c]);
      }
    }
  }
  if (k0 + jr < a.Sk) {
    T* dkp = static_cast<T*>(a.dk) + b * a.sdk.b + (k0 + jr) * a.sdk.s + kvh * a.sdk.h;
    T* dvp = static_cast<T*>(a.dv) + b * a.sdv.b + (k0 + jr) * a.sdv.s + kvh * a.sdv.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) dkp[cg + 4 * c] = from_f32<T>(dk[c] * a.scale);
#pragma unroll
    for (int c = 0; c < DCV; ++c) dvp[cg + 4 * c] = from_f32<T>(dv[c]);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) bwd_dq_fma(Args a) {
  constexpr int DC = D / 4;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kPitch] queries
  float* Gt = Qt + D * kPitch;                   // dO, [DV][kPitch]
  float* Kt = Gt + DV * kPitch;                  // [D][kPitch] keys
  float* Vt = Kt + D * kPitch;                   // [DV][kPitch]
  float* Ss = Vt + DV * kPitch;                  // dS, [query][kPitch]
  float* Ls = Ss + kT * kPitch;
  float* Ds = Ls + kT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ir = tid >> 2, cg = tid & 3;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  load_t<T, D>(Qt, static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h,
               a.sq.s, q0, a.Sq);
  load_t<T, DV>(Gt, static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h,
                a.sdo.s, q0, a.Sq);
  if (tid < kT) {
    const bool in = q0 + tid < a.Sq;
    const long long base = ((long long)b * a.H + h) * a.Sp + q0 + tid;
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
    load_t<T, DV>(Vt, vp, a.sv.s, k0, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    micro_tiles<D, DV>(Qt, Kt, Gt, Vt, ty, tx, s, dp);
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
// bf16 on Hopper's tensor cores: TMA ring, wgmma, one producer warp.
//
// Both kernels run three warpgroups: warpgroup 0 gives most of its registers
// away (setmaxnreg) and one of its threads TMA-loads tiles into a ring of
// kStages = 4 stages (3 at D = 192; a "full" barrier each, completed by the
// copies, and an
// "empty" one, on which the consumers' eight warps arrive); warpgroups 1 and
// 2 compute, 64 rows each.  Tiles are 64-row TMA boxes laid out for wgmma
// (hopper.cuh): the 128-byte swizzle at D = 128 and 64, the 64-byte one at
// D = 32 and 80 (three 32-column blocks, padded to 96).  Masks are evaluated only on tiles that cross a boundary (ragged
// tail, causal diagonal, window edge); elsewhere every pair is visible.
//
// dK/dV: a block owns kKeyTile = 128 keys of one (batch, kv head); K and V
// stay resident.  The ring brings, for every query head of the group and
// every 64-query tile that meets the key tile, Q, dO, LSE and delta.  Each
// consumer starts S^T = K Q^T and dP^T = V dO^T for its 64 keys (shared-
// memory wgmma m64n64k16, all operands K-major) and waits for S^T only;
// P^T = exp2(S^T scale log2 e - LSE log2 e) is formed while dP^T runs, then
// dV += P^T dO is started (register-A wgmma, dO read MN-major) and dS^T =
// P^T (dP^T - delta) is formed while it runs, then dK += dS^T Q.  P^T and
// dS^T are rounded to bf16 in place (the accumulator layout is the
// A-fragment layout).  A stage is released once the next tile's products
// are started and this tile's dV and dK are done.  dK and dV stay in
// registers until the end.
//
// dQ: a block owns kQTile = 128 queries of one (batch, head); Q and dO stay
// resident and the ring brings 64-key K and V tiles.  Each consumer forms
// S = Q K^T and dP = dO V^T for its 64 rows, P while dP runs, dS, and
// dQ += dS K with K read MN-major, released likewise one tile later.
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 384;
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may have
constexpr int kKeyTile = 128;  // dK/dV block: keys, 64 a consumer
constexpr int kQStep = 64;     // dK/dV ring stage: queries
constexpr int kQTile = 128;    // dQ block: queries, 64 a consumer
constexpr int kKStep = 64;     // dQ ring stage: keys

using bf16 = __nv_bfloat16;

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;   // (D, heads, S, B) views, 64-row boxes
  CUtensorMap tlse, tdelta;      // flat (B H Sp) f32, 64-value boxes
  Args a;
  float scale_log2;
};

// whether every query of [q0, q1] sees every key of [k0, k1]
__device__ __forceinline__ bool tiles_full(int q0, int q1, int k0, int k1,
                                           const Args& a) {
  if (q1 >= a.Sq || k1 >= a.Sk) return false;
  if (a.causal && k1 > q0) return false;
  if (a.window > 0 && k0 <= q1 - a.window) return false;
  return true;
}

// K and V resident, then the ring of (Q, dO, LSE, delta) stages, then the
// barriers; 4 stages where they fit, else 3
template <int D, int DV, int kS>
struct DkdvLayoutS {
  using KT = hopper::Tile<D, kKeyTile>;
  using VT = hopper::Tile<DV, kKeyTile>;
  using QT = hopper::Tile<D, kQStep>;
  using OT = hopper::Tile<DV, kQStep>;
  static constexpr int kStages = kS;
  static constexpr int kK = 0;
  static constexpr int kV = KT::kBytes;
  static constexpr int kRing = KT::kBytes + VT::kBytes;
  static constexpr int kDo = QT::kBytes;            // within a stage
  static constexpr int kLse = QT::kBytes + OT::kBytes;
  static constexpr int kDelta = kLse + 512;
  static constexpr int kStage = kLse + 1024;
  static constexpr int kStageTx = QT::kBytes + OT::kBytes + 2 * kQStep * 4;
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int DV>
using DkdvLayout = DkdvLayoutS<D, DV,
                               DkdvLayoutS<D, DV, 4>::kBytes <= kSmemMax ? 4 : 3>;

// Which accumulators a dK/dV kernel keeps: kPart 0 all of dK and dV (the
// equal dims), 1 dV and dK's first 64 columns, 2 dK's columns from 64 on
// (the two kernels of a split pass, module comment).
template <int D, int DV>
constexpr bool dkdv_split() { return D != DV; }

template <int D, int DV, int kPart>
struct DkdvPart {
  static constexpr int DP = hopper::Tile<D, kQStep>::DP;
  static constexpr bool kDv = kPart != 2;
  static constexpr int kC0 = kPart == 2 ? 64 : 0;      // dK's first column
  static constexpr int kN = kPart == 0 ? DP : kPart == 1 ? 64 : DP - 64;
};

template <int D, int DV, int kPart>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dkdv_wgmma(const __grid_constant__ BwdParams p) {
  using L = DkdvLayout<D, DV>;
  using Part = DkdvPart<D, DV, kPart>;
  constexpr int kStages = L::kStages;
  static_assert(L::kBytes <= kSmemMax, "the ring does not fit");
  const Args& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;
  const int k0 = blockIdx.x * kKeyTile, kvh = blockIdx.y, b = blockIdx.z;
  const int n_qt = (a.Sq + kQStep - 1) / kQStep;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(full_kv, L::KT::kBytes + L::VT::kBytes);
      hopper::load_tile<D, kKeyTile>(sm + L::kK, &p.tk, full_kv, kvh, k0, b);
      hopper::load_tile<DV, kKeyTile>(sm + L::kV, &p.tv, full_kv, kvh, k0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int gh = 0; gh < a.G; ++gh) {
        const int h = kvh * a.G + gh;
        const int row = (b * a.H + h) * a.Sp;
        for (int qt = 0; qt < n_qt; ++qt) {
          const int q0 = qt * kQStep;
          if (!tiles_meet(q0, q0 + kQStep - 1, k0, k0 + kKeyTile - 1, a))
            continue;
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = sm + L::kRing + stage * L::kStage;
          hopper::mbar_expect_tx(&full[stage], L::kStageTx);
          hopper::load_tile<D, kQStep>(st, &p.tq, &full[stage], h, q0, b);
          hopper::load_tile<DV, kQStep>(st + L::kDo, &p.tdo, &full[stage], h,
                                        q0, b);
          hopper::tma_load_1d(st + L::kLse, &p.tlse, &full[stage], row + q0);
          hopper::tma_load_1d(st + L::kDelta, &p.tdelta, &full[stage],
                              row + q0);
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<240>();

  constexpr int NK = Part::kN / 2;    // dK accumulator registers
  constexpr int NV = Part::kDv ? L::VT::DP / 2 : 1;   // dV's
  constexpr int NS = kQStep / 2;      // S^T / dP^T accumulator registers
  const int tid = threadIdx.x & 127, w = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int kw = k0 + 64 * w;                   // this warpgroup's first key
  const int kpos0 = kw + warp * 16 + g, kpos1 = kpos0 + 8;

  float dk[NK], dv[NV];   // first written by the first tile's products

  hopper::mbar_wait(full_kv, 0);
  int stage = 0, prev = -1;   // prev: the stage whose dV, dK are in flight
  uint32_t phase = 0;
  uint32_t pa[kQStep / 16][4], sa[kQStep / 16][4];
  for (int gh = 0; gh < a.G; ++gh) {
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kQStep;
      if (!tiles_meet(q0, q0 + kQStep - 1, k0, k0 + kKeyTile - 1, a))
        continue;
      const unsigned char* st = sm + L::kRing + stage * L::kStage;
      const float* ls = reinterpret_cast<const float*>(st + L::kLse);
      const float* dl = reinterpret_cast<const float*>(st + L::kDelta);
      hopper::mbar_wait(&full[stage], phase);
      float s[NS], dp[NS];   // S^T and dP^T: rows keys, columns queries
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        hopper::wgmma_ss(s, hopper::desc_k<D, kKeyTile>(sm + L::kK, 64 * w, kc),
                         hopper::desc_k<D, kQStep>(st, 0, kc), kc > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < DV / 16; ++kc)
        hopper::wgmma_ss(dp, hopper::desc_k<DV, kKeyTile>(sm + L::kV, 64 * w, kc),
                         hopper::desc_k<DV, kQStep>(st + L::kDo, 0, kc), kc > 0);
      hopper::wgmma_commit();
      if (prev >= 0) {   // the previous tile's dV and dK (or dK) are done
        hopper::wgmma_wait<2>();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);

      // P^T, rounded to bf16, while dP^T is formed
      const bool masked = !tiles_full(q0, q0 + kQStep - 1, kw, kw + 63, a);
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + j * 8 + tg * 2);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[4 * j + c] = hopper::ex2(fmaf(s[4 * j + c], p.scale_log2, nl[c & 1]));
      }
      if (masked) {
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (!visible(q0 + j * 8 + tg * 2 + (c & 1), c < 2 ? kpos0 : kpos1, a))
              s[4 * j + c] = 0.f;
      }
      if constexpr (Part::kDv) {
#pragma unroll
        for (int kk = 0; kk < kQStep / 16; ++kk) hopper::acc_to_a(pa[kk], s, kk);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQStep / 16; ++kk)
          hopper::wgmma_rs_tb(dv, pa[kk],
                              hopper::desc_mn<DV, kQStep>(st + L::kDo, kk),
                              prev >= 0 || kk > 0);
        hopper::wgmma_commit();
        // dS^T = P^T (dP^T - delta) while dV accumulates
        hopper::wgmma_wait<1>();
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + j * 8 + tg * 2);
        const float dd[2] = {d2.x, d2.y};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dp[4 * j + c] = s[4 * j + c] * (dp[4 * j + c] - dd[c & 1]);
      }
#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk) hopper::acc_to_a(sa[kk], dp, kk);
      hopper::wgmma_fence();
      // dK's columns [kC0, kC0 + kN): Q from its column block kC0 / 64
      const unsigned char* qc = st + (Part::kC0 / L::QT::W) * L::QT::kBlock;
#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk)
        hopper::wgmma_rs_tb(dk, sa[kk], hopper::desc_mn<D, kQStep>(qc, kk),
                            prev >= 0 || kk > 0);
      hopper::wgmma_commit();
      prev = stage;
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dv);
  hopper::fence_regs(dk);
  if (prev < 0) {   // no query sees these keys
#pragma unroll
    for (int i = 0; i < NK; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) dv[i] = 0.f;
  }

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.sdk.b + kvh * a.sdk.h;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.sdv.b + kvh * a.sdv.h;
  // dK's real columns of this part, not the padding
  constexpr int kKCols = (D - Part::kC0 < Part::kN ? D - Part::kC0 : Part::kN);
#pragma unroll
  for (int j = 0; j < kKCols / 8; ++j) {
    const int c = Part::kC0 + j * 8 + tg * 2;
    if (kpos0 < a.Sk)
      *reinterpret_cast<uint32_t*>(dkp + kpos0 * a.sdk.s + c) =
          hopper::pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
    if (kpos1 < a.Sk)
      *reinterpret_cast<uint32_t*>(dkp + kpos1 * a.sdk.s + c) =
          hopper::pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
  }
  if constexpr (Part::kDv) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {   // the DV real columns
      const int c = j * 8 + tg * 2;
      if (kpos0 < a.Sk)
        *reinterpret_cast<uint32_t*>(dvp + kpos0 * a.sdv.s + c) =
            hopper::pack_bf16(dv[4 * j], dv[4 * j + 1]);
      if (kpos1 < a.Sk)
        *reinterpret_cast<uint32_t*>(dvp + kpos1 * a.sdv.s + c) =
            hopper::pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// Q and dO resident, then the ring of (K, V) stages, then the barriers; 4
// stages where they fit, else 3
template <int D, int DV, int kS>
struct DqLayoutS {
  using QT = hopper::Tile<D, kQTile>;
  using OT = hopper::Tile<DV, kQTile>;
  using KT = hopper::Tile<D, kKStep>;
  using VT = hopper::Tile<DV, kKStep>;
  static constexpr int kStages = kS;
  static constexpr int kQ = 0;
  static constexpr int kDo = QT::kBytes;
  static constexpr int kRing = QT::kBytes + OT::kBytes;
  static constexpr int kStage = KT::kBytes + VT::kBytes;   // K, then V
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int DV>
using DqLayout = DqLayoutS<D, DV,
                           DqLayoutS<D, DV, 4>::kBytes <= kSmemMax ? 4 : 3>;

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_dq_wgmma(const __grid_constant__ BwdParams p) {
  using L = DqLayout<D, DV>;
  constexpr int kStages = L::kStages;
  static_assert(L::kBytes <= kSmemMax, "the ring does not fit");
  const Args& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full_qo = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = full_qo + 1;
  uint64_t* empty = full + kStages;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int n_kt = (a.Sk + kKStep - 1) / kKStep;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_qo, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(full_qo, L::QT::kBytes + L::OT::kBytes);
      hopper::load_tile<D, kQTile>(sm + L::kQ, &p.tq, full_qo, h, q0, b);
      hopper::load_tile<DV, kQTile>(sm + L::kDo, &p.tdo, full_qo, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * kKStep;
        if (!tiles_meet(q0, q0 + kQTile - 1, k0, k0 + kKStep - 1, a)) continue;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = sm + L::kRing + stage * L::kStage;
        hopper::mbar_expect_tx(&full[stage], L::kStage);
        hopper::load_tile<D, kKStep>(st, &p.tk, &full[stage], kvh, k0, b);
        hopper::load_tile<DV, kKStep>(st + L::KT::kBytes, &p.tv, &full[stage],
                                      kvh, k0, b);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<240>();

  constexpr int NA = L::QT::DP / 2;  // dQ accumulator registers
  constexpr int NS = kKStep / 2;     // S / dP accumulator registers
  const int tid = threadIdx.x & 127, w = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int qw = q0 + 64 * w;                   // this warpgroup's first row
  const int row0 = qw + warp * 16 + g, row1 = row0 + 8;
  const long long stat = ((long long)b * a.H + h) * a.Sp;
  const float l0 = row0 < a.Sq ? a.lse[stat + row0] * kLog2e : 0.f;
  const float l1 = row1 < a.Sq ? a.lse[stat + row1] * kLog2e : 0.f;
  const float d0 = row0 < a.Sq ? a.delta[stat + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.delta[stat + row1] : 0.f;

  float dq[NA];   // first written by the first tile's product

  hopper::mbar_wait(full_qo, 0);
  int stage = 0, prev = -1;   // prev: the stage whose dQ product is in flight
  uint32_t phase = 0;
  uint32_t sa[kKStep / 16][4];
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKStep;
    if (!tiles_meet(q0, q0 + kQTile - 1, k0, k0 + kKStep - 1, a)) continue;
    const unsigned char* kt_s = sm + L::kRing + stage * L::kStage;
    const unsigned char* vt_s = kt_s + L::KT::kBytes;
    hopper::mbar_wait(&full[stage], phase);
    float s[NS], dp[NS];
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      hopper::wgmma_ss(s, hopper::desc_k<D, kQTile>(sm + L::kQ, 64 * w, kc),
                       hopper::desc_k<D, kKStep>(kt_s, 0, kc), kc > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < DV / 16; ++kc)
      hopper::wgmma_ss(dp, hopper::desc_k<DV, kQTile>(sm + L::kDo, 64 * w, kc),
                       hopper::desc_k<DV, kKStep>(vt_s, 0, kc), kc > 0);
    hopper::wgmma_commit();
    if (prev >= 0) {   // the previous tile's dQ is done
      hopper::wgmma_wait<2>();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);
    }
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);

    // P while dP is formed, then dS = P (dP - delta)
    const bool masked = !tiles_full(qw, qw + 63, k0, k0 + kKStep - 1, a);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[4 * j + c] = hopper::ex2(fmaf(s[4 * j + c], p.scale_log2,
                                        c < 2 ? -l0 : -l1));
    if (masked) {
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (!visible(c < 2 ? row0 : row1, k0 + j * 8 + tg * 2 + (c & 1), a))
            s[4 * j + c] = 0.f;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[4 * j + c] *= dp[4 * j + c] - (c < 2 ? d0 : d1);   // dS
#pragma unroll
    for (int kk = 0; kk < kKStep / 16; ++kk) hopper::acc_to_a(sa[kk], s, kk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKStep / 16; ++kk)
      hopper::wgmma_rs_tb(dq, sa[kk], hopper::desc_mn<D, kKStep>(kt_s, kk),
                          prev >= 0 || kk > 0);
    hopper::wgmma_commit();
    prev = stage;
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dq);
  if (prev < 0) {   // this row block sees no key
#pragma unroll
    for (int i = 0; i < NA; ++i) dq[i] = 0.f;
  }

  bf16* dqp = static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {   // the D real columns, not the padding
    const int c = j * 8 + tg * 2;
    if (row0 < a.Sq)
      *reinterpret_cast<uint32_t*>(dqp + row0 * a.sdq.s + c) =
          hopper::pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    if (row1 < a.Sq)
      *reinterpret_cast<uint32_t*>(dqp + row1 * a.sdq.s + c) =
          hopper::pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
}

// ---------------------------------------------------------------- launch
int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

template <typename T>
int launch_delta(const Args& a, int D, cudaStream_t s) {
  bwd_delta<T><<<cdiv((long long)a.B * a.Sq * a.H, 8), 256, 0, s>>>(a, D);
  return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
int launch_fma(const Args& a, cudaStream_t s) {
  const int sm1 = (int)sizeof(float) * dkdv_fma_floats<D, DV>();
  const int sm2 = (int)sizeof(float) * dq_fma_floats<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_fma<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      bwd_dq_fma<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm2);
  if (err != cudaSuccess) return (int)err;
  int rc = launch_delta<T>(a, DV, s);
  if (rc) return rc;
  bwd_dkdv_fma<T, D, DV><<<dim3(cdiv(a.Sk, kT), a.K, a.B), kThreads, sm1, s>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  bwd_dq_fma<T, D, DV><<<dim3(cdiv(a.Sq, kT), a.H, a.B), kThreads, sm2, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int DV, int kPart>
int launch_dkdv(const BwdParams& p, cudaStream_t s) {
  static bool sized = false;
  const int rc = size_once(bwd_dkdv_wgmma<D, DV, kPart>,
                           DkdvLayout<D, DV>::kBytes, &sized);
  if (rc) return rc;
  bwd_dkdv_wgmma<D, DV, kPart><<<dim3(cdiv(p.a.Sk, kKeyTile), p.a.K, p.a.B),
                                 kWgThreads, DkdvLayout<D, DV>::kBytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_wgmma(const Args& a, cudaStream_t s) {
  static bool sized = false;
  int rc = size_once(bwd_dq_wgmma<D, DV>, DqLayout<D, DV>::kBytes, &sized);
  if (rc) return rc;
  BwdParams p;
  CUresult cr = encode_bshd(&p.tq, a.q, D, a.H, a.Sq, a.B, a.sq.b, a.sq.s, a.sq.h);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&p.tk, a.k, D, a.K, a.Sk, a.B, a.sk.b, a.sk.s, a.sk.h);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&p.tv, a.v, DV, a.K, a.Sk, a.B, a.sv.b, a.sv.s, a.sv.h);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&p.tdo, a.dout, DV, a.H, a.Sq, a.B, a.sdo.b, a.sdo.s, a.sdo.h);
  const long long rows = (long long)a.B * a.H * a.Sp;
  if (cr == CUDA_SUCCESS) cr = encode_f32_rows(&p.tlse, a.lse, rows);
  if (cr == CUDA_SUCCESS) cr = encode_f32_rows(&p.tdelta, a.delta, rows);
  if (cr != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  p.a = a;
  p.scale_log2 = a.scale * kLog2e;
  rc = launch_delta<bf16>(a, DV, s);
  if (rc) return rc;
  if constexpr (dkdv_split<D, DV>()) {
    rc = launch_dkdv<D, DV, 1>(p, s);
    if (!rc) rc = launch_dkdv<D, DV, 2>(p, s);
  } else {
    rc = launch_dkdv<D, DV, 0>(p, s);
  }
  if (rc) return rc;
  bwd_dq_wgmma<D, DV><<<dim3(cdiv(a.Sq, kQTile), a.H, a.B), kWgThreads,
                        DqLayout<D, DV>::kBytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma_d(const Args& a, int D, int DV, cudaStream_t s) {
#define FA_FMA(d, dv) if (D == d && DV == dv) return launch_fma<T, d, dv>(a, s);
  FA_FMA(32, 32) FA_FMA(64, 64) FA_FMA(80, 80) FA_FMA(128, 128) FA_FMA(192, 128)
#undef FA_FMA
  return (int)cudaErrorInvalidValue;
}

// TMA reads the tiles and the LSE and delta rows: every base pointer 16-byte
// aligned, every stride a multiple of 8 elements (16 bytes) and the LSE and
// delta row pitch a multiple of 4 values, so that every row starts on 16
// bytes (a 1-D TMA load from an address that is not 16-byte aligned is an
// illegal instruction); the outputs are written in 4-byte pairs
bool mma_aligned(const Args& a) {
  if (a.Sp % 4) return false;
  for (const void* p : {a.q, a.k, a.v, a.o, a.dout,
                        static_cast<const void*>(a.lse),
                        static_cast<const void*>(a.delta),
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
// q, dq are (B, Sq, H, D), o, dout (B, Sq, H, Dv); k, dk (B, Sk, K, D), v,
// dv (B, Sk, K, Dv), (D, Dv) one of the pairs above; lse and
// delta are contiguous (B, H, lse_pitch) float32 whose rows hold Sq values
// each (lse from the forward, delta scratch); the bf16 tensor-core path
// needs lse_pitch to be a multiple of 4.  strides holds 24 element strides:
// (batch, seq, head) of q, k, v, o, dout, dq, dk, dv in that order; the D
// axis is contiguous.  dk and dv are written whole (one block per key
// tile), so they need no zeroing.  Returns the first CUDA error of the three
// launches, or 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int K, int D, int Dv,
    int lse_pitch, const long long* strides, int causal, int window,
    float scale, void* stream) {
  if (K <= 0 || H % K != 0 || B <= 0 || Sq <= 0 || Sk <= 0 || lse_pitch < Sq)
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
  a.Sp = lse_pitch;
  a.causal = causal; a.window = window; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fma_d<float>(a, D, Dv, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (mma_aligned(a)) {
#define FA_WG(d, dv) if (D == d && Dv == dv) return launch_wgmma<d, dv>(a, s);
    FA_WG(32, 32) FA_WG(64, 64) FA_WG(80, 80) FA_WG(128, 128) FA_WG(192, 128)
#undef FA_WG
    return (int)cudaErrorInvalidValue;
  }
  return launch_fma_d<bf16>(a, D, Dv, s);
}
