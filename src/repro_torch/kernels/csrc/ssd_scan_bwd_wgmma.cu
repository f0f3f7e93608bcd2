// Backward of the Mamba-2 SSD chunked scan on the tensor cores: bf16 x, B,
// C and dy at Mamba-2's shape (head dim 64, state 128, chunk 128).
//
// Replaces, with csrc/ssd_scan_bwd.cu (the f32 FMA passes, kept for f32 and
// every other shape), the JAX package's autodiff of
// src/repro/models/ssm.py:ssd_chunked.  The route is
// kernels/ssd_scan.py:tensor_core_bwd_route (the forward's
// tensor_core_route and a contiguous dy); a launch error is returned, never
// retried on the FMA passes.  The equations are ssd_scan_bwd.cu's: per
// (b, h) and chunk, with cum the running sum of dt a, total = cum[Q-1],
// S = C B^T, E[q,k] = exp(cum[q] - cum[k]) and M = E dt[k] on and below
// the diagonal, w[k] = exp(total - cum[k]) dt[k], h_prev the state entering
// the chunk and dh the gradient of the state leaving it:
//   dh_prev = exp(total) dh + (exp(cum) dy)^T C
//   dx      = (S M)^T dy + w (B dh^T)
//   dS      = sum_h M (dy x^T);  dC = dS B + sum_h exp(cum) (dy h_prev);
//             dB = dS^T C + sum_h w (x dh)
//   ddt, da from the row and column sums of S E (dy x^T) and the carried
//   terms x.(dh B), dy.(h_prev C), <dh, h_prev> (ref.ssd_scan_bwd_ref).
//
// Bound on the H100: at the training path's shape (B 4, L 4608, H 32)
// ~250 MB of inputs and outputs (0.0747 ms at 3.35 TB/s) and ~69.5 GFLOP
// of products (0.0702 ms on the bf16 tensor cores): bytes, by a little.
//
// Design: four launches, every product on wgmma with f32 accumulation,
// every tile loaded by TMA, no atomics (a rerun gives the same bits).
//   1. ssd_bwd_states: one block per (b, h) walks the chunks forward with
//      the state h (P x N f32) in two consumer warpgroups' registers, the
//      forward's update (exp(total) h + xw_hi^T B + xw_lo^T B, ssd_scan.cu);
//      before each chunk it stages the state entering it as bf16 hi + lo in
//      shared memory and TMA-stores it (4-byte stores straight from the
//      accumulator layout, eight rows a warp, took most of its time).
//   2. ssd_bwd_reverse: one block per (b, h) walks the chunks from last to
//      first with dh (P x N f32) in registers from dhT (or zero) to the
//      first chunk.  A producer warp TMA-loads the chunk's x, dy, B, C and
//      h_prev hi/lo tiles (128 KB: one stage; two would not fit beside the
//      operand tiles).  Warpgroup W owns chunk rows [64W, 64W + 64) as k
//      (dx, the transposed scores) and as q (dy.(h_prev C)), and state
//      columns [64W, 64W + 64) of dh.  Per chunk:
//        a. V = B dh^T and Y = C h_prev^T, each over the hi and lo tiles,
//           and <dh, h_prev> under them; x.V and dy.Y per row, dx = w V;
//        b. per 64 queries: S^T = B C^T and G^T = x dy^T; on and below the
//           diagonal (exp only there) the row and column sums of S E G, the
//           bf16 A operand (S M)^T of dx += (S M)^T dy, and dS^T = (M G)^T,
//           stored as bf16 in the fragments' own order;
//        c. dh = exp(total) dh + ed_hi^T C + ed_lo^T C, ed = exp(cum) dy
//           (the forward's state update, run backwards);
//        d. the producer warpgroup's second warp, handed the chunk's row
//           sums through named barriers: cum's gradient, its reverse running
//           sum dA, ddt, the chunk's part of da, w and exp(cum) for step 3;
//        e. dh's bf16 hi + lo tiles for the next chunk.
//      The row sums and cum of a chunk live in two parity buffers, so step d
//      overlaps the next chunk; dx and dh's hi part (for step 3) leave
//      through staging tiles and TMA stores.
//   3. ssd_bwd_dbc_tc: one block per (chunk, dB or dC, b) sums the heads'
//      dS^T in head order in f32, splits it into bf16 hi + lo for
//      dB = dS^T C (register A) or dC = dS B (shared-memory A, transposed),
//      then adds each head's carried term, (w x) dh or (exp(cum) dy) h_prev,
//      from a four-stage TMA ring of the head's tiles.
//   4. ssd_bwd_da_tc: da summed over (batch, chunk) in order.
// On an H100 SXM (700 W) the four take 0.677 ms at the path shape, 9.1x
// the bound, against 8.05 ms for the FMA passes (PERF.md); their own
// traffic (the scratch below, x and dy read twice) is ~1.3 GB, 0.39 ms.
// Why the sums over the heads take a kernel of their own: B and C are
// shared by the 32 heads, so dB and dC are sums over heads of (Q, N) f32
// terms; summing them where they are formed (one block per head) needs a
// cluster reduction through distributed shared memory, and the per-head
// tiles already fill the reverse kernel's shared memory.  The cost is
// scratch: h_prev hi + lo (B, L/Q, H, P, N) bf16 each, dh's hi part as much
// again, each head's dS^T (3/4 of Q x Q: the quarter above the diagonal is
// zero) as bf16, and w, exp(cum) and the da partials, ~340 MB at the path
// shape, against the FMA passes' ~350 MB.
//
// Precision, by design (ref.ssd_tensor_core_bwd_ref writes it out;
// tests/test_torch_ssm.py holds it against jax.vjp of ssd_chunked).  x, B,
// C and dy enter every product exactly; every sum is f32.  h_prev, dh and
// ed = exp(cum) dy are split into bf16 hi + lo where they reach ddt or da
// (x.(dh B), dy.(h_prev C), <dh, h_prev>, and dh's own update): with any
// one of them rounded once, ddt or da leaves its 1e-4 band on the CPU
// rehearsal.  (S M), each head's dS and the carried terms' operands are
// rounded once to bf16 (dx, dB and dC are themselves bf16, band 1e-2);
// dS summed over the heads is split again.
#include "hopper.cuh"

// Everything here lives in namespace ssd_bwd, as the FMA passes do, so that
// a profiler's kernel names book it as the backward (chip_smoke.py:
// PROFILE_GROUPS).
namespace ssd_bwd {
namespace {

constexpr int kThreads = 384;   // a producer and two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kQ = 128, kP = 64, kN = 128;
using XTile = hopper::Tile<kP, kQ>;   // x, dy, xw, ed: 128 tokens x 64
using BTile = hopper::Tile<kN, kQ>;   // B, C, dS^T: 128 rows x 128
using HTile = hopper::Tile<kN, kP>;   // h_prev, dh: 64 (p) x 128 (n)
// dS^T words (bf16 pairs) of one (b, chunk, head): three 64 x 64 blocks
// (k < 64, q < 64), (k < 64, q >= 64), (k >= 64, q >= 64), 2048 words each
constexpr int kDsWords = 3 * 2048;

__device__ __forceinline__ uint32_t split_bf16(float v0, float v1,
                                               uint32_t* lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  *lo = hopper::pack_bf16(v0 - __low2float(hi), v1 - __high2float(hi));
  return *reinterpret_cast<const uint32_t*>(&hi);
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return make_float2(__low2float(v), __high2float(v));
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* p) {
  return unpack(*reinterpret_cast<const uint32_t*>(p));
}

// byte offset of (row, col) in one 64-column block of a swizzled tile
// (128-byte rows; the 16-byte chunk j of row r lies at j ^ (r % 8))
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cum (the running sum of dt a over the chunk in one fixed order: a warp
// scan, then the sums of the warps before) and dt of token tid, for one
// warpgroup's 128 threads; `bar` is the warpgroup's named barrier
__device__ __forceinline__ void chunk_cum(float dtq, float av, int tid,
                                          float* wsum, float* cum,
                                          float* dts, int bar) {
  const int lane = tid & 31, warp = tid >> 5;
  float v = dtq * av;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) wsum[warp] = v;
  hopper::bar_sync(bar, 128);
  float pre = 0.f;
  for (int i = 0; i < warp; ++i) pre += wsum[i];
  cum[tid] = pre + v;
  dts[tid] = dtq;
  hopper::bar_sync(bar, 128);
}

// Writes w[q] v[q][:] as bf16 hi + lo for this warpgroup's 64 rows of a
// 128 x 64 tile, in the source tile's own (swizzled) layout; w[q] is
// exp2(scale * (off - cum[q])) * (dt[q] or 1)
template <int W>
__device__ __forceinline__ void scaled_split(const unsigned char* src,
                                             unsigned char* hi_t,
                                             unsigned char* lo_t,
                                             const float* cum,
                                             const float* dts, float off,
                                             float sign, bool with_dt,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = 64 * W * 128 + (i * 128 + tid) * 16;
    const int q = o >> 7;
    float wq = hopper::ex2(sign * (off - cum[q]) * kLog2e);
    if (with_dt) wq *= dts[q];
    const uint4 raw = *reinterpret_cast<const uint4*>(src + o);
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack(in[e]);
      hi[e] = split_bf16(v.x * wq, v.y * wq, &lo[e]);
    }
    *reinterpret_cast<uint4*>(hi_t + o) = make_uint4(hi[0], hi[1], hi[2],
                                                     hi[3]);
    *reinterpret_cast<uint4*>(lo_t + o) = make_uint4(lo[0], lo[1], lo[2],
                                                     lo[3]);
  }
}

// A (P x N) state held as a warpgroup's m64n64 accumulator (rows p0,
// p0 + 8; columns 64W + 8j + 2tg, +1): its hi and lo bf16 parts into two
// HTiles
template <int W>
__device__ __forceinline__ void put_state(const float (&s)[32],
                                          unsigned char* hi_t,
                                          unsigned char* lo_t, int p0,
                                          int tg) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t lo;
      const uint32_t hi = split_bf16(s[4 * j + 2 * r], s[4 * j + 2 * r + 1],
                                     &lo);
      const int o = W * HTile::kBlock + swz(p0 + 8 * r, 8 * j + 2 * tg);
      *reinterpret_cast<uint32_t*>(hi_t + o) = hi;
      *reinterpret_cast<uint32_t*>(lo_t + o) = lo;
    }
  }
}

// the thread that issues a kernel's TMA stores: consumer warpgroup 0's first
__device__ __forceinline__ bool store_issuer() { return threadIdx.x == 128; }

// ---------------------------------------------------------------------------
// 1. The states entering each chunk, bf16 hi + lo
// ---------------------------------------------------------------------------
struct StParams {
  CUtensorMap tx, tb, thi, tlo;   // thi/tlo: (N, 1, rows, 1) views of hp
  const float* dt;
  const float* a;
  int L, H, nc;
};

struct StLayout {
  static constexpr int kX = 0;
  static constexpr int kB = XTile::kBytes;
  static constexpr int kStage = kB + BTile::kBytes;
  static constexpr int kXwHi = 2 * kStage;
  static constexpr int kXwLo = kXwHi + XTile::kBytes;
  static constexpr int kSt = kXwLo + XTile::kBytes;     // [par][hi, lo] HTile
  static constexpr int kCum = kSt + 4 * HTile::kBytes;  // [w][cum, dt][Q]
  static constexpr int kWsum = kCum + 2 * 2 * kQ * 4;   // [w][4 warps]
  static constexpr int kBar = kWsum + 2 * 4 * 4;        // full[2], empty[2]
  static constexpr int kBytes = kBar + 4 * 8 + 1024;
};

template <int W>
__device__ __forceinline__ void st_consume(const StParams& p,
                                           unsigned char* sm, uint64_t* full,
                                           uint64_t* empty) {
  using Lay = StLayout;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  float* cum = reinterpret_cast<float*>(sm + Lay::kCum) + W * 2 * kQ;
  float* dts = cum + kQ;
  float* wsum = reinterpret_cast<float*>(sm + Lay::kWsum) + W * 4;
  unsigned char* xw_hi = sm + Lay::kXwHi;
  unsigned char* xw_lo = sm + Lay::kXwLo;
  const float av = p.a[h];
  const float* dtp = p.dt + (long long)b * p.L * p.H + h;
  const int p0 = warp * 16 + g;
  float hs[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) hs[i] = 0.f;
  float dt_next = dtp[(long long)tid * p.H];
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < p.nc; ++c) {
    // the state entering chunk c into this chunk's pair of staging tiles
    // (the TMA store of chunk c - 2 has read them: the wait at its end)
    unsigned char* st_hi = sm + Lay::kSt + (c & 1) * 2 * HTile::kBytes;
    unsigned char* st_lo = st_hi + HTile::kBytes;
    const int row = (int)((((long long)b * p.nc + c) * p.H + h) * kP);
    put_state<W>(hs, st_hi, st_lo, p0, tg);
    if (c + 1 == p.nc) {   // the state leaving the last chunk is unused
      hopper::fence_proxy_async();
      hopper::bar_sync(3, 256);
      if (store_issuer()) {
        hopper::store_tile<kN, kP>(&p.thi, st_hi, 0, row, 0);
        hopper::store_tile<kN, kP>(&p.tlo, st_lo, 0, row, 0);
        hopper::bulk_commit();
        hopper::bulk_wait<0>();
      }
      break;
    }
    chunk_cum(dt_next, av, tid, wsum, cum, dts, 1 + W);
    dt_next = dtp[((long long)(c + 1) * kQ + tid) * p.H];
    const float total = cum[kQ - 1];
    const unsigned char* xt = sm + stage * Lay::kStage + Lay::kX;
    const unsigned char* bt = sm + stage * Lay::kStage + Lay::kB;
    hopper::mbar_wait(&full[stage], phase);
    // xw = exp(total - cum[q]) dt[q] x[q][:] as hi + lo, this warpgroup's rows
    scaled_split<W>(xt, xw_hi, xw_lo, cum, dts, total, 1.f, true, tid);
    hopper::fence_proxy_async();
    hopper::bar_sync(3, 256);
    if (store_issuer()) {
      hopper::store_tile<kN, kP>(&p.thi, st_hi, 0, row, 0);
      hopper::store_tile<kN, kP>(&p.tlo, st_lo, 0, row, 0);
      hopper::bulk_commit();
    }
    const float dec = hopper::ex2(total * kLog2e);
#pragma unroll
    for (int i = 0; i < 32; ++i) hs[i] *= dec;
    const unsigned char* bw = bt + W * BTile::kBlock;
    hopper::fence_regs(hs);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      hopper::wgmma_ss_tt(hs, hopper::desc_mn<kP, kQ>(xw_hi, kk),
                          hopper::desc_mn<kP, kQ>(bw, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      hopper::wgmma_ss_tt(hs, hopper::desc_mn<kP, kQ>(xw_lo, kk),
                          hopper::desc_mn<kP, kQ>(bw, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(hs);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    // chunk c - 1's store has read its staging tiles, which chunk c + 1
    // fills; both warpgroups' products have read the xw tiles
    if (store_issuer()) hopper::bulk_wait_read<1>();
    hopper::bar_sync(3, 256);
    if (++stage == 2) { stage = 0; phase ^= 1; }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_states(const __grid_constant__ StParams p) {
  using Lay = StLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::kBar);
  uint64_t* empty = full + 2;
  const int h = blockIdx.x, b = blockIdx.y;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
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
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c + 1 < p.nc; ++c) {
        unsigned char* ring = sm + stage * Lay::kStage;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_expect_tx(&full[stage], Lay::kStage);
        hopper::load_tile<kP, kQ>(ring + Lay::kX, &p.tx, &full[stage], h,
                                  c * kQ, b);
        hopper::load_tile<kN, kQ>(ring + Lay::kB, &p.tb, &full[stage], 0,
                                  c * kQ, b);
        if (++stage == 2) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<240>();
  if (wg == 1)
    st_consume<0>(p, sm, full, empty);
  else
    st_consume<1>(p, sm, full, empty);
}

// ---------------------------------------------------------------------------
// 2. The reverse walk
// ---------------------------------------------------------------------------
struct RvParams {
  CUtensorMap tx, tdy, tb, tc, thi, tlo, tdh, tdx;
  const float* dt;
  const float* a;
  const float* dhT;          // (B, H, P, N) or null
  float* ddt;
  float* dapart;             // (B, nc, H)
  uint32_t* ds;              // (B, nc, H, kDsWords)
  float* wk;                 // (B, nc, H, Q): w[k]
  float* ecq;                // (B, nc, H, Q): exp(cum[q])
  int L, H, nc;
};

struct RvLayout {
  static constexpr int kX = 0;
  static constexpr int kDy = kX + XTile::kBytes;
  static constexpr int kB = kDy + XTile::kBytes;
  static constexpr int kC = kB + BTile::kBytes;
  static constexpr int kHi = kC + BTile::kBytes;
  static constexpr int kLo = kHi + HTile::kBytes;
  static constexpr int kStage = kLo + HTile::kBytes;    // 128 KB
  static constexpr int kT0 = kStage;                    // dh hi / ed hi
  static constexpr int kT1 = kT0 + HTile::kBytes;       // dh lo / ed lo
  static constexpr int kDx = kT1 + HTile::kBytes;       // [par] dx XTile
  static constexpr int kCum = kDx + 2 * XTile::kBytes;  // [par][w][cum, dt][Q]
  static constexpr int kWsum = kCum + 2 * 2 * 2 * kQ * 4;   // [w][4]
  static constexpr int kRow = kWsum + 2 * 4 * 4;        // [par][w][warp][Q]
  static constexpr int kVec = kRow + 2 * 8 * kQ * 4;    // [par][3][Q]
  static constexpr int kHd = kVec + 2 * 3 * kQ * 4;     // [par][w][warp]
  static constexpr int kBar = kHd + 2 * 8 * 4;          // full, empty
  static constexpr int kBytes = kBar + 2 * 8 + 1024;
};

// named barriers of the handoff between the consumers and the scalar warp
// (1, 2: each consumer warpgroup; 3: both)
constexpr int kReadyBar = 4;   // + parity: a chunk's row sums are written
constexpr int kFreeBar = 6;    // + parity: the scalar warp has read them
constexpr int kHandoff = 256 + 32;

template <int W>
__device__ __forceinline__ void rv_consume(const RvParams& p,
                                           unsigned char* sm, uint64_t* full,
                                           uint64_t* empty) {
  using Lay = RvLayout;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  float* wsum = reinterpret_cast<float*>(sm + Lay::kWsum) + W * 4;
  unsigned char* t0 = sm + Lay::kT0;
  unsigned char* t1 = sm + Lay::kT1;
  const unsigned char* xt = sm + Lay::kX;
  const unsigned char* dyt = sm + Lay::kDy;
  const unsigned char* bt = sm + Lay::kB;
  const unsigned char* ct = sm + Lay::kC;
  const unsigned char* hit = sm + Lay::kHi;
  const unsigned char* lot = sm + Lay::kLo;
  const float av = p.a[h];
  const float* dtp = p.dt + (long long)b * p.L * p.H + h;
  const long long PN = (long long)kP * kN;
  const int p0 = warp * 16 + g;                       // state rows p0, p0 + 8
  const int r0 = 64 * W + warp * 16 + g, r1 = r0 + 8; // chunk rows (k or q)
  const int row_last = (int)((((long long)b * p.nc + p.nc - 1) * p.H + h) *
                             kP);

  // dh leaving the last chunk: dhT or zero; its hi part stored for step 3
  float dh[32];
  if (p.dhT != nullptr) {
    const float* src = p.dhT + ((long long)b * p.H + h) * PN + 64 * W + 2 * tg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 u = *reinterpret_cast<const float2*>(src + p0 * kN + 8 * j);
      const float2 v = *reinterpret_cast<const float2*>(
          src + (p0 + 8) * kN + 8 * j);
      dh[4 * j] = u.x; dh[4 * j + 1] = u.y;
      dh[4 * j + 2] = v.x; dh[4 * j + 3] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) dh[i] = 0.f;
  }
  put_state<W>(dh, t0, t1, p0, tg);
  hopper::fence_proxy_async();
  hopper::bar_sync(3, 256);
  if (store_issuer()) {
    hopper::store_tile<kN, kP>(&p.tdh, t0, 0, row_last, 0);
    hopper::bulk_commit();
  }

  float dt_next = dtp[((long long)(p.nc - 1) * kQ + tid) * p.H];
  uint32_t phase = 0;
  for (int c = p.nc - 1; c >= 0; --c) {
    const int par = c & 1;
    // the scalar warp has read this parity's buffers (chunk c + 2)
    if (c + 2 <= p.nc - 1) hopper::bar_sync(kFreeBar + par, kHandoff);
    float* cum = reinterpret_cast<float*>(sm + Lay::kCum) + (par * 2 + W) *
                 2 * kQ;
    float* dts = cum + kQ;
    float* rowp = reinterpret_cast<float*>(sm + Lay::kRow) + par * 8 * kQ;
    float* vec = reinterpret_cast<float*>(sm + Lay::kVec) + par * 3 * kQ;
    float* hdp = reinterpret_cast<float*>(sm + Lay::kHd) + par * 8;
    unsigned char* dxt = sm + Lay::kDx + par * XTile::kBytes;
    const long long bch = ((long long)b * p.nc + c) * p.H + h;
    chunk_cum(dt_next, av, tid, wsum, cum, dts, 1 + W);
    if (c > 0) dt_next = dtp[((long long)(c - 1) * kQ + tid) * p.H];
    const float total = cum[kQ - 1];
    hopper::mbar_wait(&full[0], phase);

    // a. V = B dh^T (rows k) and Y = C h_prev^T (rows q), hi + lo each
    float v[32], yv[32];
    hopper::fence_regs(v);
    hopper::fence_regs(yv);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kN / 16; ++kc)
      hopper::wgmma_ss(v, hopper::desc_k<kN, kQ>(bt, 64 * W, kc),
                       hopper::desc_k<kN, kP>(t0, 0, kc), kc > 0);
#pragma unroll
    for (int kc = 0; kc < kN / 16; ++kc)
      hopper::wgmma_ss(v, hopper::desc_k<kN, kQ>(bt, 64 * W, kc),
                       hopper::desc_k<kN, kP>(t1, 0, kc), 1);
    hopper::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < kN / 16; ++kc)
      hopper::wgmma_ss(yv, hopper::desc_k<kN, kQ>(ct, 64 * W, kc),
                       hopper::desc_k<kN, kP>(hit, 0, kc), kc > 0);
#pragma unroll
    for (int kc = 0; kc < kN / 16; ++kc)
      hopper::wgmma_ss(yv, hopper::desc_k<kN, kQ>(ct, 64 * W, kc),
                       hopper::desc_k<kN, kP>(lot, 0, kc), 1);
    hopper::wgmma_commit();
    // under the products: <dh, h_prev> over this thread's elements
    {
      float hd = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = W * HTile::kBlock + swz(p0 + 8 * r, 8 * j + 2 * tg);
          const float2 hi = ld_pair(hit + o), lo = ld_pair(lot + o);
          hd = fmaf(dh[4 * j + 2 * r], hi.x + lo.x, hd);
          hd = fmaf(dh[4 * j + 2 * r + 1], hi.y + lo.y, hd);
        }
      }
      hd = warp_sum(hd);
      if (lane == 0) hdp[W * 4 + warp] = hd;
    }
    // x.V per row k, then dx's carried part w[k] V
    hopper::wgmma_wait<1>();
    hopper::fence_regs(v);
    {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 u = ld_pair(xt + swz(r0, 8 * j + 2 * tg));
        const float2 w = ld_pair(xt + swz(r1, 8 * j + 2 * tg));
        s0 = fmaf(u.x, v[4 * j], fmaf(u.y, v[4 * j + 1], s0));
        s1 = fmaf(w.x, v[4 * j + 2], fmaf(w.y, v[4 * j + 3], s1));
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (tg == 0) {
        vec[kQ + r0] = s0;
        vec[kQ + r1] = s1;
      }
      const float w0 = hopper::ex2((total - cum[r0]) * kLog2e) * dts[r0];
      const float w1 = hopper::ex2((total - cum[r1]) * kLog2e) * dts[r1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[4 * j] *= w0;
        v[4 * j + 1] *= w0;
        v[4 * j + 2] *= w1;
        v[4 * j + 3] *= w1;
      }
    }
    // dy.Y per row q
    hopper::wgmma_wait<0>();
    hopper::fence_regs(yv);
    {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 u = ld_pair(dyt + swz(r0, 8 * j + 2 * tg));
        const float2 w = ld_pair(dyt + swz(r1, 8 * j + 2 * tg));
        s0 = fmaf(u.x, yv[4 * j], fmaf(u.y, yv[4 * j + 1], s0));
        s1 = fmaf(w.x, yv[4 * j + 2], fmaf(w.y, yv[4 * j + 3], s1));
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if (tg == 0) {
        vec[2 * kQ + r0] = s0;
        vec[2 * kQ + r1] = s1;
      }
    }

    // b. per 64 queries [q0, q0 + 64) with q0 >= 64W (rows k > q are zero)
    float csd0 = 0.f, csd1 = 0.f;
    const float ck0 = cum[r0], ck1 = cum[r1], d0 = dts[r0], d1 = dts[r1];
#pragma unroll
    for (int qh = W; qh < 2; ++qh) {
      const int q0 = 64 * qh;
      float s[32], gg[32];
      hopper::fence_regs(s);
      hopper::fence_regs(gg);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc)
        hopper::wgmma_ss(s, hopper::desc_k<kN, kQ>(bt, 64 * W, kc),
                         hopper::desc_k<kN, kQ>(ct, q0, kc), kc > 0);
#pragma unroll
      for (int kc = 0; kc < kP / 16; ++kc)
        hopper::wgmma_ss(gg, hopper::desc_k<kP, kQ>(xt, 64 * W, kc),
                         hopper::desc_k<kP, kQ>(dyt, q0, kc), kc > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(gg);
      float rt[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * j + 2 * tg + e;
          const float cq = cum[q];
          const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
          const float m0 = r0 <= q ? hopper::ex2((cq - ck0) * kLog2e) : 0.f;
          const float m1 = r1 <= q ? hopper::ex2((cq - ck1) * kLog2e) : 0.f;
          const float sd0 = s[i0] * m0 * gg[i0];
          const float sd1 = s[i1] * m1 * gg[i1];
          csd0 += sd0;
          csd1 += sd1;
          rt[2 * j + e] = sd0 * d0 + sd1 * d1;
          s[i0] *= m0 * d0;      // (S M)^T
          s[i1] *= m1 * d1;
          gg[i0] *= m0 * d0;     // dS^T
          gg[i1] *= m1 * d1;
        }
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(pa[kk], s, kk);
      {
        uint4* dst = reinterpret_cast<uint4*>(
            p.ds + bch * kDsWords + (W + qh) * 2048 + tid * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[i] = make_uint4(hopper::pack_bf16(gg[8 * i], gg[8 * i + 1]),
                              hopper::pack_bf16(gg[8 * i + 2], gg[8 * i + 3]),
                              hopper::pack_bf16(gg[8 * i + 4], gg[8 * i + 5]),
                              hopper::pack_bf16(gg[8 * i + 6], gg[8 * i + 7]));
      }
      // the sum of T over this warp's 16 rows, per query
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        rt[i] += __shfl_xor_sync(0xffffffffu, rt[i], 4);
        rt[i] += __shfl_xor_sync(0xffffffffu, rt[i], 8);
        rt[i] += __shfl_xor_sync(0xffffffffu, rt[i], 16);
      }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          rowp[(W * 4 + warp) * kQ + q0 + 8 * j + 2 * tg] = rt[2 * j];
          rowp[(W * 4 + warp) * kQ + q0 + 8 * j + 2 * tg + 1] = rt[2 * j + 1];
        }
      }
      // dx += (S M)^T dy over these queries
      hopper::fence_regs(v);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs_tb(v, pa[kk],
                            hopper::desc_mn<kP, kQ>(dyt, 4 * qh + kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(v);
    }
    csd0 += __shfl_xor_sync(0xffffffffu, csd0, 1);
    csd0 += __shfl_xor_sync(0xffffffffu, csd0, 2);
    csd1 += __shfl_xor_sync(0xffffffffu, csd1, 1);
    csd1 += __shfl_xor_sync(0xffffffffu, csd1, 2);
    if (tg == 0) {
      vec[r0] = csd0;
      vec[r1] = csd1;
    }
    // dx (bf16) into this parity's staging tile (its store of chunk c + 2
    // has read it: the wait before step c of chunk c + 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(dxt + swz(r0, 8 * j + 2 * tg)) =
          hopper::pack_bf16(v[4 * j], v[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dxt + swz(r1, 8 * j + 2 * tg)) =
          hopper::pack_bf16(v[4 * j + 2], v[4 * j + 3]);
    }
    hopper::fence_proxy_async();

    // c. dh = exp(total) dh + ed_hi^T C + ed_lo^T C, ed = exp(cum) dy (the
    //    first chunk's entering state has no gradient to carry).  The
    //    barrier: both warpgroups' V have read the dh tiles and the dx tile
    //    is written; the stores issued so far have read their tiles.
    if (store_issuer()) hopper::bulk_wait_read<0>();
    hopper::bar_sync(3, 256);
    if (store_issuer()) {
      hopper::store_tile<kP, kQ>(&p.tdx, dxt, h, c * kQ, b);
      hopper::bulk_commit();
    }
    if (c > 0) {
      scaled_split<W>(dyt, t0, t1, cum, dts, 0.f, -1.f, false, tid);
      hopper::fence_proxy_async();
      hopper::bar_sync(3, 256);
      const float dec = hopper::ex2(total * kLog2e);
#pragma unroll
      for (int i = 0; i < 32; ++i) dh[i] *= dec;
      const unsigned char* cw = ct + W * BTile::kBlock;
      hopper::fence_regs(dh);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        hopper::wgmma_ss_tt(dh, hopper::desc_mn<kP, kQ>(t0, kk),
                            hopper::desc_mn<kP, kQ>(cw, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        hopper::wgmma_ss_tt(dh, hopper::desc_mn<kP, kQ>(t1, kk),
                            hopper::desc_mn<kP, kQ>(cw, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dh);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[0]);
    // this chunk's row sums are written: hand them to the scalar warp
    hopper::bar_arrive(kReadyBar + par, kHandoff);

    // e. dh's tiles for chunk c - 1 (both warpgroups' updates have read the
    //    ed tiles) and its hi part stored for step 3
    if (c > 0) {
      hopper::bar_sync(3, 256);
      put_state<W>(dh, t0, t1, p0, tg);
      hopper::fence_proxy_async();
      hopper::bar_sync(3, 256);
      if (store_issuer()) {
        hopper::store_tile<kN, kP>(&p.tdh, t0, 0, (int)((bch - p.H) * kP),
                                   0);
        hopper::bulk_commit();
      }
    }
    phase ^= 1;
  }
  if (store_issuer()) hopper::bulk_wait<0>();
}

// d. The scalar warp (the producer warpgroup's second): per chunk, once the
// consumers hand over its row sums, cum's gradient, its reverse running sum
// dA, ddt, the chunk's part of da, and w and exp(cum) for step 3.
__device__ __forceinline__ void rv_scalars(const RvParams& p,
                                           unsigned char* sm) {
  using Lay = RvLayout;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float av = p.a[h];
  for (int c = p.nc - 1; c >= 0; --c) {
    const int par = c & 1;
    hopper::bar_sync(kReadyBar + par, kHandoff);
    const float* cum = reinterpret_cast<const float*>(sm + Lay::kCum) +
                       par * 4 * kQ;   // warpgroup 0's copy
    const float* dts = cum + kQ;
    const float* rowp = reinterpret_cast<const float*>(sm + Lay::kRow) +
                        par * 8 * kQ;
    const float* vec = reinterpret_cast<const float*>(sm + Lay::kVec) +
                       par * 3 * kQ;
    const float* hdp = reinterpret_cast<const float*>(sm + Lay::kHd) +
                       par * 8;
    const long long tok0 = (long long)b * p.L + (long long)c * kQ;
    const long long bch = ((long long)b * p.nc + c) * p.H + h;
    const float total = cum[kQ - 1];
    float hdot = 0.f;
    for (int i = 0; i < 8; ++i) hdot += hdp[i];
    const float carry = hopper::ex2(total * kLog2e) * hdot;
    float dc[4], e2v[4], csd[4], xv[4], dq[4], usum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * lane + i;
      float rT = 0.f;
      for (int r = 0; r < (q < 64 ? 4 : 8); ++r) rT += rowp[r * kQ + q];
      dq[i] = dts[q];
      csd[i] = vec[q];
      xv[i] = vec[kQ + q];
      const float e2 = hopper::ex2((total - cum[q]) * kLog2e);
      const float eq = hopper::ex2(cum[q] * kLog2e);
      const float u = e2 * dq[i] * xv[i];
      dc[i] = rT - dq[i] * csd[i] + eq * vec[2 * kQ + q] - u;
      usum += u;
      e2v[i] = e2;
      p.wk[bch * kQ + q] = e2 * dq[i];
      p.ecq[bch * kQ + q] = eq;
    }
    // the consumers may refill this parity's buffers (chunk c - 2)
    __syncwarp();
    if (c >= 2) hopper::bar_arrive(kFreeBar + par, kHandoff);
    usum = warp_sum(usum);
    if (lane == 31) dc[3] += carry + usum;
    float loc[4], s = 0.f;
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      s += dc[i];
      loc[i] = s;
    }
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += t;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.f;
    float dap = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * lane + i;
      const float dA = excl + loc[i];
      p.ddt[(tok0 + q) * p.H + h] = csd[i] + e2v[i] * xv[i] + av * dA;
      dap = fmaf(dq[i], dA, dap);
    }
    dap = warp_sum(dap);
    if (lane == 0) p.dapart[bch] = dap;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_reverse(const __grid_constant__ RvParams p) {
  using Lay = RvLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::kBar);
  uint64_t* empty = full + 1;
  const int h = blockIdx.x, b = blockIdx.y;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full, 1);
    hopper::mbar_init(empty, 8);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<56>();
    if (threadIdx.x == 0) {
      uint32_t phase = 0;
      for (int c = p.nc - 1; c >= 0; --c) {
        hopper::mbar_wait(empty, phase ^ 1);
        hopper::mbar_expect_tx(full, Lay::kStage);
        hopper::load_tile<kP, kQ>(sm + Lay::kX, &p.tx, full, h, c * kQ, b);
        hopper::load_tile<kP, kQ>(sm + Lay::kDy, &p.tdy, full, h, c * kQ, b);
        hopper::load_tile<kN, kQ>(sm + Lay::kB, &p.tb, full, 0, c * kQ, b);
        hopper::load_tile<kN, kQ>(sm + Lay::kC, &p.tc, full, 0, c * kQ, b);
        const int row = (int)((((long long)b * p.nc + c) * p.H + h) * kP);
        hopper::load_tile<kN, kP>(sm + Lay::kHi, &p.thi, full, 0, row, 0);
        hopper::load_tile<kN, kP>(sm + Lay::kLo, &p.tlo, full, 0, row, 0);
        phase ^= 1;
      }
    } else if (threadIdx.x / 32 == 1) {
      rv_scalars(p, sm);
    }
    return;
  }
  hopper::setmaxnreg_inc<224>();
  if (wg == 1)
    rv_consume<0>(p, sm, full, empty);
  else
    rv_consume<1>(p, sm, full, empty);
}

// ---------------------------------------------------------------------------
// 3. dB and dC: the heads' dS summed in order, then the carried terms
// ---------------------------------------------------------------------------
struct DbcParams {
  CUtensorMap tx, tdy, tb, tc, thi, tdh;
  const uint32_t* ds;
  const float* wk;
  const float* ecq;
  __nv_bfloat16* dbm;
  __nv_bfloat16* dcm;
  int L, H, nc;
};

// the ring of a head's two tiles: four stages keep three heads' loads in
// flight under the fourth's products
constexpr int kDbcStages = 4;

struct DbcLayout {
  static constexpr int kOther = 0;                      // C (dB) or B (dC)
  static constexpr int kSHi = BTile::kBytes;            // dS^T hi / lo (dC)
  static constexpr int kSLo = kSHi + BTile::kBytes;
  static constexpr int kRing = kSLo + BTile::kBytes;
  static constexpr int kRows = 0;                       // within a stage
  static constexpr int kState = XTile::kBytes;
  static constexpr int kStage = kState + HTile::kBytes; // 32 KB
  // full[kDbcStages], empty[kDbcStages], once
  static constexpr int kBar = kRing + kDbcStages * kStage;
  static constexpr int kBytes = kBar + (2 * kDbcStages + 1) * 8 + 1024;
};

// KIND 0: dB (rows k = 64W + ...), KIND 1: dC (rows q = 64W + ...)
template <int W, int KIND>
__device__ __forceinline__ void dbc_consume(const DbcParams& p,
                                            unsigned char* sm, uint64_t* full,
                                            uint64_t* empty, uint64_t* once) {
  using Lay = DbcLayout;
  constexpr int NB = W == 0 ? 2 : 1;   // dS^T blocks of this warpgroup's rows
  const int c = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int r0 = 64 * W + warp * 16 + g, r1 = r0 + 8;
  const long long bc0 = ((long long)b * p.nc + c) * p.H;

  // dS^T summed over the heads in order, rows k = r0, r1 of this warpgroup;
  // its block i (stored block 2W + i) covers queries [64 (W + i), + 64)
  float acc[64];
  {
    float sum[NB * 32];
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) sum[i] = 0.f;
#pragma unroll 4
    for (int hh = 0; hh < p.H; ++hh) {
      const uint32_t* src = p.ds + (bc0 + hh) * kDsWords + tid * 16;
#pragma unroll
      for (int blk = 0; blk < NB; ++blk) {
        const uint4* s4 =
            reinterpret_cast<const uint4*>(src + (2 * W + blk) * 2048);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 u = s4[i];
          const uint32_t wv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack(wv[e]);
            sum[blk * 32 + 8 * i + 2 * e] += f.x;
            sum[blk * 32 + 8 * i + 2 * e + 1] += f.y;
          }
        }
      }
    }
    if (KIND == 0) {
      // dB = dS^T C: register A (rows k, reduction over the queries)
      uint32_t ahi[NB * 4][4], alo[NB * 4][4];
#pragma unroll
      for (int kk = 0; kk < NB * 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ahi[kk][e] = split_bf16(sum[8 * kk + 2 * e], sum[8 * kk + 2 * e + 1],
                                  &alo[kk][e]);
      const unsigned char* ct = sm + Lay::kOther;
      hopper::mbar_wait(once, 0);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NB * 4; ++kk)
        hopper::wgmma_rs_tb(acc, ahi[kk],
                            hopper::desc_mn<kN, kQ>(ct, 4 * W + kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < NB * 4; ++kk)
        hopper::wgmma_rs_tb(acc, alo[kk],
                            hopper::desc_mn<kN, kQ>(ct, 4 * W + kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    } else {
      // dC = dS B: dS^T into shared memory (rows k, columns q) as hi + lo,
      // read back transposed as the A operand (rows q)
      unsigned char* shi = sm + Lay::kSHi;
      unsigned char* slo = sm + Lay::kSLo;
#pragma unroll
      for (int blk = 0; blk < NB; ++blk) {
        const int cb = (W + blk) * BTile::kBlock;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r == 0 ? r0 : r1;
            uint32_t lo;
            const uint32_t hi = split_bf16(sum[blk * 32 + 4 * j + 2 * r],
                                           sum[blk * 32 + 4 * j + 2 * r + 1],
                                           &lo);
            const int o = cb + swz(row, 8 * j + 2 * tg);
            *reinterpret_cast<uint32_t*>(shi + o) = hi;
            *reinterpret_cast<uint32_t*>(slo + o) = lo;
          }
        }
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(3, 256);
      const unsigned char* bt = sm + Lay::kOther;
      hopper::mbar_wait(once, 0);
      // queries below 64 see only keys below 64
      constexpr int NK = W == 0 ? 4 : 8;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        hopper::wgmma_ss_tt(acc,
                            hopper::desc_mn<kN, kQ>(shi + W * BTile::kBlock,
                                                    kk),
                            hopper::desc_mn<kN, kQ>(bt, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        hopper::wgmma_ss_tt(acc,
                            hopper::desc_mn<kN, kQ>(slo + W * BTile::kBlock,
                                                    kk),
                            hopper::desc_mn<kN, kQ>(bt, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
  }

  // the carried terms, head by head: dB += (w x) dh, dC += (exp(cum) dy)
  // h_prev (zero in the first chunk)
  if (KIND == 0 || c > 0) {
    const float* scale = KIND == 0 ? p.wk : p.ecq;
    int stage = 0;
    uint32_t phase = 0;
    // each head's row scales are loaded one head ahead
    float f0n = scale[bc0 * kQ + r0], f1n = scale[bc0 * kQ + r1];
    for (int hh = 0; hh < p.H; ++hh) {
      const float f0 = f0n, f1 = f1n;
      if (hh + 1 < p.H) {
        f0n = scale[(bc0 + hh + 1) * kQ + r0];
        f1n = scale[(bc0 + hh + 1) * kQ + r1];
      }
      const unsigned char* rows = sm + Lay::kRing + stage * Lay::kStage;
      const unsigned char* st = rows + Lay::kState;
      hopper::mbar_wait(&full[stage], phase);
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int col = 16 * kk + 8 * hb + 2 * tg;
          const float2 u = ld_pair(rows + swz(r0, col));
          const float2 w = ld_pair(rows + swz(r1, col));
          af[kk][2 * hb] = hopper::pack_bf16(f0 * u.x, f0 * u.y);
          af[kk][2 * hb + 1] = hopper::pack_bf16(f1 * w.x, f1 * w.y);
        }
      }
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs_tb(acc, af[kk], hopper::desc_mn<kN, kP>(st, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == kDbcStages) { stage = 0; phase ^= 1; }
    }
  }

  __nv_bfloat16* out = (KIND == 0 ? p.dbm : p.dcm)
      + ((long long)b * p.L + (long long)c * kQ) * kN + 2 * tg;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(out + r0 * kN + 8 * j) =
        hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(out + r1 * kN + 8 * j) =
        hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dbc_tc(const __grid_constant__ DbcParams p) {
  using Lay = DbcLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Lay::kBar);
  uint64_t* empty = full + kDbcStages;
  uint64_t* once = empty + kDbcStages;
  const int c = blockIdx.x, kind = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDbcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_init(once, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(once, BTile::kBytes);
      hopper::load_tile<kN, kQ>(sm + Lay::kOther, kind == 0 ? &p.tc : &p.tb,
                                once, 0, c * kQ, b);
      if (kind == 0 || c > 0) {
        const CUtensorMap* rows = kind == 0 ? &p.tx : &p.tdy;
        const CUtensorMap* state = kind == 0 ? &p.tdh : &p.thi;
        int stage = 0;
        uint32_t phase = 0;
        for (int hh = 0; hh < p.H; ++hh) {
          unsigned char* ring = sm + Lay::kRing + stage * Lay::kStage;
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&full[stage], Lay::kStage);
          hopper::load_tile<kP, kQ>(ring + Lay::kRows, rows, &full[stage], hh,
                                    c * kQ, b);
          const int row = (int)((((long long)b * p.nc + c) * p.H + hh) * kP);
          hopper::load_tile<kN, kP>(ring + Lay::kState, state, &full[stage],
                                    0, row, 0);
          if (++stage == kDbcStages) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<240>();
  if (kind == 0) {
    if (wg == 1)
      dbc_consume<0, 0>(p, sm, full, empty, once);
    else
      dbc_consume<1, 0>(p, sm, full, empty, once);
  } else {
    if (wg == 1)
      dbc_consume<0, 1>(p, sm, full, empty, once);
    else
      dbc_consume<1, 1>(p, sm, full, empty, once);
  }
}

// 4. da[h] = the partials summed over (batch, chunk) in order
__global__ void __launch_bounds__(128)
ssd_bwd_da_tc(const float* __restrict__ dapart, float* __restrict__ da,
              int H, int BC) {
  const int h = blockIdx.x * 128 + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int i = 0; i < BC; ++i) s += dapart[(long long)i * H + h];
  da[h] = s;
}

// TMA reads x, B, C and dy: base pointers 16-byte aligned, strides
// multiples of 8 elements on every axis longer than one
bool tc_aligned(const void* const* ptrs, int n, int B, int L,
                const long long* st, int nst) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16) return false;
  for (int i = 0; i < nst; ++i)
    if ((B > 1 && st[2 * i] % 8) || (L > 1 && st[2 * i + 1] % 8))
      return false;
  return true;
}

}  // namespace
}  // namespace ssd_bwd

extern "C" {

// bf16 x, bm, cm, dy (dy contiguous) with P = 64, N = 128 and a chunk of
// 128 (L a multiple of it), TMA-aligned; dt, a, dhT (or null), ddt, da f32.
// Scratch the caller allocates: hp_hi, hp_lo and dh_hi (B, L/128, H, 64,
// 128) bf16, ds (B, L/128, H, 6144) 32-bit words, wk and ecq (B, L/128, H,
// 128) f32, dapart (B, L/128, H) f32.  Outputs dx (B, L, H, 64), dbm and dcm
// (B, L, 128) bf16 contiguous.  Returns a CUDA error code (0 on success).
int ssd_scan_bwd_wgmma(const void* x, const void* dt, const void* a,
                       const void* bm, const void* cm, const void* dy,
                       const void* dhT, void* dx, void* ddt, void* da,
                       void* dbm, void* dcm, void* hp_hi, void* hp_lo,
                       void* dh_hi, void* ds, void* wk, void* ecq,
                       void* dapart, int B, int L, int H, long long x_sb,
                       long long x_sl, long long b_sb, long long b_sl,
                       long long c_sb, long long c_sl, void* stream) {
  using namespace ssd_bwd;
  const long long st[6] = {x_sb, x_sl, b_sb, b_sl, c_sb, c_sl};
  const void* ptrs[4] = {x, bm, cm, dy};
  if (B < 1 || H < 1 || L < kQ || L % kQ != 0 ||
      !tc_aligned(ptrs, 4, B, L, st, 3))
    return cudaErrorInvalidValue;
  const int nc = L / kQ;
  const long long rows = (long long)B * nc * H * kP;
  if (rows >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long dy_sl = (long long)H * kP, dy_sb = dy_sl * L;
  CUtensorMap tx, tdy, tdx, tb, tc, thi, tlo, tdh;
  CUresult cr = encode_bshd(&tx, x, kP, H, L, B, x_sb, x_sl, kP);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&tdy, dy, kP, H, L, B, dy_sb, dy_sl, kP);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&tdx, dx, kP, H, L, B, dy_sb, dy_sl, kP);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&tb, bm, kN, 1, L, B, b_sb, b_sl, kN);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&tc, cm, kN, 1, L, B, c_sb, c_sl, kN);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&thi, hp_hi, kN, 1, (int)rows, 1, 0, kN, kN);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&tlo, hp_lo, kN, 1, (int)rows, 1, 0, kN, kN);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&tdh, dh_hi, kN, 1, (int)rows, 1, 0, kN, kN);
  if (cr != CUDA_SUCCESS) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);

  StParams sp;
  sp.tx = tx;
  sp.tb = tb;
  sp.thi = thi;
  sp.tlo = tlo;
  sp.dt = dtf;
  sp.a = af;
  sp.L = L;
  sp.H = H;
  sp.nc = nc;
  static bool sized_st = false, sized_rv = false, sized_dbc = false;
  int rc = size_once(ssd_bwd_states, StLayout::kBytes, &sized_st);
  if (rc) return rc;
  ssd_bwd_states<<<dim3(H, B), kThreads, StLayout::kBytes, s>>>(sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  RvParams rp;
  rp.tx = tx;
  rp.tdy = tdy;
  rp.tb = tb;
  rp.tc = tc;
  rp.thi = thi;
  rp.tlo = tlo;
  rp.tdh = tdh;
  rp.tdx = tdx;
  rp.dt = dtf;
  rp.a = af;
  rp.dhT = static_cast<const float*>(dhT);
  rp.ddt = static_cast<float*>(ddt);
  rp.dapart = static_cast<float*>(dapart);
  rp.ds = static_cast<uint32_t*>(ds);
  rp.wk = static_cast<float*>(wk);
  rp.ecq = static_cast<float*>(ecq);
  rp.L = L;
  rp.H = H;
  rp.nc = nc;
  rc = size_once(ssd_bwd_reverse, RvLayout::kBytes, &sized_rv);
  if (rc) return rc;
  ssd_bwd_reverse<<<dim3(H, B), kThreads, RvLayout::kBytes, s>>>(rp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  DbcParams dp;
  dp.tx = tx;
  dp.tdy = tdy;
  dp.tb = tb;
  dp.tc = tc;
  dp.thi = thi;
  dp.tdh = tdh;
  dp.ds = static_cast<const uint32_t*>(ds);
  dp.wk = static_cast<const float*>(wk);
  dp.ecq = static_cast<const float*>(ecq);
  dp.dbm = static_cast<__nv_bfloat16*>(dbm);
  dp.dcm = static_cast<__nv_bfloat16*>(dcm);
  dp.L = L;
  dp.H = H;
  dp.nc = nc;
  rc = size_once(ssd_bwd_dbc_tc, DbcLayout::kBytes, &sized_dbc);
  if (rc) return rc;
  ssd_bwd_dbc_tc<<<dim3(nc, 2, B), kThreads, DbcLayout::kBytes, s>>>(dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ssd_bwd_da_tc<<<dim3((H + 127) / 128), 128, 0, s>>>(
      static_cast<const float*>(dapart), static_cast<float*>(da), H,
      B * nc);
  return cudaGetLastError();
}

}  // extern "C"
