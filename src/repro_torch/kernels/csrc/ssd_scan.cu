// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan (body
// _ssd_kernel).  x (B,L,H,P), dt (B,L,H) f32, a (H,) f32, bm/cm (B,L,N),
// one state group shared by all heads.  Per chunk of Q tokens, with
// dA = dt*a and cum its running sum within the chunk:
//   y      = (exp(segsum) (.) C B^T) (dt (.) x) + exp(cum) (.) (C h_prev^T)
//   h_next = exp(sum dA) h_prev + (exp(total - cum) (.) dt (.) x)^T B
// The state starts at zero; y is stored in x's dtype and the final state
// hT (B,H,P,N) in f32.
//
// Bound on the H100: bytes.  At the serving shape (B=4, L=4608, H=32,
// P=64, N=128, Q=128, bf16) the inputs and outputs move ~167 MB (0.050 ms at
// 3.35 TB/s) for ~30 GFLOP (0.030 ms on the bf16 tensor cores).
//
// Two kernels, chosen by dtype and shape (kernels/ssd_scan.py:
// tensor_core_route, mirrored by tc_aligned here).  bf16 x, B and C at
// Mamba-2's shape (P = 64, N = 128, a chunk of 128, L a multiple of it)
// whose base pointers are 16-byte aligned and whose batch and token strides
// are multiples of 8 elements (what TMA needs; the serving path's column
// slices of the conv output are) run ssd_scan_wgmma, the kernel of the
// serving path.  f32 inputs and every other shape run the four FMA passes
// below, exact to f32 rounding.  The route depends on nothing else; a
// launch error is returned, never retried on the other kernel.
//
// ssd_scan_wgmma follows the TPU kernel's dataflow: one block per (b, h)
// walks the chunks in order with the (P, N) state on chip, so x, B and C
// are read once per block and y and hT written once, with no state, score
// or decay scratch in device memory (the FMA passes round-trip ~600 MB of
// it a call); every product runs on wgmma with f32 accumulation, TMA loads
// a two-stage ring, and the state chain overlaps the next products (design
// above the kernel).  It recomputes S = C B^T per head (shared by the 32
// heads, cheap on the tensor cores) and does its state update twice (hi,
// lo).  On an H100 SXM (700 W) it runs at 0.176 ms at the serving shape,
// 3.5x its bound, against 2.36 ms for the FMA passes (PERF.md).
//
// Precision of ssd_scan_wgmma, by design.  x, B and C are bf16 and enter
// every product exactly; S and all sums are f32.  Three factors exist only
// in f32 and are rounded where they become product operands:
//   * the state-update operand xw = exp(total - cum) dt x is split into
//     bf16 hi + lo (two products; ~2^-16 relative): with one rounding the
//     final state misses its 1e-4 band by more than 5x on the slow-decay
//     draw (ref.ssd_tensor_core_ref, the kernel's rounding written out, in
//     tests/test_torch_ssm.py); with the split it holds <= 7.6e-6 of max
//     |hT| on an H100 over chip_smoke.py's phase 10 cases;
//   * L' and the carried state h_prev (for C h_prev^T) are rounded once to
//     bf16: y, itself stored in bf16, then holds <= 4.9e-3 of max |y| on the
//     card against its 1e-2 band (the slow-decay case, where the carried
//     state is the whole of y, at 4.1e-3), a margin of 2x measured, not
//     assumed; splitting both would cost a third more products.
// Sums run in a fixed order and there are no atomics in either kernel, so
// a rerun gives the same bits.
//
// The FMA passes (the first port, kept for f32 and the other shapes): the
// chunked form in four passes, each but the third over every (chunk, head,
// batch); passes 1-3 live in ssd_fma.cuh, where the backward
// (ssd_scan_bwd.cu) runs them too:
//   1. ssd_chunk_scores: S = C B^T per (b, chunk), shared by all heads
//      (stored transposed, so that pass 4 reads it along q).
//   2. ssd_chunk_state: the chunk's own end state (exp(total - cum) dt x)^T B
//      and its decay exp(total), per (b, chunk, h), into device memory.
//   3. ssd_state_pass: per (b, h) and state element, the recurrence over the
//      chunks; it overwrites each chunk's own state with the state entering
//      it and writes hT.
//   4. ssd_chunk_out: y = L (dt x) + (C (.) exp(cum)) h_prev^T, with
//      L[q][k] = S[q][k] exp(cum[q] - cum[k]) for k <= q and 0 above the
//      diagonal (exp is evaluated only where k <= q: above it the exponent is
//      positive and may overflow).
// The products are register-tiled f32 FMAs over shared-memory tiles of 32
// along the reduction (67 TFLOP/s at most on the CUDA cores: 0.45 ms for
// the serving shape's work); every output is summed by one thread.
// Limits: Q <= 128, P <= 64, N <= 128 (any values, ragged tiles are
// zero-filled); row strides of x, bm and cm are arguments (they arrive as
// column slices of the conv output); dt is contiguous.
#include "hopper.cuh"
#include "ssd_fma.cuh"

namespace {

// Pass 4: y[q][p] = sum_k L[q][k] dt[k] x[k][p]
//                 + sum_n C[q][n] exp(cum[q]) h_prev[p][n];
// grid (nc, H, B); 4 (q) x 8 (p) tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_out(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const T* __restrict__ cm,
              const float* __restrict__ S, const float* __restrict__ states,
              T* __restrict__ y, int L, int H, int P, int N, int Q, int nc,
              long long x_sb, long long x_sl, long long c_sb,
              long long c_sl) {
  __shared__ float dts[QMAX], cum[QMAX], ecum[QMAX];
  __shared__ __align__(16) float ta[KT * LDQ];   // [k or n][q]
  __shared__ __align__(16) float tv[KT * LDP];   // [k or n][p]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long l0 = (long long)c * Q;
  chunk_cumsum(dt + ((long long)b * L + l0) * H + h, H, a[h], Q, dts, cum);
  for (int q = tid; q < Q; q += kThreads) ecum[q] = expf(cum[q]);
  __syncthreads();
  const T* xb = x + b * x_sb + l0 * x_sl + (long long)h * P;
  const float* Sb = S + ((long long)b * nc + c) * Q * Q;
  const int ntp = (P + 7) / 8, ntq = (Q + 3) / 4;
  const int tp = tid % ntp, tq = tid / ntp;
  const bool active = tq < ntq;
  float acc[4][8] = {};
  // within the chunk: the masked, decayed scores against dt x
  for (int k0 = 0; k0 < Q; k0 += KT) {
    for (int i = tid; i < KT * QMAX; i += kThreads) {
      const int q = i % QMAX, kk = i / QMAX, k = k0 + kk;
      ta[kk * LDQ + q] = (q < Q && k <= q)
          ? Sb[k * Q + q] * expf(cum[q] - cum[k]) : 0.f;
    }
    for (int i = tid; i < KT * PMAX; i += kThreads) {
      const int p = i % PMAX, kk = i / PMAX, k = k0 + kk;
      tv[kk * LDP + p] = (k < Q && p < P) ? dts[k] * ld(xb + k * x_sl + p)
                                          : 0.f;
    }
    __syncthreads();
    // a thread's rows q < k0 see only the zeros above the diagonal
    if (active && k0 <= 4 * tq + 3)
      tile_fma<4, 8, LDQ, LDP>(ta, tv, 4 * tq, 8 * tp, acc);
    __syncthreads();
  }
  // the state carried into the chunk (zero for the first)
  if (c > 0) {
    const T* cb = cm + b * c_sb + l0 * c_sl;
    const float* hp = states + (((long long)b * nc + c) * H + h) * P * N;
    for (int n0 = 0; n0 < N; n0 += KT) {
      for (int i = tid; i < KT * QMAX; i += kThreads) {
        const int nn = i % KT, q = i / KT, n = n0 + nn;
        ta[nn * LDQ + q] = (q < Q && n < N) ? ld(cb + q * c_sl + n) * ecum[q]
                                            : 0.f;
      }
      for (int i = tid; i < KT * PMAX; i += kThreads) {
        const int nn = i % KT, p = i / KT, n = n0 + nn;
        tv[nn * LDP + p] = (p < P && n < N) ? hp[p * N + n] : 0.f;
      }
      __syncthreads();
      if (active) tile_fma<4, 8, LDQ, LDP>(ta, tv, 4 * tq, 8 * tp, acc);
      __syncthreads();
    }
  }
  if (!active) return;
  const long long HP = (long long)H * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = 4 * tq + r;
    if (q >= Q) continue;
    T* yr = y + ((long long)b * L + l0 + q) * HP + (long long)h * P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * tp + j;
      if (p < P) st(yr + p, acc[r][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* hT, void* S, void* states,
           void* decay, int B, int L, int H, int P, int N, int Q,
           long long x_sb, long long x_sl, long long b_sb, long long b_sl,
           long long c_sb, long long c_sl, cudaStream_t stream) {
  const int nc = L / Q;
  const T* xt = static_cast<const T*>(x);
  const T* ct = static_cast<const T*>(cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* Sf = static_cast<float*>(S);
  float* sf = static_cast<float*>(states);
  const int rc = launch_states<T>(
      xt, dtf, af, static_cast<const T*>(bm), ct, Sf, sf,
      static_cast<float*>(decay), static_cast<float*>(hT), B, L, H, P, N, Q,
      x_sb, x_sl, b_sb, b_sl, c_sb, c_sl, stream);
  if (rc) return rc;
  ssd_chunk_out<T><<<dim3(nc, H, B), kThreads, 0, stream>>>(
      xt, dtf, af, ct, Sf, sf, static_cast<T*>(y), L, H, P, N, Q, nc, x_sb,
      x_sl, c_sb, c_sl);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: one block per (b, h) walks its chunks in order.
//
// Warpgroup 0 is the producer: one thread TMA-loads chunk c's x (Q x P), B
// and C (Q x N each) into a ring of two stages while the consumers work on
// chunk c - 1.  Warpgroups 1 and 2 (W = 0, 1) own chunk rows [64W, 64W+64)
// of S, L' and y, and state columns [64W, 64W+64) of h, which stays in
// their accumulator registers from the first chunk to the last.  Per chunk:
//   1. cum = cumsum(dt a) over the chunk (each warpgroup for itself);
//   2. y = C h_prev^T (the carried state, from the bf16 h tile) and
//      S = C B^T, both wgmma on shared-memory operands, in flight at once;
//   3. under them, xw = exp(total - cum[q]) dt[q] x[q][p] as hi + lo bf16
//      tiles in x's own (swizzled) layout;
//   4. y *= exp(cum[q]) once its product has landed; named barrier;
//   5. h = exp(total) h + xw_hi^T B + xw_lo^T B (both operands MN-major);
//   6. under those, L' = S exp(cum[q] - cum[k]) dt[k] on and below the
//      diagonal in S's registers (exp only where k <= q), rounded to bf16
//      as the register A operand of y += L' x (x read MN-major from its TMA
//      tile); rows below 64 see only keys below 64, so warpgroup 0 forms S,
//      L' and L' x over 64 keys;
//   7. h rounded to bf16 into the h tile for the next chunk's step 2; y
//      stored; named barrier.
// The barrier of step 4 follows both warpgroups' C h_prev^T, so the h tile
// may be overwritten after it; the barrier of step 7 publishes the new one.
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcQ = 128, kTcP = 64, kTcN = 128;
using XTile = hopper::Tile<kTcP, kTcQ>;   // x, xw: 128 tokens x 64
using BTile = hopper::Tile<kTcN, kTcQ>;   // B, C: 128 tokens x 128
using HTile = hopper::Tile<kTcN, kTcP>;   // h_prev: 64 (p) x 128 (n)

struct TcLayout {
  static constexpr int kX = 0;                          // within a stage
  static constexpr int kB = XTile::kBytes;
  static constexpr int kC = kB + BTile::kBytes;
  static constexpr int kStage = kC + BTile::kBytes;
  static constexpr int kXwHi = 2 * kStage;
  static constexpr int kXwLo = kXwHi + XTile::kBytes;
  static constexpr int kH = kXwLo + XTile::kBytes;
  static constexpr int kCum = kH + HTile::kBytes;       // [w][cum, dt][Q] f32
  static constexpr int kWsum = kCum + 2 * 2 * kTcQ * 4; // [w][4 warps] f32
  static constexpr int kBar = kWsum + 2 * 4 * 4;        // full[2], empty[2]
  static constexpr int kBytes = kBar + 4 * 8 + 1024;
};

struct TcParams {
  CUtensorMap tx, tb, tc;   // (64, H, L, B) view of x; (128, 1, L, B) of B, C
  const float* dt;
  const float* a;
  __nv_bfloat16* y;
  float* hT;
  int L, H, nc;
};

__device__ __forceinline__ uint32_t split_bf16(float v0, float v1,
                                               uint32_t* lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  *lo = hopper::pack_bf16(v0 - __low2float(hi), v1 - __high2float(hi));
  return *reinterpret_cast<const uint32_t*>(&hi);
}

// The consumer warpgroup W (0 or 1) of ssd_scan_wgmma: chunk rows and
// state columns [64W, 64W + 64), S, L' and L' x over NS keys.  W is a
// template argument so that every wgmma sits on a path uniform
// across the warpgroup as the compiler sees it (a branch on a thread index
// between products makes ptxas serialise them, C7520).
template <int W>
__device__ __forceinline__ void tc_consume(const TcParams& p,
                                           unsigned char* sm, uint64_t* full,
                                           uint64_t* empty) {
  using Lay = TcLayout;
  constexpr int NS = W == 0 ? 64 : 128;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  float* cum = reinterpret_cast<float*>(sm + Lay::kCum) + W * 2 * kTcQ;
  float* dts = cum + kTcQ;
  float* wsum = reinterpret_cast<float*>(sm + Lay::kWsum) + W * 4;
  unsigned char* xw_hi = sm + Lay::kXwHi;
  unsigned char* xw_lo = sm + Lay::kXwLo;
  unsigned char* ht = sm + Lay::kH;
  const float av = p.a[h];
  const float* dtp = p.dt + (long long)b * p.L * p.H + h;
  // rows of the chunk this thread holds in S and y; state rows p0, p0 + 8
  const int r0 = 64 * W + warp * 16 + g, r1 = r0 + 8;
  const int rlast = 64 * W + warp * 16 + 15;
  const int p0 = warp * 16 + g;
  const long long ystride = (long long)p.H * kTcP;

  float hs[32];   // the state: rows p0, p0 + 8; columns 64W + 8j + 2tg (+1)
  float y[32];    // y: rows r0, r1; columns 8j + 2tg (+1)
  // the state entering the first chunk is zero
  uint4* own = reinterpret_cast<uint4*>(ht + W * HTile::kBlock);
  for (int i = tid; i < HTile::kBlock / 16; i += 128)
    own[i] = make_uint4(0, 0, 0, 0);
  hopper::fence_proxy_async();
  hopper::bar_sync(3, 256);
  float dt_next = dtp[(long long)tid * p.H];
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < p.nc; ++c) {
    // 1. cum over the chunk in one fixed order: a warp scan, then the sums
    //    of the warps before
    const float dtq = dt_next;
    float v = dtq * av;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) wsum[warp] = v;
    hopper::bar_sync(1 + W, 128);
    float pre = 0.f;
    for (int i = 0; i < warp; ++i) pre += wsum[i];
    cum[tid] = pre + v;
    dts[tid] = dtq;
    hopper::bar_sync(1 + W, 128);
    if (c + 1 < p.nc)
      dt_next = dtp[((long long)(c + 1) * kTcQ + tid) * p.H];
    const float total = cum[kTcQ - 1];
    const float cq0 = cum[r0], cq1 = cum[r1];

    const unsigned char* ring = sm + stage * Lay::kStage;
    const unsigned char* xt = ring + Lay::kX;
    const unsigned char* bt = ring + Lay::kB;
    const unsigned char* ct = ring + Lay::kC;
    hopper::mbar_wait(&full[stage], phase);

    // 2. y = C h_prev^T (zero before the second chunk), S = C B^T
    float s[NS / 2];
    hopper::fence_regs(y);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kTcN / 16; ++kc)
      hopper::wgmma_ss(y, hopper::desc_k<kTcN, kTcQ>(ct, 64 * W, kc),
                       hopper::desc_k<kTcN, kTcP>(ht, 0, kc), kc > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < kTcN / 16; ++kc)
      hopper::wgmma_ss(s, hopper::desc_k<kTcN, kTcQ>(ct, 64 * W, kc),
                       hopper::desc_k<kTcN, kTcQ>(bt, 0, kc), kc > 0);
    hopper::wgmma_commit();
    // 3. under those products: xw = w[q] x[q][:] as hi + lo, this
    //    warpgroup's 64 rows, in x's layout (a row of x is one 128-byte line
    //    of the tile)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = 64 * W * 128 + (i * 128 + tid) * 16;
      const int q = o >> 7;
      const float wq = hopper::ex2((total - cum[q]) * kLog2e) * dts[q];
      const uint4 raw = *reinterpret_cast<const uint4*>(xt + o);
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&in[e]);
        hi[e] = split_bf16(__low2float(pr) * wq, __high2float(pr) * wq, &lo[e]);
      }
      *reinterpret_cast<uint4*>(xw_hi + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(xw_lo + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    // 4. once C h_prev^T has landed (S may still run): y *= exp(cum[q]);
    //    then both warpgroups' xw are written and the h tile is free
    {
      hopper::wgmma_wait<1>();
      hopper::fence_regs(y);
      const float e0 = hopper::ex2(cq0 * kLog2e);
      const float e1 = hopper::ex2(cq1 * kLog2e);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[4 * j + 0] *= e0;
        y[4 * j + 1] *= e0;
        y[4 * j + 2] *= e1;
        y[4 * j + 3] *= e1;
      }
    }
    hopper::fence_proxy_async();
    hopper::bar_sync(3, 256);

    // 5. h = exp(total) h + xw_hi^T B + xw_lo^T B, this warpgroup's columns
    if (c > 0) {
      const float dec = hopper::ex2(total * kLog2e);
#pragma unroll
      for (int i = 0; i < 32; ++i) hs[i] *= dec;
    }
    const unsigned char* bw = bt + W * BTile::kBlock;
    hopper::fence_regs(hs);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcQ / 16; ++kk)
      hopper::wgmma_ss_tt(hs, hopper::desc_mn<kTcP, kTcQ>(xw_hi, kk),
                          hopper::desc_mn<kTcP, kTcQ>(bw, kk),
                          c > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < kTcQ / 16; ++kk)
      hopper::wgmma_ss_tt(hs, hopper::desc_mn<kTcP, kTcQ>(xw_lo, kk),
                          hopper::desc_mn<kTcP, kTcQ>(bw, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);

    // 6. under the state products: L' in place of S, then y += L' x
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      if (8 * j > rlast) {   // above the diagonal for every row of the warp
        s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = 0.f;
        continue;
      }
      const int k = 8 * j + 2 * tg;
      const float ck0 = cum[k], ck1 = cum[k + 1];
      const float d0 = dts[k], d1 = dts[k + 1];
      s[4 * j + 0] = k <= r0
          ? s[4 * j + 0] * hopper::ex2((cq0 - ck0) * kLog2e) * d0 : 0.f;
      s[4 * j + 1] = k + 1 <= r0
          ? s[4 * j + 1] * hopper::ex2((cq0 - ck1) * kLog2e) * d1 : 0.f;
      s[4 * j + 2] = k <= r1
          ? s[4 * j + 2] * hopper::ex2((cq1 - ck0) * kLog2e) * d0 : 0.f;
      s[4 * j + 3] = k + 1 <= r1
          ? s[4 * j + 3] * hopper::ex2((cq1 - ck1) * kLog2e) * d1 : 0.f;
    }
    uint32_t pa[NS / 16][4];
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) hopper::acc_to_a(pa[kk], s, kk);
    hopper::fence_regs(y);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk)
      hopper::wgmma_rs_tb(y, pa[kk], hopper::desc_mn<kTcP, kTcQ>(xt, kk),
                          1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(hs);
    hopper::fence_regs(y);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);

    // 7. h as bf16 for the next chunk (128-byte swizzle: the 16-byte chunk
    //    j of row r lies at j ^ (r % 8)); then y
    if (c + 1 < p.nc) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned char* blk = ht + W * HTile::kBlock + 4 * tg;
        *reinterpret_cast<uint32_t*>(blk + p0 * 128 + ((j ^ (p0 & 7)) << 4)) =
            hopper::pack_bf16(hs[4 * j], hs[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(blk + (p0 + 8) * 128 +
                                     ((j ^ ((p0 + 8) & 7)) << 4)) =
            hopper::pack_bf16(hs[4 * j + 2], hs[4 * j + 3]);
      }
      hopper::fence_proxy_async();
    }
    __nv_bfloat16* yp = p.y + (((long long)b * p.L + (long long)c * kTcQ) *
                               p.H + h) * kTcP + 2 * tg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(yp + r0 * ystride + 8 * j) =
          hopper::pack_bf16(y[4 * j], y[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(yp + r1 * ystride + 8 * j) =
          hopper::pack_bf16(y[4 * j + 2], y[4 * j + 3]);
    }
    if (c + 1 < p.nc) hopper::bar_sync(3, 256);
    if (++stage == 2) { stage = 0; phase ^= 1; }
  }

  float* hp = p.hT + ((long long)b * p.H + h) * kTcP * kTcN + 64 * W + 2 * tg;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(hp + p0 * kTcN + 8 * j) =
        make_float2(hs[4 * j], hs[4 * j + 1]);
    *reinterpret_cast<float2*>(hp + (p0 + 8) * kTcN + 8 * j) =
        make_float2(hs[4 * j + 2], hs[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
ssd_scan_wgmma(const __grid_constant__ TcParams p) {
  using Lay = TcLayout;
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
      for (int c = 0; c < p.nc; ++c) {
        unsigned char* ring = sm + stage * Lay::kStage;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_expect_tx(&full[stage], Lay::kStage);
        hopper::load_tile<kTcP, kTcQ>(ring + Lay::kX, &p.tx, &full[stage], h,
                                      c * kTcQ, b);
        hopper::load_tile<kTcN, kTcQ>(ring + Lay::kB, &p.tb, &full[stage], 0,
                                      c * kTcQ, b);
        hopper::load_tile<kTcN, kTcQ>(ring + Lay::kC, &p.tc, &full[stage], 0,
                                      c * kTcQ, b);
        if (++stage == 2) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<240>();
  if (wg == 1)
    tc_consume<0>(p, sm, full, empty);
  else
    tc_consume<1>(p, sm, full, empty);
}

// TMA reads x, B and C: base pointers 16-byte aligned, strides multiples of
// 8 elements (16 bytes) on every axis longer than one
bool tc_aligned(const void* x, const void* bm, const void* cm, int B, int L,
                const long long* st) {
  for (const void* ptr : {x, bm, cm})
    if (reinterpret_cast<unsigned long long>(ptr) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if ((B > 1 && st[2 * i] % 8) || (L > 1 && st[2 * i + 1] % 8))
      return false;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, bm, cm and y); dt and a are f32.
// S (B, L/Q, Q, Q; k major), states (B, L/Q, H, P, N) and decay (B, L/Q, H)
// are f32
// scratch the caller allocates.  Returns a CUDA error code (0 on success).
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, void* hT, void* S, void* states,
                 void* decay, int dtype, int B, int L, int H, int P, int N,
                 int Q, long long x_sb, long long x_sl, long long b_sb,
                 long long b_sl, long long c_sb, long long c_sl,
                 void* stream) {
  if (Q < 1 || Q > QMAX || P < 1 || P > PMAX || N < 1 || N > NMAX ||
      L % Q != 0 || B < 1 || H < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, y, hT, S, states, decay, B, L, H,
                         P, N, Q, x_sb, x_sl, b_sb, b_sl, c_sb, c_sl, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, hT, S, states, decay,
                                 B, L, H, P, N, Q, x_sb, x_sl, b_sb, b_sl,
                                 c_sb, c_sl, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel: bf16 x, bm, cm with P = 64, N = 128 and a chunk
// of 128 (L a multiple of it), TMA-aligned (tc_aligned); within a token x
// is packed over (H, P) and bm, cm are contiguous; y (B, L, H, P) bf16 and
// hT (B, H, P, N) f32 are contiguous.  Needs no scratch.  Returns a CUDA
// error code (0 on success).
int ssd_scan_wgmma_fwd(const void* x, const void* dt, const void* a,
                       const void* bm, const void* cm, void* y, void* hT,
                       int B, int L, int H, long long x_sb, long long x_sl,
                       long long b_sb, long long b_sl, long long c_sb,
                       long long c_sl, void* stream) {
  const long long st[6] = {x_sb, x_sl, b_sb, b_sl, c_sb, c_sl};
  if (B < 1 || H < 1 || L < kTcQ || L % kTcQ != 0 ||
      !tc_aligned(x, bm, cm, B, L, st))
    return cudaErrorInvalidValue;
  TcParams p;
  CUresult cr = encode_bshd(&p.tx, x, kTcP, H, L, B, x_sb, x_sl, kTcP);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&p.tb, bm, kTcN, 1, L, B, b_sb, b_sl, kTcN);
  if (cr == CUDA_SUCCESS)
    cr = encode_bshd(&p.tc, cm, kTcN, 1, L, B, c_sb, c_sl, kTcN);
  if (cr != CUDA_SUCCESS) return cudaErrorInvalidValue;
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.hT = static_cast<float*>(hT);
  p.L = L;
  p.H = H;
  p.nc = L / kTcQ;
  static bool sized = false;
  const int rc = size_once(ssd_scan_wgmma, TcLayout::kBytes, &sized);
  if (rc) return rc;
  ssd_scan_wgmma<<<dim3(H, B), kTcThreads, TcLayout::kBytes,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
