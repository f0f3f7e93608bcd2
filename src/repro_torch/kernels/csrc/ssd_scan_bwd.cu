// Backward of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu).
//
// Replaces the JAX package's autodiff of src/repro/models/ssm.py:ssd_chunked
// (the TPU's Pallas scan, src/repro/kernels/ssd_scan.py:ssd_scan, has no
// backward of its own).  Given the forward's inputs x (B,L,H,P), dt (B,L,H)
// f32, a (H,) f32, bm/cm (B,L,N), the gradient dy of y (B,L,H,P, x's dtype,
// contiguous) and dhT of the final state (B,H,P,N f32, or null for zero),
// it writes dx (x's dtype), ddt (f32), da (f32), dbm and dcm (bm's dtype),
// all contiguous.  Per (b, h) and chunk, with cum the running sum of
// dA = dt a, total = cum[Q-1], S = C B^T (one state group shared by the
// heads), E[q,k] = exp(cum[q] - cum[k]) and M = E dt[k] on and below the
// diagonal, w[k] = exp(total - cum[k]) dt[k], h_prev the state entering the
// chunk and dh the gradient of the state leaving it:
//   dh_prev = exp(total) dh + sum_q exp(cum[q]) dy[q] C[q]^T
//   dx[k]   = sum_q S[q,k] M[q,k] dy[q] + w[k] dh B[k]
//   dS      = sum_h M (dy x^T);  dC = dS B + sum_h exp(cum) dy h_prev;
//             dB = dS^T C + sum_h w x dh
//   ddt[k]  = sum_q S E (dy.x)[q,k] + exp(total - cum[k]) x[k].dh B[k]
//             + a dA[k],  da = sum dt dA,
// dA the reverse running sum of cum's gradient (ref.ssd_scan_bwd_ref writes
// it out).  exp is evaluated only on and below the diagonal: above it the
// exponent is positive and may overflow, and inf * 0 is NaN.
//
// Bound on the H100: at the training path's shape (B 4, L 4608, H 32, P 64,
// N 128, Q 128, bf16) the inputs and outputs move ~250 MB (0.0747 ms at
// 3.35 TB/s) for ~69.5 GFLOP of products (0.0702 ms on the bf16 tensor
// cores), so bytes bound it, by a little.  The products counted: per chunk
// S, dS B and dS^T C; per head dy x^T, (S M)^T dy and five of Q P N
// (h_prev, dh_prev, dh B^T, dy h_prev, dh^T x).  ddt's carried term
// h_prev C^T that this kernel forms is sum_n C[q,n] (dy[q] h_prev)[n], only
// O(Q N) more, and is not counted.
//
// Design: the f32 FMA passes of the forward, simple and exact to f32
// rounding, in eight launches.  They serve f32 and every shape but
// Mamba-2's bf16 one, which csrc/ssd_scan_bwd_wgmma.cu takes
// (kernels/ssd_scan.py: tensor_core_bwd_route):
//   1-3. the forward's passes 1-3 (ssd_fma.cuh) recompute S and each
//      chunk's entering state h_prev into scratch, so the autograd Function
//      saves only the inputs (h_prev of one call is 151 MB at the path
//      shape, 7.2 GB over 48 layers);
//   4. ssd_chunk_state<kGrad>: each chunk's own part of dh_prev,
//      sum_q exp(cum[q]) dy[q] C[q]^T, over every (chunk, head, batch);
//   5. ssd_state_pass<kReverse>: per (b, h), dh carried from the last chunk
//      (starting at dhT) to the first, leaving the gradient of the state
//      leaving each chunk in the scratch;
//   6. ssd_bwd_chunk: one block per (chunk, group of heads, batch) walks
//      its heads in order and writes dx, ddt and a partial of da per head,
//      and the group's part of dS (summed over its heads on chip);
//   7. ssd_bwd_dbc: per (chunk, batch), dC and dB as one product each over
//      the chunk's tokens (dS summed over the head groups in order) and over
//      (head, p) (the carried-state terms);
//   8. ssd_bwd_da: da summed over (batch, chunk) in order.
// Every sum runs in a fixed order and there are no atomics, so a rerun gives
// the same bits.  Scratch (the caller's): S (B, L/Q, Q, Q), h_prev and dh
// (B, L/Q, H, P, N) each, decay (B, L/Q, H), the da partials (B, L/Q, H) and
// the dS partials (B, L/Q, G, Q, Q), all f32, G = ceil(H / heads per group),
// the group size the caller passes.  Limits as the FMA
// forward's: Q <= 128, P <= 64, N <= 128, L a multiple of Q.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

// Everything here, the forward's passes included, lives in namespace
// ssd_bwd, so that a profiler's kernel names tell the backward's passes
// from the forward's (chip_smoke.py: PROFILE_GROUPS).
namespace ssd_bwd {

#include "ssd_fma.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

template <typename T>
struct BwdArgs {
  const T* x;
  const float* dt;
  const float* a;
  const T* bm;
  const T* cm;
  const T* dy;
  const float* S;       // (B, nc, Q, Q), k major
  const float* hprev;   // (B, nc, H, P, N): the state entering each chunk
  const float* dh;      // (B, nc, H, P, N): the gradient of the one leaving
  T* dx;
  float* ddt;
  float* dapart;        // (B, nc, H)
  float* dSpart;        // (B, nc, G, Q, Q), q major
  T* dbm;
  T* dcm;
  int L, H, P, N, Q, nc, G, hpb;  // G groups of hpb heads
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

// the sum of v over the warp, the same bits on every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ssd_bwd_chunk's dynamic shared memory, in floats
constexpr int kDS = 0;                        // dS [QMAX][QMAX]
constexpr int kTA = kDS + QMAX * QMAX;        // operand tiles [KT][LDQ]
constexpr int kTV = kTA + KT * LDQ;
constexpr int kPart = kTV + KT * LDQ;         // 3 x [16][QMAX] partial sums
constexpr int kVec = kPart + 3 * 16 * QMAX;   // 9 per-token vectors
constexpr int kRed = kVec + 9 * QMAX;         // [kWarps]
constexpr int kChunkBytes = (kRed + kWarps) * 4;

// Step 6: grid (nc, G, B), 256 threads.  Per head of the block's group, in
// order:
//   (1) G = dy x^T on and below the diagonal (8x8 tiles of (q, k)); each
//       thread adds M G to its own elements of dS and forms S E G and
//       S M G, whose row and column sums are reduced in a fixed order;
//   (2) dx = (S M)^T dy + w (B dh^T), and x.(dh B) per token (4x8 tiles of
//       (k, p));
//   (3) dy.(h_prev C) per token and <dh, h_prev>;
//   (4) warp 0: dcum, its reverse running sum dA, ddt and the da partial.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(BwdArgs<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* dS = smem + kDS;
  float* ta = smem + kTA;
  float* tv = smem + kTV;
  float* part0 = smem + kPart;
  float* part1 = part0 + 16 * QMAX;
  float* part2 = part1 + 16 * QMAX;
  float* dts = smem + kVec;
  float* cum = dts + QMAX;
  float* ecum = cum + QMAX;    // exp(cum)
  float* e2 = ecum + QMAX;     // exp(total - cum)
  float* rowT = e2 + QMAX;     // sum_k S M G [q, k]
  float* colSd = rowT + QMAX;  // sum_q S E G [q, k]
  float* colT = colSd + QMAX;  // sum_q S M G [q, k]
  float* xv = colT + QMAX;     // x[k] . dh B[k]
  float* dyz = xv + QMAX;      // dy[q] . h_prev C[q]
  float* red = smem + kRed;
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int Q = p.Q, P = p.P, N = p.N, H = p.H, L = p.L;
  const long long l0 = (long long)c * Q;
  const long long bc = (long long)b * p.nc + c;
  const long long HP = (long long)H * P;
  const float* Sb = p.S + bc * Q * Q;
  const T* bb = p.bm + b * p.b_sb + l0 * p.b_sl;
  const T* cb = p.cm + b * p.c_sb + l0 * p.c_sl;
  for (int i = tid; i < QMAX * QMAX; i += kThreads) dS[i] = 0.f;
  // (q, k) in 8x8 tiles for (1); (row, p) in 4x8 tiles for (2) and (3)
  const int nt = (Q + 7) / 8;
  const int tk = tid % nt, tq = tid / nt;
  const bool act = tq < nt;
  const int ntp = (P + 7) / 8, ntr = (Q + 3) / 4;
  const int tp = tid % ntp, tr = tid / ntp;
  const bool act2 = tr < ntr;
  const int h_end = min(H, (g + 1) * p.hpb);
  for (int h = g * p.hpb; h < h_end; ++h) {
    const float av = p.a[h];
    chunk_cumsum(p.dt + ((long long)b * L + l0) * H + h, H, av, Q, dts, cum);
    const float total = cum[Q - 1];
    for (int q = tid; q < Q; q += kThreads) {
      ecum[q] = expf(cum[q]);
      e2[q] = expf(total - cum[q]);
    }
    const T* xb = p.x + b * p.x_sb + l0 * p.x_sl + (long long)h * P;
    const T* dyb = p.dy + ((long long)b * L + l0) * HP + (long long)h * P;
    const long long so = (bc * H + h) * (long long)P * N;
    const float* hp = p.hprev + so;
    const float* dhp = p.dh + so;

    // (1) G[q][k] = dy[q] . x[k]
    float acc[8][8] = {};
    for (int p0 = 0; p0 < P; p0 += KT) {
      for (int i = tid; i < KT * QMAX; i += kThreads) {
        const int pp = i % KT, q = i / KT, pc = p0 + pp;
        const bool in = q < Q && pc < P;
        ta[pp * LDQ + q] = in ? ld(dyb + q * HP + pc) : 0.f;
        tv[pp * LDQ + q] = in ? ld(xb + q * p.x_sl + pc) : 0.f;
      }
      __syncthreads();
      // tiles with tk > tq lie above the diagonal
      if (act && tk <= tq) tile_fma<8, 8, LDQ, LDQ>(ta, tv, 8 * tq, 8 * tk,
                                                      acc);
      __syncthreads();
    }
    if (act) {
      float rt[8] = {}, csd[8] = {}, ct[8] = {};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int q = 8 * tq + r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = 8 * tk + j;
          if (q < Q && k <= q) {
            const float e = expf(cum[q] - cum[k]);
            const float gv = acc[r][j];
            const float sd = Sb[(long long)k * Q + q] * e * gv;
            const float t = sd * dts[k];
            dS[q * QMAX + k] += e * dts[k] * gv;
            rt[r] += t;
            csd[j] += sd;
            ct[j] += t;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (8 * tq + r < Q) part0[tk * QMAX + 8 * tq + r] = rt[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * tk + j < Q) {
          part1[tq * QMAX + 8 * tk + j] = csd[j];
          part2[tq * QMAX + 8 * tk + j] = ct[j];
        }
      }
    }
    __syncthreads();
    for (int q = tid; q < Q; q += kThreads) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int t = 0; t < nt; ++t) {
        s0 += part0[t * QMAX + q];
        s1 += part1[t * QMAX + q];
        s2 += part2[t * QMAX + q];
      }
      rowT[q] = s0;
      colSd[q] = s1;
      colT[q] = s2;
    }

    // (2) dx[k] = sum_q S[q][k] M[q][k] dy[q] + w[k] V[k], V[k] = dh B[k]
    float ax[4][8] = {}, aw[4][8] = {};
    for (int q0 = 0; q0 < Q; q0 += KT) {
      for (int i = tid; i < KT * QMAX; i += kThreads) {
        const int qq = i % KT, k = i / KT, q = q0 + qq;
        ta[qq * LDQ + k] = (q < Q && k <= q)
            ? Sb[(long long)k * Q + q] * expf(cum[q] - cum[k]) * dts[k] : 0.f;
      }
      for (int i = tid; i < KT * PMAX; i += kThreads) {
        const int pc = i % PMAX, qq = i / PMAX, q = q0 + qq;
        tv[qq * LDP + pc] = (q < Q && pc < P) ? ld(dyb + q * HP + pc) : 0.f;
      }
      __syncthreads();
      // a thread's rows k see only the keys q >= k
      if (act2 && q0 + KT - 1 >= 4 * tr)
        tile_fma<4, 8, LDQ, LDP>(ta, tv, 4 * tr, 8 * tp, ax);
      __syncthreads();
    }
    for (int n0 = 0; n0 < N; n0 += KT) {
      for (int i = tid; i < KT * QMAX; i += kThreads) {
        const int nn = i % KT, k = i / KT, n = n0 + nn;
        ta[nn * LDQ + k] = (k < Q && n < N) ? ld(bb + k * p.b_sl + n) : 0.f;
      }
      for (int i = tid; i < KT * PMAX; i += kThreads) {
        const int nn = i % KT, pc = i / KT, n = n0 + nn;
        tv[nn * LDP + pc] = (pc < P && n < N) ? dhp[pc * N + n] : 0.f;
      }
      __syncthreads();
      if (act2) tile_fma<4, 8, LDQ, LDP>(ta, tv, 4 * tr, 8 * tp, aw);
      __syncthreads();
    }
    if (act2) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 4 * tr + r;
        if (k >= Q) continue;
        const float wk = e2[k] * dts[k];
        T* dxr = p.dx + ((long long)b * L + l0 + k) * HP + (long long)h * P;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int pc = 8 * tp + j;
          if (pc < P) {
            st(dxr + pc, ax[r][j] + wk * aw[r][j]);
            s = fmaf(ld(xb + k * p.x_sl + pc), aw[r][j], s);
          }
        }
        part0[tp * QMAX + k] = s;
      }
    }

    // (3) Z[q] = h_prev C[q], dy[q] . Z[q]; <dh, h_prev>
    float az[4][8] = {};
    for (int n0 = 0; n0 < N; n0 += KT) {
      for (int i = tid; i < KT * QMAX; i += kThreads) {
        const int nn = i % KT, q = i / KT, n = n0 + nn;
        ta[nn * LDQ + q] = (q < Q && n < N) ? ld(cb + q * p.c_sl + n) : 0.f;
      }
      for (int i = tid; i < KT * PMAX; i += kThreads) {
        const int nn = i % KT, pc = i / KT, n = n0 + nn;
        tv[nn * LDP + pc] = (pc < P && n < N) ? hp[pc * N + n] : 0.f;
      }
      __syncthreads();
      if (act2) tile_fma<4, 8, LDQ, LDP>(ta, tv, 4 * tr, 8 * tp, az);
      __syncthreads();
    }
    if (act2) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = 4 * tr + r;
        if (q >= Q) continue;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int pc = 8 * tp + j;
          if (pc < P) s = fmaf(ld(dyb + q * HP + pc), az[r][j], s);
        }
        part1[tp * QMAX + q] = s;
      }
    }
    float hd = 0.f;
    for (int e = tid; e < P * N; e += kThreads) hd = fmaf(dhp[e], hp[e], hd);
    hd = warp_sum(hd);
    if ((tid & 31) == 0) red[tid >> 5] = hd;
    __syncthreads();
    for (int q = tid; q < Q; q += kThreads) {
      float s0 = 0.f, s1 = 0.f;
      for (int t = 0; t < ntp; ++t) {
        s0 += part0[t * QMAX + q];
        s1 += part1[t * QMAX + q];
      }
      xv[q] = s0;
      dyz[q] = s1;
    }
    __syncthreads();

    // (4) dcum[q] = rowT[q] - colT[q] + exp(cum[q]) dyz[q] - U[q], with
    // U[k] = w[k] xv[k]; the last token also takes d total =
    // exp(total) <dh, h_prev> + sum U.  dA is its reverse running sum: each
    // lane sums its (at most 4) consecutive tokens from the end, then the
    // lanes above it are added by a warp scan.
    if (tid < 32) {
      const int lane = tid;
      const int per = (Q + 31) / 32;
      float hdot = 0.f;
      for (int w = 0; w < kWarps; ++w) hdot += red[w];
      float dc[4], usum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = lane * per + i;
        dc[i] = 0.f;
        if (i < per && q < Q) {
          const float u = e2[q] * dts[q] * xv[q];
          dc[i] = rowT[q] - colT[q] + ecum[q] * dyz[q] - u;
          usum += u;
        }
      }
      usum = warp_sum(usum);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < per && lane * per + i == Q - 1)
          dc[i] += expf(total) * hdot + usum;
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
        const int q = lane * per + i;
        if (i < per && q < Q) {
          const float dA = excl + loc[i];
          p.ddt[((long long)b * L + l0 + q) * H + h] =
              colSd[q] + e2[q] * xv[q] + av * dA;
          dap = fmaf(dts[q], dA, dap);
        }
      }
      dap = warp_sum(dap);
      if (lane == 0) p.dapart[bc * H + h] = dap;
    }
    __syncthreads();
  }
  float* out = p.dSpart + (bc * p.G + g) * (long long)Q * Q;
  for (int i = tid; i < Q * Q; i += kThreads)
    out[i] = dS[(i / Q) * QMAX + i % Q];
}

// Step 7: grid (nc, 2, B); blockIdx.y 0 writes dC, 1 writes dB, each a
// (Q, N) product in 8x8 tiles, reduced over the chunk's tokens r
//   dC[q] += sum_r dS[q][r] B[r],      dB[k] += sum_r dS[r][k] C[r]
// (dS summed over the head groups in order as it is loaded), then over
// (h, p)
//   dC[q] += exp(cum[q]) dy[q][h][:] h_prev[h],  dB[k] += w[k] x[k][h][:] dh[h]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc(BwdArgs<T> p) {
  __shared__ float dts[QMAX], cum[QMAX], wv[QMAX];
  __shared__ __align__(16) float ta[KT * LDQ];   // [r][q or k]
  __shared__ __align__(16) float tb[KT * LDN];   // [r][n]
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const bool want_b = blockIdx.y == 1;
  const int Q = p.Q, P = p.P, N = p.N, H = p.H, L = p.L, G = p.G;
  const long long l0 = (long long)c * Q;
  const long long bc = (long long)b * p.nc + c;
  const long long HP = (long long)H * P;
  const long long QQ = (long long)Q * Q;
  const float* dSb = p.dSpart + bc * G * QQ;
  const T* other = want_b ? p.cm + b * p.c_sb + l0 * p.c_sl
                          : p.bm + b * p.b_sb + l0 * p.b_sl;
  const long long o_sl = want_b ? p.c_sl : p.b_sl;
  const int ntn = (N + 7) / 8, ntq = (Q + 7) / 8;
  const int tn = tid % ntn, tq = tid / ntn;
  const bool act = tq < ntq;
  float acc[8][8] = {};
  for (int r0 = 0; r0 < Q; r0 += KT) {
    if (want_b) {
      for (int i = tid; i < KT * QMAX; i += kThreads) {
        const int k = i % QMAX, rr = i / QMAX, r = r0 + rr;
        float s = 0.f;
        if (r < Q && k < Q)
          for (int gg = 0; gg < G; ++gg) s += dSb[gg * QQ + r * Q + k];
        ta[rr * LDQ + k] = s;
      }
    } else {
      for (int i = tid; i < KT * QMAX; i += kThreads) {
        const int rr = i % KT, q = i / KT, r = r0 + rr;
        float s = 0.f;
        if (r < Q && q < Q)
          for (int gg = 0; gg < G; ++gg) s += dSb[gg * QQ + q * Q + r];
        ta[rr * LDQ + q] = s;
      }
    }
    for (int i = tid; i < KT * NMAX; i += kThreads) {
      const int n = i % NMAX, rr = i / NMAX, r = r0 + rr;
      tb[rr * LDN + n] = (r < Q && n < N) ? ld(other + r * o_sl + n) : 0.f;
    }
    __syncthreads();
    if (act) tile_fma<8, 8, LDQ, LDN>(ta, tb, 8 * tq, 8 * tn, acc);
    __syncthreads();
  }
  for (int h = 0; h < H; ++h) {
    chunk_cumsum(p.dt + ((long long)b * L + l0) * H + h, H, p.a[h], Q, dts,
                 cum);
    const float total = cum[Q - 1];
    for (int q = tid; q < Q; q += kThreads)
      wv[q] = want_b ? expf(total - cum[q]) * dts[q] : expf(cum[q]);
    __syncthreads();
    const T* rows = want_b
        ? p.x + b * p.x_sb + l0 * p.x_sl + (long long)h * P
        : p.dy + ((long long)b * L + l0) * HP + (long long)h * P;
    const long long rs = want_b ? p.x_sl : HP;
    const float* state = (want_b ? p.dh : p.hprev)
        + (bc * H + h) * (long long)P * N;
    for (int p0 = 0; p0 < P; p0 += KT) {
      for (int i = tid; i < KT * QMAX; i += kThreads) {
        const int pp = i % KT, q = i / KT, pc = p0 + pp;
        ta[pp * LDQ + q] = (q < Q && pc < P) ? wv[q] * ld(rows + q * rs + pc)
                                             : 0.f;
      }
      for (int i = tid; i < KT * NMAX; i += kThreads) {
        const int n = i % NMAX, pp = i / NMAX, pc = p0 + pp;
        tb[pp * LDN + n] = (pc < P && n < N) ? state[pc * N + n] : 0.f;
      }
      __syncthreads();
      if (act) tile_fma<8, 8, LDQ, LDN>(ta, tb, 8 * tq, 8 * tn, acc);
      __syncthreads();
    }
  }
  if (!act) return;
  T* out = (want_b ? p.dbm : p.dcm) + ((long long)b * L + l0) * N;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int q = 8 * tq + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * tn + j;
      if (q < Q && n < N) st(out + (long long)q * N + n, acc[r][j]);
    }
  }
}

// Step 8: da[h] = sum over (b, chunk) of the partials, in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_da(const float* __restrict__ dapart, float* __restrict__ da, int H,
           int BC) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int i = 0; i < BC; ++i) s += dapart[(long long)i * H + h];
  da[h] = s;
}

template <typename T>
int launch_bwd(const void* x, const void* dt, const void* a, const void* bm,
               const void* cm, const void* dy, const void* dhT, void* dx,
               void* ddt, void* da, void* dbm, void* dcm, void* S,
               void* states, void* decay, void* dh, void* dapart,
               void* dSpart, int B, int L, int H, int P, int N, int Q,
               int hpb, long long x_sb, long long x_sl, long long b_sb,
               long long b_sl, long long c_sb, long long c_sl,
               cudaStream_t stream) {
  BwdArgs<T> p;
  p.x = static_cast<const T*>(x);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.bm = static_cast<const T*>(bm);
  p.cm = static_cast<const T*>(cm);
  p.dy = static_cast<const T*>(dy);
  p.S = static_cast<const float*>(S);
  p.hprev = static_cast<const float*>(states);
  p.dh = static_cast<const float*>(dh);
  p.dx = static_cast<T*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dapart = static_cast<float*>(dapart);
  p.dSpart = static_cast<float*>(dSpart);
  p.dbm = static_cast<T*>(dbm);
  p.dcm = static_cast<T*>(dcm);
  p.L = L;
  p.H = H;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.nc = L / Q;
  p.hpb = hpb;
  p.G = (H + hpb - 1) / hpb;
  p.x_sb = x_sb;
  p.x_sl = x_sl;
  p.b_sb = b_sb;
  p.b_sl = b_sl;
  p.c_sb = c_sb;
  p.c_sl = c_sl;
  float* decf = static_cast<float*>(decay);
  float* dhf = static_cast<float*>(dh);
  int rc = launch_states<T>(p.x, p.dt, p.a, p.bm, p.cm,
                            static_cast<float*>(S),
                            static_cast<float*>(states), decf, nullptr, B, L,
                            H, P, N, Q, x_sb, x_sl, b_sb, b_sl, c_sb, c_sl,
                            stream);
  if (rc) return rc;
  ssd_chunk_state<T, true><<<dim3(p.nc, H, B), kThreads, 0, stream>>>(
      p.dy, p.dt, p.a, p.cm, dhf, nullptr, L, H, P, N, Q, p.nc,
      (long long)L * H * P, (long long)H * P, c_sb, c_sl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int PN = P * N;
  ssd_state_pass<true><<<dim3((PN + kThreads - 1) / kThreads, H, B),
                         kThreads, 0, stream>>>(
      dhf, decf, static_cast<const float*>(dhT), nullptr, H, PN, p.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static bool sized = false;
  if (!sized) {
    err = cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kChunkBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  ssd_bwd_chunk<T><<<dim3(p.nc, p.G, B), kThreads, kChunkBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dbc<T><<<dim3(p.nc, 2, B), kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_da<<<dim3((H + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      p.dapart, static_cast<float*>(da), H, B * p.nc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ssd_bwd

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, bm, cm, dy, dx, dbm, dcm); dt, a,
// dhT, ddt and da are f32.  dhT may be null (a zero gradient of the final
// state).  S, states, decay, dh, dapart and dSpart are the f32 scratch of
// the header, allocated by the caller, dSpart for groups of hpb heads.
// Returns a CUDA error code (0 on success).
int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, const void* dy, const void* dhT, void* dx,
                 void* ddt, void* da, void* dbm, void* dcm, void* S,
                 void* states, void* decay, void* dh, void* dapart,
                 void* dSpart, int dtype, int B, int L, int H, int P, int N,
                 int Q, int hpb, long long x_sb, long long x_sl,
                 long long b_sb, long long b_sl, long long c_sb,
                 long long c_sl, void* stream) {
  using ssd_bwd::QMAX, ssd_bwd::PMAX, ssd_bwd::NMAX;
  if (Q < 1 || Q > QMAX || P < 1 || P > PMAX || N < 1 || N > NMAX ||
      L % Q != 0 || B < 1 || H < 1 || hpb < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ssd_bwd::launch_bwd<float>(
        x, dt, a, bm, cm, dy, dhT, dx, ddt, da, dbm, dcm, S, states, decay,
        dh, dapart, dSpart, B, L, H, P, N, Q, hpb, x_sb, x_sl, b_sb, b_sl,
        c_sb, c_sl, s);
  if (dtype == 1)
    return ssd_bwd::launch_bwd<__nv_bfloat16>(
        x, dt, a, bm, cm, dy, dhT, dx, ddt, da, dbm, dcm, S, states, decay,
        dh, dapart, dSpart, B, L, H, P, N, Q, hpb, x_sb, x_sl, b_sb, b_sl,
        c_sb, c_sl, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
