// The f32 FMA passes of the Mamba-2 SSD chunked scan shared by the forward
// (ssd_scan.cu) and the backward (ssd_scan_bwd.cu): register-tiled FMA
// products over shared-memory tiles, the chunk-local cumulative sum of
// dA = dt a in one fixed order, and passes 1-3 of the forward (the chunk
// scores S = C B^T, each chunk's own end state, and the recurrence over the
// chunks, which the backward also runs in reverse for the state gradient).
// Limits: Q <= QMAX, P <= PMAX, N <= NMAX (any values, ragged tiles are
// zero-filled); row strides of x, bm and cm are arguments; dt is contiguous.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {


constexpr int kThreads = 256;
constexpr int QMAX = 128, PMAX = 64, NMAX = 128, KT = 32;
constexpr int LDQ = QMAX + 4, LDP = PMAX + 4, LDN = NMAX + 4;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[r][c] += sum_k A[k][r0 + r] * B[k][c0 + c] over the KT rows of two
// shared tiles (row strides LDA, LDB); TR and TC are multiples of 4.
template <int TR, int TC, int LDA, int LDB>
__device__ __forceinline__ void tile_fma(const float* A, const float* B,
                                         int r0, int c0,
                                         float (&acc)[TR][TC]) {
#pragma unroll 4
  for (int k = 0; k < KT; ++k) {
    float ar[TR], br[TC];
#pragma unroll
    for (int i = 0; i < TR; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(A + k * LDA + r0 + i);
      ar[i] = v.x; ar[i + 1] = v.y; ar[i + 2] = v.z; ar[i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < TC; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(B + k * LDB + c0 + j);
      br[j] = v.x; br[j + 1] = v.y; br[j + 2] = v.z; br[j + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

// dts[q] = dt of token q of the chunk and cum[q] = sum_{r<=q} dt[r] * a, in
// one fixed order: each lane of warp 0 sums its (at most 4) consecutive
// tokens, then a warp-wide inclusive scan adds the lanes before it.
__device__ void chunk_cumsum(const float* __restrict__ dt_col, int H, float a,
                             int Q, float* dts, float* cum) {
  for (int q = threadIdx.x; q < Q; q += kThreads)
    dts[q] = dt_col[(long long)q * H];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (Q + 31) / 32;
    float loc[4];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = lane * per + i;
      if (i < per && q < Q) s += dts[q] * a;
      loc[i] = s;
    }
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = lane * per + i;
      if (i < per && q < Q) cum[q] = excl + loc[i];
    }
  }
  __syncthreads();
}

// Pass 1: S[b][c][k][q] = sum_n C[q][n] B[k][n], stored transposed (k
// major) for pass 4's loads; grid (nc, B); 8x8 tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scores(const T* __restrict__ bm, const T* __restrict__ cm,
                 float* __restrict__ S, int N, int Q, int nc,
                 long long b_sb, long long b_sl, long long c_sb,
                 long long c_sl) {
  __shared__ __align__(16) float tc[KT * LDQ];
  __shared__ __align__(16) float tb[KT * LDQ];
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long l0 = (long long)c * Q;
  const T* cb = cm + b * c_sb + l0 * c_sl;
  const T* bb = bm + b * b_sb + l0 * b_sl;
  const int nt = (Q + 7) / 8;
  const int tk = tid % nt, tq = tid / nt;
  const bool active = tq < nt;
  float acc[8][8] = {};
  for (int n0 = 0; n0 < N; n0 += KT) {
    for (int i = tid; i < KT * QMAX; i += kThreads) {
      const int nn = i % KT, q = i / KT, n = n0 + nn;
      const bool in = q < Q && n < N;
      tc[nn * LDQ + q] = in ? ld(cb + q * c_sl + n) : 0.f;
      tb[nn * LDQ + q] = in ? ld(bb + q * b_sl + n) : 0.f;
    }
    __syncthreads();
    if (active) tile_fma<8, 8, LDQ, LDQ>(tc, tb, 8 * tq, 8 * tk, acc);
    __syncthreads();
  }
  if (!active) return;
  float* Sb = S + ((long long)b * nc + c) * Q * Q;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int q = 8 * tq + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * tk + j;
      if (q < Q && k < Q) Sb[k * Q + q] = acc[r][j];
    }
  }
}

// Pass 2: states[b][c][h][p][n] = sum_q w[q] x[q][p] B[q][n] with
// w = exp(total - cum) dt, and decay[b][c][h] = exp(total); grid (nc, H, B);
// under kGrad (the backward's per-chunk state gradient) x is dy, B is C,
// w = exp(cum) and decay is not written;
// 4 (p) x 8 (n) tiles; bounded to three blocks an SM (at 87 registers a
// thread only two fit).
template <typename T, bool kGrad>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                float* __restrict__ states, float* __restrict__ decay, int L,
                int H, int P, int N, int Q, int nc, long long x_sb,
                long long x_sl, long long b_sb, long long b_sl) {
  __shared__ float dts[QMAX], cum[QMAX], wq[QMAX];
  __shared__ __align__(16) float tw[KT * LDP];
  __shared__ __align__(16) float tb[KT * LDN];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long l0 = (long long)c * Q;
  chunk_cumsum(dt + ((long long)b * L + l0) * H + h, H, a[h], Q, dts, cum);
  const float total = cum[Q - 1];
  for (int q = tid; q < Q; q += kThreads)
    wq[q] = kGrad ? expf(cum[q]) : expf(total - cum[q]) * dts[q];
  __syncthreads();
  const T* xb = x + b * x_sb + l0 * x_sl + (long long)h * P;
  const T* bb = bm + b * b_sb + l0 * b_sl;
  const int ntn = (N + 7) / 8, ntp = (P + 3) / 4;
  const int tn = tid % ntn, tp = tid / ntn;
  const bool active = tp < ntp;
  float acc[4][8] = {};
  for (int q0 = 0; q0 < Q; q0 += KT) {
    for (int i = tid; i < KT * PMAX; i += kThreads) {
      const int p = i % PMAX, qq = i / PMAX, q = q0 + qq;
      tw[qq * LDP + p] = (q < Q && p < P) ? wq[q] * ld(xb + q * x_sl + p)
                                          : 0.f;
    }
    for (int i = tid; i < KT * NMAX; i += kThreads) {
      const int n = i % NMAX, qq = i / NMAX, q = q0 + qq;
      tb[qq * LDN + n] = (q < Q && n < N) ? ld(bb + q * b_sl + n) : 0.f;
    }
    __syncthreads();
    if (active) tile_fma<4, 8, LDP, LDN>(tw, tb, 4 * tp, 8 * tn, acc);
    __syncthreads();
  }
  const long long bch = ((long long)b * nc + c) * H + h;
  if (!kGrad && tid == 0) decay[bch] = expf(total);
  if (!active) return;
  float* sb = states + bch * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = 4 * tp + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * tn + j;
      if (p < P && n < N) sb[p * N + n] = acc[r][j];
    }
  }
}

// Pass 3: for each (b, h) and state element, the recurrence over the chunks
// in order (forward: h_prev = h; h = h * decay[c] + own[c]) or in reverse
// (kReverse, the backward: the gradient of the state leaving chunk c is
// carried into the one entering it, dh_prev = dh * decay[c] + own[c]);
// states[c] <- the carried value before chunk c is applied.  It starts from
// h0 (zero when null) and ends in hT (not written when null).
// grid (ceil(P*N / kThreads), H, B).
template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               const float* __restrict__ h0, float* __restrict__ hT, int H,
               int PN, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  // loads of kUnroll chunks are issued before the serial updates use them
  constexpr int kUnroll = 4;
  const long long stride = (long long)H * PN;
  const long long he = ((long long)b * H + h) * PN + e;
  float* p = states + ((long long)b * nc * H + h) * PN + e;
  const float* dc = decay + (long long)b * nc * H + h;
  float s = h0 ? h0[he] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kUnroll) {
    float own[kUnroll], dec[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int c = kReverse ? nc - 1 - (c0 + i) : c0 + i;
      if (c0 + i < nc) {
        own[i] = p[c * stride];
        dec[i] = dc[(long long)c * H];
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int c = kReverse ? nc - 1 - (c0 + i) : c0 + i;
      if (c0 + i < nc) {
        p[c * stride] = s;
        s = s * dec[i] + own[i];
      }
    }
  }
  if (hT) hT[he] = s;
}

// Passes 1-3 of the forward: S (k major), each chunk's entering state in
// `states` and its decay; hT may be null.  Returns a CUDA error code.
template <typename T>
int launch_states(const T* x, const float* dt, const float* a, const T* bm,
                  const T* cm, float* S, float* states, float* decay,
                  float* hT, int B, int L, int H, int P, int N, int Q,
                  long long x_sb, long long x_sl, long long b_sb,
                  long long b_sl, long long c_sb, long long c_sl,
                  cudaStream_t stream) {
  const int nc = L / Q;
  ssd_chunk_scores<T><<<dim3(nc, B), kThreads, 0, stream>>>(
      bm, cm, S, N, Q, nc, b_sb, b_sl, c_sb, c_sl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_state<T, false><<<dim3(nc, H, B), kThreads, 0, stream>>>(
      x, dt, a, bm, states, decay, L, H, P, N, Q, nc, x_sb, x_sl, b_sb, b_sl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int PN = P * N;
  ssd_state_pass<false><<<dim3((PN + kThreads - 1) / kThreads, H, B),
                          kThreads, 0, stream>>>(states, decay, nullptr, hT,
                                                 H, PN, nc);
  return cudaGetLastError();
}

}  // namespace
