// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan (body
// _ssd_kernel).  x (B,L,H,P), dt (B,L,H) f32, a (H,) f32, bm/cm (B,L,N),
// one state group shared by all heads.  Per chunk of Q tokens, with
// dA = dt*a and cum its running sum within the chunk:
//   y      = (exp(segsum) (.) C B^T) (dt (.) x) + exp(cum) (.) (C h_prev^T)
//   h_next = exp(sum dA) h_prev + (exp(total - cum) (.) dt (.) x)^T B
// The state starts at zero; everything is f32; y is stored in x's dtype and
// the final state hT (B,H,P,N) in f32.
//
// Bound on the H100: bytes at the serving shape (B=4, L=4608, H=32, P=64,
// N=128, Q=128, bf16): the inputs and outputs move ~167 MB (0.050 ms at
// 3.35 TB/s) for ~30 GFLOP, 0.030 ms on the bf16 tensor cores.  This first
// kernel does its arithmetic in f32 on the CUDA cores (67 TFLOP/s, 0.45 ms
// for the same work), so the f32 FMAs are what it waits on.
//
// Design.  The TPU walked the chunks of one (b, h) in order and carried the
// (P, N) state in VMEM; here that would give B*H = 128 blocks for 132 SMs,
// each walking 36 chunks in turn.  Instead the chunked form runs in four
// passes, each but the third over every (chunk, head, batch):
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
// along the reduction.  Every output is summed by one thread in a fixed
// order and there are no atomics, so a rerun gives the same bits.
// Limits: Q <= 128, P <= 64, N <= 128 (any values, ragged tiles are
// zero-filled); row strides of x, bm and cm are arguments (they arrive as
// column slices of the conv output); dt is contiguous.
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
// 4 (p) x 8 (n) tiles; bounded to three blocks an SM (at 87 registers a
// thread only two fit).
template <typename T>
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
    wq[q] = expf(total - cum[q]) * dts[q];
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
  if (tid == 0) decay[bch] = expf(total);
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

// Pass 3: for each (b, h) and state element, in chunk order,
// h_prev = h; h = h * decay[c] + own[c]; states[c] <- h_prev; hT <- h.
// grid (ceil(P*N / kThreads), H, B).
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               float* __restrict__ hT, int H, int PN, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  // loads of kUnroll chunks are issued before the serial updates use them
  constexpr int kUnroll = 4;
  const long long stride = (long long)H * PN;
  float* p = states + ((long long)b * nc * H + h) * PN + e;
  const float* dc = decay + (long long)b * nc * H + h;
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kUnroll) {
    float own[kUnroll], dec[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (c0 + i < nc) {
        own[i] = p[(c0 + i) * stride];
        dec[i] = dc[(long long)(c0 + i) * H];
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (c0 + i < nc) {
        p[(c0 + i) * stride] = s;
        s = s * dec[i] + own[i];
      }
    }
  }
  hT[((long long)b * H + h) * PN + e] = s;
}

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
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* Sf = static_cast<float*>(S);
  float* sf = static_cast<float*>(states);
  float* df = static_cast<float*>(decay);
  ssd_chunk_scores<T><<<dim3(nc, B), kThreads, 0, stream>>>(
      bt, ct, Sf, N, Q, nc, b_sb, b_sl, c_sb, c_sl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_state<T><<<dim3(nc, H, B), kThreads, 0, stream>>>(
      xt, dtf, af, bt, sf, df, L, H, P, N, Q, nc, x_sb, x_sl, b_sb, b_sl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int PN = P * N;
  ssd_state_pass<<<dim3((PN + kThreads - 1) / kThreads, H, B), kThreads, 0,
                   stream>>>(sf, df, static_cast<float*>(hT), H, PN, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_out<T><<<dim3(nc, H, B), kThreads, 0, stream>>>(
      xt, dtf, af, ct, Sf, sf, static_cast<T*>(y), L, H, P, N, Q, nc, x_sb,
      x_sl, c_sb, c_sl);
  return cudaGetLastError();
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

}  // extern "C"
