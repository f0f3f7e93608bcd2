// Fused Flow-SDE Euler-Maruyama step with its Gaussian log-density.
//
// Replaces the TPU kernel src/repro/kernels/sde_step.py:sde_step
// (body _sde_kernel): x_next = x - [v + s2/(2t)(x + (1-t)v)] d + s sqrt(d) eps,
// with tc = clip(t, 1e-4, 0.96), s2 = eta^2 tc/(1-tc), d = t - t_next, and the
// per-row log-prob sum(-0.5(eps^2 + log 2pi) - log(s sqrt(d))).
//
// Bound on the H100: bytes.  Per element it reads v, x, eps and writes
// x_next (16 bytes in f32) for about ten flops, far below the card's
// ~295 flops per byte, so the floor is the 3.35 TB/s of device memory.
//
// Design.  The TPU ran one program per batch row over the whole row; here a
// row of 4096 x 64 floats would then occupy 4 of 132 SMs.  Each row is cut
// into `nblk` chunks, one block each (grid nblk x B), so a batch of four
// still fills the card.  Every element is read once and x_next written once,
// as 16-byte vectors where the row length and alignment allow.
// The row sum of the log-density must come out the same on every run: each
// block reduces its chunk in a fixed order (thread-serial, then a fixed
// shuffle tree, then warp partials in order) into partials[b][blk], and a
// second one-block-per-row kernel sums those partials in a fixed order.
// No float atomics anywhere.  t and t_next arrive by value.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warp_part) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w];
  }
  return s;
}

// VEC consecutive elements of one row, read as one 16-byte load.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// One block per (chunk of a row, row).  With VEC, every thread moves
// 16-byte vectors (the chunk and the row are multiples of the vector);
// without it, single elements.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
sde_step_chunks(const T* __restrict__ v, const T* __restrict__ x,
                const T* __restrict__ eps, float* __restrict__ x_next,
                float* __restrict__ partials, long long feat, long long chunk,
                int nblk, float t, float t_next, float eta) {
  __shared__ float warp_part[kThreads / 32];
  const int b = blockIdx.y, blk = blockIdx.x;
  const float tc = fminf(fmaxf(t, 1e-4f), 0.96f);
  const float sigma2 = eta * eta * tc / (1.0f - tc);
  const float delta = t - t_next;
  const float stdv = sqrtf(sigma2) * sqrtf(delta);
  const float coef = sigma2 / (2.0f * t);
  const float log_std = logf(stdv);
  const long long start = (long long)blk * chunk;
  const long long end = min(start + chunk, feat);
  const long long row = (long long)b * feat;
  constexpr int N = VEC ? Vec<T>::N : 1;
  float acc = 0.f;
  for (long long i = start + (long long)threadIdx.x * N; i < end;
       i += (long long)kThreads * N) {
    float vv[N], xx[N], e[N], xn[N];
    if constexpr (VEC) {
      Vec<T>::load(v + row + i, vv);
      Vec<T>::load(x + row + i, xx);
      Vec<T>::load(eps + row + i, e);
    } else {
      vv[0] = to_f32(v[row + i]);
      xx[0] = to_f32(x[row + i]);
      e[0] = to_f32(eps[row + i]);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float drift = vv[j] + coef * (xx[j] + (1.0f - t) * vv[j]);
      const float mean = xx[j] - drift * delta;
      xn[j] = mean + stdv * e[j];
      acc += -0.5f * (e[j] * e[j] + kLog2Pi) - log_std;
    }
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < N; j += 4)
        *reinterpret_cast<float4*>(x_next + row + i + j) =
            make_float4(xn[j], xn[j + 1], xn[j + 2], xn[j + 3]);
    } else {
      x_next[row + i] = xn[0];
    }
  }
  const float s = block_sum(acc, warp_part);
  if (threadIdx.x == 0) partials[(long long)b * nblk + blk] = s;
}

__global__ void __launch_bounds__(kThreads)
sde_logp_rows(const float* __restrict__ partials, float* __restrict__ logp,
              int nblk) {
  __shared__ float warp_part[kThreads / 32];
  const int b = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nblk; i += kThreads) acc += partials[(long long)b * nblk + i];
  const float s = block_sum(acc, warp_part);
  if (threadIdx.x == 0) logp[b] = s;
}

template <typename T>
int launch(const void* v, const void* x, const void* eps, float* x_next,
           float* partials, float* logp, int B, long long feat, int nblk,
           float t, float t_next, float eta, cudaStream_t stream) {
  const long long chunk = (feat + nblk - 1) / nblk;
  dim3 grid(nblk, B);
  // 16-byte vectors need aligned rows and chunks that are whole vectors
  bool vec = feat % Vec<T>::N == 0 && chunk % Vec<T>::N == 0;
  for (const void* p : {v, x, eps, static_cast<const void*>(x_next)})
    vec = vec && reinterpret_cast<unsigned long long>(p) % 16 == 0;
  if (vec)
    sde_step_chunks<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<const T*>(x),
        static_cast<const T*>(eps), x_next, partials, feat, chunk, nblk, t,
        t_next, eta);
  else
    sde_step_chunks<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<const T*>(x),
        static_cast<const T*>(eps), x_next, partials, feat, chunk, nblk, t,
        t_next, eta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sde_logp_rows<<<B, kThreads, 0, stream>>>(partials, logp, nblk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (v, x and eps share it).  partials holds
// B * nblk floats of scratch.  Returns cudaGetLastError() after the launches.
extern "C" int sde_step_fwd(const void* v, const void* x, const void* eps,
                            void* x_next, void* partials, void* logp,
                            int dtype, int B, long long feat, int nblk,
                            float t, float t_next, float eta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xn = static_cast<float*>(x_next);
  float* part = static_cast<float*>(partials);
  float* lp = static_cast<float*>(logp);
  if (dtype == 0)
    return launch<float>(v, x, eps, xn, part, lp, B, feat, nblk, t, t_next, eta, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(v, x, eps, xn, part, lp, B, feat, nblk, t, t_next, eta, s);
  return (int)cudaErrorInvalidValue;
}
