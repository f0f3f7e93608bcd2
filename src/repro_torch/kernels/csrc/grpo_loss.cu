// Fused GRPO (PPO-clip) loss per transition, forward and closed-form backward.
//
// Replaces the TPU kernel src/repro/kernels/grpo_loss.py:grpo_loss (body
// _grpo_kernel) and the backward of grpo_loss_diff (_gld_bwd, which the
// reference writes in jnp):
//   ratio = exp(clip(lpn - lpo, -20, 20)) [/ max(ratio_mean, 1e-6) under guard]
//   loss  = -min(ratio A, clip(ratio, 1-c, 1+c) A)
//   frac  = |ratio - 1| > c
//   d_lpn = -A ratio [unclipped is the min, or ratio in the band] g
//   d_lpo = -d_lpn,  d_adv = -(unclipped is the min ? ratio : clip(ratio)) g
//
// Bound on the H100: bytes, and at the training path's batch (B = P G = 4)
// a few dozen of them, so the launch itself is the floor.
//
// Design.  The TPU kernel ran 1024-row blocks over a padded copy of the
// inputs.  Here one thread owns one row, blocks of 256 threads cover any B,
// and the ragged tail is masked in the kernel instead of padded on the host.
// ratio_mean arrives as a device pointer (a batch statistic the caller keeps
// on the device); a null pointer means no Guard division.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float ratio_of(float lpn, float lpo) {
  return expf(fminf(fmaxf(lpn - lpo, -20.f), 20.f));
}

__global__ void __launch_bounds__(kThreads)
grpo_fwd(const float* __restrict__ lpn, const float* __restrict__ lpo,
         const float* __restrict__ adv, const float* __restrict__ ratio_mean,
         float* __restrict__ loss, float* __restrict__ frac, int B,
         float clip, float lo, float hi, int guard) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  float ratio = ratio_of(lpn[i], lpo[i]);
  if (guard) ratio = ratio / fmaxf(ratio_mean ? ratio_mean[0] : 1.f, 1e-6f);
  const float a = adv[i];
  const float unclipped = ratio * a;
  const float clipped = fminf(fmaxf(ratio, lo), hi) * a;
  loss[i] = -fminf(unclipped, clipped);
  frac[i] = fabsf(ratio - 1.f) > clip ? 1.f : 0.f;
}

__global__ void __launch_bounds__(kThreads)
grpo_bwd(const float* __restrict__ lpn, const float* __restrict__ lpo,
         const float* __restrict__ adv, const float* __restrict__ g,
         float* __restrict__ d_lpn, float* __restrict__ d_lpo,
         float* __restrict__ d_adv, int B, float clip, float lo, float hi) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const float ratio = ratio_of(lpn[i], lpo[i]);
  const float a = adv[i];
  const float rc = fminf(fmaxf(ratio, lo), hi);
  const bool unclipped_min = ratio * a <= rc * a;
  const bool active = unclipped_min || fabsf(ratio - 1.f) <= clip;
  const float gi = g[i];
  const float dn = -a * ratio * (active ? 1.f : 0.f) * gi;
  d_lpn[i] = dn;
  d_lpo[i] = -dn;
  d_adv[i] = -(unclipped_min ? ratio : rc) * gi;
}

int blocks(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

// All arrays are (B,) float32 on the device; ratio_mean is a (1,) float32
// device pointer or null.  lo and hi are 1 - clip and 1 + clip rounded once
// to float32 on the host, as the reference rounds them.  Returns
// cudaGetLastError() after the launch.
extern "C" int grpo_loss_fwd(const void* lpn, const void* lpo,
                             const void* adv, const void* ratio_mean,
                             void* loss, void* frac, int B, float clip,
                             float lo, float hi, int guard, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  grpo_fwd<<<blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpn), static_cast<const float*>(lpo),
      static_cast<const float*>(adv), static_cast<const float*>(ratio_mean),
      static_cast<float*>(loss), static_cast<float*>(frac), B, clip, lo, hi,
      guard);
  return (int)cudaGetLastError();
}

extern "C" int grpo_loss_bwd(const void* lpn, const void* lpo,
                             const void* adv, const void* g, void* d_lpn,
                             void* d_lpo, void* d_adv, int B, float clip,
                             float lo, float hi, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  grpo_bwd<<<blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lpn), static_cast<const float*>(lpo),
      static_cast<const float*>(adv), static_cast<const float*>(g),
      static_cast<float*>(d_lpn), static_cast<float*>(d_lpo),
      static_cast<float*>(d_adv), B, clip, lo, hi);
  return (int)cudaGetLastError();
}
