// Fused Eq. (8) merge + Eq. (10) Age-of-Update step for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/aou_merge.py:_aou_merge_kernel (the Pallas TPU
// kernel behind aou_merge_pallas), the mask-form server update of the exact
// selection engine (engine.masked_merge).
//
//   g    = m * g_new + (1 - m) * g_old
//   age' = min((age + 1) * (1 - m), AGE_CAP)
//
// Bound on this card: device-memory bytes.  Four (d,) float32 inputs are
// read once and two outputs written once (24 bytes per coordinate) for five
// flops, far below the card's f32 balance point.  One coalesced grid-stride
// pass with every intermediate in registers; the loop masks its own ragged
// tail, so any d works (the TPU wrapper needed d to be a multiple of its
// 65,536-lane block).
//
// The AGE_CAP clip is the one the JAX oracle (kernels/ref.py) and the engine
// (core/engine.py:masked_merge) apply; the TPU kernel itself leaves it out.
//
// Numerics: built without fast math and with FMA contraction off, so every
// result equals the plain PyTorch version bit for bit.  The merge keeps the
// arithmetic form (not a select), so NaN and signed zeros come out as there;
// the clip is written so that a NaN age propagates (fminf would drop it, as
// torch.clamp and jnp.minimum do not).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr float kAgeCap = 120.0f;

__global__ void __launch_bounds__(kThreads)
aou_merge_kernel(const float* __restrict__ g_new,
                 const float* __restrict__ g_old,
                 const float* __restrict__ age,
                 const float* __restrict__ mask, float* __restrict__ g_out,
                 float* __restrict__ age_out, long long d) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < d; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float m = mask[i];
    const float keep = 1.0f - m;
    g_out[i] = m * g_new[i] + keep * g_old[i];
    const float a = (age[i] + 1.0f) * keep;
    // NaN > cap is false, so a NaN age passes through
    age_out[i] = (a > kAgeCap) ? kAgeCap : a;
  }
}

}  // namespace

// C interface (loaded with ctypes).  Launches on ``stream`` without
// synchronising and returns cudaGetLastError().
extern "C" int repro_aou_merge(const float* g_new, const float* g_old,
                               const float* age, const float* mask,
                               float* g_out, float* age_out, long long d,
                               void* stream) {
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (d + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  aou_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      g_new, g_old, age, mask, g_out, age_out, d);
  return static_cast<int>(cudaGetLastError());
}
