// FSK majority vote (paper Sec. V-B, the one-bit uplink) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/sign_mv.py:_sign_mv_kernel and
// _sign_mv_noise_kernel (sign_mv_pallas), and
// src/repro/kernels/sign_mv.py:_sign_from_energy_kernel and
// _sign_from_energy_noise_kernel (sign_from_energy_pallas).
//
// Bound on this card: device-memory bytes.  sign_mv reads the (N, k) vote
// matrix once (4 N k bytes) and writes two (k,) rows; the work is one
// compare and one integer add per vote.  One thread owns one column and
// walks the N rows, so each row read is coalesced across the warp and the
// vote count is an exact integer (the TPU kernel reduced a (N, block_k)
// VMEM tile on the VPU instead).  sign_from_energy is a pure elementwise
// pass over (k,) rows.
//
// Vote semantics: ``v >= 0`` counts +1, so both +0.0 and -0.0 vote +1
// (truncated voters send a signed zero) and NaN votes -1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

template <bool NOISE>
__global__ void __launch_bounds__(kThreads)
sign_mv_kernel(const float* __restrict__ votes,
               const float* __restrict__ noise, float* __restrict__ signs,
               float* __restrict__ energy, int n, long long k) {
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < k; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    int s = 0;
    for (int r = 0; r < n; ++r) {
      s += (votes[static_cast<long long>(r) * k + j] >= 0.0f) ? 1 : -1;
    }
    float e = static_cast<float>(s);
    if (NOISE) e = e + noise[j];
    energy[j] = e;
    signs[j] = (e >= 0.0f) ? 1.0f : -1.0f;
  }
}

template <bool NOISE>
__global__ void __launch_bounds__(kThreads)
sign_from_energy_kernel(const float* __restrict__ energy_in,
                        const float* __restrict__ noise,
                        float* __restrict__ signs,
                        float* __restrict__ energy_out, long long k) {
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < k; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    float e = energy_in[j];
    if (NOISE) e = e + noise[j];
    energy_out[j] = e;
    signs[j] = (e >= 0.0f) ? 1.0f : -1.0f;
  }
}

unsigned grid_for(long long k) {
  long long blocks = (k + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// C interfaces (loaded with ctypes).  ``noise`` may be null (the noiseless
// variant).  Both launch on ``stream`` without synchronising and return
// cudaGetLastError().
extern "C" int repro_sign_mv(const float* votes, const float* noise,
                             float* signs, float* energy, int n, long long k,
                             void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise != nullptr) {
    sign_mv_kernel<true><<<grid_for(k), kThreads, 0, s>>>(votes, noise, signs,
                                                          energy, n, k);
  } else {
    sign_mv_kernel<false><<<grid_for(k), kThreads, 0, s>>>(votes, noise,
                                                           signs, energy, n,
                                                           k);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_sign_from_energy(const float* energy_in,
                                      const float* noise, float* signs,
                                      float* energy_out, long long k,
                                      void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise != nullptr) {
    sign_from_energy_kernel<true><<<grid_for(k), kThreads, 0, s>>>(
        energy_in, noise, signs, energy_out, k);
  } else {
    sign_from_energy_kernel<false><<<grid_for(k), kThreads, 0, s>>>(
        energy_in, noise, signs, energy_out, k);
  }
  return static_cast<int>(cudaGetLastError());
}
