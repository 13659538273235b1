// Fused FAIR-k server pass (Eq. 8 merge, Eq. 10 age update, Eq. 11
// two-stage selection) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/fairk_update.py:_fairk_kernel (the Pallas TPU
// kernel behind fairk_update_pallas / fairk_ef_update_pallas /
// fairk_stats_update_pallas).
//
// Bound on this card: device-memory bytes.  Per coordinate the pass reads
// g, g_prev, age (+ fresh, + residual) and writes g_t, age' (+ residual'):
// 20-32 bytes for a handful of compares and multiplies, far below the
// card's ~20 flop/byte balance point for f32.  The design therefore does
// one grid-stride pass with coalesced loads and keeps every intermediate
// (score, masks, jitter, sent) in registers.  The statistics row of the
// TPU kernel (counts + strided log2-magnitude / age histograms) is
// accumulated in shared-memory int atomics per block and flushed with one
// global atomicAdd per non-empty bin, so the counts are exact integers
// whatever order the blocks run in (the TPU kernel instead wrote one row
// per sequential grid step and summed the rows afterwards).
//
// The TPU wrapper padded the buffer to 256-lane blocks with PAD_AGE; here
// the grid-stride loop masks its own ragged tail, so no padding exists.
//
// Numerics: built without fast math and with FMA contraction off, so every
// elementwise result equals the plain PyTorch version bit for bit and the
// histogram bins (log2f) agree exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kMagBins = 128;
constexpr int kAgeBins = 128;
// stats accumulator layout (int32): [n_sel, n_sel_m, mag(128), age(128)]
constexpr int kMagOff = 2;
constexpr int kAgeOff = kMagOff + kMagBins;
constexpr float kAgeCap = 120.0f;
constexpr float kMagBinsPerOct = 4.0f;
constexpr float kMagLoOct = -24.0f;

// Knuth multiplicative hash of the global coordinate index -> [0, 1):
// uint32 multiply with wrap-around, low 24 bits, times 2^-24.
__device__ __forceinline__ float knuth_jitter(long long i) {
  const uint32_t h = static_cast<uint32_t>(i) * 2654435761u;
  return static_cast<float>(h & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

template <bool HAS_RES, bool HAS_FRESH, bool EMIT_STATS, bool SANITIZE>
__global__ void __launch_bounds__(kThreads)
fairk_kernel(const float* __restrict__ g, const float* __restrict__ fresh,
             const float* __restrict__ g_prev, const float* __restrict__ age,
             const float* __restrict__ res,
             const float* __restrict__ thetas, float* __restrict__ g_t,
             float* __restrict__ age_out, float* __restrict__ res_out,
             int* __restrict__ stats, long long d, int stride) {
  __shared__ int s_mag[kMagBins];
  __shared__ int s_age[kAgeBins];
  __shared__ int s_cnt[2];
  if (EMIT_STATS) {
    for (int b = threadIdx.x; b < kMagBins; b += blockDim.x) {
      s_mag[b] = 0;
      s_age[b] = 0;
    }
    if (threadIdx.x < 2) s_cnt[threadIdx.x] = 0;
    __syncthreads();
  }
  const float theta_m = thetas[0];
  const float theta_a = thetas[1];
  const long long sample_mask = static_cast<long long>(stride) - 1;
  int n_sel = 0;
  int n_sel_m = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < d; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float a = age[i];
    float score = g[i];
    float r = 0.0f;
    if (HAS_RES) {
      r = res[i];
      score = score + r;
    }
    const bool valid = a >= 0.0f;  // age < 0 marks packing pads
    bool ok = valid;
    if (SANITIZE) {
      // a non-finite score leaves both stages and is zeroed before the
      // merge, so 0 * NaN cannot reach the unselected coordinates
      const bool fin = isfinite(score);
      ok = valid && fin;
      if (!fin) score = 0.0f;
    }
    const bool mask_m = ok && (fabsf(score) >= theta_m);
    const bool mask = mask_m || (ok && (a + knuth_jitter(i) >= theta_a));
    const float maskf = mask ? 1.0f : 0.0f;
    const float keep = 1.0f - maskf;
    float sent = score;
    if (HAS_FRESH) {
      sent = fresh[i];
      if (SANITIZE && !isfinite(sent)) sent = 0.0f;
    }
    // the arithmetic form of the reference (not a select): a NaN on either
    // side propagates exactly as it does there
    g_t[i] = maskf * sent + keep * g_prev[i];
    const float an = valid ? fminf((a + 1.0f) * keep, kAgeCap) : a;
    age_out[i] = an;
    if (HAS_RES) {
      // bad coordinates keep their old residual
      res_out[i] = ok ? (score - maskf * sent) : r;
    }
    if (EMIT_STATS) {
      n_sel += mask ? 1 : 0;
      n_sel_m += mask_m ? 1 : 0;
      if (ok && (i & sample_mask) == 0) {
        const float raw = floorf(kMagBinsPerOct * log2f(fabsf(score)) -
                                 kMagBinsPerOct * kMagLoOct);
        if (raw == raw) {  // a NaN magnitude falls in no bin
          const int mb = static_cast<int>(
              fminf(fmaxf(raw, 0.0f), static_cast<float>(kMagBins - 1)));
          atomicAdd(&s_mag[mb], 1);
        }
        const int ab = static_cast<int>(fminf(
            fmaxf(floorf(an), 0.0f), static_cast<float>(kAgeBins - 1)));
        atomicAdd(&s_age[ab], 1);
      }
    }
  }
  if (EMIT_STATS) {
    for (int off = 16; off > 0; off >>= 1) {
      n_sel += __shfl_down_sync(0xffffffffu, n_sel, off);
      n_sel_m += __shfl_down_sync(0xffffffffu, n_sel_m, off);
    }
    if ((threadIdx.x & 31) == 0) {
      if (n_sel) atomicAdd(&s_cnt[0], n_sel);
      if (n_sel_m) atomicAdd(&s_cnt[1], n_sel_m);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < kMagBins; b += blockDim.x) {
      if (s_mag[b]) atomicAdd(&stats[kMagOff + b], s_mag[b]);
      if (s_age[b]) atomicAdd(&stats[kAgeOff + b], s_age[b]);
    }
    if (threadIdx.x == 0) {
      if (s_cnt[0]) atomicAdd(&stats[0], s_cnt[0]);
      if (s_cnt[1]) atomicAdd(&stats[1], s_cnt[1]);
    }
  }
}

template <int V>
void launch_variant(unsigned blocks, cudaStream_t stream, const float* g,
                    const float* fresh, const float* g_prev, const float* age,
                    const float* res, const float* thetas, float* g_t,
                    float* age_out, float* res_out, int* stats, long long d,
                    int stride) {
  fairk_kernel<(V & 1) != 0, (V & 2) != 0, (V & 4) != 0, (V & 8) != 0>
      <<<blocks, kThreads, 0, stream>>>(g, fresh, g_prev, age, res, thetas,
                                        g_t, age_out, res_out, stats, d,
                                        stride);
}

}  // namespace

// C interface (loaded with ctypes).  ``fresh``, ``res``/``res_out`` and
// ``stats`` may be null; ``stats`` (int32, 258) must be zeroed by the
// caller and is required when ``stride`` > 0 (a power of two).  Launches on
// ``stream`` without synchronising and returns cudaGetLastError().
extern "C" int repro_fairk_update(const float* g, const float* fresh,
                                  const float* g_prev, const float* age,
                                  const float* res, const float* thetas,
                                  float* g_t, float* age_out, float* res_out,
                                  int* stats, long long d, int stride,
                                  int sanitize, void* stream) {
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  const int v = (res != nullptr ? 1 : 0) | (fresh != nullptr ? 2 : 0) |
                (stride > 0 ? 4 : 0) | (sanitize ? 8 : 0);
  long long blocks = (d + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int st = stride > 0 ? stride : 1;
#define REPRO_FAIRK_CASE(V)                                                \
  case V:                                                                  \
    launch_variant<V>(grid, s, g, fresh, g_prev, age, res, thetas, g_t,    \
                      age_out, res_out, stats, d, st);                     \
    break;
  switch (v) {
    REPRO_FAIRK_CASE(0) REPRO_FAIRK_CASE(1) REPRO_FAIRK_CASE(2)
    REPRO_FAIRK_CASE(3) REPRO_FAIRK_CASE(4) REPRO_FAIRK_CASE(5)
    REPRO_FAIRK_CASE(6) REPRO_FAIRK_CASE(7) REPRO_FAIRK_CASE(8)
    REPRO_FAIRK_CASE(9) REPRO_FAIRK_CASE(10) REPRO_FAIRK_CASE(11)
    REPRO_FAIRK_CASE(12) REPRO_FAIRK_CASE(13) REPRO_FAIRK_CASE(14)
    REPRO_FAIRK_CASE(15)
  }
#undef REPRO_FAIRK_CASE
  return static_cast<int>(cudaGetLastError());
}
