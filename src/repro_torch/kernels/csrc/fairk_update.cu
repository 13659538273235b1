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
// one grid-stride pass, with 16-byte loads and stores where every operand
// is 16-byte aligned (a scalar tail covers d % 4), over a grid sized to the
// card: the kernel's occupancy times the SM count, fewer where d is small.
// Every intermediate (score, masks, jitter, sent) stays in registers.
//
// The statistics row of the TPU kernel (counts + strided log2-magnitude /
// age histograms) is the one call's only other output, so the kernel makes
// it whole, as float32, and the call is one device operation: each block
// counts in shared-memory int atomics and adds its non-empty bins into a
// per-slot int32 accumulator in device memory; a ticket counts the blocks
// that are done, and the last one converts the accumulator to floats
// (round to nearest, as a cast of the counts), writes the row and resets
// the accumulator and the ticket to 0 for the next call.  Counts are exact
// integers whatever order the blocks run in (the TPU kernel instead wrote
// one row per sequential grid step and summed the rows afterwards).  The
// accumulators and tickets are static device arrays, zero when the module
// loads, one slot per (device, stream): the cost of the scheme is that two
// calls may not share a slot at the same time, so the wrapper gives each
// stream its own slot and calls on one stream run in order.  The thresholds
// are read through two pointers to 0-dim device tensors.
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
constexpr int kMagBins = 128;
constexpr int kAgeBins = 128;
// stats row layout: [n_sel, n_sel_m, mag(128), age(128)]
constexpr int kMagOff = 2;
constexpr int kAgeOff = kMagOff + kMagBins;
constexpr int kStatsSize = kAgeOff + kAgeBins;
constexpr int kSlots = 64;
constexpr int kMaxDevices = 64;
constexpr float kAgeCap = 120.0f;
constexpr float kMagBinsPerOct = 4.0f;
constexpr float kMagLoOct = -24.0f;

__device__ int g_acc[kSlots][kStatsSize];
__device__ unsigned int g_ticket[kSlots];

// Knuth multiplicative hash of the global coordinate index -> [0, 1):
// uint32 multiply with wrap-around, low 24 bits, times 2^-24.
__device__ __forceinline__ float knuth_jitter(long long i) {
  const uint32_t h = static_cast<uint32_t>(i) * 2654435761u;
  return static_cast<float>(h & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

struct Theta {
  float m, a;
};

// one coordinate: the pass's arithmetic, in the reference's order
template <bool HAS_RES, bool HAS_FRESH, bool EMIT_STATS, bool SANITIZE>
__device__ __forceinline__ void fairk_one(
    long long i, float gi, float gp, float a, float r, float fr, Theta th,
    long long sample_mask, float* gt, float* an_out, float* r_out,
    int* n_sel, int* n_sel_m, int* s_mag, int* s_age) {
  float score = gi;
  if (HAS_RES) score = score + r;
  const bool valid = a >= 0.0f;  // age < 0 marks packing pads
  bool ok = valid;
  if (SANITIZE) {
    // a non-finite score leaves both stages and is zeroed before the
    // merge, so 0 * NaN cannot reach the unselected coordinates
    const bool fin = isfinite(score);
    ok = valid && fin;
    if (!fin) score = 0.0f;
  }
  const bool mask_m = ok && (fabsf(score) >= th.m);
  const bool mask = mask_m || (ok && (a + knuth_jitter(i) >= th.a));
  const float maskf = mask ? 1.0f : 0.0f;
  const float keep = 1.0f - maskf;
  float sent = score;
  if (HAS_FRESH) {
    sent = fr;
    if (SANITIZE && !isfinite(sent)) sent = 0.0f;
  }
  // the arithmetic form of the reference (not a select): a NaN on either
  // side propagates exactly as it does there
  *gt = maskf * sent + keep * gp;
  const float an = valid ? fminf((a + 1.0f) * keep, kAgeCap) : a;
  *an_out = an;
  if (HAS_RES) {
    // bad coordinates keep their old residual
    *r_out = ok ? (score - maskf * sent) : r;
  }
  if (EMIT_STATS) {
    *n_sel += mask ? 1 : 0;
    *n_sel_m += mask_m ? 1 : 0;
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

template <bool HAS_RES, bool HAS_FRESH, bool EMIT_STATS, bool SANITIZE,
          bool VEC>
__global__ void __launch_bounds__(kThreads)
fairk_kernel(const float* __restrict__ g, const float* __restrict__ fresh,
             const float* __restrict__ g_prev, const float* __restrict__ age,
             const float* __restrict__ res,
             const float* __restrict__ theta_m,
             const float* __restrict__ theta_a, float* __restrict__ g_t,
             float* __restrict__ age_out, float* __restrict__ res_out,
             float* __restrict__ stats, int slot, long long d, int stride) {
  __shared__ int s_mag[kMagBins];
  __shared__ int s_age[kAgeBins];
  __shared__ int s_cnt[2];
  __shared__ bool s_last;
  if (EMIT_STATS) {
    for (int b = threadIdx.x; b < kMagBins; b += blockDim.x) {
      s_mag[b] = 0;
      s_age[b] = 0;
    }
    if (threadIdx.x < 2) s_cnt[threadIdx.x] = 0;
    __syncthreads();
  }
  const Theta th{*theta_m, *theta_a};
  const long long sample_mask = static_cast<long long>(stride) - 1;
  int n_sel = 0;
  int n_sel_m = 0;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  long long tail = 0;  // where the scalar loop starts
  if (VEC) {
    const long long n4 = d >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* gp4 = reinterpret_cast<const float4*>(g_prev);
    const float4* a4 = reinterpret_cast<const float4*>(age);
    const float4* r4 = reinterpret_cast<const float4*>(res);
    const float4* f4 = reinterpret_cast<const float4*>(fresh);
    for (long long v = tid; v < n4; v += nthreads) {
      const float4 gv = g4[v];
      const float4 gpv = gp4[v];
      const float4 av = a4[v];
      const float4 rv = HAS_RES ? r4[v] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 fv = HAS_FRESH ? f4[v] : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 go, ao, ro;
      const long long i = v << 2;
      fairk_one<HAS_RES, HAS_FRESH, EMIT_STATS, SANITIZE>(
          i, gv.x, gpv.x, av.x, rv.x, fv.x, th, sample_mask, &go.x, &ao.x,
          &ro.x, &n_sel, &n_sel_m, s_mag, s_age);
      fairk_one<HAS_RES, HAS_FRESH, EMIT_STATS, SANITIZE>(
          i + 1, gv.y, gpv.y, av.y, rv.y, fv.y, th, sample_mask, &go.y,
          &ao.y, &ro.y, &n_sel, &n_sel_m, s_mag, s_age);
      fairk_one<HAS_RES, HAS_FRESH, EMIT_STATS, SANITIZE>(
          i + 2, gv.z, gpv.z, av.z, rv.z, fv.z, th, sample_mask, &go.z,
          &ao.z, &ro.z, &n_sel, &n_sel_m, s_mag, s_age);
      fairk_one<HAS_RES, HAS_FRESH, EMIT_STATS, SANITIZE>(
          i + 3, gv.w, gpv.w, av.w, rv.w, fv.w, th, sample_mask, &go.w,
          &ao.w, &ro.w, &n_sel, &n_sel_m, s_mag, s_age);
      reinterpret_cast<float4*>(g_t)[v] = go;
      reinterpret_cast<float4*>(age_out)[v] = ao;
      if (HAS_RES) reinterpret_cast<float4*>(res_out)[v] = ro;
    }
    tail = n4 << 2;
  }
  for (long long i = tail + tid; i < d; i += nthreads) {
    float ro = 0.0f;
    fairk_one<HAS_RES, HAS_FRESH, EMIT_STATS, SANITIZE>(
        i, g[i], g_prev[i], age[i], HAS_RES ? res[i] : 0.0f,
        HAS_FRESH ? fresh[i] : 0.0f, th, sample_mask, &g_t[i], &age_out[i],
        &ro, &n_sel, &n_sel_m, s_mag, s_age);
    if (HAS_RES) res_out[i] = ro;
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
    int* acc = g_acc[slot];
    for (int b = threadIdx.x; b < kMagBins; b += blockDim.x) {
      if (s_mag[b]) atomicAdd(&acc[kMagOff + b], s_mag[b]);
      if (s_age[b]) atomicAdd(&acc[kAgeOff + b], s_age[b]);
    }
    if (threadIdx.x == 0) {
      if (s_cnt[0]) atomicAdd(&acc[0], s_cnt[0]);
      if (s_cnt[1]) atomicAdd(&acc[1], s_cnt[1]);
    }
    // this block's additions are visible before its ticket is
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_last = atomicAdd(&g_ticket[slot], 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (int b = threadIdx.x; b < kStatsSize; b += blockDim.x) {
        stats[b] = static_cast<float>(atomicExch(&acc[b], 0));
      }
      if (threadIdx.x == 0) atomicExch(&g_ticket[slot], 0u);
    }
  }
}

// blocks of one variant that fill the card: resident blocks per SM (from
// the occupancy calculator, asked once per variant) times the SM count
// (asked once per device)
template <typename K>
long long card_blocks(K kernel, int* cached_occ) {
  static int sm_count[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) dev = kMaxDevices - 1;
  if (sm_count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sm_count[dev] = n > 0 ? n : 1;
  }
  if (*cached_occ == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    *cached_occ = n > 0 ? n : 1;
  }
  return static_cast<long long>(*cached_occ) * sm_count[dev];
}

template <int V>
void launch_variant(cudaStream_t stream, const float* g, const float* fresh,
                    const float* g_prev, const float* age, const float* res,
                    const float* theta_m, const float* theta_a, float* g_t,
                    float* age_out, float* res_out, float* stats, int slot,
                    long long d, int stride) {
  constexpr bool kVec = (V & 16) != 0;
  auto kernel = fairk_kernel<(V & 1) != 0, (V & 2) != 0, (V & 4) != 0,
                             (V & 8) != 0, kVec>;
  static int occ = 0;
  const long long per_block = kThreads * (kVec ? 4 : 1);
  long long blocks = (d + per_block - 1) / per_block;
  const long long full = card_blocks(kernel, &occ);
  if (blocks > full) blocks = full;
  if (blocks < 1) blocks = 1;  // d == 0 still writes the stats row
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      g, fresh, g_prev, age, res, theta_m, theta_a, g_t, age_out, res_out,
      stats, slot, d, stride);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface (loaded with ctypes).  ``fresh``, ``res``/``res_out`` and
// ``stats`` may be null; ``stats`` (float32, 258) is required when
// ``stride`` > 0 (a power of two) and is written whole.  ``theta_m`` and
// ``theta_a`` point to one float each on the device.  ``slot`` (0 <= slot <
// 64) names the statistics accumulator: no two calls that run at the same
// time may share one.  Launches on ``stream`` without synchronising and
// returns cudaGetLastError().
extern "C" int repro_fairk_update(const float* g, const float* fresh,
                                  const float* g_prev, const float* age,
                                  const float* res, const float* theta_m,
                                  const float* theta_a, float* g_t,
                                  float* age_out, float* res_out,
                                  float* stats, long long d, int stride,
                                  int slot, int sanitize, void* stream) {
  if (stride > 0 && (slot < 0 || slot >= kSlots || stats == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 0 && stride <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = aligned16(g) && aligned16(g_prev) && aligned16(age) &&
                   aligned16(g_t) && aligned16(age_out) &&
                   (fresh == nullptr || aligned16(fresh)) &&
                   (res == nullptr || (aligned16(res) && aligned16(res_out)));
  const int v = (res != nullptr ? 1 : 0) | (fresh != nullptr ? 2 : 0) |
                (stride > 0 ? 4 : 0) | (sanitize ? 8 : 0) | (vec ? 16 : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int st = stride > 0 ? stride : 1;
#define REPRO_FAIRK_CASE(V)                                                \
  case V:                                                                  \
    launch_variant<V>(s, g, fresh, g_prev, age, res, theta_m, theta_a,     \
                      g_t, age_out, res_out, stats, slot, d, st);          \
    break;
#define REPRO_FAIRK_CASES8(B)                                              \
  REPRO_FAIRK_CASE(B + 0) REPRO_FAIRK_CASE(B + 1) REPRO_FAIRK_CASE(B + 2)  \
  REPRO_FAIRK_CASE(B + 3) REPRO_FAIRK_CASE(B + 4) REPRO_FAIRK_CASE(B + 5)  \
  REPRO_FAIRK_CASE(B + 6) REPRO_FAIRK_CASE(B + 7)
  switch (v) {
    REPRO_FAIRK_CASES8(0) REPRO_FAIRK_CASES8(8) REPRO_FAIRK_CASES8(16)
    REPRO_FAIRK_CASES8(24)
  }
#undef REPRO_FAIRK_CASES8
#undef REPRO_FAIRK_CASE
  return static_cast<int>(cudaGetLastError());
}
