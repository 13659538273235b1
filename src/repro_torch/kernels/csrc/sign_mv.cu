// FSK majority vote (paper Sec. V-B, the one-bit uplink) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/sign_mv.py:_sign_mv_kernel and
// _sign_mv_noise_kernel (sign_mv_pallas), and
// src/repro/kernels/sign_mv.py:_sign_from_energy_kernel and
// _sign_from_energy_noise_kernel (sign_from_energy_pallas).
//
// Three entry points, two kernels:
//
// * repro_sign_mv: the TPU function, (N, k) votes (+ (k,) noise) ->
//   (signs, energy).
// * repro_vote_fold: the trainer's one-bit chunk fold, in place and with no
//   signs row: acc[j] += sum_r (x[r, idx[j]] >= 0 ? +1 : -1), where x is
//   the chunk's (C, d) effective gradients with rows ``ld`` floats apart
//   and a null idx means idx[j] = j.  It takes in the quantizer, the
//   gather and the add that the call site ran as operations of their own.
//   With a (C,) float row (the wireless route's per-client weight
//   sent_r * csi_r), a vote is ((x >= 0 ? 1 : -1) * row[r] >= 0) ? +1 : -1:
//   the reference multiplies the one-bit votes by the row and re-signs, so
//   a zero weight (either sign) votes +1, a negative one flips the vote and
//   a NaN weight votes -1.  One launch either way.
// * repro_sign_from_energy: the detection.  s = e, or e + noise, or
//   e + (noise_std * z) with the product rounded before the add (as
//   ``noise_std * z`` then ``e + noise`` round in PyTorch); writes
//   signs and s and, optionally, the packed path's selection score
//   |s| + jitter(j), so the detection is one device operation.
//
// Bound on this card: device-memory bytes.  The vote kernel reads each
// vote once (4 N k bytes, plus the (k,) accumulator or outputs) for one
// compare and one integer add per vote; the detection is elementwise.
// At the paths' sizes (a 10-row chunk of 109,210 or 21,842 columns) the
// time is a launch and a few memory latencies, not bandwidth.  The first
// port gave one column to one thread, which walked the N rows with 4-byte
// loads in a loop whose length is known only at run time; at k = 21,842
// its 86 CTAs left a third of the 132 SMs idle.  The design here:
//
// * A CTA is 256 threads: 64 column threads x 4 row groups, or, for a
//   chunk of at most 16 rows, 128 x 2.  Row group y reduces rows y,
//   y + G, y + 2G, ...; the G int32 partial counts of a column meet in
//   shared memory, and integer sums are exact in any order.  The grid has
//   one CTA per 256 / G columns (twice that on the paired path), so
//   (10 x 21,842) gathered runs 171 CTAs and (10 x 109,210) dense 427,
//   where the first port ran 86 and 427 of one column per thread.  Two
//   groups keep 5 rows of a 10-row chunk in each thread (fewer, fuller
//   CTAs were faster there on the card); four keep more loads in flight
//   at 50 rows.
// * The row loop is unrolled by 8: a thread starts all of its up to 8
//   loads before the first compare, so every row of a column group is in
//   flight at once.
// * On the dense path, where the base is 8-byte aligned and the row
//   stride even (109,210 floats: 8-byte but not 16-byte aligned rows), a
//   thread loads two neighbouring columns as one float2.  Other views and
//   the gather take scalar loads; the gather reads its int64 index once
//   and uses it for every row.
//
// Vote semantics: ``v >= 0`` counts +1, so both +0.0 and -0.0 vote +1
// (truncated voters send a signed zero) and NaN votes -1.  Counts are
// integers below 2^24, so the float32 energies and the folded accumulator
// equal the plain PyTorch sums bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of a CTA (both kernels)
constexpr int kUnroll = 8;     // loads a thread starts before it compares
constexpr int kFewRows = 16;   // up to this many rows: 2 row groups, else 4
constexpr int kMaxBlocks = 132 * 8;

// Knuth multiplicative hash of the global coordinate index -> [0, 1):
// uint32 multiply with wrap-around, low 24 bits, times 2^-24.  The same
// lines as fairk_update.cu's and kernels/ref.py:knuth_jitter.
__device__ __forceinline__ float knuth_jitter(long long i) {
  const uint32_t h = static_cast<uint32_t>(i) * 2654435761u;
  return static_cast<float>(h & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

// W: columns a thread loads at once (2 = float2, dense only).  G: row
// groups (blockDim.y).  GATHER: column j reads x[:, idx[j]].  FOLD:
// out[j] += count (no signs row); otherwise out is the energy row and
// signs[j] = sign(count (+ noise)).  WEIGHT: row r's votes are weighted by
// row[r] before the re-sign (fold only).
template <int W, int G, bool GATHER, bool FOLD, bool NOISE, bool WEIGHT>
__global__ void __launch_bounds__(kThreads)
sign_mv_kernel(const float* __restrict__ x, long long ld,
               const long long* __restrict__ idx, int n, long long k,
               const float* __restrict__ noise, float* __restrict__ out,
               float* __restrict__ signs, const float* __restrict__ row) {
  constexpr int kCols = kThreads / G;
  __shared__ int part[G][kCols * W];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * (kCols * W);
  const long long c0 = base + static_cast<long long>(tx) * W;
  int cnt[W];
#pragma unroll
  for (int w = 0; w < W; ++w) cnt[w] = 0;
  if (c0 < k) {
    const long long col = GATHER ? idx[c0] : c0;
    const bool pair = (W == 2) && (c0 + 1 < k);
    for (int r0 = ty; r0 < n; r0 += G * kUnroll) {
      float v[kUnroll][W];
      float wt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * G;
#pragma unroll
        for (int w = 0; w < W; ++w) v[u][w] = 0.0f;
        wt[u] = 1.0f;
        if (WEIGHT && r < n) wt[u] = __ldg(row + r);
        if (r < n) {
          const float* p = x + static_cast<long long>(r) * ld + col;
          if (W == 2 && pair) {
            const float2 t = *reinterpret_cast<const float2*>(p);
            v[u][0] = t.x;
            v[u][W - 1] = t.y;
          } else {
            v[u][0] = *p;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u * G < n) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if (WEIGHT) {
              const float s = (v[u][w] >= 0.0f) ? 1.0f : -1.0f;
              cnt[w] += (__fmul_rn(s, wt[u]) >= 0.0f) ? 1 : -1;
            } else {
              cnt[w] += (v[u][w] >= 0.0f) ? 1 : -1;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) part[ty][tx * W + w] = cnt[w];
  __syncthreads();
  // the first kCols * W threads each finish one column of the CTA, so the
  // writes of neighbouring threads are neighbouring floats
  const int t = ty * kCols + tx;
  if (t < kCols * W) {
    const long long j = base + t;
    if (j < k) {
      int s = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) s += part[g][t];
      const float e = static_cast<float>(s);
      if (FOLD) {
        out[j] = __fadd_rn(out[j], e);
      } else {
        const float sn = NOISE ? __fadd_rn(e, noise[j]) : e;
        out[j] = sn;
        signs[j] = (sn >= 0.0f) ? 1.0f : -1.0f;
      }
    }
  }
}

// NOISE: 0 none, 1 s = e + noise[j], 2 s = e + (noise_std * z[j]).
template <int NOISE, bool SCORE>
__global__ void __launch_bounds__(kThreads)
sign_from_energy_kernel(const float* __restrict__ energy_in,
                        const float* __restrict__ noise, float noise_std,
                        float* __restrict__ signs,
                        float* __restrict__ energy_out,
                        float* __restrict__ score, long long k) {
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < k; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = energy_in[j];
    if (NOISE == 1) s = __fadd_rn(s, noise[j]);
    if (NOISE == 2) s = __fadd_rn(s, __fmul_rn(noise_std, noise[j]));
    energy_out[j] = s;
    signs[j] = (s >= 0.0f) ? 1.0f : -1.0f;
    if (SCORE) score[j] = __fadd_rn(fabsf(s), knuth_jitter(j));
  }
}

template <int G, bool FOLD, bool NOISE, bool WEIGHT>
void launch_groups(const float* x, long long ld, const long long* idx, int n,
                   long long k, const float* noise, float* out, float* signs,
                   const float* row, cudaStream_t s) {
  constexpr int kCols = kThreads / G;
  const dim3 block(kCols, G);
  const bool paired = idx == nullptr &&
                      reinterpret_cast<uintptr_t>(x) % 8 == 0 && ld % 2 == 0;
  if (paired) {
    const unsigned grid =
        static_cast<unsigned>((k + 2 * kCols - 1) / (2 * kCols));
    sign_mv_kernel<2, G, false, FOLD, NOISE, WEIGHT><<<grid, block, 0, s>>>(
        x, ld, idx, n, k, noise, out, signs, row);
  } else {
    const unsigned grid = static_cast<unsigned>((k + kCols - 1) / kCols);
    if (idx != nullptr) {
      sign_mv_kernel<1, G, true, FOLD, NOISE, WEIGHT><<<grid, block, 0, s>>>(
          x, ld, idx, n, k, noise, out, signs, row);
    } else {
      sign_mv_kernel<1, G, false, FOLD, NOISE, WEIGHT><<<grid, block, 0, s>>>(
          x, ld, idx, n, k, noise, out, signs, row);
    }
  }
}

template <bool FOLD, bool NOISE, bool WEIGHT>
int launch_votes(const float* x, long long ld, const long long* idx, int n,
                 long long k, const float* noise, float* out, float* signs,
                 const float* row, cudaStream_t s) {
  if (n <= kFewRows) {
    launch_groups<2, FOLD, NOISE, WEIGHT>(x, ld, idx, n, k, noise, out,
                                          signs, row, s);
  } else {
    launch_groups<4, FOLD, NOISE, WEIGHT>(x, ld, idx, n, k, noise, out,
                                          signs, row, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NOISE>
void launch_detect(const float* e, const float* nz, float noise_std,
                   float* signs, float* e_out, float* score, long long k,
                   cudaStream_t s) {
  const long long want = (k + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(want > kMaxBlocks ? kMaxBlocks : want);
  if (score != nullptr) {
    sign_from_energy_kernel<NOISE, true><<<grid, kThreads, 0, s>>>(
        e, nz, noise_std, signs, e_out, score, k);
  } else {
    sign_from_energy_kernel<NOISE, false><<<grid, kThreads, 0, s>>>(
        e, nz, noise_std, signs, e_out, score, k);
  }
}

}  // namespace

// C interfaces (loaded with ctypes).  Each launches on ``stream`` without
// synchronising and returns cudaGetLastError().

// (n, k) contiguous votes (+ (k,) noise, may be null) -> signs, energy.
extern "C" int repro_sign_mv(const float* votes, const float* noise,
                             float* signs, float* energy, int n, long long k,
                             void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise != nullptr) {
    return launch_votes<false, true, false>(votes, k, nullptr, n, k, noise,
                                            energy, signs, nullptr, s);
  }
  return launch_votes<false, false, false>(votes, k, nullptr, n, k, nullptr,
                                           energy, signs, nullptr, s);
}

// acc (k,) += the vote counts of the n rows of x (row stride ld floats) at
// the k columns idx (int64, each in [0, d); null: columns 0..k-1), each
// row's votes weighted by row[r] before the re-sign where row is not null.
extern "C" int repro_vote_fold(const float* x, long long ld,
                               const long long* idx, const float* row,
                               float* acc, int n, long long k, void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row != nullptr) {
    return launch_votes<true, false, true>(x, ld, idx, n, k, nullptr, acc,
                                           nullptr, row, s);
  }
  return launch_votes<true, false, false>(x, ld, idx, n, k, nullptr, acc,
                                          nullptr, nullptr, s);
}

// (k,) energy -> signs, energy' and, where score is not null, the score.
// noise (may be null) is added as it is, or, with scaled != 0, as
// noise_std * noise.
extern "C" int repro_sign_from_energy(const float* energy_in,
                                      const float* noise, int scaled,
                                      float noise_std, float* signs,
                                      float* energy_out, float* score,
                                      long long k, void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise == nullptr) {
    launch_detect<0>(energy_in, noise, noise_std, signs, energy_out, score, k,
                     s);
  } else if (scaled == 0) {
    launch_detect<1>(energy_in, noise, noise_std, signs, energy_out, score, k,
                     s);
  } else {
    launch_detect<2>(energy_in, noise, noise_std, signs, energy_out, score, k,
                     s);
  }
  return static_cast<int>(cudaGetLastError());
}
