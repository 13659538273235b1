// Per-block top-m magnitude candidates for Hopper, sm_90a: stage 1 of the
// two-stage top-k (kernels/ops.py:two_stage_topk).
//
// Replaces: src/repro/kernels/block_topk.py:_block_topk_kernel (the Pallas
// TPU kernel behind block_topk_pallas).
//
// For each contiguous block of ``bs`` coordinates: the m largest |x|,
// descending, ties toward the lower index (as jnp.argmax and a stable
// descending sort break them), with their global int32 indices.  NaN ranks
// above +inf, and NaNs among themselves by index, as jnp.max / jnp.argmax
// and torch.sort rank them.
//
// Bound on this card: device-memory bytes, 4 * d read and 8 * nb * m
// written, once no step depends on m in sequence.  The TPU kernel ran m
// rounds of max-and-mask over its VMEM block (the first port kept that
// chain: m block-wide argmax rounds, two barriers each).  Here one CTA
// takes one data block:
//   1. Keys: the bit pattern of fabsf(x) as uint32, whose order is the
//      value order for non-negative floats.  Every NaN becomes the one key
//      0x7fc00000, above +inf (0x7f800000); +0 and -0 both become 0.
//   2. Threshold.  Register filter (blocks of up to 4,096 keys that are a
//      multiple of 1,024, m <= 256): each thread holds its keys in
//      registers and offers its r largest (r = 1..4, by m) to one 2,048-bin
//      histogram of the top 11 key bits; the bin of the m-th largest offer
//      gives a lower bound L with at least m keys >= L.  Otherwise (and
//      where more than 1,024 keys pass L) a radix select over the keys in
//      shared memory: 11/10/10-bit digits (8/8/8/7 where the 8 KB
//      histogram does not fit beside the keys), a histogram of the digit
//      under the prefix found so far and one block scan per pass, stopping
//      once the bin it lands in is taken whole.
//   3. Candidates: the filter takes every key >= L; the radix select
//      every key above its threshold and the first keys equal to it in
//      index order (a warp-ballot rank plus a scan of the warps' counts) --
//      no order that depends on the run.
//   4. Sort: a bitonic sort of packed 64-bit words (key << 32 | ~local
//      index), so ties go to the lower index, padded with zeros to a power
//      of two; in registers up to one word a thread (shuffles inside a
//      warp, shared memory across warps), in shared memory beside the keys
//      above that, or in a scratch row in device memory where the
//      candidates do not fit there (m near the largest blocks).  The first
//      m words give the values (|x| bit for bit) and global indices.
// The block's keys are read once; every step is a fixed number of
// block-wide passes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kNanKey = 0x7fc00000u;
constexpr unsigned kInfKey = 0x7f800000u;
// shared memory a block may use (232,448 bytes on the H100), less room
// for the kernel's static arrays
constexpr int kSmemBytes = 232448 - 1024;
// radix digits over the 31 significant key bits (bit 31 is always 0):
// wide = 11, 10, 10 bits (a 2,048-bin first histogram that splits the
// exponent and three mantissa bits, so one pass usually isolates the
// threshold's neighbourhood); narrow = 8, 8, 8, 7 bits (a 256-bin
// histogram, for blocks whose keys leave no room for the wide one)
constexpr int kWideBins = 2048;
constexpr int kNarrowBins = 256;
// the register filter: float4 groups a thread holds, candidates it keeps
constexpr int kMaxGroups = 4;
constexpr int kFilterCap = kWideBins * 4 / 8;  // the histogram's room
__constant__ int kShift[2][4] = {{23, 15, 7, 0}, {20, 10, 0, -1}};
__constant__ int kWidth[2][4] = {{8, 8, 8, 7}, {11, 10, 10, 0}};

__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned k = __float_as_uint(v) & 0x7fffffffu;
  return k > kInfKey ? kNanKey : k;
}

// exclusive prefix sum of one int per thread over the block (thread order);
// *total gets the block's sum.  Every thread must call it.
__device__ __forceinline__ int block_excl_scan(int v, int* s_warp,
                                               int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int s = s_warp[w];
    if (w < warp) before += s;
    sum += s;
  }
  __syncthreads();  // s_warp is free again
  *total = sum;
  return before + incl - v;
}

// Sort cand[0, cand_n) (a power of two) descending, in place.  Up to one
// word per thread the sort runs in registers, with warp shuffles for
// partners inside a warp and cand only for the stages whose partner lies
// in another warp; above that, every stage goes through cand.
__device__ void bitonic_desc(unsigned long long* cand, int cand_n) {
  const int tid = threadIdx.x;
  if (cand_n <= kThreads) {
    unsigned long long v = tid < cand_n ? cand[tid] : 0ull;
    for (int k = 2; k <= cand_n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        unsigned long long o;
        if (j >= 32) {  // uniform across the block
          __syncthreads();
          if (tid < cand_n) cand[tid] = v;
          __syncthreads();
          o = (tid ^ j) < cand_n ? cand[tid ^ j] : 0ull;
        } else {
          o = __shfl_xor_sync(0xffffffffu, v, j);
        }
        // a descending run keeps the larger word at the lower index
        const bool keep_max = ((tid & k) == 0) == ((tid & j) == 0);
        v = keep_max ? (v > o ? v : o) : (v < o ? v : o);
      }
    }
    __syncthreads();
    if (tid < cand_n) cand[tid] = v;
    __syncthreads();
    return;
  }
  for (int k = 2; k <= cand_n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < (cand_n >> 1); p += kThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int ixj = i | j;
        const unsigned long long a = cand[i];
        const unsigned long long b = cand[ixj];
        const bool desc = (i & k) == 0;
        if (desc ? (a < b) : (a > b)) {
          cand[i] = b;
          cand[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The radix select of one data block: keys[0, bs) already stored (not
// yet synchronised).  Dynamic shared memory holds the keys (bs * 4 bytes,
// rounded up to 16), then one region with the radix histogram during the
// select and, where they fit, the candidates afterwards.
template <bool WIDE>
__device__ __forceinline__ void topk_block(
    const unsigned* keys, int* hist, unsigned long long* cand, float* vals,
    int* idxs, long long blk, int bs, int m, int cand_n, int* s_warp,
    int* s_sel, int* s_cnt) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // radix select of the m-th largest key: the prefix (its top bits found
  // so far, below bit `shift` zero) and `need`, its rank among the keys
  // under the prefix
  unsigned prefix = 0;
  int need = m;
  int shift = 0;
  for (int p = 0; p < 4 && kWidth[WIDE][p] > 0; ++p) {
    const int s = kShift[WIDE][p];
    const int w = kWidth[WIDE][p];
    const int nbins = 1 << w;
    for (int b = tid; b < nbins; b += kThreads) hist[b] = 0;
    __syncthreads();  // the keys are in place, the histogram is zero
    const unsigned hi_mask = 0xffffffffu << (s + w);  // s + w <= 31
    for (int i0 = 0; i0 < bs; i0 += kThreads) {  // uniform across the warp
      const int i = i0 + tid;
      int d = nbins;  // no bin
      if (i < bs) {
        const unsigned k = keys[i];
        if ((k & hi_mask) == prefix) {
          d = static_cast<int>((k >> s) & static_cast<unsigned>(nbins - 1));
        }
      }
      if (WIDE) {
        // 11-bit digits spread the keys: few lanes collide on a bin
        if (d < nbins) atomicAdd(&hist[d], 1);
      } else {
        // 8-bit digits of an exponent-heavy first pass collide often:
        // one atomic per distinct bin in the warp
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (d < nbins && lane == __ffs(peers) - 1) {
          atomicAdd(&hist[d], __popc(peers));
        }
      }
    }
    __syncthreads();
    // thread t owns `per` bins, descending from the top digit
    const int per = nbins > kThreads ? nbins / kThreads : 1;
    const int pos0 = tid * per;
    int mine = 0;
    for (int q = 0; q < per && pos0 + q < nbins; ++q) {
      mine += hist[nbins - 1 - (pos0 + q)];
    }
    int total;
    int above = block_excl_scan(mine, s_warp, &total);
    if (above < need && need <= above + mine) {
      for (int q = 0;; ++q) {
        const int digit = nbins - 1 - (pos0 + q);
        const int c = hist[digit];
        if (need <= above + c) {
          s_sel[0] = digit;
          s_sel[1] = need - above;
          s_sel[2] = c;
          break;
        }
        above += c;
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(s_sel[0]) << s;
    need = s_sel[1];
    shift = s;
    const bool done = s_sel[2] == need;  // the whole bin is taken
    __syncthreads();                     // s_sel and hist are reused
    if (done) break;
  }

  // ordered compaction: keys above the prefix anywhere in [0, c_gt), the
  // first `need` keys under it (index order: each warp a contiguous
  // segment, a ballot rank inside it, the warps' counts scanned) in
  // [c_gt, m)
  const unsigned pk = prefix >> shift;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int c_gt = m - need;
  const int seg = (((bs + kWarps - 1) / kWarps) + 31) & ~31;
  const int lo = min(bs, warp * seg);
  const int hi = min(bs, lo + seg);
  int n_eq = 0;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int i = c0 + lane;
    n_eq += __popc(__ballot_sync(0xffffffffu,
                                 i < hi && (keys[i] >> shift) == pk));
  }
  if (tid == 0) *s_cnt = 0;
  if (lane == 0) s_warp[warp] = n_eq;
  __syncthreads();
  int rank = 0;
  for (int w = 0; w < warp; ++w) rank += s_warp[w];
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int i = c0 + lane;
    unsigned k = 0;
    bool gt = false, eq = false;
    if (i < hi) {
      k = keys[i];
      gt = (k >> shift) > pk;
      eq = (k >> shift) == pk;
    }
    const unsigned eq_bits = __ballot_sync(0xffffffffu, eq);
    int slot = -1;
    if (gt) {
      slot = atomicAdd(s_cnt, 1);
    } else if (eq) {
      const int r = rank + __popc(eq_bits & lt_mask);
      if (r < need) slot = c_gt + r;
    }
    if (slot >= 0) {
      cand[slot] = (static_cast<unsigned long long>(k) << 32) |
                   (0xffffffffu - static_cast<unsigned>(i));
    }
    rank += __popc(eq_bits);
  }
  for (int i = m + tid; i < cand_n; i += kThreads) cand[i] = 0ull;
  __syncthreads();

  // sort the candidates by (key descending, index ascending) and write
  bitonic_desc(cand, cand_n);
  const long long base = blk * bs;
  float* out_v = vals + blk * m;
  int* out_i = idxs + blk * m;
  for (int r = tid; r < m; r += kThreads) {
    const unsigned long long c = cand[r];
    out_v[r] = __uint_as_float(static_cast<unsigned>(c >> 32));
    out_i[r] = static_cast<int>(
        base + (0xffffffffu - static_cast<unsigned>(c & 0xffffffffu)));
  }
}

// The register filter, for blocks of up to kMaxGroups * 4 * kThreads keys
// (4,096) and m <= kThreads.  Each thread holds its keys in registers and
// keeps its `r` largest; the m-th largest of those r * kThreads values is
// at most the block's m-th largest key, so the 11-bit bin it falls in
// gives a lower bound L with at least m keys at or above it.  The keys
// >= L (usually a little more than m) are compacted and sorted; the first
// m are the answer, ties included, since every key equal to the m-th
// largest is >= L.  One histogram of r values a thread replaces the radix
// passes over all keys.  Where more than kFilterCap keys pass (a block of
// near-equal values), the keys go to shared memory and the radix select
// runs instead.  G: the float4 groups a thread holds (bs = 4 * kThreads *
// G); G = 0 loads the keys straight into shared memory for the radix
// select.
template <int G>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                  int* __restrict__ idxs, unsigned long long* scratch, int bs,
                  int m, int cand_n, int keys_bytes, int smem_cand, int wide,
                  int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_sel[3];  // digit, keys still needed, keys in its bin
  __shared__ int s_cnt;
  unsigned* keys = reinterpret_cast<unsigned*>(smem);
  int* hist = reinterpret_cast<int*>(smem + keys_bytes);
  unsigned long long* region =
      reinterpret_cast<unsigned long long*>(smem + keys_bytes);
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const float* xb = x + blk * bs;
  unsigned long long* cand = smem_cand ? region : scratch + blk * cand_n;
  if constexpr (G > 0) {
    const int lane = tid & 31;
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    unsigned kr[4 * G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const float4 f = x4[q * kThreads + tid];
      kr[4 * q] = key_of(f.x);
      kr[4 * q + 1] = key_of(f.y);
      kr[4 * q + 2] = key_of(f.z);
      kr[4 * q + 3] = key_of(f.w);
    }
    // this thread's four largest keys, descending
    unsigned t0 = 0, t1 = 0, t2 = 0, t3 = 0;
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) {
      const unsigned k = kr[j];
      if (k > t3) {
        t3 = k;
        if (t3 > t2) { const unsigned u = t2; t2 = t3; t3 = u; }
        if (t2 > t1) { const unsigned u = t1; t1 = t2; t2 = u; }
        if (t1 > t0) { const unsigned u = t0; t0 = t1; t1 = u; }
      }
    }
    for (int b = tid; b < kWideBins; b += kThreads) hist[b] = 0;
    if (tid == 0) s_cnt = 0;
    __syncthreads();
    atomicAdd(&hist[t0 >> 20], 1);
    if (r > 1) atomicAdd(&hist[t1 >> 20], 1);
    if (r > 2) atomicAdd(&hist[t2 >> 20], 1);
    if (r > 3) atomicAdd(&hist[t3 >> 20], 1);
    __syncthreads();
    // the bin of the m-th largest of the r * kThreads values
    constexpr int per = kWideBins / kThreads;
    const int pos0 = tid * per;
    int mine = 0;
#pragma unroll
    for (int q = 0; q < per; ++q) mine += hist[kWideBins - 1 - (pos0 + q)];
    int total;
    int above = block_excl_scan(mine, s_warp, &total);
    if (above < m && m <= above + mine) {
      for (int q = 0;; ++q) {
        const int digit = kWideBins - 1 - (pos0 + q);
        above += hist[digit];
        if (m <= above) {
          s_sel[0] = digit;
          break;
        }
      }
    }
    __syncthreads();  // the histogram is done with: region holds candidates
    const unsigned lo_key = static_cast<unsigned>(s_sel[0]) << 20;
    const unsigned lt_mask = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) {
      const unsigned k = kr[j];
      const bool take = k >= lo_key;
      const unsigned bits = __ballot_sync(0xffffffffu, take);
      if (bits != 0u) {
        int first = 0;
        if (lane == 0) first = atomicAdd(&s_cnt, __popc(bits));
        first = __shfl_sync(0xffffffffu, first, 0);
        const int slot = first + __popc(bits & lt_mask);
        if (take && slot < kFilterCap) {
          const unsigned i = 4u * ((j >> 2) * kThreads + tid) + (j & 3);
          region[slot] = (static_cast<unsigned long long>(k) << 32) |
                         (0xffffffffu - i);
        }
      }
    }
    __syncthreads();
    const int c = s_cnt;
    if (c <= kFilterCap) {
      int cn = 1;
      while (cn < c) cn <<= 1;
      for (int i = c + tid; i < cn; i += kThreads) region[i] = 0ull;
      __syncthreads();
      bitonic_desc(region, cn);
      const long long base = blk * bs;
      for (int q = tid; q < m; q += kThreads) {
        const unsigned long long w = region[q];
        vals[blk * m + q] = __uint_as_float(static_cast<unsigned>(w >> 32));
        idxs[blk * m + q] = static_cast<int>(
            base + (0xffffffffu - static_cast<unsigned>(w & 0xffffffffu)));
      }
      return;
    }
    uint4* k4 = reinterpret_cast<uint4*>(keys);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      k4[q * kThreads + tid] = make_uint4(kr[4 * q], kr[4 * q + 1],
                                          kr[4 * q + 2], kr[4 * q + 3]);
    }
  } else if ((bs & 3) == 0 && (reinterpret_cast<uintptr_t>(xb) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    uint4* k4 = reinterpret_cast<uint4*>(keys);
    for (int v = tid; v < (bs >> 2); v += kThreads) {
      const float4 f = x4[v];
      k4[v] = make_uint4(key_of(f.x), key_of(f.y), key_of(f.z), key_of(f.w));
    }
  } else {
    for (int i = tid; i < bs; i += kThreads) keys[i] = key_of(xb[i]);
  }
  if (wide) {
    topk_block<true>(keys, hist, cand, vals, idxs, blk, bs, m, cand_n,
                     s_warp, s_sel, &s_cnt);
  } else {
    topk_block<false>(keys, hist, cand, vals, idxs, blk, bs, m, cand_n,
                      s_warp, s_sel, &s_cnt);
  }
}

}  // namespace

// C interface (loaded with ctypes).  x holds nb * bs floats; vals / idxs
// take nb * m entries.  Needs 1 <= m <= bs.  With ``scratch`` null the
// candidates are sorted in shared memory beside the keys (bs * 4, rounded
// up to 16, plus 8 * M bytes, M the power of two >= m); otherwise
// ``scratch`` holds nb * M uint64 words and only the keys are in shared
// memory (the wrapper chooses).  Launches on ``stream`` without
// synchronising and returns cudaGetLastError() (or the error of raising
// the shared-memory limit).
extern "C" int repro_block_topk(const float* x, float* vals, int* idxs,
                                void* scratch, long long nb, int bs, int m,
                                void* stream) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  if (m < 1 || m > bs) return static_cast<int>(cudaErrorInvalidValue);
  int cand_n = 1;
  while (cand_n < m) cand_n <<= 1;
  const int keys_bytes = ((bs * 4) + 15) & ~15;
  const size_t cand_bytes =
      scratch == nullptr ? static_cast<size_t>(cand_n) * 8 : 0;
  const size_t wide = keys_bytes + std::max<size_t>(cand_bytes,
                                                    kWideBins * 4);
  const size_t narrow = keys_bytes + std::max<size_t>(cand_bytes,
                                                      kNarrowBins * 4);
  if (narrow > static_cast<size_t>(kSmemBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool use_wide = wide <= static_cast<size_t>(kSmemBytes);
  const size_t smem = use_wide ? wide : narrow;
  const bool reg = use_wide && scratch == nullptr && m <= kThreads &&
                   bs % (4 * kThreads) == 0 &&
                   bs <= 4 * kThreads * kMaxGroups &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // values a thread offers to the filter's histogram: enough that the
  // m-th largest of them lies close to the block's m-th largest
  const int r = std::min(4, 1 + (4 * m - 1) / kThreads);
  const int groups = reg ? bs / (4 * kThreads) : 0;
  auto kernel = groups == 1   ? block_topk_kernel<1>
                : groups == 2 ? block_topk_kernel<2>
                : groups == 3 ? block_topk_kernel<3>
                : groups == 4 ? block_topk_kernel<4>
                              : block_topk_kernel<0>;
  // the static arrays count against the 48 KB default too
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(nb), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, vals, idxs, static_cast<unsigned long long*>(scratch), bs, m,
      cand_n, keys_bytes, scratch == nullptr ? 1 : 0, use_wide ? 1 : 0, r);
  return static_cast<int>(cudaGetLastError());
}
