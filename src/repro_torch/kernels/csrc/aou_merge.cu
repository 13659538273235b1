// Eq. (8) merge + Eq. (10) Age-of-Update step for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/aou_merge.py:_aou_merge_kernel (the Pallas TPU
// kernel behind aou_merge_pallas), the mask-form server update of the exact
// selection engine (engine.masked_merge).
//
// Two entry points, one source:
//
// * repro_aou_merge: the TPU function, in mask form,
//     g    = m * g_new + (1 - m) * g_old
//     age' = min((age + 1) * (1 - m), AGE_CAP)
// * repro_aou_merge_by_indices: the same step for a selection given as k
//   distinct int64 indices, with everything its two exact call sites ran
//   around it as operations of their own, in one device operation:
//   - SET (the exact trainer, as .at[idx].set in the JAX trainer): g_t is
//     g_prev with the fresh (k,) row scattered in (with ``superposed`` the
//     row is first given Eq. 7's receiver tail (row + noise_std * z) / N),
//     age' = min(age + 1, AGE_CAP) with +0.0 at idx, the 0/1 mask,
//     sel_count' = sel_count + mask and, given ef_sum, the client-side EF
//     residual (ef_sum / N) * (1 - mask);
//   - ARITH (the exact engine, as repro.core.engine.masked_merge): the
//     mask form above on g_new = sent + (noise_std / N) * noise, and, given
//     the score, the residual score - m * sent.
//
// Bound on this card: device-memory bytes.  The mask form reads four (d,)
// float32 rows and writes two (24 bytes per coordinate) for five flops; the
// index form moves 28-36 bytes per coordinate plus its (k,) rows.  The first
// port was one scalar grid-stride loop over a fixed grid of 132 * 8 CTAs.
// The design here:
//
// * 16-byte float4 loads and stores wherever every (d,) operand is 16-byte
//   aligned; any other view, and the d % 4 tail, takes scalar loads.
// * The mask form gives each thread one float4 (four independent 16-byte
//   loads, all issued before the first use) over a grid that covers d
//   once.  On an H100 80GB HBM3 at 700 W this was faster at 2^24 than a
//   grid-stride loop over occupancy x SMs CTAs (132 against 139 us), and
//   no slower at 109,210; streaming cache hints and two float4 per thread
//   changed nothing.
// * The index form runs a grid-stride loop over at most occupancy x SMs
//   CTAs, the most a cooperative launch may have.
// * The index form cannot know in one dense pass which coordinates are
//   selected, so it orders two phases inside one cooperative launch: every
//   coordinate is written as unselected (m = 0), a grid-wide barrier
//   (cooperative_groups::this_grid().sync(), all CTAs co-resident), then
//   the k selected coordinates are overwritten (m = 1).  A thread reads the
//   indexed inputs of its first selected coordinate before the dense pass
//   and before the barrier (inputs only: nothing the dense pass writes), so
//   their latency hides behind both.  No (d,) mask scratch is needed.
//
// Numerics: built without fast math and with FMA contraction off, so every
// result equals the plain PyTorch version bit for bit.  The two call sites'
// arithmetic is kept apart on purpose, as their JAX counterparts differ:
// SET copies (a -0.0 fresh value stays -0.0, a NaN g_prev at idx is
// replaced, a NaN age becomes +0.0 at idx); ARITH multiplies (1 * fresh +
// 0 * g_old turns -0.0 into +0.0 where g_old >= 0 and gives NaN where either
// side is not finite; a NaN age stays NaN).  The clip keeps NaN (fminf
// would drop it, as torch.clamp and jnp.minimum do not).  Division by N is a
// multiplication by the float32 reciprocal 1.0f / N, as PyTorch's CUDA true
// division by a CPU scalar computes it; products of a scalar and a row are
// rounded before the add.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kAgeCap = 120.0f;

__device__ __forceinline__ float clip_age(float a) {
  // NaN > cap is false, so a NaN age passes through
  return a > kAgeCap ? kAgeCap : a;
}

// the mask form of one coordinate, with the mask value m
__device__ __forceinline__ void merge_one(float m, float g_new, float g_old,
                                          float age, float* g_out,
                                          float* age_out) {
  const float keep = __fsub_rn(1.0f, m);
  *g_out = __fadd_rn(__fmul_rn(m, g_new), __fmul_rn(keep, g_old));
  *age_out = clip_age(__fmul_rn(__fadd_rn(age, 1.0f), keep));
}

__device__ __forceinline__ float& lane(float4& v, int c) {
  return reinterpret_cast<float*>(&v)[c];
}

// One float4 (VEC) or one float per thread: thread v < d / 4 takes the
// four coordinates 4v..4v+3, the next d % 4 threads one tail coordinate
// each.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
aou_merge_kernel(const float* __restrict__ g_new,
                 const float* __restrict__ g_old,
                 const float* __restrict__ age,
                 const float* __restrict__ mask, float* __restrict__ g_out,
                 float* __restrict__ age_out, long long d) {
  const long long v =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n4 = VEC ? d >> 2 : 0;
  if (v < n4) {
    float4 gn = reinterpret_cast<const float4*>(g_new)[v];
    float4 go = reinterpret_cast<const float4*>(g_old)[v];
    float4 ag = reinterpret_cast<const float4*>(age)[v];
    float4 m = reinterpret_cast<const float4*>(mask)[v];
    float4 g4, a4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      merge_one(lane(m, c), lane(gn, c), lane(go, c), lane(ag, c),
                &lane(g4, c), &lane(a4, c));
    }
    reinterpret_cast<float4*>(g_out)[v] = g4;
    reinterpret_cast<float4*>(age_out)[v] = a4;
    return;
  }
  const long long i = 4 * n4 + (v - n4);
  if (i < d) {
    merge_one(mask[i], g_new[i], g_old[i], age[i], &g_out[i], &age_out[i]);
  }
}

// The index form's operands.  SET: ``row`` is the (k,) fresh row (raw
// superposed sum when ``superposed``), ``noise`` the (k,) draw z scaled by
// ``noise_mul`` = noise_std, ``aux`` ef_sum; ``sel_count``, ``mask_out``
// and ``count_out`` are used.  ARITH: ``row`` is the (d,) sent row,
// ``noise`` the (d,) draw scaled by ``noise_mul`` = noise_std / N, ``aux``
// the score.  ``noise``, ``aux`` (and ``res_out`` with it) may be null.
struct IdxArgs {
  const long long* idx;
  const float* row;
  const float* noise;
  const float* g_prev;
  const float* age;
  const float* sel_count;
  const float* aux;
  float* g_out;
  float* age_out;
  float* mask_out;
  float* count_out;
  float* res_out;
  long long d;
  long long k;
  float noise_mul;
  float inv_n;
  int superposed;
};

// One coordinate of the dense phase: written as unselected (m = 0).  In
// SET x0..x3 are g_prev, age, sel_count, ef_sum; in ARITH sent, noise,
// g_prev, age, and x4 is the score.
template <bool ARITH>
__device__ __forceinline__ void keep_one(const IdxArgs& a, float x0,
                                         float x1, float x2, float x3,
                                         float x4, float* g, float* ag,
                                         float* m, float* c, float* r) {
  if (ARITH) {
    const float noisy =
        a.noise ? __fadd_rn(x0, __fmul_rn(a.noise_mul, x1)) : x0;
    merge_one(0.0f, noisy, x2, x3, g, ag);
    *r = __fsub_rn(x4, __fmul_rn(0.0f, x0));
  } else {
    *g = x0;
    *ag = clip_age(__fadd_rn(x1, 1.0f));
    *m = 0.0f;
    *c = __fadd_rn(x2, 0.0f);
    *r = __fmul_rn(__fmul_rn(x3, a.inv_n), 1.0f);
  }
}

template <bool VEC, bool ARITH>
__device__ __forceinline__ void dense_phase(const IdxArgs& a, long long tid,
                                            long long nthreads) {
  const bool res = a.aux != nullptr;
  const float* in0 = ARITH ? a.row : a.g_prev;
  const float* in1 = ARITH ? a.noise : a.age;
  const float* in2 = ARITH ? a.g_prev : a.sel_count;
  const float* in3 = ARITH ? a.age : a.aux;
  const float* in4 = ARITH ? a.aux : nullptr;
  const bool has1 = !ARITH || a.noise != nullptr;
  const bool has3 = ARITH || res;
  const bool has4 = ARITH && res;
  long long tail = 0;
  if (VEC) {
    const long long n4 = a.d >> 2;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long v = tid; v < n4; v += nthreads) {
      float4 x0 = reinterpret_cast<const float4*>(in0)[v];
      float4 x1 = has1 ? reinterpret_cast<const float4*>(in1)[v] : zero;
      float4 x2 = reinterpret_cast<const float4*>(in2)[v];
      float4 x3 = has3 ? reinterpret_cast<const float4*>(in3)[v] : zero;
      float4 x4 = has4 ? reinterpret_cast<const float4*>(in4)[v] : zero;
      float4 g, ag, m, c, r;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        keep_one<ARITH>(a, lane(x0, l), lane(x1, l), lane(x2, l),
                        lane(x3, l), lane(x4, l), &lane(g, l), &lane(ag, l),
                        &lane(m, l), &lane(c, l), &lane(r, l));
      }
      reinterpret_cast<float4*>(a.g_out)[v] = g;
      reinterpret_cast<float4*>(a.age_out)[v] = ag;
      if (!ARITH) {
        reinterpret_cast<float4*>(a.mask_out)[v] = m;
        reinterpret_cast<float4*>(a.count_out)[v] = c;
      }
      if (res) reinterpret_cast<float4*>(a.res_out)[v] = r;
    }
    tail = n4 << 2;
  }
  for (long long i = tail + tid; i < a.d; i += nthreads) {
    float g, ag, m, c, r;
    keep_one<ARITH>(a, in0[i], has1 ? in1[i] : 0.0f, in2[i],
                    has3 ? in3[i] : 0.0f, has4 ? in4[i] : 0.0f, &g, &ag, &m,
                    &c, &r);
    a.g_out[i] = g;
    a.age_out[i] = ag;
    if (!ARITH) {
      a.mask_out[i] = m;
      a.count_out[i] = c;
    }
    if (res) a.res_out[i] = r;
  }
}

// The inputs of one selected coordinate, read before they are written out.
struct Pick {
  long long i;    // the coordinate
  float x[5];     // SET: fresh row, z, sel_count, ef_sum; ARITH: as keep_one
};

template <bool ARITH>
__device__ __forceinline__ void read_index(const IdxArgs& a, long long j,
                                           Pick* p) {
  p->i = a.idx[j];
  if (!ARITH) {
    p->x[0] = a.row[j];
    p->x[1] = a.noise ? a.noise[j] : 0.0f;
  }
}

template <bool ARITH>
__device__ __forceinline__ void read_picked(const IdxArgs& a, Pick* p) {
  const long long i = p->i;
  if (ARITH) {
    p->x[0] = a.row[i];
    p->x[1] = a.noise ? a.noise[i] : 0.0f;
    p->x[2] = a.g_prev[i];
    p->x[3] = a.age[i];
    p->x[4] = a.aux ? a.aux[i] : 0.0f;
  } else {
    p->x[2] = a.sel_count[i];
    p->x[3] = a.aux ? a.aux[i] : 0.0f;
  }
}

// One coordinate of the scatter phase: written as selected (m = 1).
template <bool ARITH>
__device__ __forceinline__ void write_picked(const IdxArgs& a,
                                             const Pick& p) {
  const long long i = p.i;
  if (ARITH) {
    const float noisy =
        a.noise ? __fadd_rn(p.x[0], __fmul_rn(a.noise_mul, p.x[1])) : p.x[0];
    merge_one(1.0f, noisy, p.x[2], p.x[3], &a.g_out[i], &a.age_out[i]);
    if (a.aux) a.res_out[i] = __fsub_rn(p.x[4], __fmul_rn(1.0f, p.x[0]));
  } else {
    float f = p.x[0];
    if (a.superposed) {
      if (a.noise) f = __fadd_rn(f, __fmul_rn(a.noise_mul, p.x[1]));
      f = __fmul_rn(f, a.inv_n);
    }
    a.g_out[i] = f;
    a.age_out[i] = 0.0f;
    a.mask_out[i] = 1.0f;
    a.count_out[i] = __fadd_rn(p.x[2], 1.0f);
    if (a.aux) a.res_out[i] = __fmul_rn(__fmul_rn(p.x[3], a.inv_n), 0.0f);
  }
}

// The dense phase, a grid-wide barrier, the scatter phase (a cooperative
// launch: every CTA is resident, so the barrier cannot wait on one that
// has not started).
template <bool VEC, bool ARITH>
__global__ void __launch_bounds__(kThreads)
aou_merge_idx_kernel(const IdxArgs a) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  Pick first;
  const bool have = tid < a.k;
  if (have) read_index<ARITH>(a, tid, &first);
  dense_phase<VEC, ARITH>(a, tid, nthreads);
  if (have) read_picked<ARITH>(a, &first);
  cg::this_grid().sync();
  if (have) write_picked<ARITH>(a, first);
  for (long long j = tid + nthreads; j < a.k; j += nthreads) {
    Pick p;
    read_index<ARITH>(a, j, &p);
    read_picked<ARITH>(a, &p);
    write_picked<ARITH>(a, p);
  }
}

// CTAs of one kernel that fit on the card at once: resident CTAs per SM
// (from the occupancy calculator, asked once per kernel) times the SM count
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

long long grid_for(long long items, long long full) {
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > full) blocks = full;
  return blocks < 1 ? 1 : blocks;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool VEC>
void launch_mask(cudaStream_t stream, const float* g_new, const float* g_old,
                 const float* age, const float* mask, float* g_out,
                 float* age_out, long long d) {
  const long long items = VEC ? (d >> 2) + (d & 3) : d;
  aou_merge_kernel<VEC><<<static_cast<unsigned>(grid_for(items, items)),
                          kThreads, 0, stream>>>(g_new, g_old, age, mask,
                                                 g_out, age_out, d);
}

template <bool VEC, bool ARITH>
int launch_idx(cudaStream_t stream, const IdxArgs& a) {
  auto kernel = aou_merge_idx_kernel<VEC, ARITH>;
  static int occ = 0;
  const long long dense = VEC ? (a.d >> 2) + (a.d & 3) : a.d;
  const long long blocks =
      grid_for(dense > a.k ? dense : a.k, card_blocks(kernel, &occ));
  IdxArgs args = a;
  void* params[] = {&args};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), params, 0, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes).  Launches on ``stream`` without
// synchronising and returns cudaGetLastError().
extern "C" int repro_aou_merge(const float* g_new, const float* g_old,
                               const float* age, const float* mask,
                               float* g_out, float* age_out, long long d,
                               void* stream) {
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(g_new) && aligned16(g_old) && aligned16(age) &&
      aligned16(mask) && aligned16(g_out) && aligned16(age_out)) {
    launch_mask<true>(s, g_new, g_old, age, mask, g_out, age_out, d);
  } else {
    launch_mask<false>(s, g_new, g_old, age, mask, g_out, age_out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The index form (see the top of the file).  ``idx`` holds k distinct
// values in [0, d).  ``arith`` picks ARITH over SET; ``n`` is N (SET: the
// tail's and the residual's divisor).  ``noise``, ``aux`` and ``res_out``
// may be null; ``sel_count``, ``mask_out`` and ``count_out`` are used only
// in SET.
extern "C" int repro_aou_merge_by_indices(
    const long long* idx, const float* row, const float* noise,
    const float* g_prev, const float* age, const float* sel_count,
    const float* aux, float* g_out, float* age_out, float* mask_out,
    float* count_out, float* res_out, long long d, long long k,
    float noise_mul, float n, int superposed, int arith, void* stream) {
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  const IdxArgs a{idx,     row,      noise,     g_prev,    age,
                  sel_count, aux,    g_out,     age_out,   mask_out,
                  count_out, res_out, d,        k,         noise_mul,
                  1.0f / n, superposed};
  const bool vec = aligned16(g_prev) && aligned16(age) &&
                   aligned16(g_out) && aligned16(age_out) &&
                   aligned16(aux) && aligned16(res_out) &&
                   (arith ? aligned16(row) && aligned16(noise)
                          : aligned16(sel_count) && aligned16(mask_out) &&
                                aligned16(count_out));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arith) {
    return vec ? launch_idx<true, true>(s, a) : launch_idx<false, true>(s, a);
  }
  return vec ? launch_idx<true, false>(s, a) : launch_idx<false, false>(s, a);
}
