// Per-block top-m magnitude candidates for Hopper, sm_90a: stage 1 of the
// two-stage top-k (kernels/ops.py:two_stage_topk).
//
// Replaces: src/repro/kernels/block_topk.py:_block_topk_kernel (the Pallas
// TPU kernel behind block_topk_pallas).
//
// For each contiguous block of ``bs`` coordinates: the m largest |x|,
// descending, ties toward the lower index (as jnp.argmax and lax.top_k
// break them), with their global int32 indices.
//
// Bound on this card: the bytes bound is d * 4 read + nb * m * 8 written,
// but the m rounds of block-wide argmax are a chain of dependent
// reductions, so at m in the tens to hundreds the kernel is latency-bound
// by those rounds, not by memory.  Design: one CTA per data block (a
// sequential grid step on the TPU); the block's |x| is read from device
// memory once into shared memory (16 KB at bs = 4,096).  Every thread
// owns the coordinates i = tid, tid + T, ... and keeps its own best
// (value, index) in registers; a round is a warp-shuffle argmax, one
// cross-warp argmax through shared memory and a store.  The winner is then
// marked -1 (the Pallas NEG: |x| >= 0, so it never wins again) and only
// its owner rescans its bs / T coordinates, instead of every thread
// rescanning the whole block as the TPU's max-and-mask loop does.
//
// Inputs are finite by contract (as in the JAX tests).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1.0f;

// (v1, i1) ranks above (v2, i2): larger value, else lower index
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void own_best(const float* s, int bs, float* bv,
                                         int* bi) {
  float v = -1e30f;
  int ix = 0x7fffffff;
  for (int i = threadIdx.x; i < bs; i += kThreads) {
    if (better(s[i], i, v, ix)) {
      v = s[i];
      ix = i;
    }
  }
  *bv = v;
  *bi = ix;
}

__device__ __forceinline__ void warp_argmax(float* v, int* ix) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, *v, off);
    const int oi = __shfl_down_sync(0xffffffffu, *ix, off);
    if (better(ov, oi, *v, *ix)) {
      *v = ov;
      *ix = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                  int* __restrict__ idxs, int bs, int m) {
  extern __shared__ float s_abs[];  // bs floats
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_win;
  const long long base = static_cast<long long>(blockIdx.x) * bs;
  for (int i = threadIdx.x; i < bs; i += kThreads) {
    s_abs[i] = fabsf(x[base + i]);
  }
  __syncthreads();
  float bv;
  int bi;
  own_best(s_abs, bs, &bv, &bi);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* out_v = vals + static_cast<long long>(blockIdx.x) * m;
  int* out_i = idxs + static_cast<long long>(blockIdx.x) * m;
  for (int r = 0; r < m; ++r) {
    float v = bv;
    int ix = bi;
    warp_argmax(&v, &ix);
    if (lane == 0) {
      s_val[warp] = v;
      s_idx[warp] = ix;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? s_val[lane] : -1e30f;
      ix = lane < kWarps ? s_idx[lane] : 0x7fffffff;
      warp_argmax(&v, &ix);
      if (lane == 0) {
        out_v[r] = v;
        out_i[r] = static_cast<int>(base + ix);
        s_abs[ix] = kNeg;
        s_win = ix;
      }
    }
    __syncthreads();
    if (s_win % kThreads == static_cast<int>(threadIdx.x)) {
      own_best(s_abs, bs, &bv, &bi);
    }
  }
}

}  // namespace

// C interface (loaded with ctypes).  x holds nb * bs floats; vals / idxs
// take nb * m entries.  Needs 1 <= m <= bs and bs * 4 bytes of dynamic
// shared memory (the wrapper checks both).  Launches on ``stream`` without
// synchronising and returns cudaGetLastError() (or the error of raising
// the shared-memory limit).
extern "C" int repro_block_topk(const float* x, float* vals, int* idxs,
                                long long nb, int bs, int m, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(bs) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  block_topk_kernel<<<static_cast<unsigned>(nb), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(x, vals, idxs, bs,
                                                           m);
  return static_cast<int>(cudaGetLastError());
}
