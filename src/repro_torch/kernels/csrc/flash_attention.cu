// Fused causal / windowed grouped-query attention for the train step,
// forward and backward, for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the reference's plain_attention
// (src/repro/models/attention.py) is jnp left to XLA.  Added because the
// port's plain version writes and re-reads a float32 score tensor of
// (B, H, S, S) per layer in the forward pass, the checkpoint's recompute
// and the backward pass (7.5 GB a layer at 8 x 4,096 positions and 14
// heads), and runs its products as float32 einsums on the CUDA cores: it
// took 88% of a train round on internvl2-1b.
//
// Bound on this card: tensor-core FLOPs.  Causal QK^T and PV are
// 2 * 2 * B * H * pairs * hd FLOPs a forward pass (2.4e11 at 8 x 4,096,
// 14 heads of 64: 0.243 ms at 989 TFLOP/s); the function's backward needs
// seven such products (QK^T and dO V^T recomputed, P^T dO, dS K, dS^T Q:
// 0.85 ms).  The bytes (q, k, v, o and the gradients, once each) lie three
// orders of magnitude below the FLOPs at the card's 295 FLOP/byte.
//
// Entry points (a plain C interface, launched on the caller's stream):
//
// * repro_flash_attn_fwd: -> o in q's dtype, the same o in float32 (the
//   backward's D reads it) and the base-2 log-sum-exp (B, H, S).
// * repro_flash_attn_bwd: three launches -> dq, dk, dv.  D = rowsum(dO *
//   O32) first; then one block per (kv block, batch x kv head) that loops
//   over its g query heads and the q blocks that see the kv block, summing
//   dK / dV in registers; then one block per (q block, batch x head) for
//   dQ.  No atomics: two runs give the same bits.
//
// bf16 design (FlashAttention-2's shape on mma.sync.m16n8k16, float32
// accumulation; four warps a block, each owning 16 rows of its tile):
//
// * Tiles move global -> shared with cp.async (16 bytes a thread, rows
//   past the sequence zero-filled), double-buffered so the next tile's
//   copy overlaps this one's products; shared rows are padded by 16 bytes
//   so ldmatrix reads them without bank conflicts.  Operands reach the
//   tensor cores through ldmatrix (.trans where the product reads a tile
//   along its rows), and a product's float32 accumulator becomes the next
//   product's A operand in registers (S -> P, dS), never through memory.
// * Forward: 64 q rows a block, 64 kv rows a tile; the longest q blocks
//   (causal) launch first; an online softmax in float32 with exp2 and the
//   scale times log2(e) folded into one multiplier; p rounded to bf16
//   against the running max before PV, as chunked_attention rounds it.
// * Registers, not shared memory, bound how many blocks an SM holds:
//   __launch_bounds__ asks for four forward blocks and three of each
//   backward kernel at hd <= 64 (up to 128 and 168 registers a thread),
//   the fastest at internvl2's shape of the counts tried on the card (a
//   few bytes spill; two 16-row slices a warp, or no cap, were slower).
// * Backward: P comes back from the log-sum-exp, dS = P (dP - D) in
//   float32, and dS enters dQ = dS K and dK = dS^T Q as hi = bf16(dS),
//   lo = bf16(dS - hi): two products each, so dS keeps more than one bf16
//   rounding (the plain version multiplies it in float32).  P enters
//   dV = P^T dO as such a pair too: one rounding of the normalised P
//   leaves dV less precise than the plain version, whose p is rounded
//   against the row max (its largest entry exact).  Those lo halves are
//   three products beyond the function's seven.
// * The kv loop of a q block (and the q loop of a kv block) covers only
//   the tiles the mask keeps some pair of (causal: up to the diagonal;
//   window: from its edge); only tiles that cross a boundary (diagonal,
//   window edge, ragged end) test each pair.
//
// float32 operands (the tests' and the float32 models' path): the same
// loops and formulas on the CUDA cores, IEEE float32 products, no rounding
// of p, P or dS; 32 x 32 tiles in shared memory, 8 threads a row.
//
// q is (B, S, H, hd), k and v (B, S, KV, hd) with H = KV * G (query head
// h reads kv head h / G), each read through its strides (the last one 1,
// rows 16-byte aligned: the wrapper checks).  Head dims 16, 32, 64, 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1.0e30f;        // plain_attention's NEG_INF
constexpr int kPad = 8;                     // bf16 a shared row is padded by
constexpr int kThreads = 128;               // bf16 kernels: 4 warps
constexpr int kF32Threads = 256;            // float32 kernels: 8 a row
constexpr int kF32Tile = 32;                // float32 kernels' rows a tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;        // forward: o; backward: dq (both q-shaped, contiguous)
  float* o32;
  float* lse;
  float* delta;
  void* dk;
  void* dv;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  long long sob, sos, soh;      // o, o32, dq
  long long sdb, sds, sdh;      // dout
  long long skob, skos, skoh;   // dk, dv
  int B, S, H, KV, G, window, causal;
  float scale, qk_scale;
};

struct Range {
  int lo, full_lo, full_hi, hi;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// The kv columns q rows [m0, m0 + bm) visit: [lo, hi), of which
// [full_lo, full_hi) need no mask (multiples of bn; hi may be ragged).
__device__ __forceinline__ Range q_range(int m0, int S, int window,
                                         int causal, int bm, int bn) {
  Range r;
  r.hi = S;
  r.full_hi = (S / bn) * bn;
  if (causal) {
    r.hi = min(m0 + bm, S);
    r.full_hi = min(r.full_hi, ((m0 + 1) / bn) * bn);
  }
  r.lo = 0;
  r.full_lo = 0;
  if (window > 0) {
    r.lo = (max(m0 - window + 1, 0) / bn) * bn;
    r.full_lo = cdiv(max(m0 + bm - window, 0), bn) * bn;
  }
  r.full_hi = max(r.full_hi, r.lo);
  r.full_lo = min(max(r.full_lo, r.lo), r.full_hi);
  return r;
}

// The q rows that see kv rows [n0, n0 + bn): [lo, hi), of which
// [full_lo, full_hi) need no mask (multiples of bm; hi may be ragged).
__device__ __forceinline__ Range kv_range(int n0, int S, int window,
                                          int causal, int bm, int bn) {
  Range r;
  r.lo = 0;
  r.full_lo = 0;
  if (causal) {
    r.lo = (n0 / bm) * bm;
    r.full_lo = cdiv(n0 + bn - 1, bm) * bm;
  }
  r.hi = S;
  r.full_hi = (S / bm) * bm;
  if (window > 0) {
    r.hi = min(n0 + bn - 1 + window, S);
    r.full_hi = min(r.full_hi, ((n0 + window) / bm) * bm);
  }
  // a ragged kv block is masked all along
  r.full_hi = n0 + bn > S ? r.lo : max(r.full_hi, r.lo);
  r.full_lo = min(max(r.full_lo, r.lo), r.full_hi);
  return r;
}

// Query index row may see key index col.
__device__ __forceinline__ bool allowed(int row, int col, const Params& p) {
  bool ok = row < p.S && col < p.S;
  if (p.causal) ok = ok && col <= row;
  if (p.window > 0) ok = ok && col > row - p.window;
  return ok;
}

// ---------------------------------------------------------------------------
// tensor-core primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm4(const bf16* ptr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm4_t(const bf16* ptr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c += a (16 x 16, rows) * b (16 x 8, columns), float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a
// row-major shared tile with ld elements a row.
__device__ __forceinline__ void load_a(const bf16* sm, int ld, int r0,
                                       int c0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm4(sm + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
            (lane >> 4) * 8,
        a);
}

// B fragments for output columns [n0, n0 + 16) over the depth [k0, k0 + 16)
// from a tile stored [n][k] (row n holds column n of B): {b0, b1} of the
// columns n0.. in r[0], r[1], of n0 + 8.. in r[2], r[3].
__device__ __forceinline__ void load_b(const bf16* sm, int ld, int n0,
                                       int k0, uint32_t (&r)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm4(sm + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
            ((lane >> 3) & 1) * 8,
        r);
}

// The same from a tile stored [k][n] (row k holds row k of B).
__device__ __forceinline__ void load_b_t(const bf16* sm, int ld, int k0,
                                         int n0, uint32_t (&r)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm4_t(sm + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
              (lane >> 4) * 8,
          r);
}

// The A fragment of depth step kk (columns 16 kk .. 16 kk + 15) from a
// product's float32 accumulator fragments, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&c)[N][4], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// The lo half of the same: bf16(x - float(bf16(x))).
__device__ __forceinline__ float lo_of(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

template <int N>
__device__ __forceinline__ void acc_to_a_lo(const float (&c)[N][4], int kk,
                                            uint32_t (&a)[4]) {
  a[0] = pack(lo_of(c[2 * kk][0]), lo_of(c[2 * kk][1]));
  a[1] = pack(lo_of(c[2 * kk][2]), lo_of(c[2 * kk][3]));
  a[2] = pack(lo_of(c[2 * kk + 1][0]), lo_of(c[2 * kk + 1][1]));
  a[3] = pack(lo_of(c[2 * kk + 1][2]), lo_of(c[2 * kk + 1][3]));
}

// c[NB][4] = A (16 x 16 KS, fragments in registers) * B^T, B stored [n][k]
// in shared memory, NB * 8 columns from row n0.
template <int NB, int KS>
__device__ __forceinline__ void mma_regs_bt(float (&c)[NB][4],
                                            const uint32_t (&a)[KS][4],
                                            const bf16* sm, int ld) {
#pragma unroll
  for (int j = 0; j < NB; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t b[4];
      load_b(sm, ld, j * 8, kk * 16, b);
      mma(c[j], a[kk], b[0], b[1]);
      mma(c[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// c[NB][4] += A * B, A the accumulator fragments p[KB][4] (16 x 8 KB, as
// bf16, hi or lo), B stored [k][n] in shared memory, NB * 8 columns.
template <int NB, int KB, bool LO>
__device__ __forceinline__ void mma_acc_b(float (&c)[NB][4],
                                          const float (&p)[KB][4],
                                          const bf16* sm, int ld) {
#pragma unroll
  for (int kk = 0; kk < KB / 2; ++kk) {
    uint32_t a[4];
    if (LO) {
      acc_to_a_lo(p, kk, a);
    } else {
      acc_to_a(p, kk, a);
    }
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t b[4];
      load_b_t(sm, ld, kk * 16, j * 8, b);
      mma(c[j], a, b[0], b[1]);
      mma(c[j + 1], a, b[2], b[3]);
    }
  }
}

// Copy rows [row0, row0 + R) of a (S, HD) bf16 view with rows `stride`
// elements apart into a padded shared tile; rows past S become zeros.
template <int R, int HD>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g,
                                          long long stride, int row0,
                                          int S) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async16(sm + r * (HD + kPad) + c,
               g + static_cast<long long>(ok ? row : 0) * stride + c, ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16 kernels
// ---------------------------------------------------------------------------

template <int HD>
struct FwdShape {
  static constexpr int BM = 64;                // q rows a block, 16 a warp
  static constexpr int BN = 64;                // kv rows a tile
  static constexpr int kSmem = (BM + 4 * BN) * (HD + kPad) * 2;
  static constexpr int kMinBlocks = HD <= 64 ? 4 : 2;  // resident an SM
};

template <int HD>
__global__ void __launch_bounds__(kThreads, FwdShape<HD>::kMinBlocks)
    attn_fwd_bf16(const Params p) {
  constexpr int BM = FwdShape<HD>::BM, BN = FwdShape<HD>::BN;
  constexpr int LD = HD + kPad, KS = HD / 16, NF = BN / 8, OF = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + BM * LD;          // [2][BN][LD]
  bf16* sv = sk + 2 * BN * LD;      // [2][BN][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.G;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest first
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + kvh * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + kvh * p.svh;
  const Range rg = q_range(m0, p.S, p.window, p.causal, BM, BN);

  load_tile<BM, HD>(sq, qg, p.sqs, m0, p.S);
  cp_commit();
  load_tile<BN, HD>(sk, kg, p.sks, rg.lo, p.S);
  load_tile<BN, HD>(sv, vg, p.svs, rg.lo, p.S);
  cp_commit();
  cp_wait_but_one();
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(sq, LD, warp * 16, kk * 16, qa[kk]);

  float acc[OF][4];
#pragma unroll
  for (int j = 0; j < OF; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int row0 = m0 + warp * 16 + (lane >> 2);
  int buf = 0;
  for (int n0 = rg.lo; n0 < rg.hi; n0 += BN) {
    if (n0 + BN < rg.hi) {
      load_tile<BN, HD>(sk + (buf ^ 1) * BN * LD, kg, p.sks, n0 + BN, p.S);
      load_tile<BN, HD>(sv + (buf ^ 1) * BN * LD, vg, p.svs, n0 + BN, p.S);
    }
    cp_commit();
    cp_wait_but_one();
    __syncthreads();
    const bool masked = !(rg.full_lo <= n0 && n0 < rg.full_hi);
    float s[NF][4];
    mma_regs_bt<NF, KS>(s, qa, sk + buf * BN * LD, LD);
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.qk_scale;
        if (masked &&
            !allowed(row0 + (e >> 1) * 8, n0 + j * 8 + 2 * (lane & 3) +
                                              (e & 1), p))
          x = kNegInf;
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(tmax[i]));
      alpha[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + psum[i];
#pragma unroll
    for (int j = 0; j < OF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    mma_acc_b<OF, NF, false>(acc, s, sv + buf * BN * LD, LD);
    __syncthreads();
    buf ^= 1;
  }

  bf16* og = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh;
  float* o32g = p.o32 + b * p.sob + h * p.soh;
  float* lseg = p.lse + static_cast<long long>(blockIdx.x) * p.S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const float l = quad_sum(l_r[i]);
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < OF; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      const float o0 = acc[j][2 * i] / l;
      const float o1 = acc[j][2 * i + 1] / l;
      const long long off = row * p.sos + col;
      *reinterpret_cast<float2*>(o32g + off) = make_float2(o0, o1);
      *reinterpret_cast<__nv_bfloat162*>(og + off) =
          __floats2bfloat162_rn(o0, o1);
    }
    if ((lane & 3) == 0) lseg[row] = m_r[i] + log2f(l);
  }
}

__device__ __forceinline__ float as_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float as_f32(float x) { return x; }

// D = rowsum(dO * O32), a group of HD / 8 threads a row.
template <int HD, typename T>
__global__ void __launch_bounds__(256) attn_bwd_delta(const Params p) {
  constexpr int kTpr = HD / 8;
  const long long idx =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / kTpr;
  const int part = threadIdx.x % kTpr;
  const long long rows = static_cast<long long>(p.B) * p.H * p.S;
  float sum = 0.f;
  if (idx < rows) {
    const int s = static_cast<int>(idx % p.S);
    const long long bh = idx / p.S;
    const int b = static_cast<int>(bh / p.H), h = static_cast<int>(bh % p.H);
    const float* o = p.o32 + b * p.sob + h * p.soh + s * p.sos + part * 8;
    const T* d = static_cast<const T*>(p.dout) + b * p.sdb + h * p.sdh +
                 s * p.sds + part * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += as_f32(d[i]) * o[i];
  }
#pragma unroll
  for (int off = 1; off < kTpr; off <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (idx < rows && part == 0) p.delta[idx] = sum;
}

template <int HD>
struct DqShape {
  static constexpr int BM = 64;
  static constexpr int BN = HD <= 64 ? 64 : 32;
  static constexpr int kSmem = (2 * BM + 4 * BN) * (HD + kPad) * 2;
  static constexpr int kMinBlocks = HD <= 64 ? 3 : 1;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, DqShape<HD>::kMinBlocks)
    attn_bwd_dq_bf16(const Params p) {
  constexpr int BM = DqShape<HD>::BM, BN = DqShape<HD>::BN, LD = HD + kPad;
  constexpr int KS = HD / 16, NF = BN / 8, OF = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + BM * LD;
  bf16* sk = sdo + BM * LD;         // [2][BN][LD]
  bf16* sv = sk + 2 * BN * LD;      // [2][BN][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.G;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + kvh * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + kvh * p.svh;
  const Range rg = q_range(m0, p.S, p.window, p.causal, BM, BN);

  load_tile<BM, HD>(sq, static_cast<const bf16*>(p.q) + b * p.sqb +
                            h * p.sqh, p.sqs, m0, p.S);
  load_tile<BM, HD>(sdo, static_cast<const bf16*>(p.dout) + b * p.sdb +
                             h * p.sdh, p.sds, m0, p.S);
  cp_commit();
  load_tile<BN, HD>(sk, kg, p.sks, rg.lo, p.S);
  load_tile<BN, HD>(sv, vg, p.svs, rg.lo, p.S);
  cp_commit();
  cp_wait_but_one();
  __syncthreads();
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(sq, LD, warp * 16, kk * 16, qa[kk]);
    load_a(sdo, LD, warp * 16, kk * 16, da[kk]);
  }
  const int row0 = m0 + warp * 16 + (lane >> 2);
  const long long bh = static_cast<long long>(blockIdx.x) * p.S;
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lse[i] = row < p.S ? p.lse[bh + row] : 0.f;
    dlt[i] = row < p.S ? p.delta[bh + row] : 0.f;
  }
  float dq[OF][4];
#pragma unroll
  for (int j = 0; j < OF; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  int buf = 0;
  for (int n0 = rg.lo; n0 < rg.hi; n0 += BN) {
    if (n0 + BN < rg.hi) {
      load_tile<BN, HD>(sk + (buf ^ 1) * BN * LD, kg, p.sks, n0 + BN, p.S);
      load_tile<BN, HD>(sv + (buf ^ 1) * BN * LD, vg, p.svs, n0 + BN, p.S);
    }
    cp_commit();
    cp_wait_but_one();
    __syncthreads();
    const bf16* skb = sk + buf * BN * LD;
    const bf16* svb = sv + buf * BN * LD;
    const bool masked = !(rg.full_lo <= n0 && n0 < rg.full_hi);
    float s[NF][4], dp[NF][4];
    mma_regs_bt<NF, KS>(s, qa, skb, LD);
    mma_regs_bt<NF, KS>(dp, da, svb, LD);
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(s[j][e] * p.qk_scale - lse[e >> 1]);
        if (masked &&
            !allowed(row0 + (e >> 1) * 8, n0 + j * 8 + 2 * (lane & 3) +
                                              (e & 1), p))
          pr = 0.f;
        s[j][e] = pr * (dp[j][e] - dlt[e >> 1]);     // dS
      }
    mma_acc_b<OF, NF, false>(dq, s, skb, LD);
    mma_acc_b<OF, NF, true>(dq, s, skb, LD);
    __syncthreads();
    buf ^= 1;
  }
  bf16* dqg = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < OF; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqg + row * p.sos + j * 8 +
                                         2 * (lane & 3)) =
          __floats2bfloat162_rn(dq[j][2 * i] * p.scale,
                                dq[j][2 * i + 1] * p.scale);
  }
}

template <int HD>
struct DkvShape {
  static constexpr int BN = 64;                    // kv rows a block
  static constexpr int BM = HD <= 64 ? 64 : 32;    // q rows a tile
  static constexpr int kSmem =
      (2 * BN + 4 * BM) * (HD + kPad) * 2 + 4 * BM * 4;
  static constexpr int kMinBlocks = HD <= 64 ? 3 : 1;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, DkvShape<HD>::kMinBlocks)
    attn_bwd_dkv_bf16(const Params p) {
  constexpr int BN = DkvShape<HD>::BN, BM = DkvShape<HD>::BM;
  constexpr int LD = HD + kPad, KS = HD / 16, NF = BM / 8, OF = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + BN * LD;
  bf16* sq = sv + BN * LD;          // [2][BM][LD]
  bf16* sdo = sq + 2 * BM * LD;     // [2][BM][LD]
  float* slse = reinterpret_cast<float*>(sdo + 2 * BM * LD);  // [2][BM]
  float* sdlt = slse + 2 * BM;                                 // [2][BM]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int n0 = blockIdx.y * BN;   // the longest (causal) first
  const Range rg = kv_range(n0, p.S, p.window, p.causal, BM, BN);
  const int n_tiles = rg.hi > rg.lo ? cdiv(rg.hi - rg.lo, BM) : 0;
  const int total = p.G * n_tiles;

  load_tile<BN, HD>(sk, static_cast<const bf16*>(p.k) + b * p.skb +
                            kvh * p.skh, p.sks, n0, p.S);
  load_tile<BN, HD>(sv, static_cast<const bf16*>(p.v) + b * p.svb +
                            kvh * p.svh, p.svs, n0, p.S);
  cp_commit();
  // tile t: query head kvh * G + t / n_tiles, q rows from lo + (t %
  // n_tiles) * BM; its q, dO rows, log-sum-exp and D into buffer bi
  auto fetch = [&](int t, int bi) {
    const int h = kvh * p.G + t / n_tiles;
    const int m0 = rg.lo + (t % n_tiles) * BM;
    load_tile<BM, HD>(sq + bi * BM * LD, static_cast<const bf16*>(p.q) +
                                             b * p.sqb + h * p.sqh,
                      p.sqs, m0, p.S);
    load_tile<BM, HD>(sdo + bi * BM * LD, static_cast<const bf16*>(p.dout) +
                                              b * p.sdb + h * p.sdh,
                      p.sds, m0, p.S);
    const long long bh = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int i = threadIdx.x; i < BM; i += kThreads) {
      const bool ok = m0 + i < p.S;
      slse[bi * BM + i] = ok ? p.lse[bh + m0 + i] : 0.f;
      sdlt[bi * BM + i] = ok ? p.delta[bh + m0 + i] : 0.f;
    }
  };
  if (total > 0) fetch(0, 0);
  cp_commit();

  float dk[OF][4], dv[OF][4];
#pragma unroll
  for (int j = 0; j < OF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int key0 = n0 + warp * 16 + (lane >> 2);
  int buf = 0;
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) fetch(t + 1, buf ^ 1);
    cp_commit();
    cp_wait_but_one();
    __syncthreads();
    const int m0 = rg.lo + (t % n_tiles) * BM;
    const bf16* sqb = sq + buf * BM * LD;
    const bf16* sdob = sdo + buf * BM * LD;
    const float* lseb = slse + buf * BM;
    const float* dltb = sdlt + buf * BM;
    const bool masked = !(rg.full_lo <= m0 && m0 < rg.full_hi);
    uint32_t ka[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) load_a(sk, LD, warp * 16, kk * 16, ka[kk]);
    float pt[NF][4];                                  // P^T: keys x q rows
    mma_regs_bt<NF, KS>(pt, ka, sqb, LD);
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * (lane & 3) + (e & 1);
        float pr = exp2f(pt[j][e] * p.qk_scale - lseb[c]);
        if (masked && !allowed(m0 + c, key0 + (e >> 1) * 8, p)) pr = 0.f;
        pt[j][e] = pr;
      }
    mma_acc_b<OF, NF, false>(dv, pt, sdob, LD);
    mma_acc_b<OF, NF, true>(dv, pt, sdob, LD);
    uint32_t va[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) load_a(sv, LD, warp * 16, kk * 16, va[kk]);
    float dpt[NF][4];
    mma_regs_bt<NF, KS>(dpt, va, sdob, LD);
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pt[j][e] *= dpt[j][e] - dltb[j * 8 + 2 * (lane & 3) + (e & 1)];
    mma_acc_b<OF, NF, false>(dk, pt, sqb, LD);        // dS^T Q
    mma_acc_b<OF, NF, true>(dk, pt, sqb, LD);
    __syncthreads();
    buf ^= 1;
  }
  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.skob + kvh * p.skoh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.skob + kvh * p.skoh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = key0 + i * 8;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < OF; ++j) {
      const long long off = row * p.skos + j * 8 + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dkg + off) = __floats2bfloat162_rn(
          dk[j][2 * i] * p.scale, dk[j][2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + off) =
          __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 kernels: 32 x 32 tiles in shared memory, thread (r, c8) of a
// block owns row r of the tile and its columns c8, c8 + 8, ...
// ---------------------------------------------------------------------------

template <int HD>
struct F32Shape {
  static constexpr int LD = HD + 1;
  static constexpr int kTile = kF32Tile * LD;           // floats
  static constexpr int kScores = kF32Tile * (kF32Tile + 1);
  static constexpr int kSmem = (4 * kTile + 2 * kScores + 2 * kF32Tile) * 4;
};

// rows [row0, row0 + 32) of a (S, HD) float32 view into a shared tile
template <int HD>
__device__ __forceinline__ void load_f32(float* sm, const float* g,
                                         long long stride, int row0, int S) {
  for (int i = threadIdx.x; i < kF32Tile * HD; i += kF32Threads) {
    const int r = i / HD, c = i % HD;
    sm[r * (HD + 1) + c] =
        row0 + r < S ? g[static_cast<long long>(row0 + r) * stride + c] : 0.f;
  }
}

// sum_d a[ra][d] * b[rb][d] over two tiles
template <int HD>
__device__ __forceinline__ float dot_f32(const float* a, int ra,
                                         const float* b, int rb) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) s += a[ra * (HD + 1) + d] * b[rb * (HD + 1) + d];
  return s;
}

__device__ __forceinline__ float row_max8(float x) {
  for (int off = 1; off < 8; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
  for (int off = 1; off < 8; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads) attn_fwd_f32(const Params p) {
  constexpr int T = kF32Tile, LD = HD + 1, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + F32Shape<HD>::kTile;
  float* sv = sk + F32Shape<HD>::kTile;
  float* sp = sv + F32Shape<HD>::kTile;
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.G;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * T;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;
  const Range rg = q_range(m0, p.S, p.window, p.causal, T, T);
  load_f32<HD>(sq, static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh,
               p.sqs, m0, p.S);
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m_r = kNegInf, l_r = 0.f;
  for (int n0 = rg.lo; n0 < rg.hi; n0 += T) {
    __syncthreads();
    load_f32<HD>(sk, kg, p.sks, n0, p.S);
    load_f32<HD>(sv, vg, p.svs, n0, p.S);
    __syncthreads();
    const bool masked = !(rg.full_lo <= n0 && n0 < rg.full_hi);
    float x[4], tmax = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c8 + 8 * jj;
      x[jj] = dot_f32<HD>(sq, r, sk, c) * p.qk_scale;
      if (masked && !allowed(m0 + r, n0 + c, p)) x[jj] = kNegInf;
      tmax = fmaxf(tmax, x[jj]);
    }
    const float m_new = fmaxf(m_r, row_max8(tmax));
    const float alpha = exp2f(m_r - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float pr = exp2f(x[jj] - m_new);
      sp[r * (T + 1) + c8 + 8 * jj] = pr;
      psum += pr;
    }
    l_r = l_r * alpha + row_sum8(psum);
    m_r = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int d = c8 + 8 * i;
      float s = 0.f;
      for (int c = 0; c < T; ++c) s += sp[r * (T + 1) + c] * sv[c * LD + d];
      acc[i] = acc[i] * alpha + s;
    }
  }
  const int row = m0 + r;
  if (row < p.S) {
    float* og = static_cast<float*>(p.o) + b * p.sob + h * p.soh + row * p.sos;
    float* o32g = p.o32 + b * p.sob + h * p.soh + row * p.sos;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      og[c8 + 8 * i] = acc[i] / l_r;
      o32g[c8 + 8 * i] = acc[i] / l_r;
    }
    if (c8 == 0)
      p.lse[static_cast<long long>(blockIdx.x) * p.S + row] = m_r + log2f(l_r);
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    attn_bwd_dq_f32(const Params p) {
  constexpr int T = kF32Tile, LD = HD + 1, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + F32Shape<HD>::kTile;
  float* sk = sdo + F32Shape<HD>::kTile;
  float* sv = sk + F32Shape<HD>::kTile;
  float* sds = sv + F32Shape<HD>::kTile;
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.G;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * T;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;
  const Range rg = q_range(m0, p.S, p.window, p.causal, T, T);
  load_f32<HD>(sq, static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh,
               p.sqs, m0, p.S);
  load_f32<HD>(sdo, static_cast<const float*>(p.dout) + b * p.sdb +
                        h * p.sdh, p.sds, m0, p.S);
  const int row = m0 + r;
  const long long at = static_cast<long long>(blockIdx.x) * p.S + row;
  const float lse = row < p.S ? p.lse[at] : 0.f;
  const float dlt = row < p.S ? p.delta[at] : 0.f;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  for (int n0 = rg.lo; n0 < rg.hi; n0 += T) {
    __syncthreads();
    load_f32<HD>(sk, kg, p.sks, n0, p.S);
    load_f32<HD>(sv, vg, p.svs, n0, p.S);
    __syncthreads();
    const bool masked = !(rg.full_lo <= n0 && n0 < rg.full_hi);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c8 + 8 * jj;
      float pr = exp2f(dot_f32<HD>(sq, r, sk, c) * p.qk_scale - lse);
      if (masked && !allowed(row, n0 + c, p)) pr = 0.f;
      sds[r * (T + 1) + c] = pr * (dot_f32<HD>(sdo, r, sv, c) - dlt);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int d = c8 + 8 * i;
      float s = 0.f;
      for (int c = 0; c < T; ++c) s += sds[r * (T + 1) + c] * sk[c * LD + d];
      acc[i] += s;
    }
  }
  if (row < p.S) {
    float* dqg = static_cast<float*>(p.o) + b * p.sob + h * p.soh +
                 row * p.sos;
#pragma unroll
    for (int i = 0; i < NO; ++i) dqg[c8 + 8 * i] = acc[i] * p.scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    attn_bwd_dkv_f32(const Params p) {
  constexpr int T = kF32Tile, LD = HD + 1, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + F32Shape<HD>::kTile;
  float* sq = sv + F32Shape<HD>::kTile;
  float* sdo = sq + F32Shape<HD>::kTile;
  float* sp = sdo + F32Shape<HD>::kTile;
  float* sds = sp + F32Shape<HD>::kScores;
  float* slse = sds + F32Shape<HD>::kScores;
  float* sdlt = slse + T;
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int n0 = blockIdx.y * T;
  const Range rg = kv_range(n0, p.S, p.window, p.causal, T, T);
  load_f32<HD>(sk, static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh,
               p.sks, n0, p.S);
  load_f32<HD>(sv, static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh,
               p.svs, n0, p.S);
  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  const int key = n0 + r;
  for (int g = 0; g < p.G; ++g) {
    const int h = kvh * p.G + g;
    const long long bh = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int m0 = rg.lo; m0 < rg.hi; m0 += T) {
      __syncthreads();
      load_f32<HD>(sq, static_cast<const float*>(p.q) + b * p.sqb +
                           h * p.sqh, p.sqs, m0, p.S);
      load_f32<HD>(sdo, static_cast<const float*>(p.dout) + b * p.sdb +
                            h * p.sdh, p.sds, m0, p.S);
      if (threadIdx.x < T) {
        const bool ok = m0 + threadIdx.x < p.S;
        slse[threadIdx.x] = ok ? p.lse[bh + m0 + threadIdx.x] : 0.f;
        sdlt[threadIdx.x] = ok ? p.delta[bh + m0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      const bool masked = !(rg.full_lo <= m0 && m0 < rg.full_hi);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = c8 + 8 * jj;
        float pr = exp2f(dot_f32<HD>(sk, r, sq, c) * p.qk_scale - slse[c]);
        if (masked && !allowed(m0 + c, key, p)) pr = 0.f;
        sp[r * (T + 1) + c] = pr;
        sds[r * (T + 1) + c] = pr * (dot_f32<HD>(sv, r, sdo, c) - sdlt[c]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int d = c8 + 8 * i;
        float a = 0.f, s = 0.f;
        for (int c = 0; c < T; ++c) {
          a += sp[r * (T + 1) + c] * sdo[c * LD + d];
          s += sds[r * (T + 1) + c] * sq[c * LD + d];
        }
        dv[i] += a;
        dk[i] += s;
      }
    }
  }
  if (key < p.S) {
    float* dkg = static_cast<float*>(p.dk) + b * p.skob + kvh * p.skoh +
                 key * p.skos;
    float* dvg = static_cast<float*>(p.dv) + b * p.skob + kvh * p.skoh +
                 key * p.skos;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      dkg[c8 + 8 * i] = dk[i] * p.scale;
      dvg[c8 + 8 * i] = dv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t fwd(const Params& p, bool f32, cudaStream_t stream) {
  if (f32)
    return launch(attn_fwd_f32<HD>,
                  dim3(p.B * p.H, cdiv(p.S, kF32Tile)), kF32Threads,
                  F32Shape<HD>::kSmem, stream, p);
  return launch(attn_fwd_bf16<HD>,
                dim3(p.B * p.H, cdiv(p.S, FwdShape<HD>::BM)), kThreads,
                FwdShape<HD>::kSmem, stream, p);
}

template <int HD>
cudaError_t bwd(const Params& p, bool f32, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.S;
  const dim3 delta_grid(static_cast<unsigned>((rows * (HD / 8) + 255) / 256));
  cudaError_t err =
      f32 ? launch(attn_bwd_delta<HD, float>, delta_grid, 256, 0, stream, p)
          : launch(attn_bwd_delta<HD, bf16>, delta_grid, 256, 0, stream, p);
  if (err != cudaSuccess) return err;
  if (f32) {
    err = launch(attn_bwd_dkv_f32<HD>, dim3(p.B * p.KV, cdiv(p.S, kF32Tile)),
                 kF32Threads, F32Shape<HD>::kSmem, stream, p);
    if (err != cudaSuccess) return err;
    return launch(attn_bwd_dq_f32<HD>, dim3(p.B * p.H, cdiv(p.S, kF32Tile)),
                  kF32Threads, F32Shape<HD>::kSmem, stream, p);
  }
  err = launch(attn_bwd_dkv_bf16<HD>,
               dim3(p.B * p.KV, cdiv(p.S, DkvShape<HD>::BN)), kThreads,
               DkvShape<HD>::kSmem, stream, p);
  if (err != cudaSuccess) return err;
  return launch(attn_bwd_dq_bf16<HD>,
                dim3(p.B * p.H, cdiv(p.S, DqShape<HD>::BM)), kThreads,
                DqShape<HD>::kSmem, stream, p);
}

// dims: B, S, H, KV, hd, causal, window, float32 (0 / 1), then the
// strides (batch, position, head) of q, k, v, the q-shaped outputs (o,
// o32, dq), dout and the k-shaped outputs (dk, dv)
Params params(const long long* dims) {
  Params p = {};
  p.B = static_cast<int>(dims[0]);
  p.S = static_cast<int>(dims[1]);
  p.H = static_cast<int>(dims[2]);
  p.KV = static_cast<int>(dims[3]);
  p.G = p.KV > 0 ? p.H / p.KV : 0;
  p.causal = static_cast<int>(dims[5]);
  p.window = static_cast<int>(dims[6]);
  p.sqb = dims[8], p.sqs = dims[9], p.sqh = dims[10];
  p.skb = dims[11], p.sks = dims[12], p.skh = dims[13];
  p.svb = dims[14], p.svs = dims[15], p.svh = dims[16];
  p.sob = dims[17], p.sos = dims[18], p.soh = dims[19];
  p.sdb = dims[20], p.sds = dims[21], p.sdh = dims[22];
  p.skob = dims[23], p.skos = dims[24], p.skoh = dims[25];
  p.scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(dims[4])));
  p.qk_scale = p.scale * kLog2e;
  return p;
}

template <cudaError_t (*F16)(const Params&, bool, cudaStream_t),
          cudaError_t (*F32)(const Params&, bool, cudaStream_t),
          cudaError_t (*F64)(const Params&, bool, cudaStream_t),
          cudaError_t (*F128)(const Params&, bool, cudaStream_t)>
int by_head_dim(const Params& p, long long hd, bool f32, void* stream) {
  if (p.B <= 0 || p.S <= 0 || p.H <= 0 || p.KV <= 0 || p.H % p.KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(F16(p, f32, s));
    case 32: return static_cast<int>(F32(p, f32, s));
    case 64: return static_cast<int>(F64(p, f32, s));
    case 128: return static_cast<int>(F128(p, f32, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, void* o, float* o32,
                                    float* lse, const long long* dims,
                                    void* stream) {
  Params p = params(dims);
  p.q = q, p.k = k, p.v = v, p.o = o, p.o32 = o32, p.lse = lse;
  return by_head_dim<fwd<16>, fwd<32>, fwd<64>, fwd<128>>(p, dims[4],
                                                          dims[7] != 0,
                                                          stream);
}

extern "C" int repro_flash_attn_bwd(const void* dout, const void* q,
                                    const void* k, const void* v,
                                    const float* o32, const float* lse,
                                    float* delta, void* dq, void* dk,
                                    void* dv, const long long* dims,
                                    void* stream) {
  Params p = params(dims);
  p.dout = dout, p.q = q, p.k = k, p.v = v;
  p.o32 = const_cast<float*>(o32), p.lse = const_cast<float*>(lse);
  p.delta = delta, p.o = dq, p.dk = dk, p.dv = dv;
  return by_head_dim<bwd<16>, bwd<32>, bwd<64>, bwd<128>>(p, dims[4],
                                                          dims[7] != 0,
                                                          stream);
}
