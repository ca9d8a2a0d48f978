// Tile operators of the block-program vocabulary (repro_torch/core/ops.py,
// paper Table 1) for the kernels that core/codegen_cuda.py emits.
//
// Every item is presented as a 2-D view: a pointer plus a row stride and a
// column stride, in float32.  A vector of n items is a (1, n) view and a
// scalar a (1, 1) view; a stride of 0 broadcasts an axis, which is how
// numpy's trailing-axis broadcasting (and ops.bcast_to's row-wise factor)
// reach the kernels.  Shapes are template parameters: the emitter knows
// them statically, and every kernel runs 256 threads (8 warps).
//
// How the operators use an H100 SM:
//
// * ew: the block's threads stride over the elements of the output tile,
//   or over a window [c0, c1) of its columns (a cluster rank's share of an
//   epilogue).  The row-wise vocabulary (row_scale, row_shift, outer,
//   causal_mask) is emitted as ew expressions.
// * dot_k, the product of operands contiguous along the contraction axis
//   (the emitter knows every stride as a literal): operands in device
//   memory are staged in shared memory by 16-byte cp.async copies, the
//   threads of a warp on neighbouring addresses, b in double-buffered
//   chunks of CC output columns (the next chunk's copies fly while the
//   current one is multiplied).  Staged rows are padded to SP floats, SP / 4
//   odd, so float4 reads of 8 neighbouring rows hit distinct banks.  With R <= 8
//   rows (decode) one warp owns an output column, its lanes split k, and
//   warp shuffles add the lanes' partial sums; with more rows each thread
//   owns a register micro-tile of ceil(R/8) rows of one column and reads
//   float4s.
// * dot_k_sum, the whole K loop of a serial map whose reduced ports are
//   all `+` accumulators of tile products sharing one operand a (the
//   SwiGLU's gate/up, two products, and its down projection, one) at 16
//   rows or more: the sums stay in registers as mma.sync C fragments for
//   the whole loop; a ring of ST stages, filled by cp.async ST - 1
//   k-steps ahead across the trips, holds the next BK-wide k-slice of a
//   (once for every product) and of each b; the products run on the
//   tensor cores in 3xTF32 (mma.cuh: m16n8k8, hi/lo split of both
//   operands, each k8's three products summed in a fresh fragment and
//   added to the running sum in float32).  The ring may overlap the
//   accumulators' shared memory, which is written once, after the loop.
// * dot, the product at any other strides: one thread per output, reading
//   its operands where they live.
// * row_sum, row_max: a warp per row, lanes over its columns, warp
//   shuffles for the result.
// * cluster_combine: the ranks of a thread-block cluster each hold a
//   partial accumulator at the same shared-memory address; each rank adds
//   (or maxes) one column window of all ranks' partials through
//   distributed shared memory, in rank order, so the result does not
//   depend on timing.
//
// Every operator ends with __syncthreads() (cluster_combine is bracketed
// by cluster_sync()) so the next one sees its result.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

#include "mma.cuh"

namespace tiles {

namespace cg = cooperative_groups;

constexpr int WARPS = 8;            // 256 threads per block
constexpr float NEG_MASK = -1e30f;  // ops.NEG_MASK

// out[r, c] = f(r, c) for the columns [c0, c1) of an R x C tile.
template <int R, int C, class F>
__device__ __forceinline__ void ew(float* o, int ors, int ocs, F f,
                                   int c0 = 0, int c1 = C) {
  const int w = c1 - c0;
  for (int e = threadIdx.x; e < R * w; e += blockDim.x) {
    const int r = e / w, c = c0 + (e - (e / w) * w);
    o[r * ors + c * ocs] = f(r, c);
  }
  __syncthreads();
}

// dot: out = a @ b.T with a (R, K) and b (C, K), any strides.
template <int R, int C, int K>
__device__ __forceinline__ void dot(float* o, int ors, int ocs,
                                    const float* a, int ars, int acs,
                                    const float* b, int brs, int bcs) {
  for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
    const int r = e / C, c = e - (e / C) * C;
    const float* ar = a + r * ars;
    const float* bc = b + c * brs;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(ar[k * acs], bc[k * bcs], s);
    o[r * ors + c * ocs] = s;
  }
  __syncthreads();
}

// -- staging -----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of an operand whose rows are K contiguous floats, rs apart,
// into shared memory at row stride SP: 16-byte cp.async from device memory
// (G), plain loads otherwise (an operand computed in the kernel).
template <int K, int SP, bool G>
__device__ __forceinline__ void stage(float* dst, const float* src, int rs,
                                      int n) {
  if constexpr (G) {
    constexpr int Q = K / 4;
    for (int e = threadIdx.x; e < n * Q; e += blockDim.x) {
      const int r = e / Q, q = e - (e / Q) * Q;
      cp_async16(dst + r * SP + 4 * q, src + (long long)r * rs + 4 * q);
    }
  } else {
    for (int e = threadIdx.x; e < n * K; e += blockDim.x) {
      const int r = e / K, k = e - (e / K) * K;
      dst[r * SP + k] = src[(long long)r * rs + k];
    }
  }
}

// dot_k: out = a @ b.T with a (R, K) and b (C, K) contiguous along K (row
// strides ars, brs), staged at row stride SP (a multiple of 4 whose quarter
// is odd: the emitter's choice).  AG / BG: the operand lies in device
// memory (staged by cp.async; the emitter checks that it is 16-byte
// aligned).  st: 16-byte aligned shared memory for R + CC rows of SP floats
// (R + 2 CC when C > CC).
template <int R, int C, int K, int CC, int SP, bool AG, bool BG>
__device__ __forceinline__ void dot_k(float* o, int ors, int ocs,
                                      const float* a, int ars,
                                      const float* b, int brs, float* st) {
  static_assert(K % 4 == 0 && SP % 4 == 0 && (SP / 4) % 2 == 1,
                "dot_k stages 16-byte rows at a conflict-free stride");
  constexpr int NC = (C + CC - 1) / CC;
  float* sa = st;
  float* sb = st + R * SP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage<K, SP, AG>(sa, a, ars, R);
  stage<K, SP, BG>(sb, b, brs, C < CC ? C : CC);
  cp_async_commit();
  for (int j = 0; j < NC; ++j) {
    if (j + 1 < NC) {
      const int n = (j + 2) * CC <= C ? CC : C - (j + 1) * CC;
      stage<K, SP, BG>(sb + ((j + 1) & 1) * CC * SP,
                       b + (long long)(j + 1) * CC * brs, brs, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bj = sb + (j & 1) * CC * SP;
    const int c0 = j * CC, nc = c0 + CC <= C ? CC : C - c0;
    if constexpr (R <= 8) {
      // a warp per output column, lanes on k, shuffles for the sum
      for (int cc = warp; cc < nc; cc += WARPS) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float bv = bj[cc * SP + k];
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(sa[r * SP + k], bv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int s = 16; s > 0; s >>= 1)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], s);
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) o[r * ors + (c0 + cc) * ocs] = acc[r];
        }
      }
    } else {
      // register micro-tiles: rows warp + 8 t, column lane (+ 32 ...)
      constexpr int TR = (R + WARPS - 1) / WARPS;
      for (int cc = lane; cc < nc; cc += 32) {
        float acc[TR];
#pragma unroll
        for (int t = 0; t < TR; ++t) acc[t] = 0.f;
        const float* bc = bj + cc * SP;
        for (int k = 0; k < K; k += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(bc + k);
#pragma unroll
          for (int t = 0; t < TR; ++t) {
            const int r = warp + WARPS * t;
            if (r < R) {
              const float4 av =
                  *reinterpret_cast<const float4*>(sa + r * SP + k);
              acc[t] = fmaf(av.x, bv.x, acc[t]);
              acc[t] = fmaf(av.y, bv.y, acc[t]);
              acc[t] = fmaf(av.z, bv.z, acc[t]);
              acc[t] = fmaf(av.w, bv.w, acc[t]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          const int r = warp + WARPS * t;
          if (r < R) o[r * ors + (c0 + cc) * ocs] = acc[t];
        }
      }
    }
    __syncthreads();
  }
}

// dot_k_sum: acc[j] = sum over the trips t0 <= i < t0 + nt of a_i @ b_j,i.T,
// with a_i = a + i * astep an (R, KT) tile at row stride ars and b_j,i =
// b[j] + i * bstep[j] a (C, KT) tile at row stride brs[j], all contiguous
// along k; acc[j] an (R, C) tile at row stride ors.  AG / BG: a / every b
// lies in device memory (staged by 16-byte cp.async; the emitter checks
// the alignment), else in shared memory (staged by plain copies).  ring:
// 16-byte aligned shared memory for ST stages of (RP + NB C) rows of
// BK + 4 floats (RP: R rounded up to 16; rows past R are zeros), which
// may overlap acc.
//
// Warp w owns the n8 column tiles w, w + 8, ... of every product and all
// RP / 16 row tiles, so each b fragment is split once and used for every
// row tile, and each a fragment once for every product.  Staged rows are
// BK + 4 floats apart, (BK + 4) / 4 odd: a fragment's 8 rows x 4 k fall
// in 32 distinct banks.
template <int R, int C, int KT, int NB, int BK, int ST, bool AG, bool BG>
__device__ __forceinline__ void dot_k_sum(
    float* const (&acc)[NB], int ors, const float* a, int ars,
    long long astep, const float* const (&b)[NB], const int (&brs)[NB],
    const long long (&bstep)[NB], int t0, int nt, float* ring) {
  constexpr int RP = (R + 15) / 16 * 16, MT = RP / 16;
  constexpr int N8 = C / 8, NW = (N8 + WARPS - 1) / WARPS;
  constexpr int SP = BK + 4, Q = BK / 4, KS = KT / BK;
  constexpr int STAGE = (RP + NB * C) * SP;
  static_assert(R >= 16 && C % 8 == 0 && BK % 8 == 0 && KT % BK == 0 &&
                    (SP / 4) % 2 == 1 && ST >= 3,
                "dot_k_sum: m16n8k8 tiles on a conflict-free ring");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int steps = nt * KS;

  // stage k-step s (trip t0 + s / KS, k-slice s % KS) into slot s % ST
  auto load = [&](int s) {
    const long long trip = t0 + s / KS;
    const int kk = (s % KS) * BK;
    float* st = ring + (s % ST) * STAGE;
    const float* as = a + trip * astep + kk;
    for (int e = threadIdx.x; e < RP * Q; e += blockDim.x) {
      const int r = e / Q, q = e - (e / Q) * Q;
      float* dst = st + r * SP + 4 * q;
      if constexpr (AG) {
        mma::cp_async16(dst, as + (long long)(r < R ? r : 0) * ars + 4 * q,
                        r < R);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[i] = r < R ? as[(long long)r * ars + 4 * q + i] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* bs = b[j] + trip * bstep[j] + kk;
      float* sb = st + (RP + j * C) * SP;
      for (int e = threadIdx.x; e < C * Q; e += blockDim.x) {
        const int c = e / Q, q = e - (e / Q) * Q;
        const float* src = bs + (long long)c * brs[j] + 4 * q;
        if constexpr (BG) {
          mma::cp_async16(sb + c * SP + 4 * q, src, true);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) sb[c * SP + 4 * q + i] = src[i];
        }
      }
    }
  };

  float c[NB][MT][NW][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) c[j][m][i][v] = 0.f;

  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) load(s);
    mma::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait<ST - 2>();  // k-step s has landed
    __syncthreads();               // ... for all, and slot (s - 1) is free
    if (s + ST - 1 < steps) load(s + ST - 1);
    mma::cp_async_commit();
    const float* sa = ring + (s % ST) * STAGE;
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* p = sa + (16 * m + g) * SP + k8 + t;
        mma::split(p[0], ah[m][0], al[m][0]);
        mma::split(p[8 * SP], ah[m][1], al[m][1]);
        mma::split(p[4], ah[m][2], al[m][2]);
        mma::split(p[8 * SP + 4], ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int n = warp + WARPS * i;
          if (N8 % WARPS == 0 || n < N8) {
            const float* p = sa + (RP + j * C + 8 * n + g) * SP + k8 + t;
            uint32_t bh[2], bl[2];
            mma::split(p[0], bh[0], bl[0]);
            mma::split(p[4], bh[1], bl[1]);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              // the tensor cores round each sum toward zero: a fresh
              // fragment per k8, added in float32, keeps that to the k8's
              // own size instead of ~1 ulp of the running sum per mma
              float t[4] = {0.f, 0.f, 0.f, 0.f};
              mma::mma_3xtf32(t, ah[m], al[m], bh, bl);
#pragma unroll
              for (int v = 0; v < 4; ++v) c[j][m][i][v] += t[v];
            }
          }
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is read out: acc may overlap it
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int n = warp + WARPS * i;
      if (N8 % WARPS == 0 || n < N8) {
        const int col = 8 * n + 2 * t;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = 16 * m + g;
          if (r < R) {
            acc[j][r * ors + col] = c[j][m][i][0];
            acc[j][r * ors + col + 1] = c[j][m][i][1];
          }
          if (r + 8 < R) {
            acc[j][(r + 8) * ors + col] = c[j][m][i][2];
            acc[j][(r + 8) * ors + col + 1] = c[j][m][i][3];
          }
        }
      }
    }
  __syncthreads();
}

// -- reductions over a row ---------------------------------------------------

// row_sum: out[r] = sum_c a[r, c]; a warp per row, lanes over columns,
// shuffles for the sum.
template <int R, int C>
__device__ __forceinline__ void row_sum(float* o, int os,
                                        const float* a, int ars, int acs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += WARPS) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += a[r * ars + c * acs];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) o[r * os] = s;
  }
  __syncthreads();
}

// row_max: out[r] = max_c a[r, c], as row_sum.
template <int R, int C>
__device__ __forceinline__ void row_max(float* o, int os,
                                        const float* a, int ars, int acs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += WARPS) {
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, a[r * ars + c * acs]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) o[r * os] = m;
  }
  __syncthreads();
}

// -- thread-block clusters ---------------------------------------------------

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cg::this_cluster().block_rank());
}

// The CS ranks of the cluster each hold a partial R x C accumulator at acc
// (strides rs, cs); this rank sums (MAX: maxes) the columns [c0, c1) of all
// partials, rank 0 first, into its own.  Call between two cluster_sync()s.
template <int R, int C, int CS, bool MAX>
__device__ __forceinline__ void cluster_combine(float* acc, int rs, int cs,
                                                int c0, int c1) {
  cg::cluster_group cl = cg::this_cluster();
  const int w = c1 - c0;
  for (int e = threadIdx.x; e < R * w; e += blockDim.x) {
    const int r = e / w, c = c0 + (e - (e / w) * w);
    float* p = acc + r * rs + c * cs;
    float s = *cl.map_shared_rank(p, 0);
    for (int q = 1; q < CS; ++q) {
      const float v = *cl.map_shared_rank(p, q);
      s = MAX ? fmaxf(s, v) : s + v;
    }
    *p = s;
  }
}

// sign as numpy defines it (0 at 0)
__device__ __forceinline__ float sign(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

}  // namespace tiles
