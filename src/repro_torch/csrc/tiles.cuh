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
