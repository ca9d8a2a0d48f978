// Fused LayerNorm + matmul for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/layernorm_matmul.py
// (layernorm_matmul_pallas / _ln_mm_kernel): Z = LN_{gamma,beta}(X) Y in
// one pass over X and Y, with the affine terms folded in by linearity:
//   acc = X (gamma * Y),  s1 = rowsum(X),  s2 = rowsum(X * X),
//   ys = colsum(gamma * Y),  yb = beta Y,
//   mu = s1 / K,  var = s2 / K - mu^2  (the TPU kernel's one-pass form),
//   Z = (acc - mu * ys) * rsqrt(var + eps) + yb.
//
// What bounds it on the H100: the products (2 M K N) at whisper's encoder
// shape, the bytes (X, Y, Z once) at its decoder shape (128 rows).  The
// products run on the tensor cores with mma.sync (mma.cuh): float32 as
// m16n8k8 TF32 in 3xTF32, which keeps float32 within its 2e-4 * sqrt(K);
// bfloat16 as two m16n8k16 passes, X hi(gamma Y) + X lo(gamma Y), since
// gamma * Y is a float32 value (the reference multiplies in float32) and
// one bfloat16 rounding of it would cost 2^-9 of every term.  gamma goes
// onto Y's fragments before the split, as the reference scales Y
// (y * gamma.T), so acc and colsum(gamma Y) see the same products and
// cancel alike in acc - mu * ys.
//
// Design.  The TPU kernel holds (128 x 512) X and (512 x 128) Y tiles,
// 2 x 196 KB at whisper width, and walks K serially.  Here a block owns a
// BM x 64 output tile (BM = 128, 64 or 32 rows; BM / 32 warps along the
// rows x 2 along the columns, each warp a 32 x 32 tile of 2 x 4 mma tiles,
// 32 accumulator floats a thread) and walks its K range in steps of BK =
// 32 through a three-stage cp.async ring of X, Y, gamma and beta tiles:
// step i + 2 loads while step i is multiplied.  Zero-fill covers the
// ragged edges (M = 3000 is no multiple of the tile); where a row of X or
// Y is not a multiple of 16 bytes, or a pointer not 16-byte aligned, the
// same ring is filled by plain loads.  Each step first splits gamma * Y
// once for all the row warps into shared memory (float32: (hi, lo) TF32
// pairs; bfloat16: a hi and a lo tile, read by ldmatrix.trans), taking
// the column statistics ys, yb in the same pass; after a barrier the warps
// multiply, splitting X's fragments into hi and lo in registers, and the
// warp of each k step's turn among the column warps adds those fragments
// to the row statistics s1, s2.  A quad shuffle and one pass over the
// warps' partials finish the statistics.
//
// Where the tiles are too few to fill the 132 SMs (whisper's decoder: 128
// rows x 1536 columns, 24 tiles), the wrapper's launch_shape splits K over
// the ranks of a thread-block cluster (blockIdx.x), kslice columns each (6
// ranks of 64 there: 144 blocks): every rank stores its partial acc, s1,
// s2, ys, yb in shared memory and, after a cluster barrier, finishes one
// window of the tile's rows, summing all ranks' partials in rank order
// through distributed shared memory (deterministic, no atomics).
//
// Shared memory (dynamic), at BM = 128: the ring, 3 x 27,904 B in float32
// (3 x 15,104 B in bfloat16); the split gamma * Y, 17,408 B (9,216 B);
// the statistics' partials, 7,168 B: 108,288 B (61,696 B), two blocks an
// SM.  Row strides are padded so that the fragment loads (float32) and
// ldmatrix (bfloat16) hit distinct banks.  Registers (nvcc -Xptxas -v):
// 100 to 167 a thread, no spills.
//
// Layout: x (M, K), y (K, N), z (M, N), contiguous, all float32 or all
// bfloat16; gamma and beta (K,) float32.

#include <cooperative_groups.h>

#include <type_traits>

#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mma;

constexpr int BN = 64;        // output columns a block
constexpr int BK = 32;        // K a ring stage
constexpr int WN = 2;         // warps along the columns (32 columns each)
constexpr int MT = 2;         // 16-row mma tiles a warp
constexpr int NT = 4;         // 8-column mma tiles a warp
constexpr int NSTAGE = 3;
constexpr int MAX_CS = 8;
constexpr int YLD = BN + 8;   // staged Y row stride
constexpr int YTLD = BN + 4;  // split gamma * Y row stride ((hi, lo) pairs)
constexpr int PLD = BN + 4;   // partial output row stride (float)

// WM x WN warps of 32 x 32 output each
template <typename T, int WM>
struct Tiles {
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BM = 32 * WM;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int XLD = BK + (BF ? 8 : 4);  // staged X row stride
  static constexpr int X_BYTES = BM * XLD * (int)sizeof(T);
  static constexpr int Y_BYTES = BK * YLD * (int)sizeof(T);
  static constexpr int STAGE = X_BYTES + Y_BYTES + 2 * BK * 4;
  static constexpr int RING =
      NSTAGE * STAGE > BM * PLD * 4 ? NSTAGE * STAGE : BM * PLD * 4;
  // after the ring (or the partial output): gamma * Y of the step, split
  // (float32: (hi, lo) TF32 pairs; bfloat16: a hi and a lo tile)
  static constexpr int YT_BYTES = BF ? 2 * Y_BYTES : BK * YTLD * 8;
  // then the statistics, as floats
  static constexpr int RED_R = 0;                   // [2][WN][BM]
  static constexpr int RED_C = RED_R + 2 * WN * BM;  // [2][WM][BN]
  static constexpr int ROWS = RED_C + 2 * WM * BN;  // [2][BM] s1, s2
  static constexpr int COLS = ROWS + 2 * BM;        // [2][BN] ys, yb
  static constexpr int FIN_R = COLS + 2 * BN;       // [2][BM] mu, istd
  static constexpr int FIN_C = FIN_R + 2 * BM;      // [2][BN] ys, yb
  static constexpr int SMEM = RING + YT_BYTES + (FIN_C + 2 * BN) * 4;
};

// rows [r0, r0 + NR) x columns [c0, c0 + NC) of a (*, ld) matrix into
// shared memory at row stride SLD; zeros at rows >= rlim or columns >=
// clim.  VEC: 16-byte cp.async copies (NC and every row a multiple of 16
// bytes, the source 16-byte aligned); else plain loads.
template <typename T, bool VEC, int NR, int NC, int SLD, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int ld,
                                          int r0, int rlim, int c0,
                                          int clim) {
  const int nr = rlim - r0, nc = clim - c0;  // rows, columns in range
  const size_t base = (size_t)r0 * ld + c0;
  if constexpr (VEC) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int PER = NC / E;
#pragma unroll
    for (int e = threadIdx.x; e < NR * PER; e += THREADS) {
      const int r = e / PER, c = (e - r * PER) * E;
      const bool in = r < nr && c < nc;
      cp_async16(dst + r * SLD + c, src + (in ? base + r * ld + c : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < NR * NC; e += THREADS) {
      const int r = e / NC, c = e - r * NC;
      const bool in = r < nr && c < nc;
      dst[r * SLD + c] = in ? src[base + r * ld + c] : T(0.f);
    }
  }
}

__device__ __forceinline__ float bf_lo(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

template <typename T, int WM, bool VEC>
__global__ void __launch_bounds__(Tiles<T, WM>::THREADS, WM == 4 ? 2 : 1)
ln_mm_fwd(const T* __restrict__ x, const T* __restrict__ y,
          const float* __restrict__ gamma, const float* __restrict__ beta,
          T* __restrict__ z, int M, int K, int N, float eps, int kslice) {
  using S = Tiles<T, WM>;
  constexpr bool BF = S::BF;
  constexpr int BM = S::BM, THREADS = S::THREADS, XLD = S::XLD;
  constexpr int KPS = BF ? BK / 16 : BK / 8;  // mma k-steps a stage
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* yt = smem + S::RING;
  float* red = reinterpret_cast<float*>(yt + S::YT_BYTES);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int kb = rank * kslice, ke = min(K, kb + kslice);
  const int nsteps = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const int rw = wm * 32, cw = wn * 32;  // the warp's first row, column

  auto load_step = [&](int i, int s) {
    unsigned char* st = smem + s * S::STAGE;
    T* xs = reinterpret_cast<T*>(st);
    T* ys = reinterpret_cast<T*>(st + S::X_BYTES);
    float* gs = reinterpret_cast<float*>(st + S::X_BYTES + S::Y_BYTES);
    const int k0 = kb + i * BK;
    load_tile<T, VEC, BM, BK, XLD, THREADS>(xs, x, K, m0, M, k0, ke);
    load_tile<T, VEC, BK, BN, YLD, THREADS>(ys, y, N, k0, ke, n0, N);
    load_tile<float, VEC, 1, BK, BK, THREADS>(gs, gamma, K, 0, 1, k0, ke);
    load_tile<float, VEC, 1, BK, BK, THREADS>(gs + BK, beta, K, 0, 1, k0,
                                              ke);
  };
#pragma unroll
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < nsteps) load_step(p, p);
    cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // row statistics of rows rw + 16 mt + 8 h + g, partial over this
  // thread's k (t); column statistics of column yn, partial over this
  // thread's rows of each Y tile (yk + THREADS / BN * r)
  float s1[MT][2] = {}, s2[MT][2] = {}, cy = 0.f, cb = 0.f;
  const int yn = threadIdx.x % BN, yk = threadIdx.x / BN;

  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step i landed; step i - 1's stage is free
    if (i + NSTAGE - 1 < nsteps)
      load_step(i + NSTAGE - 1, (i + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    const unsigned char* st = smem + (i % NSTAGE) * S::STAGE;
    const T* xs = reinterpret_cast<const T*>(st);
    const T* ys = reinterpret_cast<const T*>(st + S::X_BYTES);
    const float* gs =
        reinterpret_cast<const float*>(st + S::X_BYTES + S::Y_BYTES);
    const float* bs = gs + BK;

    // gamma * Y, split once for all the row warps, and the column
    // statistics of the tile
#pragma unroll
    for (int k = yk; k < BK; k += THREADS / BN) {
      const float yv = to_f32(ys[k * YLD + yn]);
      const float v = gs[k] * yv;
      cy += v;
      cb = fmaf(bs[k], yv, cb);
      if constexpr (BF) {
        T* yth = reinterpret_cast<T*>(yt);
        const T h = __float2bfloat16(v);
        yth[k * YLD + yn] = h;
        yth[BK * YLD + k * YLD + yn] = __float2bfloat16(v - to_f32(h));
      } else {
        uint32_t h, l;
        split(v, h, l);
        reinterpret_cast<uint2*>(yt)[k * YTLD + yn] = make_uint2(h, l);
      }
    }
    __syncthreads();  // the split tile is complete

#pragma unroll
    for (int kk = 0; kk < KPS; ++kk) {
      const int j = i * KPS + kk;  // the rank's k-step: whose turn
      const bool row_turn = j % WN == wn;
      if constexpr (BF) {
        // A: X rows, pairs (2t, 2t + 1) and (2t + 8, 2t + 9)
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const T* xa = xs + (rw + 16 * mt + g) * XLD + kk * 16 + 2 * t;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(xa);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(xa + 8 * XLD);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(xa + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(xa + 8 * XLD + 8);
          if (row_turn) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v0 = bf_lo(a[mt][h]), v1 = bf_hi(a[mt][h]);
              const float v2 = bf_lo(a[mt][h + 2]), v3 = bf_hi(a[mt][h + 2]);
              s1[mt][h] += (v0 + v1) + (v2 + v3);
              s2[mt][h] += fmaf(v0, v0, v1 * v1) + fmaf(v2, v2, v3 * v3);
            }
          }
        }
        // B: hi and lo of gamma * Y, rows 2t, 2t + 1, 2t + 8, 2t + 9 of
        // column g (one ldmatrix.x4.trans: n-tiles nt and nt + 1)
        const T* yh = reinterpret_cast<const T*>(yt) +
                      (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * YLD +
                      cw + (lane >> 4) * 8;
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, yh + nt * 8);
          ldmatrix_x4_trans(bl, yh + BK * YLD + nt * 8);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][nt + h], a[mt], bl + 2 * h);
              mma_bf16(acc[mt][nt + h], a[mt], bh + 2 * h);
            }
        }
      } else {
        const float* xf = reinterpret_cast<const float*>(xs);
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* xa = xf + (rw + 16 * mt + g) * XLD + kk * 8 + t;
          const float a[4] = {xa[0], xa[8 * XLD], xa[4], xa[8 * XLD + 4]};
          if (row_turn) {
            s1[mt][0] += a[0] + a[2];
            s1[mt][1] += a[1] + a[3];
            s2[mt][0] += fmaf(a[0], a[0], a[2] * a[2]);
            s2[mt][1] += fmaf(a[1], a[1], a[3] * a[3]);
          }
          split4(a, ah[mt], al[mt]);
        }
        const uint2* ytf = reinterpret_cast<const uint2*>(yt);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int o = (kk * 8 + t) * YTLD + cw + nt * 8 + g;
          const uint2 p0 = ytf[o], p1 = ytf[o + 4 * YTLD];
          const uint32_t bh[2] = {p0.x, p1.x}, bl[2] = {p0.y, p1.y};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh, bl);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the row statistics: over the quad's k (lanes 4g .. 4g + 3), then over
  // the column warps in order; the column statistics over the row groups
  float* red_r = red + S::RED_R;
  float* red_c = red + S::RED_C;
  float* rows = red + S::ROWS;
  float* cols = red + S::COLS;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s1[mt][h] += __shfl_xor_sync(0xffffffffu, s1[mt][h], off);
        s2[mt][h] += __shfl_xor_sync(0xffffffffu, s2[mt][h], off);
      }
  }
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + 16 * mt + 8 * h + g;
        red_r[wn * BM + r] = s1[mt][h];
        red_r[(WN + wn) * BM + r] = s2[mt][h];
      }
  }
  red_c[yk * BN + yn] = cy;  // THREADS / BN = WM row groups
  red_c[(WM + yk) * BN + yn] = cb;
  __syncthreads();  // every warp is done with the ring and the split tile
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < WN; ++w) {
      a += red_r[w * BM + r];
      b += red_r[(WN + w) * BM + r];
    }
    rows[r] = a;
    rows[BM + r] = b;
  }
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < WM; ++w) {
      a += red_c[w * BN + c];
      b += red_c[(WM + w) * BN + c];
    }
    cols[c] = a;
    cols[BN + c] = b;
  }

  if (cs == 1) {
    __syncthreads();
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      const float mu = rows[r] / K;
      rows[BM + r] = rsqrtf(rows[BM + r] / K - mu * mu + eps);
      rows[r] = mu;
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rw + 16 * mt + g + 8 * (e >> 1);
          const int c = cw + 8 * nt + 2 * t + (e & 1);
          if (m0 + r < M && n0 + c < N)
            store(&z[(size_t)(m0 + r) * N + n0 + c],
                  (acc[mt][nt][e] - rows[r] * cols[c]) * rows[BM + r] +
                      cols[BN + c]);
        }
    return;
  }

  // the ranks' partials, summed in rank order through DSMEM: this rank
  // finishes rows [r0, r1) of the tile
  float* po = reinterpret_cast<float*>(smem);  // [BM][PLD]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        po[(rw + 16 * mt + g + 8 * (e >> 1)) * PLD + cw + 8 * nt + 2 * t +
           (e & 1)] = acc[mt][nt][e];
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  float* fin_r = red + S::FIN_R;
  float* fin_c = red + S::FIN_C;
  const int rpr = (BM + cs - 1) / cs;
  const int r0 = rank * rpr, r1 = min(BM, r0 + rpr);
  for (int r = r0 + threadIdx.x; r < r1; r += THREADS) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < cs; ++q) {
      a += *cl.map_shared_rank(rows + r, q);
      b += *cl.map_shared_rank(rows + BM + r, q);
    }
    const float mu = a / K;
    fin_r[r] = mu;
    fin_r[BM + r] = rsqrtf(b / K - mu * mu + eps);
  }
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < cs; ++q) {
      a += *cl.map_shared_rank(cols + c, q);
      b += *cl.map_shared_rank(cols + BN + c, q);
    }
    fin_c[c] = a;
    fin_c[BN + c] = b;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < max(r1 - r0, 0) * BN; e += THREADS) {
    const int r = r0 + e / BN, c = e % BN;
    if (m0 + r >= M || n0 + c >= N) continue;
    float s = 0.f;
    for (int q = 0; q < cs; ++q) s += *cl.map_shared_rank(po + r * PLD + c, q);
    store(&z[(size_t)(m0 + r) * N + n0 + c],
          (s - fin_r[r] * fin_c[c]) * fin_r[BM + r] + fin_c[BN + c]);
  }
  cl.sync();  // no rank leaves while another reads its partials
}

template <typename T, int WM, bool VEC>
int launch(const void* x, const void* y, const float* gamma,
           const float* beta, void* z, int M, int K, int N, float eps,
           int cs, int kslice, cudaStream_t stream) {
  using S = Tiles<T, WM>;
  auto kernel = ln_mm_fwd<T, WM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (M + S::BM - 1) / S::BM, (N + BN - 1) / BN);
  cfg.blockDim = dim3(S::THREADS, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)y, gamma,
                           beta, (T*)z, M, K, N, eps, kslice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int WM>
int dispatch_vec(const void* x, const void* y, const float* gamma,
                 const float* beta, void* z, int M, int K, int N, float eps,
                 int cs, int kslice, int vec, cudaStream_t stream) {
  if (vec)
    return launch<T, WM, true>(x, y, gamma, beta, z, M, K, N, eps, cs,
                               kslice, stream);
  return launch<T, WM, false>(x, y, gamma, beta, z, M, K, N, eps, cs,
                              kslice, stream);
}

template <typename T>
int dispatch(const void* x, const void* y, const float* gamma,
             const float* beta, void* z, int M, int K, int N, float eps,
             int bm, int cs, int kslice, int vec, cudaStream_t stream) {
  switch (bm) {
    case 128:
      return dispatch_vec<T, 4>(x, y, gamma, beta, z, M, K, N, eps, cs,
                                kslice, vec, stream);
    case 64:
      return dispatch_vec<T, 2>(x, y, gamma, beta, z, M, K, N, eps, cs,
                                kslice, vec, stream);
    case 32:
      return dispatch_vec<T, 1>(x, y, gamma, beta, z, M, K, N, eps, cs,
                                kslice, vec, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bm: rows a block (128, 64 or 32); cs: ranks of the cluster over K
// (1..8), kslice columns each (a multiple of 32, cs * kslice >= K); vec:
// every row of x and y is a multiple of 16 bytes, K of 16 bytes' floats,
// and every pointer 16-byte aligned (cp.async copies).  Returns a
// cudaError_t code: 0 when the launch was accepted.
extern "C" int layernorm_matmul_fwd(const void* x, const void* y,
                                    const void* gamma, const void* beta,
                                    void* z, int M, int K, int N, float eps,
                                    int bf16, int bm, int cs, int kslice,
                                    int vec, void* stream) {
  if (M < 1 || K < 1 || N < 1 || cs < 1 || cs > MAX_CS || kslice < BK ||
      kslice % BK != 0 || (long long)cs * kslice < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* b = (const float*)beta;
  if (bf16)
    return dispatch<__nv_bfloat16>(x, y, g, b, z, M, K, N, eps, bm, cs,
                                   kslice, vec, st);
  return dispatch<float>(x, y, g, b, z, M, K, N, eps, bm, cs, kslice, vec,
                         st);
}
