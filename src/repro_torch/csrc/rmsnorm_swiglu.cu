// Fused RMSNorm + FFN-SwiGLU for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm_swiglu.py
// (rmsnorm_swiglu_pallas / _swiglu_kernel):
//   O = (swish(RMS_g(X) W) * (RMS_g(X) V)) U,  swish(a) = a * sigmoid(a),
// with no intermediate written to device memory.
//
// What bounds it on the H100: the products (2 M D K twice for the gate
// and up projections, 2 M K N for the down projection); the bytes (X, W,
// V, U, O once) are a tenth of that time at the smollm-135m widths.  The
// products run on the tensor cores with mma.sync: bfloat16 as m16n8k16,
// float32 as m16n8k8 TF32 in 3xTF32 (mma.cuh), which keeps float32 within
// its 4e-4.
//
// Design.  The TPU kernel holds a (128, D) X panel, (D, 512) W and V tiles
// and a (128, N) accumulator on chip, some 3 MB at smollm widths, far over
// the 227 KB of shared memory a block may use.  Here a block owns BM = 32
// rows, and the d_ff axis K is split over the CS ranks of a thread-block
// cluster (blockIdx.x), KSLICE columns each (a multiple of 64): 2048 rows
// make 64 row blocks x 2 ranks = 128 blocks, and each weight byte read
// from L2 serves 32 rows (16-row blocks over the whole of K each read all
// of W, V and U: 1.36 GB of L2 traffic a call in float32, here 0.68 GB).
// Each rank recomputes its rows' RMS statistic and writes the normalised
// X panel once into shared memory in the operand's type (float32, or
// bfloat16 as the reference rounds it).  It walks its K slice in steps of
// BKF = 64: the gate/up tiles a, b (32 x 64) accumulate in registers over
// D in chunks of DC rows of W and V; h = swish(a) * b goes to shared
// memory only (in the operand's type); then the down projection adds h U,
// in chunks of KU rows of U, into the (32 x BN) output accumulator in
// registers.  16 warps, 2 along the rows x 8 along the columns: a warp
// owns 16 rows and, of h, 8 columns; of the output, 72 columns, so BN =
// 576 columns a block and 36 accumulator floats a thread.  The choice
// against the alternatives: BM = 64 under 3 warpgroups needs 96
// accumulator floats and about 170 registers a thread at 384 threads, the
// whole register file; a first version with 8 warps of 16 x 144 output
// columns, 64-row W/V chunks and three stages took 1.4x as long on the
// card (PERF.md).  A wider N is split over
// blockIdx.z, each column block recomputing h (the paper's N replication).
// At the end each rank stores its partial (32 x BN, float32) in shared
// memory and, after a cluster barrier, sums one column window of all
// ranks' partials through distributed shared memory in rank order
// (deterministic, no atomics).
//
// W/V chunks and U chunks go through one two-stage cp.async ring (16-byte
// copies, zero-filled past the edges; plain loads when a row is not a
// multiple of 16 bytes): chunk j + 1 loads while chunk j is multiplied,
// one barrier per chunk, and the first chunk flies while the RMS
// statistic is taken.  Chunks: DC = 96, KU = 16 (float32); DC = 192, KU =
// 32 (bfloat16).  Row strides are padded so that the fragment loads
// (float32) and ldmatrix (bfloat16, .trans for W, V, U) hit distinct
// banks.
//
// Shared memory at D = 576: 193,536 B (float32), 152,576 B (bfloat16):
// the X panel 32 x (DP + pad), DP = D rounded up to DC; 2 stages of
// max(2 DC x 72, KU x 584) elements; h 32 x (64 + pad).  So D <= 864
// (float32) and D <= 1728 (bfloat16); the wrapper refuses more.
// Registers (cuobjdump -res-usage, as nvcc -Xptxas -v reports them): 93 to
// 96 a thread, no stack, no spills.
//
// Layout: x (M, D), w and v (D, K), u (K, N), out (M, N), contiguous,
// all float32 or all bfloat16; gamma (D,) float32.

#include <cooperative_groups.h>

#include <type_traits>

#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mma;

constexpr int BM = 32;        // rows a block
constexpr int BKF = 64;       // d_ff columns a step
constexpr int BN = 576;       // output columns a block
constexpr int WM = 2;         // warps along the rows (16 rows each)
constexpr int WN = 8;         // warps along the columns
constexpr int THREADS = 32 * WM * WN;
constexpr int NH = BKF / WN / 8;   // h n-tiles a warp: 1
constexpr int NTW = BN / WN / 8;   // output n-tiles a warp: 9
constexpr int NSTAGE = 2;
constexpr int MAX_CS = 8;
constexpr int WLD = BKF + 8;  // staged W / V row stride
constexpr int ULD = BN + 8;   // staged U row stride
constexpr int PLD = BN + 4;   // partial output row stride (float)

// the chunks: DC rows of W and V, KU rows of U; X panel and h row padding
template <typename T>
struct Tiles {
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int DC = BF ? 192 : 96;
  static constexpr int KU = BF ? 32 : 16;
  static constexpr int PAD = BF ? 8 : 4;
  static constexpr int HLD = BKF + PAD;
  static constexpr int STAGE =
      2 * DC * WLD > KU * ULD ? 2 * DC * WLD : KU * ULD;
  __host__ __device__ static int panel(int d) { return (d + DC - 1) / DC * DC; }
};

template <typename T>
int smem_bytes(int d) {
  using S = Tiles<T>;
  const int body = (BM * (S::panel(d) + S::PAD) + NSTAGE * S::STAGE +
                    BM * S::HLD) * (int)sizeof(T);
  const int part = BM * PLD * 4;
  return body > part ? body : part;
}

// rows [r0, r0 + NR) x columns [c0, c0 + NC) of a (*, ld) matrix into
// shared memory at row stride SLD, and of a second matrix (src2, when
// given) at the same offsets into dst2; zeros at rows >= rlim or columns
// >= clim.  NC is a multiple of 16 bytes' elements.  The 64-bit base is
// taken once a tile; a copy costs a 32-bit offset.
template <typename T, bool VEC, int NR, int NC, int SLD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, T* dst2,
                                          const T* src2, int ld, int r0,
                                          int rlim, int c0, int clim) {
  const int nr = rlim - r0, nc = clim - c0;  // rows, columns in range
  const size_t base = (size_t)r0 * ld + c0;
  if constexpr (VEC) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int PER = NC / E;
#pragma unroll
    for (int e = threadIdx.x; e < NR * PER; e += THREADS) {
      const int r = e / PER, c = (e - r * PER) * E;
      const bool in = r < nr && c < nc;
      const size_t off = in ? base + r * ld + c : 0;
      cp_async16(dst + r * SLD + c, src + off, in);
      if (src2) cp_async16(dst2 + r * SLD + c, src2 + off, in);
    }
  } else {
    for (int e = threadIdx.x; e < NR * NC; e += THREADS) {
      const int r = e / NC, c = e - r * NC;
      const bool in = r < nr && c < nc;
      const size_t off = base + r * ld + c;
      dst[r * SLD + c] = in ? src[off] : T(0.f);
      if (src2) dst2[r * SLD + c] = in ? src2[off] : T(0.f);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
swiglu_fwd(const T* __restrict__ x, const T* __restrict__ w,
           const T* __restrict__ v, const T* __restrict__ u,
           const float* __restrict__ gamma, T* __restrict__ out, int M,
           int D, int K, int N, float eps, int kslice) {
  using S = Tiles<T>;
  constexpr bool BF = S::BF;
  constexpr int DC = S::DC, KU = S::KU, HLD = S::HLD, STAGE = S::STAGE;
  const int DP = S::panel(D), XLD = DP + S::PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);   // [BM][XLD]  RMS_g(x)
  T* ring = xs + BM * XLD;              // [NSTAGE][STAGE]
  T* hs = ring + NSTAGE * STAGE;        // [BM][HLD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int nvalid = min(BN, N - n0);
  const int kb = rank * kslice, ke = min(K, kb + kslice);
  const int nsteps = ke > kb ? (ke - kb + BKF - 1) / BKF : 0;
  const int nd = DP / DC;            // W / V chunks a step
  const int jps = nd + BKF / KU;     // chunks a step
  const int jobs = nsteps * jps;
  const int hw = wn * NH * 8;        // the warp's first h column
  const int nw = wn * NTW * 8;       // the warp's first output column
  const int xrow = 16 * wm + g;      // the warp's fragment row

  // chunk j of this rank: W and V rows [d0, d0 + DC) x the step's columns,
  // or U rows [k0, k0 + KU) x the block's columns
  auto load_job = [&](int j, int stage) {
    T* st = ring + stage * STAGE;
    const int s = j / jps, jj = j - s * jps;
    const int kc0 = kb + s * BKF;
    if (jj < nd)
      load_tile<T, VEC, DC, BKF, WLD>(st, w, st + DC * WLD, v, K, jj * DC, D,
                                      kc0, ke);
    else
      load_tile<T, VEC, KU, BN, ULD>(st, u, nullptr, nullptr, N,
                                     kc0 + (jj - nd) * KU, ke, n0, N);
  };
#pragma unroll
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < jobs) load_job(p, p);
    cp_async_commit();
  }

  // the RMS statistic of the block's rows and the normalised panel: a warp
  // a row, raw values first, then scaled in place
  for (int r = warp; r < BM; r += THREADS / 32) {
    const bool in = m0 + r < M;
    const T* xr = x + (size_t)(m0 + r) * D;
    float ss = 0.f;
    for (int c = lane; c < DP; c += 32) {
      const float xv = in && c < D ? to_f32(xr[c]) : 0.f;
      ss = fmaf(xv, xv, ss);
      store(&xs[r * XLD + c], xv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float ir = rsqrtf(ss / D + eps);
    __syncwarp();
    for (int c = lane; c < D; c += 32)
      store(&xs[r * XLD + c], to_f32(xs[r * XLD + c]) * ir * gamma[c]);
  }

  float ga[NH][4], ua[NH][4], acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int j = 0; j < jobs; ++j) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk j landed; chunk j - 1's stage is free
    if (j + NSTAGE - 1 < jobs)
      load_job(j + NSTAGE - 1, (j + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    const T* st = ring + (j % NSTAGE) * STAGE;
    const int jj = j % jps;

    if (jj < nd) {
      // gate / up: a += X[:, d0:d0+DC] W[d0:d0+DC, step], b likewise
      if (jj == 0) {
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) ga[n][i] = ua[n][i] = 0.f;
      }
      if constexpr (BF) {
        // one ldmatrix.x4.trans: W's b0, b1 (lanes 0-15), V's (16-31)
        const T* wv = st + (lane >> 4) * DC * WLD +
                      ((lane & 7) + ((lane >> 3) & 1) * 8) * WLD + hw;
#pragma unroll
        for (int kc = 0; kc < DC / 16; ++kc) {
          const T* xa = xs + xrow * XLD + jj * DC + kc * 16 + 2 * t;
          const uint32_t a[4] = {
              *reinterpret_cast<const uint32_t*>(xa),
              *reinterpret_cast<const uint32_t*>(xa + 8 * XLD),
              *reinterpret_cast<const uint32_t*>(xa + 8),
              *reinterpret_cast<const uint32_t*>(xa + 8 * XLD + 8)};
#pragma unroll
          for (int n = 0; n < NH; ++n) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, wv + kc * 16 * WLD + n * 8);
            mma_bf16(ga[n], a, b);
            mma_bf16(ua[n], a, b + 2);
          }
        }
      } else {
        const float* xf = reinterpret_cast<const float*>(xs);
        const float* wf = reinterpret_cast<const float*>(st);
        const float* vf = wf + DC * WLD;
#pragma unroll
        for (int kc = 0; kc < DC / 8; ++kc) {
          const float* xa = xf + xrow * XLD + jj * DC + kc * 8 + t;
          const float af[4] = {xa[0], xa[8 * XLD], xa[4], xa[8 * XLD + 4]};
          uint32_t ah[4], al[4];
          split4(af, ah, al);
#pragma unroll
          for (int n = 0; n < NH; ++n) {
            const int o = (kc * 8 + t) * WLD + hw + n * 8 + g;
            uint32_t bh[2], bl[2];
            split(wf[o], bh[0], bl[0]);
            split(wf[o + 4 * WLD], bh[1], bl[1]);
            mma_3xtf32(ga[n], ah, al, bh, bl);
            split(vf[o], bh[0], bl[0]);
            split(vf[o + 4 * WLD], bh[1], bl[1]);
            mma_3xtf32(ua[n], ah, al, bh, bl);
          }
        }
      }
      if (jj == nd - 1) {
        // h = swish(a) * b, on chip only
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = xrow + 8 * (i >> 1);
            const int col = hw + n * 8 + 2 * t + (i & 1);
            const float a = ga[n][i];
            store(&hs[row * HLD + col], a / (1.f + expf(-a)) * ua[n][i]);
          }
      }
    } else {
      // down projection: acc += h[:, k0:k0+KU] U[k0:k0+KU, block columns]
      const int k0 = (jj - nd) * KU;
      if constexpr (BF) {
        const T* ub = st + ((lane & 7) + ((lane >> 3) & 1) * 8) * ULD + nw +
                      (lane >> 4) * 8;
#pragma unroll
        for (int kc = 0; kc < KU / 16; ++kc) {
          const T* ha = hs + xrow * HLD + k0 + kc * 16 + 2 * t;
          const uint32_t a[4] = {
              *reinterpret_cast<const uint32_t*>(ha),
              *reinterpret_cast<const uint32_t*>(ha + 8 * HLD),
              *reinterpret_cast<const uint32_t*>(ha + 8),
              *reinterpret_cast<const uint32_t*>(ha + 8 * HLD + 8)};
#pragma unroll
          for (int n = 0; n < NTW; n += 2) {
            if (nw + n * 8 >= nvalid) break;
            uint32_t b[4];  // n-tiles n, n + 1 (past the warp's: padding)
            ldmatrix_x4_trans(b, ub + kc * 16 * ULD + n * 8);
            mma_bf16(acc[n], a, b);
            if (n + 1 < NTW) mma_bf16(acc[n + 1], a, b + 2);
          }
        }
      } else {
        const float* hf = reinterpret_cast<const float*>(hs);
        const float* uf = reinterpret_cast<const float*>(st);
#pragma unroll
        for (int kc = 0; kc < KU / 8; ++kc) {
          const float* ha = hf + xrow * HLD + k0 + kc * 8 + t;
          const float af[4] = {ha[0], ha[8 * HLD], ha[4], ha[8 * HLD + 4]};
          uint32_t ah[4], al[4];
          split4(af, ah, al);
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            if (nw + n * 8 >= nvalid) break;
            const int o = (kc * 8 + t) * ULD + nw + n * 8 + g;
            uint32_t bh[2], bl[2];
            split(uf[o], bh[0], bl[0]);
            split(uf[o + 4 * ULD], bh[1], bl[1]);
            mma_3xtf32(acc[n], ah, al, bh, bl);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (cs == 1) {
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + xrow + 8 * (i >> 1);
        const int col = nw + n * 8 + 2 * t + (i & 1);
        if (row < M && col < nvalid)
          store(&out[(size_t)row * N + n0 + col], acc[n][i]);
      }
    return;
  }

  // the ranks' partials, summed in rank order through DSMEM
  float* po = reinterpret_cast<float*>(smem);  // [BM][PLD]
  __syncthreads();  // every warp is done with the panel, ring and h
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      po[(xrow + 8 * (i >> 1)) * PLD + nw + n * 8 + 2 * t + (i & 1)] =
          acc[n][i];
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int cw = (nvalid + cs - 1) / cs;
  const int c0 = rank * cw, c1 = min(nvalid, c0 + cw);
  for (int e = threadIdx.x; e < BM * max(c1 - c0, 0); e += THREADS) {
    const int r = e / (c1 - c0), c = c0 + e % (c1 - c0);
    if (m0 + r >= M) continue;
    float s = 0.f;
    for (int q = 0; q < cs; ++q) s += *cl.map_shared_rank(po + r * PLD + c, q);
    store(&out[(size_t)(m0 + r) * N + n0 + c], s);
  }
  cl.sync();  // no rank leaves while another reads its partial
}

template <typename T, bool VEC>
int launch(const void* x, const void* w, const void* v, const void* u,
           const float* gamma, void* out, int M, int D, int K, int N,
           float eps, int cs, int kslice, cudaStream_t stream) {
  auto kernel = swiglu_fwd<T, VEC>;
  const int smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (M + BM - 1) / BM, (N + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)w,
                           (const T*)v, (const T*)u, gamma, (T*)out, M, D, K,
                           N, eps, kslice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* v, const void* u,
             const float* gamma, void* out, int M, int D, int K, int N,
             float eps, int cs, int kslice, int vec, cudaStream_t stream) {
  if (vec)
    return launch<T, true>(x, w, v, u, gamma, out, M, D, K, N, eps, cs,
                           kslice, stream);
  return launch<T, false>(x, w, v, u, gamma, out, M, D, K, N, eps, cs,
                          kslice, stream);
}

}  // namespace

// cs: ranks of the cluster over d_ff (1..8), kslice columns each (a
// multiple of 64, cs * kslice >= K); vec: every row of x, w, v, u is a
// multiple of 16 bytes and every pointer 16-byte aligned (cp.async copies).
// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int rmsnorm_swiglu_fwd(const void* x, const void* w,
                                  const void* v, const void* u,
                                  const void* gamma, void* out, int M, int D,
                                  int K, int N, float eps, int bf16, int cs,
                                  int kslice, int vec, void* stream) {
  if (M < 1 || D < 1 || K < 1 || N < 1 || cs < 1 || cs > MAX_CS ||
      kslice < BKF || kslice % BKF != 0 || (long long)cs * kslice < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  if (bf16)
    return dispatch<__nv_bfloat16>(x, w, v, u, g, out, M, D, K, N, eps, cs,
                                   kslice, vec, st);
  return dispatch<float>(x, w, v, u, g, out, M, D, K, N, eps, cs, kslice,
                         vec, st);
}
