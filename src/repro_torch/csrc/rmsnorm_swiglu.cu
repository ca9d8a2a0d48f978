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
// Each rank first takes its rows' RMS statistic r in a pre-pass over X (a
// warp a row).  It walks its K slice in steps of BKF = 64: the gate/up
// tiles a, b (32 x 64) accumulate in registers over D in chunks of DC
// columns of RMS_g(X) beside DC rows of W and V; h = swish(a) * b goes to
// shared memory only (in the operand's type); then the down projection
// adds h U, in chunks of KU rows of U, into the (32 x BN) output
// accumulator in registers.  Where RMS_g(X) comes from, two layouts:
//
// * the panel (PANEL, where it fits: D <= 864 in float32, D <= 1728 in
//   bfloat16): the pre-pass writes the block's 32 normalised rows once into
//   shared memory, in the operand's type, and every step reads them there;
// * streamed (any D): X is not kept on chip.  Each step streams its
//   DC-column chunks again with the weights (a quarter more bytes through
//   the ring at D = 576), so shared memory does not grow with D.  A warp
//   normalises the X values of its A fragments as it loads them.
//
// Both compute x r gamma in float32 and round it to the operand's type
// (the reference's RMS_g(x) in bfloat16) before the product, so both feed
// the products the same values; r stays out of the product's sum.  The
// wrapper takes the panel where it fits: at smollm-135m's widths the
// streamed layout took 1.11x (float32) and 1.22x (bfloat16) the panel's
// time on the card (launch/hand_variants.py, PERF.md).
// 16 warps, 2 along the rows x 8 along the columns: a warp owns 16 rows
// and, of h, 8 columns; of the output, 72 columns, so BN = 576 columns a
// block and 36 accumulator floats a thread.  The choice against the
// alternatives: BM = 64 under 3 warpgroups needs 96 accumulator floats
// and about 170 registers a thread at 384 threads, the whole register
// file; a first version with 8 warps of 16 x 144 output columns, 64-row
// W/V chunks and three stages took 1.4x as long on the card (PERF.md).  A
// wider N is split over blockIdx.z, each column block recomputing h (the
// paper's N replication).  At the end each rank stores its partial (32 x
// BN, float32) in shared memory and, after a cluster barrier, sums one
// column window of all ranks' partials through distributed shared memory
// in rank order (deterministic, no atomics).
//
// X/W/V chunks (with gamma's DC values) and U chunks go through one
// two-stage cp.async ring (16-byte copies, zero-filled past the edges;
// plain loads when a row is not a multiple of 16 bytes): chunk j + 1 loads
// while chunk j is multiplied, one barrier per chunk, and the first chunk
// flies while the RMS statistic is taken.  Chunks: DC = 96, KU = 16
// (float32); DC = 192, KU = 32 (bfloat16).  Row strides are padded so
// that the fragment loads (float32, and bfloat16 X) and ldmatrix
// (bfloat16 W, V, U, .trans) hit distinct banks.
//
// Shared memory: streamed, at any D, 145,792 B (float32), 142,464 B
// (bfloat16): 2 stages of max(2 DC x 72 + 32 x (DC + pad) + gamma's DC
// floats, KU x 584) elements; h 32 x (64 + pad); r 32 floats.  The panel
// at D = 576: 193,664 B (float32), 152,704 B (bfloat16): the panel 32 x
// (D rounded up to DC, + pad), 2 stages of max(2 DC x 72, KU x 584), h, r.
// Registers (cuobjdump -res-usage, as nvcc -Xptxas -v reports them): 93
// to 96 a thread with the panel, 96 to 110 streamed; no stack, no spills.
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

// the chunks: DC columns of X and rows of W and V, KU rows of U; the X
// chunk, panel and h row padding.  A W/V stage holds W and V and, when X
// is streamed, the X chunk (BM x XLD) and gamma's DC float32 values (GSZ
// elements of T), in that order.
template <typename T>
struct Tiles {
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int DC = BF ? 192 : 96;
  static constexpr int KU = BF ? 32 : 16;
  static constexpr int PAD = BF ? 8 : 4;
  static constexpr int XLD = DC + PAD;
  static constexpr int HLD = BKF + PAD;
  static constexpr int GSZ = DC * 4 / (int)sizeof(T);
  static constexpr int WV = 2 * DC * WLD;
  static constexpr int WVX = WV + BM * XLD + GSZ;
  static constexpr int U = KU * ULD;
  static constexpr int STAGE_PANEL = WV > U ? WV : U;
  static constexpr int STAGE_STREAMED = WVX > U ? WVX : U;
  // the resident panel's row stride: D rounded up to DC, padded
  __host__ __device__ static int panel_ld(int d) {
    return (d + DC - 1) / DC * DC + PAD;
  }
};

// the panel's share grows with D; the streamed layout's does not
template <typename T, bool PANEL>
int smem_bytes(int d) {
  using S = Tiles<T>;
  const int body = ((PANEL ? BM * S::panel_ld(d) : 0) +
                    NSTAGE * (PANEL ? S::STAGE_PANEL : S::STAGE_STREAMED) +
                    BM * S::HLD) *
                       (int)sizeof(T) +
                   BM * 4;
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

// x r g in float32, rounded to bfloat16, for the two bfloat16 values of
// a fragment register (the lower address in the low half)
__device__ __forceinline__ uint32_t norm2(uint32_t raw, float r, float2 g) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return pack_bf16(f.x * r * g.x, f.y * r * g.y);
}

template <typename T, bool VEC, bool PANEL>
__global__ void __launch_bounds__(THREADS)
swiglu_fwd(const T* __restrict__ x, const T* __restrict__ w,
           const T* __restrict__ v, const T* __restrict__ u,
           const float* __restrict__ gamma, T* __restrict__ out, int M,
           int D, int K, int N, float eps, int kslice) {
  using S = Tiles<T>;
  constexpr bool BF = S::BF;
  constexpr int DC = S::DC, KU = S::KU, XLD = S::XLD, HLD = S::HLD;
  constexpr int STAGE = PANEL ? S::STAGE_PANEL : S::STAGE_STREAMED;
  constexpr int XOFF = S::WV, GOFF = XOFF + BM * XLD;
  const int PLDX = PANEL ? S::panel_ld(D) : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [BM][PLDX]  RMS_g(x), PANEL only
  T* ring = xs + BM * PLDX;            // [NSTAGE][STAGE]
  T* hs = ring + NSTAGE * STAGE;       // [BM][HLD]
  float* rs = reinterpret_cast<float*>(hs + BM * HLD);  // [BM]  1 / rms

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int nvalid = min(BN, N - n0);
  const int kb = rank * kslice, ke = min(K, kb + kslice);
  const int nsteps = ke > kb ? (ke - kb + BKF - 1) / BKF : 0;
  const int nd = (D + DC - 1) / DC;  // X / W / V chunks a step
  const int jps = nd + BKF / KU;     // chunks a step
  const int jobs = nsteps * jps;
  const int hw = wn * NH * 8;        // the warp's first h column
  const int nw = wn * NTW * 8;       // the warp's first output column
  const int xrow = 16 * wm + g;      // the warp's fragment row

  // chunk j of this rank: W and V rows [d0, d0 + DC) x the step's
  // columns (streamed: and X columns [d0, d0 + DC) of the block's rows, and
  // gamma's); or U rows [k0, k0 + KU) x the block's columns
  auto load_job = [&](int j, int stage) {
    T* st = ring + stage * STAGE;
    const int s = j / jps, jj = j - s * jps;
    const int kc0 = kb + s * BKF;
    if (jj < nd) {
      load_tile<T, VEC, DC, BKF, WLD>(st, w, st + DC * WLD, v, K, jj * DC, D,
                                      kc0, ke);
      if constexpr (!PANEL) {
        load_tile<T, VEC, BM, DC, XLD>(st + XOFF, x, nullptr, nullptr, D, m0,
                                       M, jj * DC, D);
        load_tile<float, VEC, 1, DC, DC>(reinterpret_cast<float*>(st + GOFF),
                                         gamma, nullptr, nullptr, D, 0, 1,
                                         jj * DC, D);
      }
    } else {
      load_tile<T, VEC, KU, BN, ULD>(st, u, nullptr, nullptr, N,
                                     kc0 + (jj - nd) * KU, ke, n0, N);
    }
  };
#pragma unroll
  for (int p = 0; p < NSTAGE - 1; ++p) {
    if (p < jobs) load_job(p, p);
    cp_async_commit();
  }

  // the RMS statistic of the block's rows, a warp a row; the panel holds
  // the raw rows (zeros past D), then, scaled in place, RMS_g(x)
  for (int r = warp; r < BM; r += THREADS / 32) {
    const bool in = m0 + r < M;
    const T* xr = x + (size_t)(m0 + r) * D;
    float ss = 0.f;
    for (int c = lane; c < (PANEL ? PLDX - S::PAD : D); c += 32) {
      const float xv = in && c < D ? to_f32(xr[c]) : 0.f;
      ss = fmaf(xv, xv, ss);
      if constexpr (PANEL) store(&xs[r * PLDX + c], xv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float ir = rsqrtf(ss / D + eps);
    if (lane == 0) rs[r] = ir;
    if constexpr (PANEL) {
      __syncwarp();
      for (int c = lane; c < D; c += 32)
        store(&xs[r * PLDX + c], to_f32(xs[r * PLDX + c]) * ir * gamma[c]);
    }
  }
  __syncthreads();
  const float r0 = rs[xrow], r1 = rs[xrow + 8];  // the fragment rows'

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
      // gate / up: a += RMS_g(X)[:, d0:d0+DC] W[d0:d0+DC, step], b likewise
      if (jj == 0) {
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) ga[n][i] = ua[n][i] = 0.f;
      }
      const float* gs = reinterpret_cast<const float*>(st + GOFF);
      if constexpr (BF) {
        // one ldmatrix.x4.trans: W's b0, b1 (lanes 0-15), V's (16-31)
        const T* wv = st + (lane >> 4) * DC * WLD +
                      ((lane & 7) + ((lane >> 3) & 1) * 8) * WLD + hw;
#pragma unroll
        for (int kc = 0; kc < DC / 16; ++kc) {
          uint32_t a[4];
          if constexpr (PANEL) {
            const T* xa = xs + xrow * PLDX + jj * DC + kc * 16 + 2 * t;
            a[0] = *reinterpret_cast<const uint32_t*>(xa);
            a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * PLDX);
            a[2] = *reinterpret_cast<const uint32_t*>(xa + 8);
            a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * PLDX + 8);
          } else {
            const T* xa = st + XOFF + xrow * XLD + kc * 16 + 2 * t;
            const float2 gl =
                *reinterpret_cast<const float2*>(gs + kc * 16 + 2 * t);
            const float2 gh =
                *reinterpret_cast<const float2*>(gs + kc * 16 + 2 * t + 8);
            a[0] = norm2(*reinterpret_cast<const uint32_t*>(xa), r0, gl);
            a[1] = norm2(*reinterpret_cast<const uint32_t*>(xa + 8 * XLD), r1,
                         gl);
            a[2] = norm2(*reinterpret_cast<const uint32_t*>(xa + 8), r0, gh);
            a[3] = norm2(*reinterpret_cast<const uint32_t*>(xa + 8 * XLD + 8),
                         r1, gh);
          }
#pragma unroll
          for (int n = 0; n < NH; ++n) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, wv + kc * 16 * WLD + n * 8);
            mma_bf16(ga[n], a, b);
            mma_bf16(ua[n], a, b + 2);
          }
        }
      } else {
        const float* wf = reinterpret_cast<const float*>(st);
        const float* vf = wf + DC * WLD;
#pragma unroll
        for (int kc = 0; kc < DC / 8; ++kc) {
          float af[4];
          if constexpr (PANEL) {
            const float* xa = reinterpret_cast<const float*>(xs) +
                              xrow * PLDX + jj * DC + kc * 8 + t;
            af[0] = xa[0], af[1] = xa[8 * PLDX], af[2] = xa[4],
            af[3] = xa[8 * PLDX + 4];
          } else {
            const float* xa = reinterpret_cast<const float*>(st + XOFF) +
                              xrow * XLD + kc * 8 + t;
            const float g0 = gs[kc * 8 + t], g1 = gs[kc * 8 + t + 4];
            af[0] = xa[0] * r0 * g0, af[1] = xa[8 * XLD] * r1 * g0;
            af[2] = xa[4] * r0 * g1, af[3] = xa[8 * XLD + 4] * r1 * g1;
          }
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

template <typename T, bool VEC, bool PANEL>
int launch(const void* x, const void* w, const void* v, const void* u,
           const float* gamma, void* out, int M, int D, int K, int N,
           float eps, int cs, int kslice, cudaStream_t stream) {
  auto kernel = swiglu_fwd<T, VEC, PANEL>;
  const int smem = smem_bytes<T, PANEL>(D);
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

template <typename T, bool PANEL>
int by_vec(const void* x, const void* w, const void* v, const void* u,
           const float* gamma, void* out, int M, int D, int K, int N,
           float eps, int cs, int kslice, int vec, cudaStream_t stream) {
  if (vec)
    return launch<T, true, PANEL>(x, w, v, u, gamma, out, M, D, K, N, eps,
                                  cs, kslice, stream);
  return launch<T, false, PANEL>(x, w, v, u, gamma, out, M, D, K, N, eps, cs,
                                 kslice, stream);
}

template <typename T>
int dispatch(const void* x, const void* w, const void* v, const void* u,
             const float* gamma, void* out, int M, int D, int K, int N,
             float eps, int cs, int kslice, int vec, int panel,
             cudaStream_t stream) {
  if (panel)
    return by_vec<T, true>(x, w, v, u, gamma, out, M, D, K, N, eps, cs,
                           kslice, vec, stream);
  return by_vec<T, false>(x, w, v, u, gamma, out, M, D, K, N, eps, cs,
                          kslice, vec, stream);
}

}  // namespace

// cs: ranks of the cluster over d_ff (1..8), kslice columns each (a
// multiple of 64, cs * kslice >= K); vec: every row of x, w, v, u and
// gamma is a multiple of 16 bytes and every pointer, gamma's too, 16-byte
// aligned (cp.async copies); panel: hold the normalised X panel in shared
// memory (smem_bytes<T, true>(D) must fit) instead of streaming X.
// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int rmsnorm_swiglu_fwd(const void* x, const void* w,
                                  const void* v, const void* u,
                                  const void* gamma, void* out, int M, int D,
                                  int K, int N, float eps, int bf16, int cs,
                                  int kslice, int vec, int panel,
                                  void* stream) {
  if (M < 1 || D < 1 || K < 1 || N < 1 || cs < 1 || cs > MAX_CS ||
      kslice < BKF || kslice % BKF != 0 || (long long)cs * kslice < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  if (bf16)
    return dispatch<__nv_bfloat16>(x, w, v, u, g, out, M, D, K, N, eps, cs,
                                   kslice, vec, panel, st);
  return dispatch<float>(x, w, v, u, g, out, M, D, K, N, eps, cs, kslice,
                         vec, panel, st);
}
