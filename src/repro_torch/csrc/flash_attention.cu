// Flash attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas / _flash_kernel): softmax(scale * Q K^T) V with
// an online softmax over key tiles, an optional causal mask with a static
// query offset (query row r sits at position q_offset + r), padded keys
// masked out, masked scores set to NEG_INF = -1e30 as in the reference,
// and GQA through kv head = query head / (Hq / Hkv).
//
// What bounds it on the H100: the products QK^T and PV (4 Dh operations
// per kept score pair) at the prefill shapes; the bytes (Q, K, V, O once)
// are a few percent of that.  The products run on the tensor cores with
// mma.sync: bfloat16 as m16n8k16, float32 as m16n8k8 TF32 in 3xTF32 (three
// products per tile, mma.cuh), which keeps float32 within its 2e-4.
//
// Design (FlashAttention-2 layout): a warp owns 16 query rows; BQ = 16 x
// WARPS rows a block (WARPS = 4, or 1 where the query axis is short).  Q's
// fragments stay in registers for the whole kernel, the scores S (16 x 64
// a warp) and the output accumulator O (16 x Dh) too; the row max and
// denominator are reduced within each quad of lanes by shuffles; P goes
// from S's registers straight into the A operand of PV (float32: the 8
// keys of a TF32 step are taken in the order 2t, 2t + 1 of the C fragment,
// and V's rows are read in the same order).  K/V tiles of BK = 64 keys come
// through a two-stage cp.async ring: tile i + 1 loads while tile i is
// multiplied, one barrier per tile.  bfloat16 stays bfloat16 in shared
// memory and its B operands come by ldmatrix (.trans for V); float32 rows
// are padded by 4 floats so the fragment loads hit 32 distinct banks.
//
// Short query axes: the key axis is split over the SPLIT ranks of a
// thread-block cluster (blockIdx.x), CHUNK keys each (a multiple of 16);
// each rank keeps its own (m, l, O) partial, and after a cluster barrier
// each rank combines a window of the block's rows from all ranks' partials
// through distributed shared memory, in rank order (deterministic, no
// atomics).  A rank that sees no key keeps the exact-zero partial (m =
// NEG_INF, l = 0, O = 0), whose weight in the combine is exactly 0.  The
// Python wrapper's launch_shape() picks BQ, SPLIT and CHUNK.
//
// Causal tiles wholly past the block's frontier are skipped (a warp also
// skips a tile wholly past its own rows); with q_offset < 0 nothing is
// skipped, so a row with no visible key averages V as the reference does.
// Ragged edges are bounds checks (zero-filled copies), not padded inputs.
//
// Shared memory: 2 stages x (K, V) x 64 x (Dh + pad) elements: 69,632 B
// (float32) and 36,864 B (bfloat16) at Dh = 64; a split block reuses the
// ring for its partial (BQ x (Dh + 4) floats, m and l).  Registers
// (cuobjdump -res-usage): at Dh = 64, 4 warps, float32 168 (capped so
// that three blocks share an SM, with 24 B of stack), bfloat16 159; at
// Dh = 128 float32 255 with 24 B of stack, bfloat16 202; no stack
// elsewhere.
//
// Layout: q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), o like q; all
// contiguous and 16-byte aligned, float32 or bfloat16.

#include <cooperative_groups.h>

#include <type_traits>

#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mma;

constexpr int BK = 64;            // keys per tile
constexpr int MAX_SPLIT = 8;      // ranks of a cluster (portable size)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int DH>
struct Shape {
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LD = DH + (BF ? 8 : 4);  // staged row stride
  static constexpr int TILE = BK * LD;          // elements of one K/V tile
  static constexpr int RING = 2 * 2 * TILE * (int)sizeof(T);  // bytes
  static constexpr int PLD = DH + 4;            // partial O row stride
};

template <typename T, int DH, int WARPS>
int smem_bytes(int split) {
  using S = Shape<T, DH>;
  const int part = split > 1 ? (16 * WARPS * (S::PLD + 2)) * 4 : 0;
  return S::RING > part ? S::RING : part;
}

// three 4-warp blocks an SM at Dh <= 64 (the registers capped at 168)
template <typename T, int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32,
                                  (WARPS == 4 && DH <= 64) ? 3 : 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
          int sq, int skv, float scale_log2, int causal, int q_offset,
          int chunk) {
  using S = Shape<T, DH>;
  constexpr bool BF = S::BF;
  constexpr int LD = S::LD, TILE = S::TILE;
  constexpr int BQ = 16 * WARPS, THREADS = 32 * WARPS;
  constexpr int KS = BF ? 16 : 8;  // depth of one mma
  constexpr int QC = DH / KS;      // depth steps of QK^T
  constexpr int NT = BK / 8;       // score n-tiles of a warp
  constexpr int ND = DH / 8;       // output n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nsplit = gridDim.x, rank = blockIdx.x;
  const int bh = blockIdx.z;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.y * BQ;
  const int wr0 = q0 + warp * 16;    // the warp's first row
  const int r0 = wr0 + g, r1 = r0 + 8;
  const T* qg = q + (size_t)bh * sq * DH;
  const T* kg = k + (size_t)kvh * skv * DH;
  const T* vg = v + (size_t)kvh * skv * DH;

  // this rank's keys [kbeg, klim); tiles stop at the block's frontier
  const int kbeg = rank * chunk;
  const int klim = min(skv, kbeg + chunk);
  const bool skip = causal && q_offset >= 0;
  int kstop = klim;
  if (skip) kstop = min(kstop, q_offset + min(q0 + BQ, sq));
  const int n_tiles = kstop > kbeg ? (kstop - kbeg + BK - 1) / BK : 0;
  // the warp's last visible key + 1 (its rows past sq compute nothing)
  const int wstop =
      wr0 >= sq ? kbeg : (skip ? q_offset + min(wr0 + 16, sq) : klim);

  auto load_tile = [&](int tile, int stage) {
    constexpr int VEC = 16 / (int)sizeof(T);
    constexpr int PER_ROW = DH / VEC;
    const int k0 = kbeg + tile * BK;
    T* ks = ring + stage * 2 * TILE;
    T* vs = ks + TILE;
    for (int e = threadIdx.x; e < BK * PER_ROW; e += THREADS) {
      const int r = e / PER_ROW, c = (e - r * PER_ROW) * VEC;
      const bool in = k0 + r < klim;
      const size_t gi = in ? (size_t)(k0 + r) * DH + c : 0;
      cp_async16(ks + r * LD + c, kg + gi, in);
      cp_async16(vs + r * LD + c, vg + gi, in);
    }
  };

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // Q fragments, in registers for the whole kernel
  uint32_t qa[BF ? QC : 1][4];
  float qf[BF ? 1 : QC][4];
  if constexpr (BF) {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qg);
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      const int col = c * 16 + 2 * t;
      qa[c][0] = r0 < sq ? q32[((size_t)r0 * DH + col) / 2] : 0u;
      qa[c][1] = r1 < sq ? q32[((size_t)r1 * DH + col) / 2] : 0u;
      qa[c][2] = r0 < sq ? q32[((size_t)r0 * DH + col + 8) / 2] : 0u;
      qa[c][3] = r1 < sq ? q32[((size_t)r1 * DH + col + 8) / 2] : 0u;
    }
  } else {
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      const int col = c * 8 + t;
      qf[c][0] = r0 < sq ? to_f32(qg[(size_t)r0 * DH + col]) : 0.f;
      qf[c][1] = r1 < sq ? to_f32(qg[(size_t)r1 * DH + col]) : 0.f;
      qf[c][2] = r0 < sq ? to_f32(qg[(size_t)r0 * DH + col + 4]) : 0.f;
      qf[c][3] = r1 < sq ? to_f32(qg[(size_t)r1 * DH + col + 4]) : 0.f;
    }
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; tile it - 1's stage is free
    if (it + 1 < n_tiles) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int k0 = kbeg + it * BK;
    if (k0 >= wstop) continue;  // wholly past this warp's rows
    const T* ks = ring + (it & 1) * 2 * TILE;
    const T* vs = ks + TILE;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    if constexpr (BF) {
      const int key = (lane & 7) + ((lane >> 4) << 3);
      const int dcol = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int c = 0; c < QC; ++c) {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (8 * n + key) * LD + c * 16 + dcol);
          mma_bf16(s[n], qa[c], b);
          mma_bf16(s[n + 1], qa[c], b + 2);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        uint32_t ah[4], al[4];
        split4(qf[c], ah, al);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* kr = reinterpret_cast<const float*>(ks) +
                            (8 * n + g) * LD + c * 8 + t;
          uint32_t bh[2], bl[2];
          split(kr[0], bh[0], bl[0]);
          split(kr[4], bh[1], bl[1]);
          mma_3xtf32(s[n], ah, al, bh, bl);
        }
      }
    }

    // online softmax in the log2 domain; a row lives in one quad of lanes
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + 8 * n + 2 * t + (i & 1);
        const int row = i < 2 ? r0 : r1;
        float x = s[n][i] * scale_log2;
        if (col >= klim || (causal && q_offset + row < col)) x = NEG_INF;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = exp2f(m[j] - mx[j]);
      m[j] = mx[j];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[n][i] - m[i >> 1]);
        s[n][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];

    // O += P V, P from S's registers
    if constexpr (BF) {
      const int key = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int dcol = (lane >> 4) * 8;
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                         pack_bf16(s[2 * c][2], s[2 * c][3]),
                         pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                         pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (c * 16 + key) * LD + n * 8 + dcol);
          mma_bf16(acc[n], a, b);
          mma_bf16(acc[n + 1], a, b + 2);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // the TF32 step's depth index t (t + 4) is key 2t (2t + 1)
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ah[4], al[4];
        split4(pa, ah, al);
        const float* vr = reinterpret_cast<const float*>(vs) +
                          (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh[2], bl[2];
          split(vr[8 * n], bh[0], bl[0]);
          split(vr[LD + 8 * n], bh[1], bl[1]);
          mma_3xtf32(acc[n], ah, al, bh, bl);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  T* og = o + (size_t)bh * sq * DH;

  if (nsplit == 1) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = j ? r1 : r0;
      if (row >= sq) continue;
      const float inv = 1.f / l[j];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = 8 * n + 2 * t;
        store(&og[(size_t)row * DH + col], acc[n][2 * j] * inv);
        store(&og[(size_t)row * DH + col + 1], acc[n][2 * j + 1] * inv);
      }
    }
    return;
  }

  // the ranks' partials, combined in rank order through DSMEM
  constexpr int PLD = S::PLD;
  float* po = reinterpret_cast<float*>(smem);  // [BQ][PLD]
  float* pm = po + BQ * PLD;                   // [BQ]
  float* pl = pm + BQ;                         // [BQ]
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int rl = warp * 16 + g + 8 * j;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      po[rl * PLD + 8 * n + 2 * t] = acc[n][2 * j];
      po[rl * PLD + 8 * n + 2 * t + 1] = acc[n][2 * j + 1];
    }
    if (t == 0) {
      pm[rl] = m[j];
      pl[rl] = l[j];
    }
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int rw = (BQ + nsplit - 1) / nsplit;
  const int rbeg = rank * rw, rend = min(BQ, rbeg + rw);
  for (int e = threadIdx.x; e < (rend - rbeg) * DH; e += THREADS) {
    const int rl = rbeg + e / DH, c = e % DH;
    const int row = q0 + rl;
    if (row >= sq) continue;
    float mm = NEG_INF;
    for (int r = 0; r < nsplit; ++r)
      mm = fmaxf(mm, *cl.map_shared_rank(pm + rl, r));
    float den = 0.f, num = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float w = exp2f(*cl.map_shared_rank(pm + rl, r) - mm);
      den += w * *cl.map_shared_rank(pl + rl, r);
      num += w * *cl.map_shared_rank(po + rl * PLD + c, r);
    }
    store(&og[(size_t)row * DH + c], num / den);
  }
  cl.sync();  // no rank leaves while another reads its partial
}

template <typename T, int DH, int WARPS>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, float scale, int causal,
           int q_offset, int split, int chunk, cudaStream_t stream) {
  auto kernel = flash_fwd<T, DH, WARPS>;
  const int smem = smem_bytes<T, DH, WARPS>(split);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (sq + 16 * WARPS - 1) / (16 * WARPS), b * hq);
  cfg.blockDim = dim3(32 * WARPS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, (const T*)k,
                           (const T*)v, (T*)o, hq, hkv, sq, skv,
                           scale * LOG2E, causal, q_offset, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int by_rows(const void* q, const void* k, const void* v, void* o, int b,
            int hq, int hkv, int sq, int skv, float scale, int causal,
            int q_offset, int bq, int split, int chunk,
            cudaStream_t stream) {
  if (bq == 64)
    return launch<T, DH, 4>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                            q_offset, split, chunk, stream);
  if (bq == 16)
    return launch<T, DH, 1>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                            q_offset, split, chunk, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int skv, int dh, float scale,
             int causal, int q_offset, int bq, int split, int chunk,
             cudaStream_t stream) {
  switch (dh) {
    case 32:
      return by_rows<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                            q_offset, bq, split, chunk, stream);
    case 64:
      return by_rows<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                            q_offset, bq, split, chunk, stream);
    case 128:
      return by_rows<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale,
                             causal, q_offset, bq, split, chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bq: query rows a block (16 or 64); split: ranks of the cluster over the
// key axis (1..8), chunk keys each (a multiple of 16, split * chunk >= skv).
// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int hq,
                                   int hkv, int sq, int skv, int dh,
                                   float scale, int causal, int q_offset,
                                   int bf16, int bq, int split, int chunk,
                                   void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 ||
      split < 1 || split > MAX_SPLIT || chunk < 16 || chunk % 16 != 0 ||
      (long long)split * chunk < skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, dh,
                                   scale, causal, q_offset, bq, split, chunk,
                                   st);
  return dispatch<float>(q, k, v, o, b, hq, hkv, sq, skv, dh, scale, causal,
                         q_offset, bq, split, chunk, st);
}
