// Grouped expert products of an MoE layer for Hopper (sm_90a), written by
// hand: the held experts' SwiGLU, each expert on only the rows routed to it.
//
// Replaces no TPU kernel: the reference's MoE layer (src/repro/models/
// layers.py, moe_apply) runs its experts as plain jnp einsums over a
// drop-free buffer of capacity rows an expert, outside any pallas_call.
// The port ran the same as three padded torch.bmm's, which read every held
// expert's weights and computed every capacity row, though the router
// sends a held expert about one row of a 32-row decode step.
//
// What bounds it on the H100: the touched experts' weight bytes.  A held
// expert of deepseek-v3 holds 3 x 7168 x 2048 float32 = 176 MB; at about
// one row an expert, each weight value read serves one to a few FMAs, far
// below the card's ~10 FMAs a byte.  So the design moves each touched
// expert's weights across from device memory once for all its rows (up to
// RT = 8 rows a pass), and an expert no row was routed to moves nothing.
//
// Design.  Four launches, each with fixed shapes, so a CUDA graph captures
// them once and every replay follows its own step's routing:
//
//   dispatch (one block): from the top-k ids, each held expert's row count
//            n[e] and its table of (token, k) slots in the flattened
//            (token, k) order, kept under the capacity (a warp an expert,
//            ballots over 32 ids at a time); which slots are kept; each
//            token's count of its assignments to held experts, then the
//            rows the experts compute, sum of n[e];
//   gate/up (NMAT = 2, grid of BN = 32 columns x held experts):
//            h[e, r] = swish(x_r Wg[e]) * (x_r Wu[e]) for the expert's rows
//            r < n[e], x_r the row of the token behind its table entry;
//   down    (NMAT = 1, the same grid over D): slots[table[e, r]] = h[e, r]
//            Wd[e];
//   combine (a block a token): out[t] = sum over j of w[t, j] slots[t k +
//            j] over its kept slots, j in order (a slot not kept is never
//            read, so the slots need no zeros).
//
// A gate/up or down block reads n[e] first and returns at once when it is
// 0.  Otherwise, for each tile of up to RT of its rows, it stages those
// rows' K values (chunks of KC) in shared memory and streams its weight
// columns once through the K loop: each thread owns 4 columns of one weight (a 16-byte
// load of a K row) and every KPB-th K row, keeps UNROLL loads in flight and
// accumulates its rows in registers with FFMA in full float32.  The tile's
// row count is a template argument, so a tile computes exactly its rows:
// no row is padded.  The block's K parts are summed through shared memory
// in a fixed order, so two runs give the same bits; no atomics.  The down
// pass writes each row's output into its (token, k) slot, and the combine
// sums a token's slots by its routing weights.
//
// At deepseek's widths the gate/up grid is 64 x 8 blocks and the down grid
// 224 x 8; with ~5 of 8 experts touched in a decode step, ~330 and ~1,140
// blocks stream, three resident an SM.

#include <cuda_runtime.h>

// A named namespace, so that a device trace names the kernels
// grouped_moe::dispatch, grouped_moe::grouped_fwd<2> (gate/up),
// grouped_moe::grouped_fwd<1> (down) and grouped_moe::combine.
namespace grouped_moe {

constexpr int THREADS = 256;  // 8 warps
constexpr int BN = 32;        // output columns of each weight a block
constexpr int RT = 8;         // rows a pass over the weights (row tile)
constexpr int KC = 1024;      // K values of the tile's rows staged a chunk
constexpr int UNROLL = 4;     // weight loads in flight a thread
constexpr int MAX_TK = 12288; // (token, k) assignments the dispatch holds

struct Args {
  const float* src;    // gate/up: x (T, K); down: h (count * cap, K)
  const float* w0;     // (count, K, N): Wg or Wd
  const float* w1;     // (count, K, N): Wu (gate/up only)
  const int* n;        // (count,) rows of each expert, each <= cap
  const int* table;    // (count, cap): the (token, k) slot of each row
  float* out;          // gate/up: h (count * cap, N); down: slots (T k, N)
  int K, N, cap, topk;
};

template <int NMAT>
struct Shape {
  static constexpr int LPR = NMAT * BN / 4;            // lanes a K row
  static constexpr int KPW = 32 / LPR;                 // K rows a warp
  static constexpr int KPB = KPW * (THREADS / 32);     // K rows a block
  static constexpr int COLS = NMAT * BN;               // columns a block
  static_assert(KC % (KPB * UNROLL) == 0, "chunks of whole steps");
  static_assert(KPB * RT * COLS <= RT * KC, "the K parts fit the stage");
};

__device__ __forceinline__ float swish(float g) {
  return g / (1.0f + expf(-g));
}

// One pass over the expert's weights for its rows r0 .. r0 + R - 1.
template <int NMAT, int R>
__device__ __forceinline__ void rows_pass(const Args& a, int e, int r0,
                                          float* sm, long long* s_src,
                                          long long* s_dst) {
  using S = Shape<NMAT>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane % S::LPR;             // this thread's 4 columns
  const int m = q / (BN / 4);              // of weight m
  const int col = blockIdx.x * BN + 4 * (q % (BN / 4));
  const int kpart = warp * S::KPW + lane / S::LPR;
  const bool colok = col < a.N;
  const float* wbase = (m == 0 ? a.w0 : a.w1) +
                       (long long)e * a.K * a.N + (colok ? col : 0);
  if (tid < R) {
    const long long row = (long long)e * a.cap + r0 + tid;
    const int slot = a.table[row];
    if (NMAT == 2) {
      s_src[tid] = (long long)(slot / a.topk) * a.K;
      s_dst[tid] = row * a.N;
    } else {
      s_src[tid] = row * a.K;
      s_dst[tid] = (long long)slot * a.N;
    }
  }
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;

  for (int kc = 0; kc < a.K; kc += KC) {
    __syncthreads();  // the row offsets written; the last chunk read
    const int kn = min(KC, a.K - kc);
    // the rows' chunk, row-major, zero past K
    for (int i = tid; i < R * KC; i += THREADS) {
      const int r = i / KC, kk = i % KC;
      sm[r * KC + kk] = kk < kn ? a.src[s_src[r] + kc + kk] : 0.0f;
    }
    __syncthreads();
    const float* wp = wbase + (long long)kc * a.N;
    for (int kk = kpart; kk < kn; kk += S::KPB * UNROLL) {
      float4 wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k2 = kk + u * S::KPB;
        wv[u] = (colok && k2 < kn)
                    ? __ldcs(reinterpret_cast<const float4*>(
                          wp + (long long)k2 * a.N))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k2 = kk + u * S::KPB;  // < KC: staged, zero past K
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = sm[r * KC + k2];
          acc[r][0] = fmaf(x, wv[u].x, acc[r][0]);
          acc[r][1] = fmaf(x, wv[u].y, acc[r][1]);
          acc[r][2] = fmaf(x, wv[u].z, acc[r][2]);
          acc[r][3] = fmaf(x, wv[u].w, acc[r][3]);
        }
      }
    }
  }
  __syncthreads();  // the stage is free: it holds the K parts now
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(sm + (kpart * R + r) * S::COLS + 4 * q) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  if (tid < R * BN) {
    const int r = tid / BN, c = tid % BN;
    const int gc = blockIdx.x * BN + c;
    float s[NMAT];
#pragma unroll
    for (int mm = 0; mm < NMAT; ++mm) {
      s[mm] = 0.0f;
      for (int p = 0; p < S::KPB; ++p)  // the K parts in a fixed order
        s[mm] += sm[(p * R + r) * S::COLS + mm * BN + c];
    }
    if (gc < a.N)
      a.out[s_dst[r] + gc] = NMAT == 2 ? swish(s[0]) * s[NMAT - 1] : s[0];
  }
  __syncthreads();  // the K parts and row offsets read before the next tile
}

template <int NMAT>
__global__ void __launch_bounds__(THREADS, 3) grouped_fwd(Args a) {
  __shared__ __align__(16) float sm[RT * KC];
  __shared__ long long s_src[RT], s_dst[RT];
  const int e = blockIdx.y;
  const int ne = a.n[e];
  for (int r0 = 0; r0 < ne; r0 += RT) {
    switch (min(RT, ne - r0)) {
      case 1: rows_pass<NMAT, 1>(a, e, r0, sm, s_src, s_dst); break;
      case 2: rows_pass<NMAT, 2>(a, e, r0, sm, s_src, s_dst); break;
      case 3: rows_pass<NMAT, 3>(a, e, r0, sm, s_src, s_dst); break;
      case 4: rows_pass<NMAT, 4>(a, e, r0, sm, s_src, s_dst); break;
      case 5: rows_pass<NMAT, 5>(a, e, r0, sm, s_src, s_dst); break;
      case 6: rows_pass<NMAT, 6>(a, e, r0, sm, s_src, s_dst); break;
      case 7: rows_pass<NMAT, 7>(a, e, r0, sm, s_src, s_dst); break;
      default: rows_pass<NMAT, RT>(a, e, r0, sm, s_src, s_dst); break;
    }
  }
}

constexpr int DISPATCH_THREADS = 1024;

// ids (T k) int64; outputs n, table, keep (T k) and held (T + 1) int64:
// each token's assignments to held experts, then the sum of n.
__global__ void __launch_bounds__(DISPATCH_THREADS)
dispatch(const long long* ids, int t, int k, int base, int count, int cap,
         int* n, int* table, unsigned char* keep, long long* held) {
  extern __shared__ int s_local[];  // each assignment's expert - base
  const int tk = t * k, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < tk; i += DISPATCH_THREADS) {
    s_local[i] = (int)(ids[i] - base);
    keep[i] = 0;
  }
  __syncthreads();
  // a warp an expert: its assignments in order, 32 at a time
  for (int e = warp; e < count; e += DISPATCH_THREADS / 32) {
    int c = 0;
    for (int i0 = 0; i0 < tk; i0 += 32) {
      const int i = i0 + lane;
      const bool mine = i < tk && s_local[i] == e;
      const unsigned ball = __ballot_sync(0xffffffffu, mine);
      const int slot = c + __popc(ball & ((1u << lane) - 1u));
      if (mine && slot < cap) {
        table[(long long)e * cap + slot] = i;
        keep[i] = 1;
      }
      c += __popc(ball);
    }
    for (int r = min(c, cap) + lane; r < cap; r += 32)
      table[(long long)e * cap + r] = -1;
    if (lane == 0) n[e] = min(c, cap);
  }
  __syncthreads();  // every n[e] written
  if (tid == 0) {
    long long rows = 0;
    for (int e = 0; e < count; ++e) rows += n[e];
    held[t] = rows;
  }
  for (int tok = tid; tok < t; tok += DISPATCH_THREADS) {
    long long h = 0;
    for (int j = 0; j < k; ++j) {
      const int l = s_local[tok * k + j];
      h += l >= 0 && l < count;
    }
    held[tok] = h;
  }
}

constexpr int COMBINE_THREADS = 256;

// out[t, c] = sum over j < k, kept, of w[t, j] * slots[t k + j, c], in j's
// order; a block a token, a thread 4 columns at a time.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine(const float* slots, const float* w, const unsigned char* keep,
        float* out, int k, int D) {
  const int tok = blockIdx.x;
  for (int c = 4 * threadIdx.x; c < D; c += 4 * COMBINE_THREADS) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < k; ++j) {
      const long long a = (long long)tok * k + j;
      if (!keep[a]) continue;
      const float wj = w[a];
      const float4 v = *reinterpret_cast<const float4*>(slots + a * D + c);
      acc.x = fmaf(wj, v.x, acc.x);
      acc.y = fmaf(wj, v.y, acc.y);
      acc.z = fmaf(wj, v.z, acc.z);
      acc.w = fmaf(wj, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(out + (long long)tok * D + c) = acc;
  }
}

}  // namespace grouped_moe

using namespace grouped_moe;

// x (T, D) float32; w (T, k) float32 routing weights; ids (T, k) int64
// expert ids; wg, wu (count, D, F); wd (count, F, D): the held experts
// base .. base + count - 1.  Outputs: n (count,) int32 rows of each held
// expert; table (count, cap) int32, the slot t k + j of each of an
// expert's rows, -1 past n; keep (T k) uint8; held (T + 1,) int64, each
// token's assignments to held experts, then the rows computed (sum of n);
// out (T, D) float32.  Scratch: h (count *
// cap, F), slots (T k, D).  D and F multiples of 4, T k <= MAX_TK, every
// float pointer 16-byte aligned.  Launches dispatch, gate/up, down and
// combine on ``stream``; returns the first cudaError.
extern "C" int grouped_moe_fwd(const void* x, const void* w, const void* ids,
                               const void* wg, const void* wu, const void* wd,
                               void* n, void* table, void* keep, void* held,
                               void* h, void* slots, void* out, int T, int k,
                               int base, int count, int cap, int D, int F,
                               void* stream) {
  if (T < 1 || k < 1 || T * k > MAX_TK || count < 1 || count > 65535 ||
      cap < 1 || D < 4 || F < 4 || D % 4 != 0 || F % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* nn = (int*)n;
  int* tb = (int*)table;
  unsigned char* kp = (unsigned char*)keep;
  dispatch<<<1, DISPATCH_THREADS, T * k * sizeof(int), st>>>(
      (const long long*)ids, T, k, base, count, cap, nn, tb, kp,
      (long long*)held);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args up{(const float*)x, (const float*)wg, (const float*)wu, nn, tb,
          (float*)h, D, F, cap, k};
  grouped_fwd<2><<<dim3((F + BN - 1) / BN, count), THREADS, 0, st>>>(up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args down{(const float*)h, (const float*)wd, nullptr, nn, tb,
            (float*)slots, F, D, cap, k};
  grouped_fwd<1><<<dim3((D + BN - 1) / BN, count), THREADS, 0, st>>>(down);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine<<<T, COMBINE_THREADS, 0, st>>>((const float*)slots, (const float*)w,
                                         kp, (float*)out, k, D);
  return (int)cudaGetLastError();
}
