// Fused RMSNorm + FFN-SwiGLU for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm_swiglu.py
// (rmsnorm_swiglu_pallas / _swiglu_kernel):
//   O = (swish(RMS_g(X) W) * (RMS_g(X) V)) U,  swish(a) = a * sigmoid(a),
// with the RMS statistic taken once per row block over the whole of D and
// no intermediate written to device memory.
//
// What bounds it on the H100: float operations (2 M D K twice for the
// gate and up projections, 2 M K N for the down projection); the bytes
// (X, W, V, U, O once) are a tenth of that time at the smollm-135m widths.
//
// Design, and the N/K trade-off of the paper: the TPU kernel holds a
// (128, D) X panel, (D, 512) W and V tiles and a (128, N) accumulator on
// chip, some 3 MB at smollm widths, far over the 227 KB of shared memory
// a block may use.  Here a block owns BM = 16 rows: their normalised rows
// (BM x D, float32) stay in shared memory for the whole kernel, the
// d_ff dimension K is streamed in steps of BK = 64 (the serial K map),
// W and V come in (DC = 32) x BK tiles, the h tile swish(a) * b (BM x BK)
// lives in shared memory only, and the (BM x N) output accumulator lives
// in registers, NPT = 4 columns of all BM rows per thread.  So one block
// covers N <= 1024 with no recomputation of h (the paper's N = 1); a wider
// N is split over blockIdx.y, each column block recomputing h (N
// replication).  Shared memory: 4 * (BM * D + 2 * DC * BK + BM * BK + BM)
// bytes, 57,408 at D = 576.  Simple first version: float32 FMA, no tensor
// cores, no TMA.
//
// Layout: x (M, D), w and v (D, K), u (K, N), out (M, N), contiguous,
// all float32 or all bfloat16; gamma (D,) float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 16;        // rows per block
constexpr int BK = 64;        // d_ff columns per step of the K loop
constexpr int DC = 32;        // rows of D per staged W / V tile
constexpr int THREADS = 256;
constexpr int NPT = 4;        // output columns per thread
constexpr int BN = NPT * THREADS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
swiglu_fwd(const T* __restrict__ x, const T* __restrict__ w,
           const T* __restrict__ v, const T* __restrict__ u,
           const float* __restrict__ gamma, T* __restrict__ out, int M,
           int D, int K, int N, float eps) {
  extern __shared__ float smem[];
  float* xs = smem;              // [BM][D]  RMS_g(x), float32
  float* ws = xs + BM * D;       // [DC][BK]
  float* vsm = ws + DC * BK;     // [DC][BK]
  float* hs = vsm + DC * BK;     // [BM][BK]
  float* irms = hs + BM * BK;    // [BM]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D;
    xs[e] = m0 + r < M ? to_f32(x[(size_t)m0 * D + e]) : 0.f;
  }
  __syncthreads();
  for (int r = warp; r < BM; r += THREADS / 32) {
    float ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float t = xs[r * D + c];
      ss = fmaf(t, t, ss);
    }
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) irms[r] = rsqrtf(ss / D + eps);
  }
  __syncthreads();
  for (int e = tid; e < BM * D; e += THREADS)
    xs[e] = xs[e] * gamma[e % D] * irms[e / D];

  // gate/up: thread owns rows hr and hr + 8, columns hc and hc + 1 of h
  const int hr = tid / 32, hc = (tid % 32) * 2;
  float acc[BM][NPT];
  for (int r = 0; r < BM; ++r)
    for (int j = 0; j < NPT; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    float a[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float b[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int d0 = 0; d0 < D; d0 += DC) {
      // also orders the previous step's reads of hs before its rewrite
      __syncthreads();
      for (int e = tid; e < DC * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const bool in = d0 + r < D && k0 + c < K;
        const size_t g = (size_t)(d0 + r) * K + k0 + c;
        ws[e] = in ? to_f32(w[g]) : 0.f;
        vsm[e] = in ? to_f32(v[g]) : 0.f;
      }
      __syncthreads();
      const int dn = min(DC, D - d0);
      for (int dd = 0; dd < dn; ++dd) {
        const float x0 = xs[hr * D + d0 + dd];
        const float x1 = xs[(hr + 8) * D + d0 + dd];
        const float2 wv = *reinterpret_cast<const float2*>(&ws[dd * BK + hc]);
        const float2 vv = *reinterpret_cast<const float2*>(&vsm[dd * BK + hc]);
        a[0][0] = fmaf(x0, wv.x, a[0][0]);
        a[0][1] = fmaf(x0, wv.y, a[0][1]);
        a[1][0] = fmaf(x1, wv.x, a[1][0]);
        a[1][1] = fmaf(x1, wv.y, a[1][1]);
        b[0][0] = fmaf(x0, vv.x, b[0][0]);
        b[0][1] = fmaf(x0, vv.y, b[0][1]);
        b[1][0] = fmaf(x1, vv.x, b[1][0]);
        b[1][1] = fmaf(x1, vv.y, b[1][1]);
      }
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        const float g = a[i][j];
        hs[(hr + 8 * i) * BK + hc + j] = g * (1.f / (1.f + expf(-g))) * b[i][j];
      }
    __syncthreads();  // the h tile is complete

    // down projection: thread owns columns n0 + tid + THREADS * j
    const int kn = min(BK, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float uu[NPT];
      for (int j = 0; j < NPT; ++j) {
        const int n = n0 + tid + THREADS * j;
        uu[j] = n < N ? to_f32(u[(size_t)(k0 + kk) * N + n]) : 0.f;
      }
      for (int r = 0; r < BM; ++r) {
        const float h = hs[r * BK + kk];
        for (int j = 0; j < NPT; ++j) acc[r][j] = fmaf(h, uu[j], acc[r][j]);
      }
    }
  }

  for (int r = 0; r < BM; ++r) {
    if (m0 + r >= M) break;
    for (int j = 0; j < NPT; ++j) {
      const int n = n0 + tid + THREADS * j;
      if (n < N) store(&out[(size_t)(m0 + r) * N + n], acc[r][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* v, const void* u,
           const float* gamma, void* out, int M, int D, int K, int N,
           float eps, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (BM * D + 2 * DC * BK + BM * BK + BM);
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  swiglu_fwd<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w, (const T*)v, (const T*)u, gamma, (T*)out, M,
      D, K, N, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int rmsnorm_swiglu_fwd(const void* x, const void* w,
                                  const void* v, const void* u,
                                  const void* gamma, void* out, int M, int D,
                                  int K, int N, float eps, int bf16,
                                  void* stream) {
  if (M < 1 || D < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  if (bf16)
    return launch<__nv_bfloat16>(x, w, v, u, g, out, M, D, K, N, eps, st);
  return launch<float>(x, w, v, u, g, out, M, D, K, N, eps, st);
}
