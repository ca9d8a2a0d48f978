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
// What bounds it on the H100: float operations (2 M K N) at the whisper
// widths; the bytes (X, Y, Z once) take a third of that time.
//
// Design: the TPU kernel takes (128 x 512) X and (512 x 128) Y tiles,
// 2 x 196 KB at whisper width.  Here a block owns a BM x BN = 64 x 64
// output tile and walks K in steps of BK = 16 (the serial K map), with
// 8.4 KB of X and gamma*Y tiles in shared memory; the four statistic
// accumulators are carried across the K steps in registers (each thread
// holds partial sums of the rows and the column it loads) and reduced
// once before the epilogue.  Each of the 256 threads computes a 4 x 4
// register tile of acc.  Ragged edges are bounds checks.  Simple first
// version: float32 FMA, no tensor cores, no TMA.
//
// Layout: x (M, K), y (K, N), z (M, N), contiguous, all float32 or all
// bfloat16; gamma and beta (K,) float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16; (ty, tx) owns rows ty + 16 i,
                              // columns tx + 16 j

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
ln_mm_fwd(const T* __restrict__ x, const T* __restrict__ y,
          const float* __restrict__ gamma, const float* __restrict__ beta,
          T* __restrict__ z, int M, int K, int N, float eps) {
  __shared__ float xs[BK][BM + 4];  // x tile, transposed
  __shared__ float yg[BK][BN];      // gamma * y tile
  __shared__ float cs[2][THREADS / BN][BN];  // partial column statistics
  __shared__ float mu_s[BM], istd_s[BM], ys_s[BN], yb_s[BN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // loader roles: x element (tid / 16 + 16 i, tid % 16) and y element
  // (tid / 64 + 4 i, tid % 64) of each tile
  const int xk = tid % BK, xm = tid / BK;
  const int yn = tid % BN, yk = tid / BN;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  float ys = 0.f, yb = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + xm + 16 * i, gk = k0 + xk;
      const float xv = gm < M && gk < K ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
      xs[xk][xm + 16 * i] = xv;
      s1[i] += xv;
      s2[i] = fmaf(xv, xv, s2[i]);
    }
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + yk + 4 * i, gn = n0 + yn;
      float yv = 0.f, g = 0.f, bt = 0.f;
      if (gk < K) {
        g = gamma[gk];
        bt = beta[gk];
        if (gn < N) yv = to_f32(y[(size_t)gk * N + gn]);
      }
      const float t = yv * g;
      yg[yk + 4 * i][yn] = t;
      ys += t;
      yb = fmaf(bt, yv, yb);
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
      for (int j = 0; j < 4; ++j) b[j] = yg[kk][tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // row statistics: the 16 threads that loaded a row are 16 neighbouring
  // lanes of one warp
  for (int i = 0; i < 4; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
    if (xk == 0) {
      const float mu = s1[i] / K;
      const float var = s2[i] / K - mu * mu;
      mu_s[xm + 16 * i] = mu;
      istd_s[xm + 16 * i] = rsqrtf(var + eps);
    }
  }
  // column statistics: four threads (yk = 0..3) per column
  cs[0][yk][yn] = ys;
  cs[1][yk][yn] = yb;
  __syncthreads();
  if (tid < BN) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < THREADS / BN; ++r) {
      a += cs[0][r][tid];
      b += cs[1][r][tid];
    }
    ys_s[tid] = a;
    yb_s[tid] = b;
  }
  __syncthreads();

  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, gm = m0 + r;
    if (gm >= M) break;
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, gn = n0 + c;
      if (gn < N)
        store(&z[(size_t)gm * N + gn],
              (acc[i][j] - mu_s[r] * ys_s[c]) * istd_s[r] + yb_s[c]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, const float* gamma,
           const float* beta, void* z, int M, int K, int N, float eps,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ln_mm_fwd<T><<<grid, THREADS, 0, stream>>>((const T*)x, (const T*)y, gamma,
                                             beta, (T*)z, M, K, N, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int layernorm_matmul_fwd(const void* x, const void* y,
                                    const void* gamma, const void* beta,
                                    void* z, int M, int K, int N, float eps,
                                    int bf16, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* b = (const float*)beta;
  if (bf16) return launch<__nv_bfloat16>(x, y, g, b, z, M, K, N, eps, st);
  return launch<float>(x, y, g, b, z, M, K, N, eps, st);
}
