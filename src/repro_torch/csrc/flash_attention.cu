// Flash attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas / _flash_kernel): softmax(scale * Q K^T) V with
// an online softmax over key tiles, an optional causal mask with a static
// query offset (query row r sits at position q_offset + r), padded keys
// masked out, masked scores set to NEG_INF = -1e30 as in the reference,
// and GQA through kv head = query head / (Hq / Hkv).
//
// What bounds it on the H100: float operations (4 * Dh per kept score
// pair) at the shapes of the prefill paths; the bytes (Q, K, V, O once)
// are a few percent of that time.  The design keeps every intermediate on
// chip: one block owns BQ query rows of one head, walks the key tiles in
// a loop (the TPU grid's serial KV dimension), holds the running max,
// denominator and output accumulator in registers, and never writes the
// score matrix to device memory.  Tiles that lie wholly past the causal
// frontier are skipped: their scores are all NEG_INF and add exactly 0.
// Ragged edges are bounds checks, not padded copies.  Simple first
// version: float32 FMA from shared memory, no tensor cores, no TMA.
//
// Layout: q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), o like q; all
// contiguous, float32 or bfloat16 (accumulation in float32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads; (ty, tx) owns rows ty + 16 i
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
          int sq, int skv, float scale, int causal, int q_offset) {
  constexpr int LD = DH + 1;   // padded stride of the Q and K tiles
  constexpr int LP = BK + 1;   // padded stride of the P tile
  constexpr int NC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][LD]
  float* ks = qs + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][DH]
  float* ps = vs + BK * DH;    // [BQ][LP]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;                       // b * Hq + h
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const T* qg = q + (size_t)bh * sq * DH;
  const T* kg = k + (size_t)kvh * skv * DH;
  const T* vg = v + (size_t)kvh * skv * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, c = e % DH;
    qs[r * LD + c] =
        q0 + r < sq ? to_f32(qg[(size_t)(q0 + r) * DH + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (skv + BK - 1) / BK;
  if (causal && q_offset >= 0) {
    // key column 0 is visible to every row, so each row has a finite
    // running max after tile 0 and later all-masked tiles add exactly 0
    const int last = q_offset + min(q0 + BQ, sq) - 1;
    n_tiles = min(n_tiles, last / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers of ks, vs, ps are done
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int r = e / DH, c = e % DH;
      const bool in = k0 + r < skv;
      const size_t g = (size_t)(k0 + r) * DH + c;
      ks[r * LD + c] = in ? to_f32(kg[g]) : 0.f;
      vs[r * DH + c] = in ? to_f32(vg[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + d];
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (col >= skv || (causal && q_offset + row < col)) val = NEG_INF;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the P tile is complete

    for (int kk = 0; kk < BK; ++kk) {
      float vv[NC];
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * DH + tx + 16 * c];
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * LP + kk];
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* og = o + (size_t)bh * sq * DH;
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    for (int c = 0; c < NC; ++c)
      store(&og[(size_t)row * DH + tx + 16 * c], acc[i][c] / l[i]);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, float scale, int causal,
           int q_offset, cudaStream_t stream) {
  const int smem =
      (int)sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH +
                            BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_fwd<T, DH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, hq, hkv, sq, skv, scale,
      causal, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int skv, int dh, float scale,
             int causal, int q_offset, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                           q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                           q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                            q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int hq,
                                   int hkv, int sq, int skv, int dh,
                                   float scale, int causal, int q_offset,
                                   int bf16, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, dh,
                                   scale, causal, q_offset, st);
  return dispatch<float>(q, k, v, o, b, hq, hkv, sq, skv, dh, scale, causal,
                         q_offset, st);
}
