// Unmasked attention forward, softmax(q k^T scale) v over (BH, L, d) tensors.
//
// Replaces the Pallas kernels of svol_tpu/ops/pallas/flash_attention.py:
// `_kernel` (the video self-attention, L = 1568) and `_kernel_packed` (the
// query self-attention, L = 320). On the TPU one grid step holds a whole
// (BQ, L) f32 logits tile in VMEM; on Hopper 64 rows of a 1568-wide f32 row
// are 401 KB, above the 227 KB a block may use. So K/V stream through shared
// memory in 64-key tiles and each query row keeps an online softmax (running
// max, running sum, rescaled f32 accumulator). Logits never reach device
// memory: traffic is q/k/v read once per query tile and o written once.
//
// What bounds it on the H100: at d = 32 the work is 4 L^2 d operations per
// batch-head against 8 L d bytes of bf16 I/O, so the tensor cores would make
// it operation-bound near 20 us at the flagship shape. This first version
// runs on the CUDA cores in f32 (one FMA per multiply-add, ~15x slower than
// the bf16 tensor-core peak); it is kept simple and exact, and the timings in
// PERF.md say how far it is from its bound.
//
// Design: one thread owns one query row (TPR = 1) or a quarter of one (TPR =
// 4, for short L: with one thread per row L = 320 gives only 5 warps per SM,
// so four threads split each key tile and merge their partial softmax states
// with warp shuffles at the end). q is scaled in q's dtype before the dot
// (`q * scale`, flash_attention.py:64) and the unnormalized weights are
// rounded to v's dtype before P.V (:75); statistics and sums stay f32.
// When the autograd path asks for it (lse != nullptr), each row's f32
// logsumexp m + log(l) is written too: the backward kernels
// (flash_attention_bwd.cu) rebuild the softmax from it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 128;  // threads per block
constexpr int kTileK = 64;   // keys per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round an f32 value to T's precision and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kBlock)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int lq, int lk, float scale) {
  constexpr int kRows = kBlock / TPR;          // query rows per block
  constexpr int kKeysPerThread = kTileK / TPR;
  constexpr int kStride = D + 4;               // pad: TPR lanes read 4 rows apart
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float sk[kTileK * kStride];
  __shared__ __align__(16) float sv[kTileK * kStride];

  const int bh = blockIdx.y;
  const int part = threadIdx.x % TPR;
  const int row = blockIdx.x * kRows + threadIdx.x / TPR;
  const bool valid = row < lq;
  const T* qb = q + (size_t)bh * lq * D;
  const T* kb = k + (size_t)bh * lk * D;
  const T* vb = v + (size_t)bh * lk * D;

  // rows past lq compute on zeros so every lane reaches the shuffles below
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = valid ? round_to<T>(to_f(qb[(size_t)row * D + d]) * scale) : 0.f;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kTileK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTileK * D; i += kBlock) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < lk;
      sk[r * kStride + c] = in ? to_f(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      sv[r * kStride + c] = in ? to_f(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();
    const int nk = min(kTileK, lk - k0);

    float s[kKeysPerThread];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) {
      const int j = jj * TPR + part;
      const float4* kr = reinterpret_cast<const float4*>(sk + j * kStride);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kv.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
      }
      s[jj] = j < nk ? dot : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -CUDART_INF_F) continue;  // no key of this thread yet
    const float alpha = expf(m - m_new);   // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) {
      const int j = jj * TPR + part;
      const float p = expf(s[jj] - m_new);
      l += p;
      const float pv = round_to<T>(p);
      const float4* vr = reinterpret_cast<const float4*>(sv + j * kStride);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(pv, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(pv, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(pv, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(pv, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  // merge the TPR partial states of a row (adjacent lanes of one warp)
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_n = fmaxf(m, m_o);
    const float a = m == -CUDART_INF_F ? 0.f : expf(m - m_n);
    const float b = m_o == -CUDART_INF_F ? 0.f : expf(m_o - m_n);
    l = l * a + l_o * b;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * a + acc_o * b;
    }
    m = m_n;
  }

  if (valid) {
    const float inv = 1.f / l;
    T* orow = o + ((size_t)bh * lq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d / (D / TPR) == part) orow[d] = from_f<T>(acc[d] * inv);
    if (lse != nullptr && part == 0) lse[(size_t)bh * lq + row] = m + logf(l);
  }
}

template <typename T, int D, int TPR>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int lq, int lk, float scale,
                   cudaStream_t stream) {
  constexpr int kRows = kBlock / TPR;
  dim3 grid((lq + kRows - 1) / kRows, bh);
  flash_fwd_kernel<T, D, TPR><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, lq, lk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. tpr: threads per query row (1 or 4).
// lse: (bh, lq) float32 row logsumexp output, or null. Only head dim 32
// (the flagship's 256 / 8) is instantiated.
int svol_flash_attention(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int lq, int lk, int d, float scale,
                         int dtype, int tpr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != 32 || (tpr != 1 && tpr != 4) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return tpr == 1 ? launch<float, 32, 1>(q, k, v, o, l, bh, lq, lk, scale, s)
                    : launch<float, 32, 4>(q, k, v, o, l, bh, lq, lk, scale, s);
  return tpr == 1 ? launch<__nv_bfloat16, 32, 1>(q, k, v, o, l, bh, lq, lk, scale, s)
                  : launch<__nv_bfloat16, 32, 4>(q, k, v, o, l, bh, lq, lk, scale, s);
}

const char* svol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
