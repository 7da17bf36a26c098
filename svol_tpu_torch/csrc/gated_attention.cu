// Gated sketch->video cross-attention forward, SVOL's weights-as-gate op:
//
//   q   = s Wq + bq                        (1, D)
//   k   = kin Wk + bk,  kin = mem + pos    (L, D)
//   a_h = softmax_L(q_h . k_h / sqrt(hd))  per head
//   g   = mean_h a_h                       (L,)    -> att
//   out = g * mem                          (L, D)  -> gated
//
// Replaces svol_tpu/ops/pallas/gated_attention.py::_kernel. The TPU kernel
// projects all L keys on the MXU (L D^2 multiply-adds) and reduces per head
// against a head-indicator matrix. Here the query is folded into the key
// weights first: u[:, h] = Wk[:, h] q_h and c_h = bk_h . q_h, so that
// logits[l, h] = kin[l] . u[:, h] + c_h, which is L D H multiply-adds
// instead of L D^2 and computes the same function.
//
// What bounds it on the H100: after the fold the work is ~56 MFLOP at the
// flagship shape (B = 8, L = 1568, D = 256, H = 8) against ~20 MB of
// kin/mem reads and gated writes, so it is bound by memory bytes (~6 us at
// 3.35 TB/s). This first version runs one block per batch row, so only B of
// the 132 SMs stream; it keeps the (L, H) f32 logits in shared memory (50 KB
// at the flagship shape) so the softmax over L needs no second pass, and
// reads kin and mem once each. Spreading a batch row over several blocks is
// later work (PERF.md has its time against the bound).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared memory: sketch (D) | q (D) | u (H*D, head-major) | c (H) |
//                logits (L*H) | per-warp reduction scratch (kWarps*H) | stats (2H)
__host__ __device__ inline size_t smem_floats(int L, int D, int H) {
  return (size_t)2 * D + (size_t)H * D + H + (size_t)L * H + (size_t)kWarps * H + 2 * H;
}

template <typename T, int H>
__global__ void __launch_bounds__(kBlock)
gated_attention_kernel(const T* __restrict__ sketch, const T* __restrict__ kin,
                       const T* __restrict__ mem, const float* __restrict__ wq,
                       const float* __restrict__ bq, const float* __restrict__ wk,
                       const float* __restrict__ bk, T* __restrict__ att,
                       T* __restrict__ out, int L, int D, float scale) {
  extern __shared__ float smem[];
  float* s_sk = smem;
  float* s_q = s_sk + D;
  float* s_u = s_q + D;
  float* s_c = s_u + H * D;
  float* s_logit = s_c + H;
  float* s_red = s_logit + (size_t)L * H;
  float* s_max = s_red + kWarps * H;
  float* s_sum = s_max + H;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hd = D / H;
  const T* kin_b = kin + (size_t)b * L * D;
  const T* mem_b = mem + (size_t)b * L * D;

  // (1) q = s Wq + bq, in f32
  for (int i = tid; i < D; i += kBlock) s_sk[i] = to_f(sketch[(size_t)b * D + i]);
  __syncthreads();
  for (int e = tid; e < D; e += kBlock) {
    float acc = bq[e];
    for (int d = 0; d < D; ++d) acc = fmaf(s_sk[d], wq[(size_t)d * D + e], acc);
    s_q[e] = acc;
  }
  __syncthreads();

  // (2) fold the scaled query into the key weights: u[h][d], c[h]
  for (int i = tid; i < H * D; i += kBlock) {
    const int h = i / D, d = i % D;
    const float* w = wk + (size_t)d * D + h * hd;
    const float* qh = s_q + h * hd;
    float acc = 0.f;
    for (int j = 0; j < hd; ++j) acc = fmaf(w[j], qh[j], acc);
    s_u[i] = acc * scale;
  }
  if (tid < H) {
    float acc = 0.f;
    for (int j = 0; j < hd; ++j) acc = fmaf(bk[tid * hd + j], s_q[tid * hd + j], acc);
    s_c[tid] = acc * scale;
  }
  __syncthreads();

  // (3) logits[l][h] = kin[l] . u[h] + c[h]: one warp per row, lanes over d
  float wmax[H];
#pragma unroll
  for (int h = 0; h < H; ++h) wmax[h] = -CUDART_INF_F;
  for (int l = warp; l < L; l += kWarps) {
    float acc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = 0.f;
    const T* row = kin_b + (size_t)l * D;
    for (int d = lane; d < D; d += 32) {
      const float x = to_f(row[d]);
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = fmaf(x, s_u[h * D + d], acc[h]);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], off);
      const float logit = acc[h] + s_c[h];
      wmax[h] = fmaxf(wmax[h], logit);
      if (lane == 0) s_logit[(size_t)l * H + h] = logit;
    }
  }
  // (4) per-head max over L, then exp and per-head sum
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) s_red[warp * H + h] = wmax[h];
  }
  __syncthreads();
  if (tid < H) {
    float mx = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_red[w * H + tid]);
    s_max[tid] = mx;
  }
  __syncthreads();
  float psum[H];
#pragma unroll
  for (int h = 0; h < H; ++h) psum[h] = 0.f;
  for (int l = tid; l < L; l += kBlock) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float e = expf(s_logit[(size_t)l * H + h] - s_max[h]);
      s_logit[(size_t)l * H + h] = e;
      psum[h] += e;
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) s_red[warp * H + h] = psum[h];
  }
  __syncthreads();
  if (tid < H) {
    float sm = 0.f;
    for (int w = 0; w < kWarps; ++w) sm += s_red[w * H + tid];
    s_sum[tid] = sm;
  }
  __syncthreads();

  // (5) g[l] = mean_h e[l][h] / sum[h]; g is kept in logits row l, slot 0
  for (int l = tid; l < L; l += kBlock) {
    float g = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) g += s_logit[(size_t)l * H + h] / s_sum[h];
    g *= 1.f / H;
    s_logit[(size_t)l * H] = g;
    att[(size_t)b * L + l] = from_f<T>(g);
  }
  __syncthreads();

  // (6) gated = g * mem, streamed once
  T* out_b = out + (size_t)b * L * D;
  for (int l = warp; l < L; l += kWarps) {
    const float g = s_logit[(size_t)l * H];
    const size_t base = (size_t)l * D;
    for (int d = lane; d < D; d += 32) out_b[base + d] = from_f<T>(to_f(mem_b[base + d]) * g);
  }
}

template <typename T, int H>
cudaError_t launch(const void* sketch, const void* kin, const void* mem,
                   const float* wq, const float* bq, const float* wk,
                   const float* bk, void* att, void* out, int B, int L, int D,
                   float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(L, D, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gated_attention_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  gated_attention_kernel<T, H><<<B, kBlock, bytes, stream>>>(
      static_cast<const T*>(sketch), static_cast<const T*>(kin),
      static_cast<const T*>(mem), wq, bq, wk, bk, static_cast<T*>(att),
      static_cast<T*>(out), L, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* sketch, const void* kin, const void* mem,
                     const float* wq, const float* bq, const float* wk,
                     const float* bk, void* att, void* out, int B, int L, int D,
                     int H, float scale, cudaStream_t s) {
  switch (H) {
    case 1: return launch<T, 1>(sketch, kin, mem, wq, bq, wk, bk, att, out, B, L, D, scale, s);
    case 2: return launch<T, 2>(sketch, kin, mem, wq, bq, wk, bk, att, out, B, L, D, scale, s);
    case 4: return launch<T, 4>(sketch, kin, mem, wq, bq, wk, bk, att, out, B, L, D, scale, s);
    case 8: return launch<T, 8>(sketch, kin, mem, wq, bq, wk, bk, att, out, B, L, D, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one block needs, for the wrapper's check
size_t svol_gated_attention_smem_bytes(int L, int D, int H) {
  return smem_floats(L, D, H) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (sketch, kin, mem, att, out); the four
// projection weights are float32, as the JAX module keeps them.
int svol_gated_attention(const void* sketch, const void* kin, const void* mem,
                         const void* wq, const void* bq, const void* wk,
                         const void* bk, void* att, void* out, int B, int L,
                         int D, int H, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fwq = static_cast<const float*>(wq);
  const float* fbq = static_cast<const float*>(bq);
  const float* fwk = static_cast<const float*>(wk);
  const float* fbk = static_cast<const float*>(bk);
  if (dtype == 0)
    return dispatch<float>(sketch, kin, mem, fwq, fbq, fwk, fbk, att, out, B, L, D, H, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(sketch, kin, mem, fwq, fbq, fwk, fbk, att, out, B, L, D, H, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* svol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
