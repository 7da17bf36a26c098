// Unmasked attention backward over (BH, L, d) tensors: given q, k, v, the
// forward's row logsumexp and the output gradient g,
//     w  = softmax(q k^T scale)          (rebuilt from the logsumexp)
//     dv = w^T g
//     dl = w * (g v^T - delta),  delta = rowsum(w * (g v^T))
//     dq = scale * dl k,  dk = scale * dl^T q
//
// Replaces the Pallas kernel svol_tpu/ops/pallas/flash_attention.py::
// _bwd_kernel (via _pallas_backward / _bwd). The TPU kernel holds one
// batch-head's whole (L, L) f32 weights tile and its (L, L) dw tile in VMEM,
// 9.8 MB each at L = 1568; a Hopper block has 227 KB of shared memory, so
// that design cannot carry over. Here nothing (L, L) exists at all:
//   * the forward kernel saves the f32 row logsumexp, so w = exp(s - lse)
//     is rebuilt one logit at a time;
//   * the row term delta is summed as the TPU kernel sums it, w * (g v^T)
//     over the keys in f32, in a first pass of the dQ kernel over the
//     key tiles. (delta = g . o from the saved output, as FlashAttention-2
//     takes it, costs that pass but not the TPU numerics: the forward
//     rounds its weights to bf16 before P.V, so o is not w v: in bf16 that
//     put dq and dk up to 5 ulps from the plain version on the card, where
//     an emulation of these rounding points with this sum stays within 1);
//   * two kernels, no atomics, deterministic: the dQ kernel (one thread
//     per query row, key/value tiles streamed through shared memory, dq in
//     registers) also writes delta; the dK/dV kernel (one thread per key
//     row, query tiles streamed, dk and dv in registers) reads it.
// Rounding follows the TPU kernel: logits from q scaled in q's dtype (the
// same fma chain as the forward kernel, so s is the forward's logit to the
// bit), w rounded to v's dtype before w^T g, dl rounded to q's dtype before
// both products, f32 accumulation, and the f32 scale applied to dq and dk
// at the end.
//
// What bounds it on the H100: 10 L^2 d operations per batch-head (the
// minimal QK^T, dV, dP, dQ and dK products; this design computes QK^T and
// g v^T three times, 18 L^2 d) against 14 L d bytes of bf16 I/O, so the
// tensor cores would make it operation-bound (~0.1 ms at L = 1568, BH =
// 128). This first version runs on the CUDA cores in f32, like the
// forward kernel; PERF.md has its time against that bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 128;   // threads per block: one query (dQ) or key (dK/dV) row each
constexpr int kTile = 64;    // rows of the streamed operand per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// fma chain over d in order 0..D-1 from 0: the forward kernel's logit
template <int D>
__device__ __forceinline__ float dot_chain(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 bv = reinterpret_cast<const float4*>(b)[d4];
    acc = fmaf(a[4 * d4 + 0], bv.x, acc);
    acc = fmaf(a[4 * d4 + 1], bv.y, acc);
    acc = fmaf(a[4 * d4 + 2], bv.z, acc);
    acc = fmaf(a[4 * d4 + 3], bv.w, acc);
  }
  return acc;
}

// load keys/values [k0, k0 + kTile) of one batch-head into shared memory
template <typename T, int D, int kStride>
__device__ __forceinline__ void load_kv_tile(const T* kb, const T* vb, float* sk,
                                             float* sv, int k0, int lk) {
  for (int i = threadIdx.x; i < kTile * D; i += kRows) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < lk;
    sk[r * kStride + c] = in ? to_f(kb[(size_t)(k0 + r) * D + c]) : 0.f;
    sv[r * kStride + c] = in ? to_f(vb[(size_t)(k0 + r) * D + c]) : 0.f;
  }
}

// dq for kRows query rows of one batch-head; also writes delta
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int lq, int lk, float scale_q,
                    float scale) {
  constexpr int kStride = D + 4;
  __shared__ __align__(16) float sk[kTile * kStride];
  __shared__ __align__(16) float sv[kTile * kStride];
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool valid = row < lq;
  const size_t qoff = ((size_t)bh * lq + row) * D;
  const T* kb = k + (size_t)bh * lk * D;
  const T* vb = v + (size_t)bh * lk * D;

  float qs[D], gr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qs[d] = valid ? round_to<T>(to_f(q[qoff + d]) * scale_q) : 0.f;
    gr[d] = valid ? to_f(g[qoff + d]) : 0.f;
    acc[d] = 0.f;
  }
  const float l = valid ? lse[(size_t)bh * lq + row] : 0.f;

  // pass 1: delta = sum_k w_k (g . v_k) in f32
  float dlt = 0.f;
  for (int k0 = 0; k0 < lk; k0 += kTile) {
    __syncthreads();
    load_kv_tile<T, D, kStride>(kb, vb, sk, sv, k0, lk);
    __syncthreads();
    const int nk = min(kTile, lk - k0);
    for (int j = 0; j < nk; ++j) {
      const float p = expf(dot_chain<D>(qs, sk + j * kStride) - l);
      dlt = fmaf(p, dot_chain<D>(gr, sv + j * kStride), dlt);
    }
  }
  if (valid) delta[(size_t)bh * lq + row] = dlt;

  // pass 2: dq
  for (int k0 = 0; k0 < lk; k0 += kTile) {
    __syncthreads();
    load_kv_tile<T, D, kStride>(kb, vb, sk, sv, k0, lk);
    __syncthreads();
    const int nk = min(kTile, lk - k0);
    for (int j = 0; j < nk; ++j) {
      const float* kr = sk + j * kStride;
      const float s = dot_chain<D>(qs, kr);
      const float p = expf(s - l);
      const float dp = dot_chain<D>(gr, sv + j * kStride);
      const float ds = round_to<T>(p * (dp - dlt));
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = reinterpret_cast<const float4*>(kr)[d4];
        acc[4 * d4 + 0] = fmaf(ds, kv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(ds, kv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(ds, kv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(ds, kv.w, acc[4 * d4 + 3]);
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[qoff + d] = from_f<T>(acc[d] * scale);
  }
}

// dk and dv for kRows key rows of one batch-head
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int lq, int lk, float scale_q,
                      float scale) {
  constexpr int kStride = D + 4;
  __shared__ __align__(16) float sqs[kTile * kStride];  // q scaled in its dtype
  __shared__ __align__(16) float sq[kTile * kStride];   // q as it is
  __shared__ __align__(16) float sg[kTile * kStride];
  __shared__ float sl[kTile], sd[kTile];
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;  // key row
  const bool valid = row < lk;
  const size_t koff = ((size_t)bh * lk + row) * D;
  const T* qb = q + (size_t)bh * lq * D;
  const T* gb = g + (size_t)bh * lq * D;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = valid ? to_f(k[koff + d]) : 0.f;
    vr[d] = valid ? to_f(v[koff + d]) : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  for (int q0 = 0; q0 < lq; q0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += kRows) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < lq;
      const float qv = in ? to_f(qb[(size_t)(q0 + r) * D + c]) : 0.f;
      sq[r * kStride + c] = qv;
      sqs[r * kStride + c] = round_to<T>(qv * scale_q);
      sg[r * kStride + c] = in ? to_f(gb[(size_t)(q0 + r) * D + c]) : 0.f;
    }
    for (int r = threadIdx.x; r < kTile; r += kRows) {
      const bool in = q0 + r < lq;
      sl[r] = in ? lse[(size_t)bh * lq + q0 + r] : 0.f;
      sd[r] = in ? delta[(size_t)bh * lq + q0 + r] : 0.f;
    }
    __syncthreads();
    const int nq = min(kTile, lq - q0);
    for (int i = 0; i < nq; ++i) {
      // the forward's logit: q_i (scaled) against this key, same fma chain
      const float* qsr = sqs + i * kStride;
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = reinterpret_cast<const float4*>(qsr)[d4];
        s = fmaf(qv.x, kr[4 * d4 + 0], s);
        s = fmaf(qv.y, kr[4 * d4 + 1], s);
        s = fmaf(qv.z, kr[4 * d4 + 2], s);
        s = fmaf(qv.w, kr[4 * d4 + 3], s);
      }
      const float p = expf(s - sl[i]);
      const float pv = round_to<T>(p);
      const float* gr = sg + i * kStride;
      const float dp = dot_chain<D>(vr, gr);
      const float ds = round_to<T>(p * (dp - sd[i]));
      const float* qr = sq + i * kStride;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 gv = reinterpret_cast<const float4*>(gr)[d4];
        const float4 qv = reinterpret_cast<const float4*>(qr)[d4];
        dva[4 * d4 + 0] = fmaf(pv, gv.x, dva[4 * d4 + 0]);
        dva[4 * d4 + 1] = fmaf(pv, gv.y, dva[4 * d4 + 1]);
        dva[4 * d4 + 2] = fmaf(pv, gv.z, dva[4 * d4 + 2]);
        dva[4 * d4 + 3] = fmaf(pv, gv.w, dva[4 * d4 + 3]);
        dka[4 * d4 + 0] = fmaf(ds, qv.x, dka[4 * d4 + 0]);
        dka[4 * d4 + 1] = fmaf(ds, qv.y, dka[4 * d4 + 1]);
        dka[4 * d4 + 2] = fmaf(ds, qv.z, dka[4 * d4 + 2]);
        dka[4 * d4 + 3] = fmaf(ds, qv.w, dka[4 * d4 + 3]);
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[koff + d] = from_f<T>(dka[d] * scale);
      dv[koff + d] = from_f<T>(dva[d]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int bh, int lq, int lk, float scale_q,
                   float scale, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  flash_bwd_dq_kernel<T, D><<<dim3((lq + kRows - 1) / kRows, bh), kRows, 0, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), lq, lk, scale_q, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((lk + kRows - 1) / kRows, bh), kRows, 0, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), lq,
      lk, scale_q, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, g, dq: (bh, lq, d); k, v, dk, dv: (bh, lk, d), all of one dtype
// (0 = float32, 1 = bfloat16); lse: (bh, lq) float32 from the forward;
// delta: (bh, lq) float32 scratch. scale_q: the scale in q's dtype (the
// forward's q * scale); scale: the f32 scale applied to dq and dk. Only
// head dim 32 is instantiated.
int svol_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* g, const void* lse, void* delta,
                             void* dq, void* dk, void* dv, int bh, int lq,
                             int lk, int d, float scale_q, float scale,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != 32 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch<float, 32>(q, k, v, g, l, dl, dq, dk, dv, bh, lq, lk, scale_q,
                             scale, s);
  return launch<__nv_bfloat16, 32>(q, k, v, g, l, dl, dq, dk, dv, bh, lq, lk,
                                   scale_q, scale, s);
}

const char* svol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
