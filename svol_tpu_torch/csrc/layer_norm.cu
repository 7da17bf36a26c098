// Row LayerNorm forward: y = (x - mean) * rsqrt(var + eps) * w + b over the
// last axis, statistics in f32, output in x's dtype.
//
// Replaces the Pallas kernel svol_tpu/ops/pallas/layer_norm.py::_kernel
// (via `fused_layer_norm`). On the TPU one grid step holds a (512, D) block
// in VMEM and reduces along the lane axis. On Hopper a row of the ViT's
// D = 768 fits one warp's registers (24 values a lane), so one warp owns one
// row: it reads the row once with 16-byte loads, reduces the sum and then
// the sum of squared deviations with shuffles (the two-pass mean and biased
// variance of `layer_norm_reference`, no E[x^2] - E[x]^2 cancellation), and
// writes the row once. Nothing else touches device memory but the f32
// weight and bias (3 KB, L2-resident).
//
// What bounds it on the H100: bytes. At the ViT video shape (256 frames x
// 197 tokens = 50,432 rows of 768) in bf16 it reads and writes 77.5 MB each,
// ~0.046 ms at 3.35 TB/s, against ~10 f32 operations per element. Eight
// warps a block, one row each: 6,304 blocks at that shape.
//
// Rounding points follow the Pallas kernel: mean = sum / D, var = sum of
// (x - mean)^2 / D, then (x - mean) * r, times w, plus b, each an f32
// operation (no fused multiply-add, so the products round where the
// reference rounds them), and one cast to x's dtype. rsqrtf is within two
// ulps of 1 / sqrt.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;                 // rows per block
constexpr int kMaxPerLane = 32;           // D <= 32 * 32 = 1024

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// V: values per 16-byte vector (4 f32, 8 bf16). Lane l holds vectors
// l, l + 32, ... of its row; rows have stride ld elements.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y, int rows,
                  int d, long long ld, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecs = kMaxPerLane / V;  // vectors a lane may hold
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int nvec = d / V;
  const T* xr = x + (size_t)row * ld;

  float v[kVecs * V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int vec = lane + 32 * i;
    if (vec < nvec) {
      load_vec(xr + vec * V, v + i * V);
#pragma unroll
      for (int j = 0; j < V; ++j) sum += v[i * V + j];
    }
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)d);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = __fsub_rn(v[i * V + j], mean);
        v[i * V + j] = c;
        sq = __fadd_rn(sq, __fmul_rn(c, c));
      }
    }
  }
  const float var = __fdiv_rn(warp_sum(sq), (float)d);
  const float r = rsqrtf(__fadd_rn(var, eps));

  T* yr = y + (size_t)row * d;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int vec = lane + 32 * i;
    if (vec < nvec) {
      float out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = vec * V + j;
        out[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i * V + j], r), w[col]), b[col]);
      }
      store_vec(yr + vec * V, out);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* b, void* y,
                   int rows, int d, long long ld, float eps, cudaStream_t s) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  layer_norm_kernel<T><<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), rows, d, ld, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: rows of d values, row stride ld elements (16-byte aligned rows);
// w, b: (d,) float32; y: (rows, d) contiguous. dtype: 0 = float32,
// 1 = bfloat16. d must be a multiple of 16 bytes' worth of values and at
// most 1024.
int svol_layer_norm(const void* x, const void* w, const void* b, void* y,
                    int rows, int d, long long ld, float eps, int dtype,
                    void* stream) {
  const int v = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || d <= 0 || d > 32 * kMaxPerLane || d % v ||
      ld % v || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  return dtype == 0 ? launch<float>(x, wf, bf, y, rows, d, ld, eps, s)
                    : launch<__nv_bfloat16>(x, wf, bf, y, rows, d, ld, eps, s);
}

const char* svol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
