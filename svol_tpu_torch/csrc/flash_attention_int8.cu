// Unmasked int8 attention forward over (BH, L, d) int8 tensors, for serving.
//
// Replaces the Pallas kernel `_kernel_int8_runtime_scale` of
// svol_tpu/ops/pallas/flash_attention.py. Per query row, with q, k, v
// already quantized per tensor (the wrapper, flash_attention_int8.py):
//   l = q k^T (int32); s = f32(l) * logit_scale; m = max s; e = exp(s - m);
//   denom = sum e; wq = round(e * 127) (int8); out = f32(wq v) / (127 denom).
// The wrapper then multiplies by v's scale.
//
// No online softmax: the weights are rounded to int8 against the row's
// final maximum (e = 1 there, so the step is the static 1/127), and an
// int8 weight rounded against an earlier maximum cannot be rescaled. So the
// kernel makes two passes over the key tiles: the first finds the row's
// largest int32 logit (s is monotone in l, since logit_scale > 0, so
// max s = f32(max l) * logit_scale exactly), the second computes e, denom,
// wq and the int32 accumulator. QK in int8 is cheap to compute twice. The
// f32 logits never reach device memory; a 1568-wide row for 64 query rows
// would be 401 KB, above a block's 227 KB.
//
// What bounds it on the H100: per batch-head L^2 exponentials on the
// multi-function units (16 a clock per SM) against 4 L^2 d int8 operations
// on the tensor cores (1,979 TOP/s) and 3 L d + 4 L d bytes of I/O; at the
// flagship's L = 1568, BH = 64 the exponentials bound it (chip_smoke.py
// computes all three). This first version runs the integer products on the
// CUDA cores with __dp4a (four int8 products summed into an int32 per
// instruction): 8 for a logit, and for P.V one per head-dim column per four
// keys, with v's tile held transposed in shared memory so that four keys'
// values of one column form one 32-bit word. Shared memory is read 16
// bytes at a time, as broadcasts: every thread of a block reads the same
// key at the same time. Exact: int32 sums of int8
// products, rintf (round half to even, as jnp.round) for wq, expf.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kRows = 64;    // threads per block, one query row each
constexpr int kTileK = 64;   // keys per shared-memory tile
constexpr int kD = 32;       // head dim
constexpr int kW = kD / 4;   // 32-bit words of a q/k row

// four int8 values, the first in the lowest byte
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>((static_cast<unsigned>(a) & 0xffu)
                          | ((static_cast<unsigned>(b) & 0xffu) << 8)
                          | ((static_cast<unsigned>(c) & 0xffu) << 16)
                          | ((static_cast<unsigned>(d) & 0xffu) << 24));
}

__global__ void __launch_bounds__(kRows)
flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const int8_t* __restrict__ v,
                  const float* __restrict__ logit_scale, float* __restrict__ o,
                  int lq, int lk) {
  // every thread of a block reads the same key's words at once
  // (broadcasts), 16 bytes at a time
  __shared__ __align__(16) int sk[kTileK][kW];
  // sv[g][c]: column c of keys 4g .. 4g+3, one int8 each
  __shared__ __align__(16) int sv[kTileK / 4][kD];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool valid = row < lq;
  const int* kb = reinterpret_cast<const int*>(k + (size_t)bh * lk * kD);
  const int8_t* vb = v + (size_t)bh * lk * kD;
  const float ls = *logit_scale;

  int qr[kW];
  const int* qrow = reinterpret_cast<const int*>(q + ((size_t)bh * lq + row) * kD);
#pragma unroll
  for (int w = 0; w < kW; ++w) qr[w] = valid ? qrow[w] : 0;

  auto load_k = [&](int k0) {
    for (int i = threadIdx.x; i < kTileK * kW; i += kRows) {
      const int r = i / kW, w = i % kW;
      sk[r][w] = k0 + r < lk ? kb[(size_t)(k0 + r) * kW + w] : 0;
    }
  };
  auto dot = [&](int j) {
    const int4* kr = reinterpret_cast<const int4*>(sk[j]);
    int acc = 0;
#pragma unroll
    for (int w4 = 0; w4 < kW / 4; ++w4) {
      const int4 kk = kr[w4];
      acc = __dp4a(qr[4 * w4], kk.x, acc);
      acc = __dp4a(qr[4 * w4 + 1], kk.y, acc);
      acc = __dp4a(qr[4 * w4 + 2], kk.z, acc);
      acc = __dp4a(qr[4 * w4 + 3], kk.w, acc);
    }
    return acc;
  };

  // pass 1: the row's largest int32 logit
  int lmax = INT_MIN;
  for (int k0 = 0; k0 < lk; k0 += kTileK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    const int nk = min(kTileK, lk - k0);
    for (int j = 0; j < nk; ++j) lmax = max(lmax, dot(j));
  }
  const float m = static_cast<float>(lmax) * ls;

  // pass 2: e, denom, int8 weights and the int32 P.V accumulator
  int acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] = 0;
  float denom = 0.f;
  for (int k0 = 0; k0 < lk; k0 += kTileK) {
    __syncthreads();
    load_k(k0);
    for (int i = threadIdx.x; i < (kTileK / 4) * kD; i += kRows) {
      const int g = i / kD, c = i % kD;
      int b[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int key = k0 + 4 * g + t;
        b[t] = key < lk ? vb[(size_t)key * kD + c] : 0;
      }
      sv[g][c] = pack4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
    const int nk = min(kTileK, lk - k0);
    for (int g = 0; g < (nk + 3) / 4; ++g) {
      int wq[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * g + t;
        wq[t] = 0;
        if (j < nk) {
          // product and difference rounded apart, as the JAX kernel takes
          // them (no contraction into one fma)
          const float e = expf(__fsub_rn(__fmul_rn(static_cast<float>(dot(j)), ls), m));
          denom += e;
          wq[t] = static_cast<int>(rintf(e * 127.f));
        }
      }
      const int w4 = pack4(wq[0], wq[1], wq[2], wq[3]);
      const int4* vr = reinterpret_cast<const int4*>(sv[g]);
#pragma unroll
      for (int c4 = 0; c4 < kD / 4; ++c4) {
        const int4 vv = vr[c4];
        acc[4 * c4] = __dp4a(w4, vv.x, acc[4 * c4]);
        acc[4 * c4 + 1] = __dp4a(w4, vv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = __dp4a(w4, vv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = __dp4a(w4, vv.w, acc[4 * c4 + 3]);
      }
    }
  }

  if (valid) {
    const float row_scale = 1.f / (127.f * denom);
    float4* orow = reinterpret_cast<float4*>(o + ((size_t)bh * lq + row) * kD);
#pragma unroll
    for (int c4 = 0; c4 < kD / 4; ++c4)
      orow[c4] = make_float4(static_cast<float>(acc[4 * c4]) * row_scale,
                             static_cast<float>(acc[4 * c4 + 1]) * row_scale,
                             static_cast<float>(acc[4 * c4 + 2]) * row_scale,
                             static_cast<float>(acc[4 * c4 + 3]) * row_scale);
  }
}

}  // namespace

extern "C" {

// q (bh, lq, d), k and v (bh, lk, d) int8, 16-byte aligned; logit_scale one
// float32 on the card; o (bh, lq, d) float32. Only head dim 32 (the
// flagship's 256 / 8) is built.
int svol_flash_attention_int8(const void* q, const void* k, const void* v,
                              const void* logit_scale, void* o, int bh, int lq,
                              int lk, int d, void* stream) {
  if (d != kD || bh <= 0 || lq <= 0 || lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((lq + kRows - 1) / kRows, bh);
  flash_int8_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(logit_scale),
      static_cast<float*>(o), lq, lk);
  return static_cast<int>(cudaGetLastError());
}

const char* svol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
