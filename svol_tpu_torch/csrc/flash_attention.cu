// Unmasked attention forward, softmax(q k^T scale) v over (BH, L, d) tensors
// or, with heads as column slices, over (B, L, H*d) tensors.
//
// Replaces the Pallas kernels of svol_tpu/ops/pallas/flash_attention.py:
// `_kernel` (the video self-attention, L = 1568), `_kernel_packed` (the
// query self-attention, L = 320) and `_kernel_bld` (the ViT encoder's
// self-attention, L = 197, H = 12, d = 64, taken and returned in the
// (B, L, D) layout of its projections). On the TPU one grid step holds a whole
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
// with warp shuffles at the end). The (B, L, D) entry in float32 is the same
// kernel with other strides: batch-head bh reads rows of stride ld = H*d
// starting at column (bh % H)*d of image bh / H, and writes its output
// there, so no transposed copy of q, k, v or o is ever made; (BH, L, d) is
// the case H = 1, ld = d. At the ViT's d = 64 each thread holds 64 f32 q
// values and 64 accumulators, so only the four-threads-per-row shape is
// built (16 logits a thread per key tile), and the two 64-key f32 tiles of
// K and V stay within the 48 KB of static shared memory (34.8 KB). The
// (B, L, D) entry in bfloat16, the ViT's served path, runs the tensor-core
// kernel at the end of this file with the same strides and rounding
// points. q is scaled in q's dtype before the dot
// (`q * scale`, flash_attention.py:64) and the unnormalized weights are
// rounded to v's dtype before P.V (:75); statistics and sums stay f32.
// When the autograd path asks for it (lse != nullptr), each row's f32
// logsumexp m + log(l) is written too: the backward kernels
// (flash_attention_bwd.cu) rebuild the softmax from it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <cstdint>

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
                 float* __restrict__ lse, int lq, int lk, int heads, int ld,
                 float scale) {
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
  // image bh / heads, head bh % heads: its column slice of rows of stride ld
  const size_t col = (size_t)(bh % heads) * D;
  const T* qb = q + (size_t)(bh / heads) * lq * ld + col;
  const T* kb = k + (size_t)(bh / heads) * lk * ld + col;
  const T* vb = v + (size_t)(bh / heads) * lk * ld + col;

  // rows past lq compute on zeros so every lane reaches the shuffles below
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = valid ? round_to<T>(to_f(qb[(size_t)row * ld + d]) * scale) : 0.f;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kTileK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTileK * D; i += kBlock) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < lk;
      sk[r * kStride + c] = in ? to_f(kb[(size_t)(k0 + r) * ld + c]) : 0.f;
      sv[r * kStride + c] = in ? to_f(vb[(size_t)(k0 + r) * ld + c]) : 0.f;
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
    T* orow = o + (size_t)(bh / heads) * lq * ld + col + (size_t)row * ld;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d / (D / TPR) == part) orow[d] = from_f<T>(acc[d] * inv);
    if (lse != nullptr && part == 0) lse[(size_t)bh * lq + row] = m + logf(l);
  }
}

template <typename T, int D, int TPR>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int lq, int lk, int heads, int ld,
                   float scale, cudaStream_t stream) {
  constexpr int kRows = kBlock / TPR;
  dim3 grid((lq + kRows - 1) / kRows, bh);
  flash_fwd_kernel<T, D, TPR><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, lq, lk, heads, ld,
      scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// (B, L, H*64) bf16 forward on the tensor cores (`_kernel_bld` at the ViT's
// d = 64). The CUDA-core kernel above holds 64 q values and 64 accumulators
// a thread (254 registers) and feeds every FMA from shared memory, so at
// (256, 197, 768) it ran ~44x its 0.093 ms bound, slower than the plain
// version. Here each warp owns 16 query rows and runs the two products as
// mma.sync.m16n8k16 bf16 -> f32, FlashAttention-2 style:
//   * q (16 x 64, scaled in bf16 first) stays in registers as 4 A
//     fragments; a block of 4 warps takes 64 query rows of one batch-head;
//   * K (64 keys x 64) and V, transposed, stream through shared memory in
//     64-key tiles; S = q K^T is 8 f32 accumulator tiles (16 x 8 each);
//   * the online softmax runs on those fragments (each row lives in the 4
//     lanes of a quad: shuffles xor 1 and 2), and the unnormalized weights,
//     rounded to bf16, become the A fragments of O += P V without leaving
//     the registers;
//   * O is divided by the f32 row sum and written to its (B, L, D) slice.
// Rounding points are those of the kernel above: q scaled in bf16, exact
// bf16 products summed in f32, exp in f32, weights rounded to bf16 before
// P.V, f32 statistics; only the order of the f32 sums differs.
constexpr int kMmaWarps = 4;        // query rows a block: 16 per warp
constexpr int kMmaD = 64;           // head dim
constexpr int kMmaKeys = 64;        // keys per shared-memory tile
constexpr int kMmaPad = kMmaD + 8;  // bf16 row stride: conflict-free fragment reads

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two q values of one row at columns c, c + 1, scaled and rounded to bf16
// (zeros past the last row)
__device__ __forceinline__ uint32_t load_q2(const __nv_bfloat16* qb, int row, int lq,
                                            int ld, int c, float scale) {
  if (row >= lq) return 0u;
  const __nv_bfloat162 v =
      *reinterpret_cast<const __nv_bfloat162*>(qb + (size_t)row * ld + c);
  return pack_bf16(__bfloat162float(v.x) * scale, __bfloat162float(v.y) * scale);
}

__global__ void __launch_bounds__(kMmaWarps * 32)
flash_bld_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int lq, int lk, int heads,
                     int ld, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sk[kMmaKeys * kMmaPad];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 svt[kMmaD * kMmaPad];     // [d][key]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int bh = blockIdx.y;
  const size_t col = (size_t)(bh % heads) * kMmaD;
  const __nv_bfloat16* qb = q + (size_t)(bh / heads) * lq * ld + col;
  const __nv_bfloat16* kb = k + (size_t)(bh / heads) * lk * ld + col;
  const __nv_bfloat16* vb = v + (size_t)(bh / heads) * lk * ld + col;
  const int row0 = blockIdx.x * kMmaWarps * 16 + warp * 16;
  const bool active = row0 < lq;  // warps wholly past the last row only load

  uint32_t qa[kMmaD / 16][4];
#pragma unroll
  for (int kc = 0; kc < kMmaD / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qa[kc][0] = load_q2(qb, row0 + g, lq, ld, c, scale);
    qa[kc][1] = load_q2(qb, row0 + g + 8, lq, ld, c, scale);
    qa[kc][2] = load_q2(qb, row0 + g, lq, ld, c + 8, scale);
    qa[kc][3] = load_q2(qb, row0 + g + 8, lq, ld, c + 8, scale);
  }
  float acc[kMmaD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMmaD / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};  // rows g, g + 8

  for (int k0 = 0; k0 < lk; k0 += kMmaKeys) {
    __syncthreads();
    // 16-byte loads of 8 values; keys past the last are zeros
    for (int i = threadIdx.x; i < kMmaKeys * kMmaD / 8; i += kMmaWarps * 32) {
      const int r = i / (kMmaD / 8), c8 = (i % (kMmaD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * ld + c8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * ld + c8);
      }
      *reinterpret_cast<uint4*>(sk + r * kMmaPad + c8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) svt[(c8 + e) * kMmaPad + r] = ve[e];
    }
    __syncthreads();
    if (!active) continue;

    // S = q K^T: 8 tiles of 8 keys
    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaKeys / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sk + (nt * 8 + g) * kMmaPad + 2 * t;
#pragma unroll
      for (int kc = 0; kc < kMmaD / 16; ++kc)
        mma_bf16(s[nt], qa[kc], *reinterpret_cast<const uint32_t*>(kr + kc * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kc * 16 + 8));
    }
    const int nk = lk - k0;
    if (nk < kMmaKeys) {
#pragma unroll
      for (int nt = 0; nt < kMmaKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + 2 * t + (e & 1) >= nk) s[nt][e] = -CUDART_INF_F;
    }

    // online softmax of rows g (elements 0, 1) and g + 8 (elements 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < kMmaKeys / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);  // finite: key k0 is valid
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kMmaKeys / 8; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
        s[nt][2 * r] = expf(s[nt][2 * r] - m_new);
        s[nt][2 * r + 1] = expf(s[nt][2 * r + 1] - m_new);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
    }

    // O += P V: the S accumulators of two key tiles are one A fragment
#pragma unroll
    for (int kc = 0; kc < kMmaKeys / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nt = 0; nt < kMmaD / 8; ++nt) {
        const __nv_bfloat16* vr = svt + (nt * 8 + g) * kMmaPad + kc * 16 + 2 * t;
        mma_bf16(acc[nt], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= lq) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = o + (size_t)(bh / heads) * lq * ld + col + (size_t)row * ld;
#pragma unroll
    for (int nt = 0; nt < kMmaD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
  }
}

cudaError_t launch_bld_mma(const void* q, const void* k, const void* v, void* o,
                           int b, int heads, int lq, int lk, float scale,
                           cudaStream_t stream) {
  constexpr int kRows = kMmaWarps * 16;
  dim3 grid((lq + kRows - 1) / kRows, b * heads);
  flash_bld_mma_kernel<<<grid, kMmaWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lq, lk,
      heads, heads * kMmaD, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (BH, L, d) tensors. dtype: 0 = float32, 1 = bfloat16. tpr: threads per
// query row (1 or 4). lse: (bh, lq) float32 row logsumexp output, or null.
// Only head dim 32 (the flagship head's 256 / 8) is instantiated.
int svol_flash_attention(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int lq, int lk, int d, float scale,
                         int dtype, int tpr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != 32 || (tpr != 1 && tpr != 4) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return tpr == 1 ? launch<float, 32, 1>(q, k, v, o, l, bh, lq, lk, 1, d, scale, s)
                    : launch<float, 32, 4>(q, k, v, o, l, bh, lq, lk, 1, d, scale, s);
  return tpr == 1 ? launch<__nv_bfloat16, 32, 1>(q, k, v, o, l, bh, lq, lk, 1, d, scale, s)
                  : launch<__nv_bfloat16, 32, 4>(q, k, v, o, l, bh, lq, lk, 1, d, scale, s);
}

// (B, L, H*d) tensors, head h the columns [h*d, (h+1)*d): q and o are
// (b, lq, H*d), k and v (b, lk, H*d), all contiguous; no logsumexp (forward
// only). Only head dim 64 (ViT-B/16's 768 / 12): float32 on the CUDA-core
// kernel at four threads a row, bfloat16 on the tensor cores.
int svol_flash_attention_bld(const void* q, const void* k, const void* v,
                             void* o, int b, int heads, int lq, int lk, int d,
                             float scale, int dtype, void* stream) {
  if (d != kMmaD || heads < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bld_mma(q, k, v, o, b, heads, lq, lk, scale, s);
  return launch<float, kMmaD, 4>(q, k, v, o, nullptr, b * heads, lq, lk, heads,
                                 heads * kMmaD, scale, s);
}

const char* svol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
