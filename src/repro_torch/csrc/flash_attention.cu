// Blocked causal / windowed grouped-query attention with the online softmax.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _flash_kernel).
//
// q (B, H, Sq, D), k and v (B, KH, Sk, D), each read through its own
// (batch, head, position) strides with unit stride along D; o is written
// through its strides. Query head h reads kv head h / (H / KH). Query row
// i sits at absolute position q_offset + i, key j at j. A pair takes part
// when j < Sk, and, if causal, q_offset + i >= j, and, with a window
// (window > 0), q_offset + i - j < window. s = (q * scale) . k in fp32 from
// the inputs' values; the running max m, the running sum l and the
// accumulator are fp32; keys outside the masks add exactly 0; a row with
// no pair writes 0 (l = 0 is taken as 1). The output is in the inputs'
// dtype (fp32 or bf16), D in {16, 32, 64, 128}.
//
// Design. One block per (kv head of one batch row, tile of 64 query rows),
// where the rows of a tile are the (position, head) pairs of the G = H / KH
// query heads that share that kv head, position-major: all G heads of a
// position read the same keys, so every K/V tile loaded into shared memory
// serves G heads at once (G = 6 for qwen2-1.5b). Four threads own a row,
// each a quarter of D in 16-byte chunks interleaved so that the four read
// neighbouring words of a shared-memory row; a two-step shuffle sums the
// partial dot products. The TPU kernel's sequential kv grid axis becomes a
// loop over 32-key tiles inside the block, bounded by the causal and window
// limits of the block's rows, so tiles that no row of the block may see are
// never visited (the TPU kernel's @pl.when(run)). Products are fp32 FMAs on
// the CUDA cores, matching the TPU kernel's fp32 products; the PV product
// uses the fp32 p, as there.
//
// Bound on the card: operations. At the mesh prefill cell's shapes (q 12
// heads x 2048 rows of D 128 at offset 2048 against 4096 keys, or 16 x 12
// x 512 rows causal) the masked pairs need 4 D flops each, 38.7 and 12.9
// GFLOP, against q, k, v and o of a few tens of MB: hundreds of flops a
// byte, far above the card's ~20 flops a byte in fp32 and ~300 in bf16
// tensor-core work. These FMAs reach at most the 67 TFLOP/s fp32 peak,
// some 15 times under the bf16 tensor cores' 989, which a later mma/wgmma
// version is for; this one is the simple, right first port.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                  // (position, head) rows a block
constexpr int kTpr = 4;                    // threads a row
constexpr int kThreads = kRows * kTpr;     // 256
constexpr int kBK = 32;                    // keys a shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int KH, int Sq,
          int Sk, long long qsb, long long qsh, long long qss, long long ksb,
          long long ksh, long long kss, long long vsb, long long vsh,
          long long vss, long long osb, long long osh, long long oss,
          int q_offset, int causal, int window, float scale) {
  constexpr int D4 = D / 4;                // 16-byte chunks of fp32 a row
  constexpr int C = D4 / kTpr;             // chunks a thread
  __shared__ float4 ks[kBK][D4];
  __shared__ float4 vs[kBK][D4];

  const int G = H / KH;
  const int b = blockIdx.y / KH;
  const int kh = blockIdx.y % KH;
  const long long rows = static_cast<long long>(G) * Sq;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int lr = threadIdx.x / kTpr;
  const int sub = threadIdx.x % kTpr;
  const long long r = r0 + lr;
  const bool live = r < rows;
  const int pos = live ? static_cast<int>(r / G) : 0;
  const int h = kh * G + (live ? static_cast<int>(r % G) : 0);
  const int qi = q_offset + pos;

  // the keys any row of this block may see; the same for every thread
  const long long r_last = min(r0 + kRows, rows) - 1;
  const int p_lo = q_offset + static_cast<int>(r0 / G);
  const int p_hi = q_offset + static_cast<int>(r_last / G);
  const int k_end = causal ? min(Sk, p_hi + 1) : Sk;
  int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  k_begin -= k_begin % kBK;

  const T* qrow = q + b * qsb + h * qsh + pos * qss;
  float4 qr[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = 4 * (c * kTpr + sub);
    qr[c] = make_float4(to_f(qrow[d]) * scale, to_f(qrow[d + 1]) * scale,
                        to_f(qrow[d + 2]) * scale, to_f(qrow[d + 3]) * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  const T* kbase = k + b * ksb + kh * ksh;
  const T* vbase = v + b * vsb + kh * vsh;
  for (int t0 = k_begin; t0 < k_end; t0 += kBK) {
    __syncthreads();                       // the last tile is consumed
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const int kj = t0 + j;
      float kx = 0.f, vx = 0.f;            // rows past Sk load as zeros
      if (kj < Sk) {
        kx = to_f(kbase[kj * kss + d]);
        vx = to_f(vbase[kj * vss + d]);
      }
      reinterpret_cast<float*>(ks[j])[d] = kx;
      reinterpret_cast<float*>(vs[j])[d] = vx;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kk = ks[j][c * kTpr + sub];
        part = fmaf(qr[c].x, kk.x, part);
        part = fmaf(qr[c].y, kk.y, part);
        part = fmaf(qr[c].z, kk.z, part);
        part = fmaf(qr[c].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = t0 + j;
      bool ok = kj < Sk;
      if (causal) ok = ok && qi >= kj;
      if (window > 0) ok = ok && qi - kj < window;
      s[j] = ok ? part : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= corr;
      acc[c].y *= corr;
      acc[c].z *= corr;
      acc[c].w *= corr;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_safe);
      psum += p;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = vs[j][c * kTpr + sub];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (!live) return;
  const float den = l == 0.f ? 1.f : l;    // a row with no pair writes 0
  T* orow = o + b * osb + h * osh + pos * oss;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int d = 4 * (c * kTpr + sub);
    store(orow + d, acc[c].x / den);
    store(orow + d + 1, acc[c].y / den);
    store(orow + d + 2, acc[c].z / den);
    store(orow + d + 3, acc[c].w / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KH, int Sq, int Sk, const long long* st,
                   int q_offset, int causal, int window, float scale,
                   cudaStream_t stream) {
  const long long rows = static_cast<long long>(H / KH) * Sq;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(B * KH));
  flash_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], q_offset, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int KH, int Sq, int Sk,
                     const long long* st, int q_offset, int causal,
                     int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KH, Sq, Sk, st, q_offset,
                           causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KH, Sq, Sk, st, q_offset,
                           causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KH, Sq, Sk, st, q_offset,
                           causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, Sq, Sk, st, q_offset,
                            causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides in elements, (batch, head,
// position) for q, k, v and o in that order. window <= 0: no window.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int D,
    int B, int H, int KH, int Sq, int Sk, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int q_offset, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || KH <= 0 || H % KH != 0 || B * KH > 65535)
    return cudaErrorInvalidValue;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, H, KH, Sq, Sk, st, q_offset,
                           causal, window, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KH, Sq, Sk, st,
                                   q_offset, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
