// Exit decision (ATHEENA Eq. 4) as one streamed reduction over the vocab.
//
// Replaces: src/repro/kernels/exit_decision/kernel.py:exit_decision_pallas
// (body _exit_decision_kernel).
//
// Per row: m = max_j x_j, s = sum_j exp(x_j - m), pred = first j with
// x_j == m. Emits exit = (c_thr * s < 1), pred, conf = 1 / s. All
// arithmetic in fp32 whatever the logits' type; no softmax is written.
//
// Bound on the card: bytes. Every logit is read once (32 x 151,936 fp32 on
// the serving path, 19.4 MB) and the work per element is one exp and a few
// adds, far below the card's arithmetic rate. One block per row would put
// 32 blocks on 132 SMs, so the vocab is cut into chunks: pass 1 runs one
// block per (chunk, row) and writes a partial (m, s, argmax) per chunk;
// pass 2 runs one warp per row and merges the partials. Blocks carry
// nothing between them (the TPU kernel's sequential vocab grid carried its
// accumulators in scratch); the merge keeps the first-occurrence rule by
// taking the smaller column among equal maxima.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct State {
  float m;  // running max
  float s;  // sum of exp(x - m)
  int i;    // first column holding m
};

__device__ __forceinline__ State identity() {
  State st;
  st.m = -INFINITY;
  st.s = 0.f;
  st.i = INT_MAX;
  return st;
}

__device__ __forceinline__ State merge(State a, State b) {
  State r;
  r.m = fmaxf(a.m, b.m);
  float sa = (a.m == -INFINITY) ? 0.f : a.s * expf(a.m - r.m);
  float sb = (b.m == -INFINITY) ? 0.f : b.s * expf(b.m - r.m);
  r.s = sa + sb;
  if (a.m > b.m) {
    r.i = a.i;
  } else if (b.m > a.m) {
    r.i = b.i;
  } else {
    r.i = min(a.i, b.i);  // first occurrence on ties
  }
  return r;
}

__device__ __forceinline__ State warp_reduce(State st) {
  for (int off = 16; off > 0; off >>= 1) {
    State o;
    o.m = __shfl_down_sync(0xffffffffu, st.m, off);
    o.s = __shfl_down_sync(0xffffffffu, st.s, off);
    o.i = __shfl_down_sync(0xffffffffu, st.i, off);
    st = merge(st, o);
  }
  return st;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// pass 1: grid (n_chunks, B); block (chunk c, row b) reduces columns
// [c * chunk, min((c + 1) * chunk, V)) of row b into one partial.
template <typename T>
__global__ void __launch_bounds__(kThreads)
exit_decision_partial(const T* __restrict__ x, int V, long long ld, int chunk,
                      float* __restrict__ part_m, float* __restrict__ part_s,
                      int* __restrict__ part_i) {
  const int c = blockIdx.x;
  const int row = blockIdx.y;
  const int lo = c * chunk;
  const int hi = min(lo + chunk, V);
  const T* xr = x + static_cast<long long>(row) * ld;

  // each thread walks its columns in increasing order, so a strict '>'
  // keeps its first maximum
  State st = identity();
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    float v = to_float(xr[j]);
    if (v > st.m) {
      st.s = st.s * expf(st.m - v) + 1.f;
      st.m = v;
      st.i = j;
    } else if (v != -INFINITY) {  // -inf adds nothing; skipping it keeps
      st.s += expf(v - st.m);       // an all -inf prefix from making NaN
    }
  }

  __shared__ State warps[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  st = warp_reduce(st);
  if (lane == 0) warps[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = (lane < kThreads / 32) ? warps[lane] : identity();
    st = warp_reduce(st);
    if (lane == 0) {
      const long long k = static_cast<long long>(row) * gridDim.x + c;
      part_m[k] = st.m;
      part_s[k] = st.s;
      part_i[k] = st.i;
    }
  }
}

// pass 2: one warp per row merges its n_chunks partials and decides
__global__ void exit_decision_combine(const float* __restrict__ part_m,
                                      const float* __restrict__ part_s,
                                      const int* __restrict__ part_i,
                                      int n_chunks, float c_thr,
                                      unsigned char* __restrict__ exit_mask,
                                      int* __restrict__ pred,
                                      float* __restrict__ conf) {
  const int row = blockIdx.x;
  const long long base = static_cast<long long>(row) * n_chunks;
  State st = identity();
  for (int c = threadIdx.x; c < n_chunks; c += 32) {
    State p;
    p.m = part_m[base + c];
    p.s = part_s[base + c];
    p.i = part_i[base + c];
    st = merge(st, p);
  }
  st = warp_reduce(st);
  if (threadIdx.x == 0) {
    exit_mask[row] = (c_thr * st.s < 1.0f) ? 1 : 0;
    pred[row] = (st.i == INT_MAX) ? 0 : st.i;  // an all -inf row: column 0
    conf[row] = 1.0f / st.s;
  }
}

template <typename T>
cudaError_t launch(const void* x, int B, int V, long long ld, int chunk,
                   int n_chunks, float* part_m, float* part_s, int* part_i,
                   float c_thr, unsigned char* exit_mask, int* pred,
                   float* conf, cudaStream_t stream) {
  dim3 grid(n_chunks, B);
  exit_decision_partial<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), V, ld, chunk, part_m, part_s, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  exit_decision_combine<<<B, 32, 0, stream>>>(part_m, part_s, part_i,
                                               n_chunks, c_thr, exit_mask,
                                               pred, conf);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. part_* hold B * n_chunks
// entries each, allocated by the caller.
extern "C" int repro_exit_decision(const void* x, int dtype, int B, int V,
                                   long long ld, int chunk, int n_chunks,
                                   float* part_m, float* part_s, int* part_i,
                                   float c_thr, unsigned char* exit_mask,
                                   int* pred, float* conf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, B, V, ld, chunk, n_chunks, part_m, part_s,
                           part_i, c_thr, exit_mask, pred, conf, s);
    case 1:
      return launch<__nv_bfloat16>(x, B, V, ld, chunk, n_chunks, part_m,
                                   part_s, part_i, c_thr, exit_mask, pred,
                                   conf, s);
    case 2:
      return launch<__half>(x, B, V, ld, chunk, n_chunks, part_m, part_s,
                            part_i, c_thr, exit_mask, pred, conf, s);
    default:
      return cudaErrorInvalidValue;
  }
}
