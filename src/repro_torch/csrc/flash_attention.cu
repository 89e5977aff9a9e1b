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
// (window > 0), q_offset + i - j < window. The running max m, the running
// sum l and the accumulator are fp32; keys outside the masks add exactly 0;
// a row with no pair writes 0 (l = 0 is taken as 1). The output is in the
// inputs' dtype, D in {16, 32, 64, 128}. Two kernels, chosen by dtype:
//
// flash_fwd_mma (bf16). Bound on the card: operations. At the mesh prefill
// cell's shapes (q 12 heads x 2048 rows of D 128 at offset 2048 against
// 4096 keys, or 16 x 12 x 512 rows causal) the masked pairs need 4 D flops
// each, 38.7 and 12.9 GFLOP, against q, k, v and o of a few tens of MB:
// hundreds of flops a byte, above the ~300 a byte at which the bf16 tensor
// cores (989 TFLOP/s) and not the memory are the limit. So both products
// go to the tensor cores through mma.sync.m16n8k16 (bf16 in, fp32
// accumulate):
//   * Blocks. A block owns 64 (position, head) rows of one kv head of one
//     batch row, position-major, so each K/V tile in shared memory serves
//     the G = H / KH query heads of the group (G = 6 for qwen2-1.5b). Four
//     warps take 16 rows each. Row boundaries stay at multiples of 64, so
//     a mesh shard of S/m x G rows never splits a block.
//   * K/V ring. Tiles of 64 keys reach dynamic shared memory through a
//     two-stage cp.async.cg ring, the next tile in flight while this one is
//     used; 16-byte chunks are XOR-swizzled by row so that every ldmatrix
//     of 8 rows hits 8 distinct bank groups.
//   * QK^T on unscaled bf16 q: the block's q rows land in shared memory
//     once, beside the ring, and q's and k's fragments are read by ldmatrix
//     at every tile. Holding q's fragments in registers for the whole loop
//     instead (32 more a thread at D 128) ran slower on the card at both
//     shard shapes, as did two 16-row m-tiles a warp and a register cap
//     for three blocks an SM; 32-key tiles ran slower at the seq shard and
//     a little faster at the batch shard; a third ring stage changed
//     neither. The scale, folded with log2 e, is applied to s in fp32
//     inside exp2f.
//   * Online softmax in fp32 registers; the row max is reduced over the
//     four threads of a quad by shuffles, the row sum once at the end.
//   * PV with p split: the plain version and the TPU kernel multiply fp32
//     p into v; p rounded to bf16 puts 0.28 % (seq shard) to ~5 % (batch
//     shard) of the bf16 outputs past the kernel's gate of 2^-7 |want| +
//     1e-4. So p = hi + lo with hi = bf16(p), lo = bf16(p - hi), and two
//     mma.sync a k-step go into one fp32 accumulator (v fragments by
//     ldmatrix.trans); l sums the fp32 p. This doubles the PV product's
//     tensor work: 1.5x the function's 4 D flops a pair. It is the price
//     of the gate.
//   * Key tiles that no row of the block may see are never visited (the
//     TPU kernel's @pl.when(run)); tiles on a mask's edge are masked per
//     element. A tile fully masked for a row is an exact no-op for it
//     (correction 1, p exactly 0), so a row's result does not depend on
//     which block computed it: the mesh's shards equal one unsplit launch
//     bit for bit.
//
// flash_fwd (fp32). fp32 FMAs on the CUDA cores, products in full fp32 as
// the TPU kernel's (a TF32 product would not hold the fp32 gates). One
// block per (kv head of one batch row, tile of 64 rows) as above, four
// threads a row, each a quarter of D in 16-byte chunks interleaved so that
// the four read neighbouring words of a shared-memory row; a two-step
// shuffle sums the partial dot products; a loop over 32-key tiles bounded
// by the causal and window limits of the block's rows; s = (q * scale) . k.
// Its bound is the 67 TFLOP/s fp32 peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

// ---------------------------------------------------------------- fp32 --

constexpr int kRows = 64;                  // (position, head) rows a block
constexpr int kTpr = 4;                    // threads a row
constexpr int kThreads = kRows * kTpr;     // 256
constexpr int kBK = 32;                    // keys a shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------- bf16 --

using bf16 = __nv_bfloat16;

constexpr int kMRows = 64;                 // (position, head) rows a block
constexpr int kMThreads = 128;             // four warps of 16 rows
constexpr int kBN = 64;                    // keys a K/V tile
constexpr int kStages = 2;                 // K/V tiles in the ring

template <int D>
struct Tile {
  static constexpr int NC = D / 8;                  // 16-byte chunks a row
  static constexpr int RPL = NC >= 8 ? 1 : 8 / NC;  // rows a 128-byte line
  static constexpr int SWZ = (NC >= 8 ? 8 : NC) - 1;
  static constexpr int KV_BYTES = kBN * D * 2;      // one K or V tile
  static constexpr int SMEM = kMRows * D * 2 + 2 * kStages * KV_BYTES;
};

// Byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile. The
// chunk index is XORed with the row's place among the 8 rows an ldmatrix
// reads (counted in 128-byte lines), so those 8 rows' chunks fall in 8
// distinct groups of 4 banks.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  using T = Tile<D>;
  return static_cast<uint32_t>(
      (r * T::NC + (c ^ ((r / T::RPL) & T::SWZ))) * 16);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // src-size 0 fills the 16 bytes with zeros (rows past the end)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) = hi + lo, each a pair of bf16 (a in the low half)
__device__ __forceinline__ void split_p(float a, float b, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

template <int D>
__global__ void __launch_bounds__(kMThreads, 2)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int H, int KH,
              int Sq, int Sk, long long qsb, long long qsh, long long qss,
              long long ksb, long long ksh, long long kss, long long vsb,
              long long vsh, long long vss, long long osb, long long osh,
              long long oss, int q_offset, int causal, int window,
              float scale) {
  using T = Tile<D>;
  constexpr int NC = T::NC;
  constexpr int KS = D / 16;               // k-steps of QK^T over D
  constexpr int NT = kBN / 8;              // 8-key column tiles of s
  constexpr int DT = D / 8;                // 8-wide column tiles of o
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sk = sq + kMRows * D * 2;             // K stages
  const uint32_t sv = sk + kStages * T::KV_BYTES;      // V stages

  const int G = H / KH;
  const int b = blockIdx.y / KH;
  const int kh = blockIdx.y % KH;
  const long long rows = static_cast<long long>(G) * Sq;
  // the last row tiles, which see the most keys under a causal mask, first
  const long long r0 =
      static_cast<long long>(gridDim.x - 1 - blockIdx.x) * kMRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the keys any row of this block may see; the same for every thread
  const long long r_last = min(r0 + kMRows, rows) - 1;
  const int p_lo = q_offset + static_cast<int>(r0 / G);
  const int p_hi = q_offset + static_cast<int>(r_last / G);
  const int k_end = causal ? min(Sk, p_hi + 1) : Sk;
  int k_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  k_begin -= k_begin % kBN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBN - 1) / kBN
                                      : 0;

  const bf16* kbase = k + b * ksb + kh * ksh;
  const bf16* vbase = v + b * vsb + kh * vsh;
  auto load_kv = [&](int t) {
    const int t0 = k_begin + t * kBN;
    const uint32_t off = (t % kStages) * T::KV_BYTES;
#pragma unroll
    for (int it = 0; it < kBN * NC / kMThreads; ++it) {
      const int i = tid + it * kMThreads;
      const int j = i / NC, c = i % NC;
      const bool ok = t0 + j < Sk;          // keys past Sk load as zeros
      const long long kj = ok ? t0 + j : 0;
      cp_async16(sk + off + swz<D>(j, c), kbase + kj * kss + c * 8, ok);
      cp_async16(sv + off + swz<D>(j, c), vbase + kj * vss + c * 8, ok);
    }
  };

  // group 0: the block's q rows; groups 1 .. kStages - 1: the first tiles
#pragma unroll
  for (int it = 0; it < kMRows * NC / kMThreads; ++it) {
    const int i = tid + it * kMThreads;
    const int lr = i / NC, c = i % NC;
    const long long r = r0 + lr;
    const bool ok = r < rows;               // rows past the end: zeros
    const int pos = ok ? static_cast<int>(r / G) : 0;
    const int h = kh * G + (ok ? static_cast<int>(r % G) : 0);
    cp_async16(sq + swz<D>(lr, c), q + b * qsb + h * qsh + pos * qss + c * 8,
               ok);
  }
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  // this thread's two rows of the warp's 16: lane / 4 and lane / 4 + 8
  const int wr = warp * 16;
  const int col = 2 * (lane % 4);
  int qi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qi[i] = q_offset + static_cast<int>((r0 + wr + lane / 4 + 8 * i) / G);
  const float sl2 = scale * 1.4426950408889634f;     // scale * log2 e

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int mi = lane / 8;                  // the 8x8 matrix this lane names
  for (int t = 0; t < n_tiles; ++t) {
    // the stage refilled here was read in iteration t - 1, which every
    // warp has left (the barrier at the end of the loop)
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // q and tile t have landed
    __syncthreads();
    const uint32_t off = (t % kStages) * T::KV_BYTES;
    const int t0 = k_begin + t * kBN;

    // s = q k^T, unscaled; q's fragments come from shared memory at every
    // tile, which leaves the registers to the accumulators
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, sq + swz<D>(wr + (lane & 15), 2 * kk + lane / 16));
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, sk + off + swz<D>(16 * jp + 8 * (mi / 2) + (lane & 7),
                                      2 * kk + (mi & 1)));
        mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
      }
    }

    // per-element masks, on tiles across a mask's edge only
    const bool full = t0 + kBN <= Sk &&
                      (!causal || t0 + kBN - 1 <= p_lo) &&
                      (window <= 0 || p_hi - t0 < window);
    if (!full) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = t0 + 8 * n + col + (e & 1);
          const int qe = qi[e / 2];
          bool ok = kj < Sk;
          if (causal) ok = ok && qe >= kj;
          if (window > 0) ok = ok && qe - kj < window;
          if (!ok) s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax: a row's four threads share its max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float base[2], corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i] * sl2;
      // an unchanged max (a tile fully masked for the row) leaves the row
      // exactly as it was
      corr[i] = mx[i] == m[i] ? 1.f : exp2f(m[i] * sl2 - base[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(fmaf(s[n][e], sl2, -base[e / 2]));   // -inf -> 0
        ps[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ps[i];
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // o += p v with p = hi + lo: the s accumulators of two key tiles are
    // the A fragment of one 16-key k-step
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
      uint32_t ph[4], pl[4];
      split_p(s[2 * kt][0], s[2 * kt][1], ph[0], pl[0]);
      split_p(s[2 * kt][2], s[2 * kt][3], ph[1], pl[1]);
      split_p(s[2 * kt + 1][0], s[2 * kt + 1][1], ph[2], pl[2]);
      split_p(s[2 * kt + 1][2], s[2 * kt + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, sv + off + swz<D>(16 * kt + 8 * (mi & 1) + (lane & 7),
                                        2 * dp + mi / 2));
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();                        // the stage may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const long long r = r0 + wr + lane / 4 + 8 * i;
    if (r >= rows) continue;
    const int pos = static_cast<int>(r / G);
    const int h = kh * G + static_cast<int>(r % G);
    const float den = l[i] == 0.f ? 1.f : l[i];   // a row with no pair: 0
    bf16* orow = o + b * osb + h * osh + pos * oss + col;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

// ------------------------------------------------------------ launches --

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, KH, Sq, Sk;
  const long long* st;
  int q_offset, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_fp32(const Args& a) {
  const long long rows = static_cast<long long>(a.H / a.KH) * a.Sq;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(a.B * a.KH));
  const long long* st = a.st;
  flash_fwd<float, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.H, a.KH,
      a.Sq, a.Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], a.q_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

constexpr int kMaxDevices = 64;

// The dynamic shared memory cap is fixed for each D: set it once on each
// device, and hand back that call's error on every later launch.
template <int D>
cudaError_t set_smem() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(
        flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<D>::SMEM);
  });
  return err[dev];
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  // cp.async moves 16-byte chunks: every base and stride that addresses
  // a chunk must be a multiple of 16 bytes (the wrapper makes it so)
  const long long* st = a.st;
  const int ext[9] = {a.B, a.H, a.Sq, a.B, a.KH, a.Sk, a.B, a.KH, a.Sk};
  for (int i = 0; i < 9; ++i)
    if (ext[i] > 1 && st[i] % 8 != 0) return cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const cudaError_t e = set_smem<D>();
  if (e != cudaSuccess) return e;
  const long long rows = static_cast<long long>(a.H / a.KH) * a.Sq;
  const dim3 grid(static_cast<unsigned>((rows + kMRows - 1) / kMRows),
                  static_cast<unsigned>(a.B * a.KH));
  flash_fwd_mma<D><<<grid, kMThreads, Tile<D>::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.H, a.KH,
      a.Sq, a.Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], a.q_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t attrs_bf16(int* out) {
  cudaError_t e = set_smem<D>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, flash_fwd_mma<D>);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_mma<D>, kMThreads, Tile<D>::SMEM);
  if (e != cudaSuccess) return e;
  out[0] = fa.numRegs;
  out[1] = Tile<D>::SMEM;
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = blocks;
  out[5] = kMThreads;
  return cudaSuccess;
}

}  // namespace

// dtype: 0 float32 (flash_fwd), 1 bfloat16 (flash_fwd_mma). Strides in
// elements, (batch, head, position) for q, k, v and o in that order.
// window <= 0: no window.
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
  const Args a{q,  k,  v,  o,        B,      H,      KH,    Sq,
               Sk, st, q_offset, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_fp32<16>(a);
      case 32: return launch_fp32<32>(a);
      case 64: return launch_fp32<64>(a);
      case 128: return launch_fp32<128>(a);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_bf16<16>(a);
      case 32: return launch_bf16<32>(a);
      case 64: return launch_bf16<64>(a);
      case 128: return launch_bf16<128>(a);
    }
  }
  return cudaErrorInvalidValue;
}

// The bf16 kernel's resources at head dim D, into out[6]: registers a
// thread, dynamic shared bytes a block, static shared bytes, local (spill)
// bytes a thread, resident blocks an SM, threads a block.
extern "C" int repro_flash_attention_attrs(int D, int* out) {
  switch (D) {
    case 16: return attrs_bf16<16>(out);
    case 32: return attrs_bf16<32>(out);
    case 64: return attrs_bf16<64>(out);
    case 128: return attrs_bf16<128>(out);
  }
  return cudaErrorInvalidValue;
}
