// Stream compaction: the conditional buffer (ATHEENA section III-C.2).
//
// Replaces: src/repro/kernels/gather_compact/kernel.py:gather_compact_pallas
// (body _gather_compact_kernel).
//
// Given x (B, row_bytes), a hard mask (B,) and a capacity C: slot k < C
// takes the k-th hard row in original order while k < min(n_hard, C);
// every other slot is a flush slot that copies row 0 and carries id -1.
// n_hard counts all hard rows and may exceed C.
//
// Bound on the card: bytes, (min(n_hard, C) + C) rows of the payload (the
// hard rows read once, every slab row written once); on the serving path a
// row is 64 x 1536 bf16 = 196,608 bytes. The partition is a prefix sum over
// B (a few thousand at most), so one block computes it into a take vector;
// a second launch then copies rows with one block per (row chunk, slot),
// 16-byte words where alignment allows, so the copy runs at the card's
// memory rate whatever the payload's type.
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr int kScanThreads = 1024;

// One block. take/ids (C,) and n_hard (1,) are outputs.
__global__ void __launch_bounds__(kScanThreads)
gather_compact_partition(const unsigned char* __restrict__ mask, int B, int C,
                         int* __restrict__ take, int* __restrict__ ids,
                         int* __restrict__ n_hard) {
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    take[k] = 0;   // flush slots read row 0
    ids[k] = -1;
  }
  __shared__ int warp_incl[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int base = 0; base < B; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int h = (i < B && mask[i]) ? 1 : 0;
    int v = h;  // inclusive scan inside the warp
    for (int off = 1; off < 32; off <<= 1) {
      int n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    if (lane == 31) warp_incl[warp] = v;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int w = (lane < n_warps) ? warp_incl[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        int n = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += n;
      }
      warp_incl[lane] = w;
    }
    __syncthreads();
    const int incl = carry + v + (warp > 0 ? warp_incl[warp - 1] : 0);
    if (h && incl - 1 < C) {
      take[incl - 1] = i;
      ids[incl - 1] = i;
    }
    __syncthreads();  // every thread has read carry and warp_incl
    if (threadIdx.x == blockDim.x - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_hard = carry;
}

// grid (row chunks, C): slab row k <- x row take[k]
template <typename W>
__global__ void __launch_bounds__(repro::kCopyThreads)
gather_rows(const W* __restrict__ x, const int* __restrict__ take,
            W* __restrict__ slab, long long row_words) {
  const long long per_block =
      static_cast<long long>(repro::kCopyThreads) * repro::kWordsPerThread;
  const long long lo = static_cast<long long>(blockIdx.x) * per_block;
  const long long hi = min(lo + per_block, row_words);
  const int k = blockIdx.y;
  repro::copy_words<W>(x, slab, take[k], k, row_words, lo, hi);
}

template <typename W>
cudaError_t launch_gather(const void* x, const int* take, void* slab,
                          long long row_bytes, int C, cudaStream_t stream) {
  const long long row_words = row_bytes / static_cast<long long>(sizeof(W));
  dim3 grid(repro::word_blocks(row_words), C);
  gather_rows<W><<<grid, repro::kCopyThreads, 0, stream>>>(
      static_cast<const W*>(x), take, static_cast<W*>(slab), row_words);
  return cudaGetLastError();
}

}  // namespace

// take (C,) is caller-allocated scratch; slab (C, row_bytes), ids (C,),
// n_hard (1,) are outputs.
extern "C" int repro_gather_compact(const void* x, const unsigned char* mask,
                                    int B, long long row_bytes, int C,
                                    void* slab, int* ids, int* n_hard,
                                    int* take, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_compact_partition<<<1, kScanThreads, 0, s>>>(mask, B, C, take, ids,
                                                       n_hard);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || row_bytes == 0 || C == 0) return err;
  switch (repro::word_bytes(row_bytes, x, slab)) {
    case 16:
      return launch_gather<uint4>(x, take, slab, row_bytes, C, s);
    case 4:
      return launch_gather<unsigned int>(x, take, slab, row_bytes, C, s);
    default:
      return launch_gather<unsigned char>(x, take, slab, row_bytes, C, s);
  }
}
