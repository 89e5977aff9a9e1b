// Row copies shared by the compaction and scatter-merge kernels.
//
// Rows are moved as raw bytes, so one kernel serves bf16, fp32 and int32
// payloads. The widest word (16, 4 or 1 bytes) that divides the row and
// both base pointers is chosen on the host; consecutive threads touch
// consecutive words, so every warp issues coalesced loads and stores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kCopyThreads = 256;
constexpr int kWordsPerThread = 4;   // words one thread moves per block

// dst row `dst_row` <- src row `src_row`, words [lo, hi) of the row
template <typename W>
__device__ __forceinline__ void copy_words(const W* __restrict__ src,
                                           W* __restrict__ dst,
                                           long long src_row,
                                           long long dst_row,
                                           long long row_words,
                                           long long lo, long long hi) {
  const W* s = src + src_row * row_words;
  W* d = dst + dst_row * row_words;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) d[j] = s[j];
}

// Word size for a row copy: 16 when row and pointers are 16-byte aligned,
// else 4, else 1.
inline int word_bytes(long long row_bytes, const void* a, const void* b) {
  uintptr_t bits = static_cast<uintptr_t>(row_bytes) |
                   reinterpret_cast<uintptr_t>(a) |
                   reinterpret_cast<uintptr_t>(b);
  if ((bits & 15) == 0) return 16;
  if ((bits & 3) == 0) return 4;
  return 1;
}

inline unsigned int word_blocks(long long row_words) {
  long long per_block = static_cast<long long>(kCopyThreads) * kWordsPerThread;
  return static_cast<unsigned int>((row_words + per_block - 1) / per_block);
}

}  // namespace repro
