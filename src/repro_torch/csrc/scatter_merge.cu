// Ring scatter-merge: the in-ring enqueue of the fused dispatch.
//
// Replaces: src/repro/kernels/fused_dispatch/kernel.py:_scatter_merge
// (body _scatter_merge_kernel), reached from fused_dispatch_pallas.
//
// Ring slot r takes payload row src_map[r] where src_map[r] >= 0 and keeps
// its bytes otherwise. The ring is updated in place.
//
// Bound on the card: bytes, 2 * n_enq rows (each claimed row read from the
// payload once and written into the ring once); on the serving path a row
// is 196,608 bytes and n_enq <= 32. The TPU kernel streamed the whole ring
// slab in and out (size rows each way); here a block whose slot is not
// claimed returns before touching memory, so only the claimed rows move.
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

// grid (row chunks, size): ring row r <- x row src_map[r] when claimed
template <typename W>
__global__ void __launch_bounds__(repro::kCopyThreads)
scatter_merge_rows(const int* __restrict__ src_map, const W* __restrict__ x,
                   W* __restrict__ ring, long long row_words) {
  const int r = blockIdx.y;
  const int src = src_map[r];
  if (src < 0) return;
  const long long per_block =
      static_cast<long long>(repro::kCopyThreads) * repro::kWordsPerThread;
  const long long lo = static_cast<long long>(blockIdx.x) * per_block;
  const long long hi = min(lo + per_block, row_words);
  repro::copy_words<W>(x, ring, src, r, row_words, lo, hi);
}

template <typename W>
cudaError_t launch_merge(const int* src_map, int size, const void* x,
                         void* ring, long long row_bytes,
                         cudaStream_t stream) {
  const long long row_words = row_bytes / static_cast<long long>(sizeof(W));
  dim3 grid(repro::word_blocks(row_words), size);
  scatter_merge_rows<W><<<grid, repro::kCopyThreads, 0, stream>>>(
      src_map, static_cast<const W*>(x), static_cast<W*>(ring), row_words);
  return cudaGetLastError();
}

}  // namespace

// src_map (size,), x (B, row_bytes) payload, ring (size, row_bytes) in place
extern "C" int repro_scatter_merge(const int* src_map, int size,
                                   const void* x, void* ring,
                                   long long row_bytes, void* stream) {
  if (row_bytes == 0 || size == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (repro::word_bytes(row_bytes, x, ring)) {
    case 16:
      return launch_merge<uint4>(src_map, size, x, ring, row_bytes, s);
    case 4:
      return launch_merge<unsigned int>(src_map, size, x, ring, row_bytes, s);
    default:
      return launch_merge<unsigned char>(src_map, size, x, ring, row_bytes,
                                         s);
  }
}
