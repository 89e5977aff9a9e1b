// Paged KV cache: tail-page append, then a gather of every row's pages.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py:
// paged_gather_append_pallas (body _paged_gather_append_kernel).
//
// Two pools (K and V) of (P, page, row_bytes) move through one call. For
// each batch row b with write position pos[b]:
//   1. append: the new row a_new[b] / b_new[b] goes to page
//      bt[b, pos[b] / page], row pos[b] % page, of both pools, unless
//      pos[b] >= M * page (the parked / flush sentinel), or that table entry
//      is the NULL page 0 (which stays all-zero whatever the caller passes),
//      or it lies outside the pool;
//   2. gather: after every row has appended, gathered[b, p] <- pool page
//      bt[b, p] for all M entries of the row's table.
// The pools are updated in place (the JAX kernel aliased them).
//
// The Pallas body merged a row's new token in-register into its own tail
// cell, which equals "append every row, then gather" only while no two rows
// share a non-null page. Here the two steps are two launches on one stream,
// so a page read by several rows shows every append to it.
//
// Bound on the card: bytes. The gather reads and writes B * M pages of both
// pools (on the serving path 16 rows x 8 pages x 16 rows of 512 bytes, about
// 2.1 MB each way); the append moves 2 * B rows. Rows are copied as raw
// bytes in the widest aligned word (16 bytes on the serving path), one block
// per (page cell, pool), so one kernel serves bf16 and fp32 pools. At these
// sizes the two launches, not the bytes, set the time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kAppendThreads = 128;

// grid (B, 2): block (b, pool) appends row b's new token to that pool
template <typename W>
__global__ void __launch_bounds__(kAppendThreads)
paged_append(const int* __restrict__ bt, const int* __restrict__ pos, int M,
             int page, int n_pages, const W* __restrict__ a_new,
             const W* __restrict__ b_new, W* __restrict__ a_pool,
             W* __restrict__ b_pool, long long a_words, long long b_words) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p >= M * page) return;                       // sentinel: no append
  int pg = p >= 0 ? p / page : -((page - 1 - p) / page);   // floor
  pg = min(max(pg, 0), M - 1);
  const int q = bt[static_cast<long long>(b) * M + pg];
  if (q <= 0 || q >= n_pages) return;              // null page / outside
  const int r = ((p % page) + page) % page;
  const long long dst = static_cast<long long>(q) * page + r;
  if (blockIdx.y == 0) {
    repro::copy_words<W>(a_new, a_pool, b, dst, a_words, 0, a_words);
  } else {
    repro::copy_words<W>(b_new, b_pool, b, dst, b_words, 0, b_words);
  }
}

// grid (B * M, chunks, 2): block (cell, chunk, pool) copies one chunk of
// pool page bt[cell] into gathered page `cell`
template <typename W>
__global__ void __launch_bounds__(repro::kCopyThreads)
paged_gather(const int* __restrict__ bt, int n_pages,
             const W* __restrict__ a_pool, const W* __restrict__ b_pool,
             W* __restrict__ ga, W* __restrict__ gb, long long a_page_words,
             long long b_page_words) {
  const bool second = blockIdx.z == 1;
  const long long page_words = second ? b_page_words : a_page_words;
  const long long per_block =
      static_cast<long long>(repro::kCopyThreads) * repro::kWordsPerThread;
  const long long lo = static_cast<long long>(blockIdx.y) * per_block;
  if (lo >= page_words) return;                    // the narrower pool
  const long long hi = min(lo + per_block, page_words);
  const long long cell = blockIdx.x;
  const int q = min(max(bt[cell], 0), n_pages - 1);  // never read outside
  repro::copy_words<W>(second ? b_pool : a_pool, second ? gb : ga, q, cell,
                       page_words, lo, hi);
}

template <typename W>
cudaError_t launch(const int* bt, const int* pos, int B, int M, int page,
                   int n_pages, void* a_pool, void* b_pool, const void* a_new,
                   const void* b_new, long long a_row_bytes,
                   long long b_row_bytes, void* ga, void* gb,
                   cudaStream_t s) {
  const long long w = static_cast<long long>(sizeof(W));
  const long long a_words = a_row_bytes / w, b_words = b_row_bytes / w;
  paged_append<W><<<dim3(B, 2), kAppendThreads, 0, s>>>(
      bt, pos, M, page, n_pages, static_cast<const W*>(a_new),
      static_cast<const W*>(b_new), static_cast<W*>(a_pool),
      static_cast<W*>(b_pool), a_words, b_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long a_page = a_words * page, b_page = b_words * page;
  dim3 grid(static_cast<unsigned int>(B) * M,
            repro::word_blocks(a_page > b_page ? a_page : b_page), 2);
  paged_gather<W><<<grid, repro::kCopyThreads, 0, s>>>(
      bt, n_pages, static_cast<const W*>(a_pool),
      static_cast<const W*>(b_pool), static_cast<W*>(ga),
      static_cast<W*>(gb), a_page, b_page);
  return cudaGetLastError();
}

}  // namespace

// bt (B, M) and pos (B,) int32; pools (n_pages, page, row_bytes) updated in
// place; a_new/b_new (B, row_bytes); ga/gb (B, M, page, row_bytes) outputs.
extern "C" int repro_paged_gather_append(
    const int* bt, const int* pos, int B, int M, int page, int n_pages,
    void* a_pool, void* b_pool, const void* a_new, const void* b_new,
    long long a_row_bytes, long long b_row_bytes, void* ga, void* gb,
    void* stream) {
  if (B == 0 || M == 0 || page == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uintptr_t bits = static_cast<uintptr_t>(a_row_bytes) |
                   static_cast<uintptr_t>(b_row_bytes) |
                   reinterpret_cast<uintptr_t>(a_pool) |
                   reinterpret_cast<uintptr_t>(b_pool) |
                   reinterpret_cast<uintptr_t>(a_new) |
                   reinterpret_cast<uintptr_t>(b_new) |
                   reinterpret_cast<uintptr_t>(ga) |
                   reinterpret_cast<uintptr_t>(gb);
  if ((bits & 15) == 0)
    return launch<uint4>(bt, pos, B, M, page, n_pages, a_pool, b_pool, a_new,
                         b_new, a_row_bytes, b_row_bytes, ga, gb, s);
  if ((bits & 3) == 0)
    return launch<unsigned int>(bt, pos, B, M, page, n_pages, a_pool, b_pool,
                                a_new, b_new, a_row_bytes, b_row_bytes, ga,
                                gb, s);
  return launch<unsigned char>(bt, pos, B, M, page, n_pages, a_pool, b_pool,
                               a_new, b_new, a_row_bytes, b_row_bytes, ga, gb,
                               s);
}
