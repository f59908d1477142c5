// Page gather, page scatter and token append for the paged KV pools.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/page_copy/kernel.py:
// page_gather_kernel, page_scatter_kernel and token_append_kernel (twice:
// by value, and with its slots in device arrays as the Pallas kernel takes
// them through scalar prefetch, for the captured decode step).
//
// Bound: bytes. The kernels do no arithmetic; each copied byte is read
// once and written once, so the floor is 2 x (copied bytes) / HBM
// bandwidth. The copies are byte-exact whatever the dtype. Page ids and
// offsets are validated on the host (by the wrapper, or for the indexed
// append by its caller before the upload); a block whose id is
// out of range copies nothing, so a bad id can never become an
// out-of-bounds access. Scatter and append update the pools in place.
//
// Every kernel here but append_indexed_kernel takes its page ids (and
// append's offsets) by value, in the launch's parameter block: a
// __grid_constant__ struct of 2 KB (of the 4 KB limit: kMaxGather or
// kMaxScatter ids, or kMaxAppend pairs), with no index tensor and no
// host-to-device copy; a larger call is launched once per slice. The host work around a launch weighs: a
// restore's scatter or a stage-out's gather moves ~140 pages.
//
// Gather (the stage-out unit, 8 KB rows at qwen2-1.5b width) moves each
// contiguous (layer, page) row with Hopper's 1-D bulk asynchronous copy
// (TMA): one thread a block loads row pieces of at most kBulkChunk bytes
// into a ring of kBulkSlots shared-memory buffers, completing on an
// mbarrier's transaction count, and stores each arrived piece back to
// global memory with a bulk store (commit / wait groups), so kBulkSlots - 1
// loads and a store are in flight in every block; kBulkBlocksPerSM blocks
// an SM walk the list of pieces in turn. At the stage-out shape it runs
// level with a contiguous device copy of the same bytes, ~84% of the HBM
// bound, and 2-3% under the row kernel (PERF.md §6). A bulk copy needs
// 16-byte aligned addresses and a length a multiple of 16: rows that fail
// that take the row kernel, one block per (page, layer) with the widest
// access that both addresses and the row length allow. Scatter and
// append use the row kernel's copy (copy_row): one block per (page or
// token row, layer), 16-byte vectors for the bf16 pools' rows,
// consecutive threads on consecutive addresses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPageThreads = 256;
constexpr int kTokenThreads = 128;

template <typename U>
__device__ __forceinline__ void copy_units(char* dst, const char* src,
                                           long long nbytes) {
  U* d = reinterpret_cast<U*>(dst);
  const U* s = reinterpret_cast<const U*>(src);
  const long long n = nbytes / (long long)sizeof(U);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

// The widest unit dividing both addresses and the length (uniform per
// block: every thread takes the same branch).
__device__ __forceinline__ void copy_row(char* dst, const char* src,
                                         long long nbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src) | (uintptr_t)nbytes;
  if ((a & 15) == 0) {
    copy_units<uint4>(dst, src, nbytes);
  } else if ((a & 7) == 0) {
    copy_units<uint2>(dst, src, nbytes);
  } else if ((a & 3) == 0) {
    copy_units<uint32_t>(dst, src, nbytes);
  } else if ((a & 1) == 0) {
    copy_units<uint16_t>(dst, src, nbytes);
  } else {
    copy_units<uint8_t>(dst, src, nbytes);
  }
}

constexpr int kMaxGather = 512;

struct GatherIds {  // pages [i0, i0 + n) of the staging buffer
  int id[kMaxGather];
};

// grid (n, L): staging[l, i0 + i] = pool[l, ids.id[i]], staging holding
// n_total pages a layer. The path of rows a bulk copy cannot take.
__global__ void gather_rows_kernel(const char* __restrict__ pool,
                                   char* __restrict__ staging,
                                   const __grid_constant__ GatherIds ids,
                                   int i0, int n_total, int P,
                                   long long row_bytes) {
  const int i = blockIdx.x, l = blockIdx.y;
  const int id = ids.id[i];
  if (id < 0 || id >= P) return;
  copy_row(staging + ((long long)l * n_total + i0 + i) * row_bytes,
           pool + ((long long)l * P + id) * row_bytes, row_bytes);
}

// Ring depth, piece size and blocks an SM by measurement at the stage-out
// shape (launch/gather_probes.py): 8 x 4 KB, four blocks an SM (seven
// pieces, 28 KB, in flight a block), level with a contiguous copy of the
// same bytes; 4 x 8 KB within 2%, 2 x 16 KB slower.
constexpr int kBulkSlots = 8;          // ring buffers a block
constexpr int kBulkChunk = 4096;       // bytes a ring buffer: a row piece
constexpr int kBulkBlocksPerSM = 4;    // 4 x 32 KB of shared memory an SM
constexpr int kBulkThreads = 32;       // one warp; its first thread issues

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared, completing `bytes` on the barrier's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// All but the newest N bulk groups have finished reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// All bulk groups have completed (their writes are done).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct BulkGather {
  const char* pool;
  char* staging;
  int i0, n, n_total, P, parts;
  long long row_bytes;

  // Piece q (row r = l * n + i, part q % parts) of the launch: its source,
  // destination and length; false for an id out of range (nothing moves).
  __device__ __forceinline__ bool piece(const GatherIds& ids, int q,
                                        const char*& src, char*& dst,
                                        uint32_t& bytes) const {
    const int r = q / parts, part = q - r * parts;
    const int l = r / n, i = r - l * n;
    const int id = ids.id[i];
    if (id < 0 || id >= P) return false;
    const long long off = (long long)part * kBulkChunk;
    const long long left = row_bytes - off;
    bytes = static_cast<uint32_t>(left < kBulkChunk ? left : kBulkChunk);
    src = pool + ((long long)l * P + id) * row_bytes + off;
    dst = staging + ((long long)l * n_total + i0 + i) * row_bytes + off;
    return true;
  }
};

// grid (a few blocks an SM): block b moves pieces b, b + G, b + 2G, ...
// (G = gridDim.x) of the n x L rows, each row cut into `parts` pieces of
// at most kBulkChunk bytes. Piece j of the block lives in ring slot
// j % kBulkSlots; the slot of piece j - 1 is refilled with piece
// j - 1 + kBulkSlots once piece j - 1's store has read it.
__global__ void __launch_bounds__(kBulkThreads)
    gather_bulk_kernel(const __grid_constant__ GatherIds ids, BulkGather g,
                       int pieces) {
  __shared__ alignas(128) char ring[kBulkSlots][kBulkChunk];
  __shared__ alignas(8) uint64_t full[kBulkSlots];
  if (threadIdx.x != 0) return;
  const int G = gridDim.x, first = blockIdx.x;
  const int count = first < pieces ? (pieces - 1 - first) / G + 1 : 0;
  for (int s = 0; s < kBulkSlots; ++s) mbar_init(&full[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  const char* src;
  char* dst;
  uint32_t bytes;
  auto load = [&](int j) {
    if (!g.piece(ids, first + j * G, src, dst, bytes)) return;
    uint64_t* bar = &full[j % kBulkSlots];
    mbar_expect_tx(bar, bytes);
    bulk_load(ring[j % kBulkSlots], src, bytes, bar);
  };
  for (int j = 0; j < kBulkSlots && j < count; ++j) load(j);
  uint32_t phase = 0;  // bit s: the parity slot s waits for next
  for (int j = 0; j < count; ++j) {
    const int s = j % kBulkSlots;
    if (g.piece(ids, first + j * G, src, dst, bytes)) {
      mbar_wait(&full[s], (phase >> s) & 1u);
      phase ^= 1u << s;
      bulk_store(dst, ring[s], bytes);
    }
    bulk_commit();  // one group a piece, empty for a skipped one
    const int next = j - 1 + kBulkSlots;
    if (j >= 1 && next < count) {
      bulk_wait_read<1>();  // piece j - 1's store has read its slot
      load(next);
    }
  }
  bulk_wait_all();
}

constexpr int kMaxScatter = 512;

struct ScatterIds {  // pages [i0, i0 + n) of the staging buffer
  int id[kMaxScatter];
};

// grid (n, L): pool[l, ids.id[i]] = staging[l, i0 + i], staging holding
// n_total pages a layer
__global__ void scatter_kernel(char* __restrict__ pool,
                               const char* __restrict__ staging,
                               const __grid_constant__ ScatterIds ids, int i0,
                               int n_total, int P, long long row_bytes) {
  const int i = blockIdx.x, l = blockIdx.y;
  const int id = ids.id[i];
  if (id < 0 || id >= P) return;
  copy_row(pool + ((long long)l * P + id) * row_bytes,
           staging + ((long long)l * n_total + i0 + i) * row_bytes,
           row_bytes);
}

constexpr int kMaxAppend = 256;

struct AppendSlots {  // rows [b0, b0 + n) of the batch, n <= kMaxAppend
  int page[kMaxAppend];
  int offset[kMaxAppend];
};

// pool[l, pid, off] = tok[l, b] for K and V; a slot out of range copies
// nothing
__device__ __forceinline__ void append_row(char* k_pool, char* v_pool,
                                           const char* k_tok,
                                           const char* v_tok, int b, int l,
                                           int pid, int off, int B, int P,
                                           int page, long long tok_bytes) {
  if (pid < 0 || pid >= P || off < 0 || off >= page) return;
  const long long dst = (((long long)l * P + pid) * page + off) * tok_bytes;
  const long long src = ((long long)l * B + b) * tok_bytes;
  copy_row(k_pool + dst, k_tok + src, tok_bytes);
  copy_row(v_pool + dst, v_tok + src, tok_bytes);
}

// grid (n, L): pool[l, page[i], offset[i]] = tok[l, b0 + i], K and V
__global__ void append_kernel(char* __restrict__ k_pool,
                              char* __restrict__ v_pool,
                              const char* __restrict__ k_tok,
                              const char* __restrict__ v_tok,
                              const __grid_constant__ AppendSlots slots,
                              int b0, int B, int P, int page,
                              long long tok_bytes) {
  const int i = blockIdx.x, l = blockIdx.y;
  append_row(k_pool, v_pool, k_tok, v_tok, b0 + i, l, slots.page[i],
             slots.offset[i], B, P, page, tok_bytes);
}

// grid (B, L): pool[l, page[b], offset[b]] = tok[l, b], K and V, the slots
// read from int32 device arrays. A captured graph replays this launch with
// whatever the arrays hold at replay time, where the by-value launch would
// keep the slots of the step it was captured in.
__global__ void append_indexed_kernel(char* __restrict__ k_pool,
                                      char* __restrict__ v_pool,
                                      const char* __restrict__ k_tok,
                                      const char* __restrict__ v_tok,
                                      const int* __restrict__ pages,
                                      const int* __restrict__ offsets, int B,
                                      int P, int page, long long tok_bytes) {
  const int b = blockIdx.x, l = blockIdx.y;
  append_row(k_pool, v_pool, k_tok, v_tok, b, l, pages[b], offsets[b], B, P,
             page, tok_bytes);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Pages [i0, i0 + n) of a staging buffer of n_total pages a layer, n <=
// kMaxGather; the ids are a host array of n ints (repeats allowed),
// copied into the launch. Rows of 16-byte-aligned addresses and a length
// a multiple of 16 go through the bulk copies, the rest through the row
// kernel.
int page_gather_launch(const void* pool, void* staging, const int* page_ids,
                       int i0, int n, int n_total, int L, int P,
                       long long row_bytes, void* stream) {
  if (n == 0 || L == 0) return 0;
  if (n < 0 || n > kMaxGather || i0 < 0 || i0 + n > n_total)
    return static_cast<int>(cudaErrorInvalidValue);
  GatherIds ids{};
  for (int i = 0; i < n; ++i) ids.id[i] = page_ids[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(pool) |
                      reinterpret_cast<uintptr_t>(staging) |
                      static_cast<uintptr_t>(row_bytes);
  if ((a & 15) == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int parts =
        static_cast<int>((row_bytes + kBulkChunk - 1) / kBulkChunk);
    const long long pieces = (long long)n * L * parts;
    if (pieces > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>(
        pieces < (long long)kBulkBlocksPerSM * sms ? pieces
                                                   : kBulkBlocksPerSM * sms);
    BulkGather g{static_cast<const char*>(pool), static_cast<char*>(staging),
                 i0, n, n_total, P, parts, row_bytes};
    gather_bulk_kernel<<<grid, kBulkThreads, 0, st>>>(
        ids, g, static_cast<int>(pieces));
    return static_cast<int>(cudaGetLastError());
  }
  gather_rows_kernel<<<dim3(n, L), kPageThreads, 0, st>>>(
      static_cast<const char*>(pool), static_cast<char*>(staging), ids, i0,
      n_total, P, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Pages [i0, i0 + n) of a staging buffer of n_total pages a layer, n <=
// kMaxScatter; the ids are a host array of n ints, copied into the launch.
int page_scatter_launch(void* pool, const void* staging, const int* page_ids,
                        int i0, int n, int n_total, int L, int P,
                        long long row_bytes, void* stream) {
  if (n == 0 || L == 0) return 0;
  if (n < 0 || n > kMaxScatter || i0 < 0 || i0 + n > n_total)
    return static_cast<int>(cudaErrorInvalidValue);
  ScatterIds ids{};
  for (int i = 0; i < n; ++i) ids.id[i] = page_ids[i];
  scatter_kernel<<<dim3(n, L), kPageThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pool), static_cast<const char*>(staging), ids, i0,
      n_total, P, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Rows [b0, b0 + n) of a batch of B token rows, n <= kMaxAppend; the ids
// and offsets are host arrays of n ints, copied into the launch.
int token_append_launch(void* k_pool, void* v_pool, const void* k_tok,
                        const void* v_tok, const int* page_ids,
                        const int* offsets, int b0, int n, int B, int L,
                        int P, int page, long long tok_bytes, void* stream) {
  if (n == 0 || L == 0) return 0;
  if (n < 0 || n > kMaxAppend || b0 < 0 || b0 + n > B)
    return static_cast<int>(cudaErrorInvalidValue);
  AppendSlots slots{};
  for (int i = 0; i < n; ++i) {
    slots.page[i] = page_ids[i];
    slots.offset[i] = offsets[i];
  }
  append_kernel<<<dim3(n, L), kTokenThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pool), static_cast<char*>(v_pool),
      static_cast<const char*>(k_tok), static_cast<const char*>(v_tok), slots,
      b0, B, P, page, tok_bytes);
  return static_cast<int>(cudaGetLastError());
}

// All B token rows in one launch; page_ids and offsets are (B,) int32
// arrays on the device, read by the kernel (the wrapper checks their
// shape and dtype, the caller their values).
int token_append_indexed_launch(void* k_pool, void* v_pool, const void* k_tok,
                                const void* v_tok, const int* page_ids,
                                const int* offsets, int B, int L, int P,
                                int page, long long tok_bytes, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (B < 0 || L < 0 || L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  append_indexed_kernel<<<dim3(B, L), kTokenThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pool), static_cast<char*>(v_pool),
      static_cast<const char*>(k_tok), static_cast<const char*>(v_tok),
      page_ids, offsets, B, P, page, tok_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
