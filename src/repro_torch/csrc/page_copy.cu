// Page gather, page scatter and token append for the paged KV pools.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/page_copy/kernel.py:
// page_gather_kernel, page_scatter_kernel and token_append_kernel.
//
// Bound: bytes. The kernels do no arithmetic; each copied byte is read
// once and written once, so the floor is 2 x (copied bytes) / HBM
// bandwidth. Design: one thread block per (page or token row, layer),
// which spreads a stage-out of n pages over n*L blocks; each block moves
// its contiguous row with the widest access that both addresses and the
// row length allow (16-byte vectors for the bf16 pools' 16-byte-aligned
// rows, narrower scalar units otherwise), consecutive threads on
// consecutive addresses. The copies are byte-exact whatever the dtype.
// Page ids and offsets are validated on the host by the wrapper; a block
// whose id is out of range copies nothing, so a bad id can never become
// an out-of-bounds access. The pools are updated in place.
//
// Token append and page scatter are short (a few hundred bytes a row for
// append; ~140 pages of a restore for scatter), so the host work around a
// launch weighs: their page ids (and append's offsets) travel by value in
// the launch's parameter block, a __grid_constant__ struct of 2 KB (of the
// 4 KB limit: kMaxAppend pairs, or kMaxScatter ids), with no index tensor
// and no host-to-device copy; a larger call is launched once per slice.
// Gather still reads its ids from a device array.
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

// grid (n, L): staging[l, i] = pool[l, ids[i]]
__global__ void gather_kernel(const char* __restrict__ pool,
                              const int* __restrict__ ids,
                              char* __restrict__ staging, int n, int P,
                              long long row_bytes) {
  const int i = blockIdx.x, l = blockIdx.y;
  const int id = ids[i];
  if (id < 0 || id >= P) return;
  copy_row(staging + ((long long)l * n + i) * row_bytes,
           pool + ((long long)l * P + id) * row_bytes, row_bytes);
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

// grid (n, L): pool[l, page[i], offset[i]] = tok[l, b0 + i], K and V
__global__ void append_kernel(char* __restrict__ k_pool,
                              char* __restrict__ v_pool,
                              const char* __restrict__ k_tok,
                              const char* __restrict__ v_tok,
                              const __grid_constant__ AppendSlots slots,
                              int b0, int B, int P, int page,
                              long long tok_bytes) {
  const int i = blockIdx.x, l = blockIdx.y;
  const int pid = slots.page[i], off = slots.offset[i];
  if (pid < 0 || pid >= P || off < 0 || off >= page) return;
  const long long dst = (((long long)l * P + pid) * page + off) * tok_bytes;
  const long long src = ((long long)l * B + b0 + i) * tok_bytes;
  copy_row(k_pool + dst, k_tok + src, tok_bytes);
  copy_row(v_pool + dst, v_tok + src, tok_bytes);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int page_gather_launch(const void* pool, const void* ids, void* staging,
                       int n, int L, int P, long long row_bytes,
                       void* stream) {
  if (n == 0 || L == 0) return 0;
  gather_kernel<<<dim3(n, L), kPageThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(pool), static_cast<const int*>(ids),
      static_cast<char*>(staging), n, P, row_bytes);
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

}  // extern "C"
