// Paged GQA decode attention over a layer-stacked KV page pool.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/decode_attention/
// kernel.py: paged_decode_attention_kernel (with _decode_kernel).
//
// Bound: bytes. A decode step reads every live K and V row of each
// sequence once and does 4*G flops per element it reads, far below the
// card's flop:byte balance, so the floor is (live K/V bytes) / HBM
// bandwidth. Design: one thread block per (sequence, KV head). The block
// walks the sequence's live pages in table order, a tile of 64 tokens
// (several pages) per step: it stages the tile's K and V rows of its KV
// head in shared memory with 16-byte loads and serves all G query heads
// of that KV head from that single read (what the TPU kernel's shared
// page fetch did). Scores are fp32 dot products over Dh, one thread per
// (head, token) against rows padded to Dh+1 floats so the threads of a
// warp hit distinct banks; max and sum reduce one warp per head with a
// fixed shuffle tree; the online softmax keeps m, l and the accumulator
// in fp32, with NEG_INF = -2e38. Fewer, larger steps amortize the block
// barriers and load latency that a page-per-step loop pays per 16 tokens.
//
// Only live slots (ip * page < len) are read, so dead table slots may
// hold anything; a live id outside the pool poisons the row's outputs
// with NaN instead of faulting. A zero-length row reads nothing and
// yields m = -2e38, l = 0, acc = 0. A row's result depends on nothing
// but its own pages and length (no split-KV, fixed reduction order), so
// a batched call and one-row calls agree bit for bit. No split-KV, TMA or
// wgmma yet: with B*KV blocks a small batch leaves most SMs idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 512;  // 16 warps: latency hiding for one block/SM
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows x D elements (row r at src + r * row_stride; D and the row starts
// 16-byte aligned) into an fp32 [rows][stride] shared-memory tile.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int rows, long long row_stride,
                                          int D, int stride) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = D / V;
  for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
    const int r = c / per_row, j = c - r * per_row;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + r * row_stride + j * V);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < V; ++u) dst[r * stride + j * V + u] = to_float(e[u]);
  }
}

// Tokens per loop step: whole pages, about kTileTokens of them.
__host__ __device__ __forceinline__ int tile_pages(int page) {
  return page >= kTileTokens ? 1 : kTileTokens / page;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lens, float* __restrict__ acc_out,
    T* __restrict__ o_out, float* __restrict__ m_out,
    float* __restrict__ l_out, int KV, int G, int D, int P, int page,
    int n_tab, long long layer_offset, float scale) {
  const int tp = tile_pages(page);
  const int tile = tp * page;        // tokens per step
  const int S = D + 1;               // padded shared-memory row stride
  extern __shared__ float smem[];
  float* q_s = smem;                 // [G][D]
  float* acc_s = q_s + G * D;        // [G][D]
  float* k_s = acc_s + G * D;        // [tile][S]
  float* v_s = k_s + tile * S;       // [tile][S]
  float* p_s = v_s + tile * S;       // [G][tile] scores, then probabilities
  float* m_s = p_s + G * tile;       // [G] running max
  float* l_s = m_s + G;              // [G] running denominator
  float* a_s = l_s + G;              // [G] this step's rescale factor
  __shared__ int bad;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long H = (long long)KV * G;

  load_rows(q_s, q + ((long long)b * H + (long long)kvh * G) * D, G,
            (long long)D, D, D);
  for (int i = tid; i < G * D; i += blockDim.x) acc_s[i] = 0.f;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  if (tid == 0) bad = 0;
  __syncthreads();

  const int len = lens[b];
  int n_live = len > 0 ? (len + page - 1) / page : 0;
  if (n_live > n_tab) n_live = n_tab;
  const int* row_table = tables + (long long)b * n_tab;
  const long long token_stride = (long long)KV * D;
  for (int ip0 = 0; ip0 < n_live; ip0 += tp) {
    const int np = min(tp, n_live - ip0);
    int out_of_pool = 0;             // same value in every thread: uniform
    for (int j = 0; j < np; ++j) {
      const int pid = row_table[ip0 + j];
      out_of_pool |= (pid < 0 || pid >= P);
    }
    if (out_of_pool) {
      if (tid == 0) bad = 1;
      break;
    }
    const int valid = min(np * page, len - ip0 * page);
    for (int j = 0; j < np; ++j) {
      const int rows = min(page, valid - j * page);
      const long long base = layer_offset +
          (long long)row_table[ip0 + j] * page * token_stride + kvh * D;
      load_rows(k_s + j * page * S, k_pool + base, rows, token_stride, D, S);
      load_rows(v_s + j * page * S, v_pool + base, rows, token_stride, D, S);
    }
    __syncthreads();

    for (int pr = tid; pr < G * valid; pr += blockDim.x) {
      const int g = pr / valid, t = pr - g * valid;
      const float* qg = q_s + g * D;
      const float* kt = k_s + t * S;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qg[d] * kt[d];
      p_s[g * tile + t] = s * scale;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * tile;
      float mx = kNegInf;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, pg[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float p = expf(pg[t] - m_new);
        pg[t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* pg = p_s + g * tile;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < valid; ++t) a += pg[t] * v_s[t * S + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }
  __syncthreads();

  const float nan = __int_as_float(0x7fc00000);
  const long long row = ((long long)b * KV + kvh) * G;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const float a = bad ? nan : acc_s[i];
    if (o_out != nullptr) {
      store(o_out + row * D + i, a / fmaxf(l_s[i / D], 1e-30f));
    } else {
      acc_out[row * D + i] = a;
    }
  }
  if (m_out != nullptr && tid < G) {
    m_out[row + tid] = bad ? nan : m_s[tid];
    l_out[row + tid] = bad ? nan : l_s[tid];
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lens, void* acc_out, void* o_out,
           void* m_out, void* l_out, int B, int KV, int G, int D, int P,
           int page, int n_tab, int layer, float scale, cudaStream_t stream) {
  const size_t tile = (size_t)tile_pages(page) * page;
  const size_t smem =
      sizeof(float) * (2 * (size_t)G * D + 2 * tile * (D + 1) +
                       (size_t)G * tile + 3 * (size_t)G);
  static size_t smem_allowed = 48 * 1024;  // per instantiation of T
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const long long layer_offset =
      (long long)layer * P * page * (long long)KV * D;
  decode_kernel<T><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(acc_out),
      static_cast<T*>(o_out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), KV, G, D, P, page, n_tab, layer_offset,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q and both pools). With o_out set the
// normalized output (B, KV*G, D) in q's dtype is written and m_out/l_out
// may be null; otherwise acc_out (B, KV, G, D) fp32 and m_out, l_out
// (B, KV, G) fp32 are the unnormalized online-softmax residuals.
int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                        const void* tables, const void* lens, void* acc_out,
                        void* o_out, void* m_out, void* l_out, int B, int KV,
                        int G, int D, int P, int page, int n_tab, int layer,
                        float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, lens, acc_out, o_out,
                         m_out, l_out, B, KV, G, D, P, page, n_tab, layer,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lens, acc_out,
                                 o_out, m_out, l_out, B, KV, G, D, P, page,
                                 n_tab, layer, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
