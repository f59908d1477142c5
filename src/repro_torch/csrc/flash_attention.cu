// Causal GQA flash attention for prefill, with an optional sliding window
// and tanh softcap.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention/
// kernel.py: flash_attention_kernel (with _flash_kernel).
//
// Bound: operations. Causal attention does 4 * D flops per live (query,
// key) pair (q.k and p.v) on inputs it reads once: at the serving path's
// prefill shape (B=1, H=12, KV=2, S=2048, D=128) that is ~12.9 GFLOP
// against ~15 MB of q, k, v and output, ~13 us at the bf16 tensor-core
// peak against ~4.4 us of HBM traffic. Design of this first, plain
// kernel: one thread block per (query tile of 64 rows, head, batch row);
// a loop inside the block walks the key/value tiles of the head's KV
// group (the TPU grid's sequential key axis), 64 keys per step, from the
// first tile the window reaches to the causal diagonal, so tiles above
// the diagonal or wholly outside the window are never read (the Pallas
// kernel's `live` test). Tiles are staged in shared memory as fp32 (q and
// k rows padded to D+1 floats so the threads of a warp hit distinct
// banks); each of the 256 threads computes a 4 x 4 patch of the 64 x 64
// scores and a 4 x ceil(D/16) patch of the output with fp32 FMAs on the
// CUDA cores, and keeps its rows' online-softmax state (m, l) and the
// fp32 accumulator in registers, reduced across the 16 lanes of a row
// with shuffles. Ragged edges (S not a multiple of 64, D not a multiple
// of 16) are masked, so any S and any D up to 256 work; q, k, v and o are
// read and written through element strides, so the model's (B, S, H, D)
// activations need no transpose copy. Query tiles launch heaviest first
// (the last tiles see the most keys). No tensor cores, TMA or pipelining
// yet: the kernel is far above its bound, and making it fast is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per loop step
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4-row patch
constexpr int kPS = kBK + 1;   // padded row stride of the probability tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {  // element strides of a (B, heads, S, D) view; D is unit
  long long b, h, s;
};

// rows [row0, row0 + n) of one head into an fp32 [n][stride] tile; rows
// at or past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n, int S, int D, int stride) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * stride + d] =
        row0 + r < S ? to_float(src[(long long)(row0 + r) * row_stride + d])
                     : 0.f;
  }
}

template <typename T, int NJ>  // NJ = output columns per thread, >= D / 16
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
    Strides vs, Strides os, int G, int S, int D, float scale, int causal,
    int window, float softcap) {
  extern __shared__ float smem[];
  const int QS = D + 1;
  float* q_s = smem;              // [kBQ][D + 1]
  float* k_s = q_s + kBQ * QS;    // [kBK][D + 1]
  float* v_s = k_s + kBK * QS;    // [kBK][D]
  float* p_s = v_s + kBK * D;     // [kBQ][kBK + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = qt * kBQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  load_tile(q_s, qb, qs.s, q0, kBQ, S, D, QS);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }

  // live key range: the causal diagonal above, the window below
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  const int kv_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    load_tile(k_s, kb, ks.s, k0, kBK, S, D, QS);
    load_tile(v_s, vb, vs.s, k0, kBK, S, D, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = q_s[(tr + 16 * a) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = k_s[(tc + 16 * c) * QS + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + tr + 16 * a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tc + 16 * c;
        float x = s[a][c] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool live = j < S && (!causal || j <= i) &&
                          (window <= 0 || j > i - window);
        s[a][c] = live ? x : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[a][c] > kNegInf ? expf(s[a][c] - m_new) : 0.f;
        p_s[(tr + 16 * a) * kPS + tc + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();

    for (int t = 0; t < kBK; ++t) {
      float pa[4], vj[NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_s[(tr + 16 * a) * kPS + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tc + 16 * j;
        vj[j] = d < D ? v_s[t * D + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[a][j] = fmaf(pa[a], vj[j], acc[a][j]);
    }
    __syncthreads();
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + tr + 16 * a;
    if (i >= S) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tc + 16 * j;
      if (d < D) store(ob + (long long)i * os.s + d, acc[a][j] * inv);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * kPS);
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int KV, int S, int D,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, H / KV,
      S, D, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* st, int B, int H, int KV, int S, int D,
             float scale, int causal, int window, float softcap,
             cudaStream_t s) {
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, st, B, H, KV, S, D, scale, causal,
                        window, softcap, s);
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, st, B, H, KV, S, D, scale, causal,
                        window, softcap, s);
  return launch<T, 16>(q, k, v, o, st, B, H, KV, S, D, scale, causal, window,
                       softcap, s);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, H, S, D), k/v (B, KV, S, D), o (B, H, S, D), all of one dtype
// (0 = float32, 1 = bfloat16) with unit stride along D; strides holds the
// element strides (batch, head, position) of q, k, v and o, in that
// order. 1 <= D <= 256, H a multiple of KV; window <= 0 means none,
// softcap <= 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int B, int H,
                           int KV, int S, int D, float scale, int causal,
                           int window, float softcap, int dtype,
                           void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (D < 1 || D > 256 || KV < 1 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, strides, B, H, KV, S, D, scale, causal,
                           window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, H, KV, S, D,
                                   scale, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
