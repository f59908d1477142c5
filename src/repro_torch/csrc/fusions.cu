// The elementwise chains and row norms of the paged decode step, fused.
//
// Replaces no Pallas kernel. The reference's serving decode step is one
// XLA program (jax.jit(PagedKVRuntime._decode_step_impl),
// src/repro/serving/paged_runtime.py:69, its body at :377-444), and XLA
// fuses each elementwise chain of it into one kernel. The port's plain
// spelling of the step (repro_torch/serving/paged_runtime.py,
// _decode_step with fused=False) runs every op of those chains as a torch
// kernel of its own, ~90 a layer. These are the fusions, by hand; the
// fourth, the new token's exact merge, rides in decode_attention.cu's
// combine:
// - rms_norm_kernel: a row's RMS norm (models/common.rms_norm) alone (a
//   first layer's ln1, a qk norm), or after a residual add whose sum it
//   reads in fp32 (ln2 after the out-projection, common.add_rms_norm) or
//   rounded to the compute dtype (the FFN's residual add folded into the
//   next layer's ln1, and after the last layer into the final norm: the
//   reference's scan carry);
// - qkv_rope_kernel: the qkv biases, the optional qk norm and the rotary
//   embedding of the three projections (models/attention.qkv_project,
//   common.apply_rope), written in the layouts the decode kernel and the
//   token append read (an fp32 or wider decode step's); in its cache
//   launch (qkv_rope_cache_launch, the prefill / extend chunk of
//   Model.forward(fused=True)), a chunk's rows at a position each, k and v
//   written straight into the layer's cache at the row's offset, read on
//   the device (attention.write_cache);
// - qkv_proj_kernel: the bf16 decode step's three qkv products with
//   qkv_rope_kernel's chain in their epilogue, one launch;
// - gated_act_kernel: act(gate) * up, SiLU or the tanh GELU
//   (models/mlp.mlp_apply, common._silu, common._gelu_tanh);
// - gate_up_kernel: the decode step's act(x @ w1) * (x @ w3) as one
//   launch, the two products on the tensor cores and the activation in
//   their epilogue (its design and bound at the kernel below).
//
// Numerics. Each kernel computes the plain spelling's arithmetic op for
// op. Every fp32 operation that the plain spelling runs as a torch kernel
// of its own is one __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn here,
// which nvcc never contracts into an FMA (so the source builds with the
// default flags, and expf, tanhf and rsqrtf are the functions torch's CUDA
// kernels call); every rounding to the compute dtype that the plain
// spelling makes between two ops is a __float2bfloat16_rn here. So the
// RoPE and activation passes are bit-equal to the plain spelling. A norm
// sums each row's squares in one fixed order, a function of the row
// length alone, so a row's result does not depend on the batch: the row's
// R threads (norm_geometry below) each sum their 16-byte chunks t, t + R,
// ... in element order, a xor-shuffle tree adds a warp's 32 sums, and the
// row's warp sums are added in warp order. torch's mean sums in another
// order, so a norm is within one ulp of the compute dtype of the plain
// one, not equal to it. A row of at most 64 chunks takes one warp (R =
// 32), so the qk norm of the qkv passes (a head row on at most one warp's
// lanes) sums in the same order.
//
// Bound: bytes. Each pass reads its inputs once and writes its outputs
// once, with a few flops an element. At the decode step's shapes (B rows
// of d_model, d_ff or the heads) a pass moves tens of KB, so each takes
// about a launch's latency; what the fusion removes is the kernels
// between, each a round trip to device memory. The norm's design follows
// from that: a row is spread over a block, one thread a 16-byte chunk (up
// to 512 threads a row; a longer row gives a thread up to 4 chunks), and
// each thread loads its x, delta and scale chunks at once and keeps them
// in registers across the reduction, so a row costs one round trip to
// memory for its reads and one block barrier (the row is read twice only
// past 2048 chunks: 16384 bf16 or 8192 fp32 elements). At qwen2-1.5b's
// 4 x 1536 decode rows its bytes take 15.6 ns at 3.35 TB/s, far under a
// launch: empty_kernel, launched alone, is the floor a graph node has on
// the card, timed beside it.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kNormMaxThreads = 512;  // a norm row's threads, at most
constexpr int kActThreads = 256;
constexpr int kActMaxBlocks = 132 * 8;

enum NormMode { kPlain = 0, kAddF32 = 1, kAddRounded = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and read back: the value a T tensor holds between two
// ops of the plain spelling.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_float(from_float<T>(x));
}

// One 16-byte chunk of T as floats, and back.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) x[i] = to_float(e[i]);
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* x) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) e[i] = from_float<T>(x[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// The sum of the warp's 32 lane values, the same on every lane (each
// step adds a pair in either order, and fp32 addition commutes).
__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// The row's values at one chunk: x, or the residual sum x + delta in fp32
// (kAddF32) or rounded to T (kAddRounded).
template <typename T>
__device__ __forceinline__ void row_chunk(const T* __restrict__ x,
                                          const T* __restrict__ delta,
                                          int mode, long long off, float* v) {
  constexpr int N = 16 / sizeof(T);
  load16(x + off, v);
  if (mode != kPlain) {
    float d[N];
    load16(delta + off, d);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = __fadd_rn(v[i], d[i]);
      if (mode == kAddRounded) v[i] = rnd<T>(v[i]);
    }
  }
}

// A norm row of `chunks` 16-byte chunks on `rt` threads (a multiple of
// 32), `rows_per_block` rows a block (norm_geometry: functions of the
// row length alone). Thread t of a row holds chunks t, t + rt, ... up to
// CPT of them in registers; CPT = 0 streams any number, reading the row
// again for the scale pass. h_out = norm(row) * (1 + scale) in T; with a
// residual add also x_out = the sum in T.
template <typename T, int CPT>
__global__ void __launch_bounds__(kNormMaxThreads) rms_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ delta,
    const T* __restrict__ scale, T* __restrict__ x_out,
    T* __restrict__ h_out, int rows, int D, float eps, int mode, int rt) {
  constexpr int N = 16 / sizeof(T);
  constexpr int R = CPT > 0 ? CPT : 1;
  __shared__ float warp_sums[kNormMaxThreads / 32];
  const int chunks = D / N;
  const int sub = threadIdx.x / rt;           // the block's row
  const int t = threadIdx.x - sub * rt;
  const int row = blockIdx.x * (blockDim.x / rt) + sub;
  const bool live = row < rows;
  const long long base = (long long)row * D;
  float v[R][N], g[R][N];
  float ss = 0.f;
  if (CPT > 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) {   // every load issued before any use
      const int c = t + k * rt;
      if (live && c < chunks) {
        row_chunk(x, delta, mode, base + (long long)c * N, v[k]);
        load16(scale + (long long)c * N, g[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (live && t + k * rt < chunks)
#pragma unroll
        for (int i = 0; i < N; ++i)
          ss = __fadd_rn(ss, __fmul_rn(v[k][i], v[k][i]));
  } else {
    for (int c = t; live && c < chunks; c += rt) {
      row_chunk(x, delta, mode, base + (long long)c * N, v[0]);
#pragma unroll
      for (int i = 0; i < N; ++i)
        ss = __fadd_rn(ss, __fmul_rn(v[0][i], v[0][i]));
    }
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  const int wpr = rt >> 5;
  const float* sums = warp_sums + sub * wpr;
  float total = sums[0];
  for (int w = 1; w < wpr; ++w) total = __fadd_rn(total, sums[w]);
  // torch's mean is the sum times (float)(1 / n)
  const float r = rsqrtf(
      __fadd_rn(__fmul_rn(total, __fdiv_rn(1.0f, (float)D)), eps));
  if (!live) return;
  auto finish = [&](int c, const float* vc, const float* gc) {
    float h[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      h[i] = __fmul_rn(__fmul_rn(vc[i], r), __fadd_rn(1.0f, gc[i]));
    store16(h_out + base + (long long)c * N, h);
    if (mode != kPlain) store16(x_out + base + (long long)c * N, vc);
  };
  if (CPT > 0) {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (t + k * rt < chunks) finish(t + k * rt, v[k], g[k]);
  } else {
    for (int c = t; c < chunks; c += rt) {
      row_chunk(x, delta, mode, base + (long long)c * N, v[0]);
      load16(scale + (long long)c * N, g[0]);
      finish(c, v[0], g[0]);
    }
  }
}

// Launched alone, it times the floor a launch (a graph node) costs.
__global__ void empty_kernel() {}

// ------------------------------------------------------ the qkv row pass
// The chain after the qkv projections, one head row at a time: the bias
// added and rounded (q + bq), q and k normed (qn, kn), then their leading
// 2 rot_half channels rotated, each product, difference and sum rounded
// as apply_rope's ops round them, cos and sin rounded to T as apply_rope
// casts its tables. The rows of token b are its H query heads, then its
// KV key heads, then its KV value heads; row b reads table row b mod
// tab_rows (tab_rows = B, or a chunk's C positions shared by its
// sequences).
//
// Bound: bytes (each row read and written once; ~8 flops an element).
// Design (kernels/fusions/kernel.rope_geometry): a row of `chunks` 16-byte
// chunks lies on rt lanes of one warp (rt the power of two at or above
// chunks, at most 32), lane c holding chunk c in registers; the row, its
// bias and norm chunks are loaded before any is used, so a launch of many
// rows keeps 16-byte loads in flight on every SM (and a block of 256
// threads keeps at most 64 registers a thread, so path A's 512-row chunk
// is one wave). Past the loads the pass is bound by the card's
// conversions to bf16 (16 an SM a clock, an eighth of its fp32 rate):
// every rounding is a packed pair, one conversion for two values, and
// RoPE's products of two bf16 values are bf16x2 products, which round the
// exact product once as the fp32 product rounded to bf16 does, with no
// conversion at all. The qk norm sums in rms_norm_kernel's one-warp
// order: each lane its chunk's squares in element order, then the xor
// tree over the row's rt lanes; the one-warp tree's steps past rt only
// add lanes that hold no chunk, exactly 0, so dropping them changes no
// bit. RoPE's partner channel (i and i + rot_half) is another lane's
// chunk where rot_half is a whole number of chunks (a shuffle), else it
// is read from a copy of the row in shared memory (kShared).
constexpr int kRowThreads = 256;   // a row-pass block
constexpr int kMaxHeadDim = 256;

// v[0 .. n) rounded to T and read back, two values a conversion.
template <typename T, int n>
__device__ __forceinline__ void rnd_pairs(float* v) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < n; i += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[i], v[i + 1]);
      v[i] = __low2float(h);
      v[i + 1] = __high2float(h);
    }
  }
}

// Two floats that hold bf16 values, as a bf16 pair (their high halves).
__device__ __forceinline__ __nv_bfloat162 pack_bf16(float lo, float hi) {
  const uint32_t u = __byte_perm(__float_as_uint(lo), __float_as_uint(hi),
                                 0x7632);
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// Lane c's share of a head row's chain (N = 16 / sizeof(T) values of
// chunk c): x the projection as T holds it, bb its bias chunk, g its norm
// scale chunk, cs / sn its channels' cos and sin as the fp32 tables hold
// them (rounded to T here), loaded by the caller. `live` lanes hold a
// chunk of a row; `bias`, `norm`, `rope` say what the row takes; `normed`
// and rot_half > 0 are the same for the whole launch, so every lane of a
// warp runs the same shuffles. stage: the row's Dh floats of shared
// memory (kShared only). Leaves the output in x.
template <typename T, bool kShared>
__device__ __forceinline__ void row_chain(float* x, const float* bb,
                                          const float* g, const float* cs,
                                          const float* sn, int c, int rt,
                                          bool live, bool bias, bool norm,
                                          bool normed, bool rope, int Dh,
                                          int rot_half, float eps,
                                          float* stage) {
  constexpr int N = 16 / sizeof(T);
  if (live && bias) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __fadd_rn(x[i], bb[i]);
    rnd_pairs<T, N>(x);
  }
  if (normed) {
    float ss = 0.f;
    if (live && norm)
#pragma unroll
      for (int i = 0; i < N; ++i) ss = __fadd_rn(ss, __fmul_rn(x[i], x[i]));
    for (int off = rt >> 1; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    // torch's mean is the sum times (float)(1 / n)
    const float rr = rsqrtf(
        __fadd_rn(__fmul_rn(ss, __fdiv_rn(1.0f, (float)Dh)), eps));
    if (live && norm) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        x[i] = __fmul_rn(__fmul_rn(x[i], rr), __fadd_rn(1.0f, g[i]));
      rnd_pairs<T, N>(x);
    }
  }
  if (rot_half == 0) return;
  float p[N];                      // the partner channels' values
  if constexpr (kShared) {
    if (live)
#pragma unroll
      for (int i = 0; i < N; ++i) stage[c * N + i] = x[i];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = c * N + i;
      p[i] = live && e < 2 * rot_half
                 ? stage[e < rot_half ? e + rot_half : e - rot_half]
                 : 0.f;
    }
    __syncwarp();                  // the stage is free for the next row
  } else {
    const int R = rot_half / N;
    const int lane = threadIdx.x & 31;
    const int src =
        (lane & ~(rt - 1)) + (c < R ? c + R : c < 2 * R ? c - R : c);
#pragma unroll
    for (int i = 0; i < N; ++i)
      p[i] = __shfl_sync(0xffffffffu, x[i], src);
  }
  if (!live || !rope || c * N >= 2 * rot_half) return;
  float a[N], b[N];                // x cos and the partner's sin, rounded
  if constexpr (sizeof(T) == 2) {
    // cos and sin rounded to bf16 a pair a conversion; x and its partner
    // are bf16 values already, so a bf16x2 product rounds each exact
    // product once, as the fp32 product rounded to bf16 does
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const __nv_bfloat162 c2 = __floats2bfloat162_rn(cs[i], cs[i + 1]);
      const __nv_bfloat162 s2 = __floats2bfloat162_rn(sn[i], sn[i + 1]);
      const __nv_bfloat162 ca = __hmul2(pack_bf16(x[i], x[i + 1]), c2);
      const __nv_bfloat162 sb = __hmul2(pack_bf16(p[i], p[i + 1]), s2);
      a[i] = __low2float(ca), a[i + 1] = __high2float(ca);
      b[i] = __low2float(sb), b[i + 1] = __high2float(sb);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      a[i] = __fmul_rn(x[i], cs[i]);
      b[i] = __fmul_rn(p[i], sn[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = c * N + i;
    if (e < rot_half)                          // x1 cos - x2 sin
      x[i] = __fsub_rn(a[i], b[i]);
    else if (e < 2 * rot_half)                 // x2 cos + x1 sin
      x[i] = __fadd_rn(a[i], b[i]);
  }
  rnd_pairs<T, N>(x);              // channels past the rotation: unchanged
}

// Chunk c's cos and sin as the fp32 tables hold them (channel e = c N + i
// takes table column e mod rot_half, for e < 2 rot_half): 16-byte loads
// where a chunk's columns are whole 16-byte pieces of the row, else one
// float at a time.
template <typename T, bool kShared>
__device__ __forceinline__ void chunk_tables(const float* __restrict__ cos_r,
                                             const float* __restrict__ sin_r,
                                             int c, int rot_half, float* cs,
                                             float* sn) {
  constexpr int N = 16 / sizeof(T);
  if constexpr (!kShared) {
    if (c * N >= 2 * rot_half) return;
    const int j = (c * N) % rot_half;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(cos_r + j + i);
      const float4 b = *reinterpret_cast<const float4*>(sin_r + j + i);
      cs[i] = a.x, cs[i + 1] = a.y, cs[i + 2] = a.z, cs[i + 3] = a.w;
      sn[i] = b.x, sn[i + 1] = b.y, sn[i + 2] = b.z, sn[i + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = c * N + i;
      if (e >= 2 * rot_half) continue;
      const int j = e < rot_half ? e : e - rot_half;
      cs[i] = cos_r[j];
      sn[i] = sin_r[j];
    }
  }
}

// grid ceil(B (H + 2 KV) / (kRowThreads / rt)): the block's rows are
// consecutive head rows, rt lanes each. q_out (B, H, Dh). Without `off`,
// k_out and v_out (B, KV, Dh). With `off` (the cache launch) the B rows
// are nb sequences of C tokens: row b = s C + c of sequence s goes to slot
// clamp(off[s], 0, slots - C) + c of k_out / v_out, caches of (nb, slots,
// KV, Dh) whose sequences lie cache_stride elements apart (write_cache's
// clamp, the offset read by every thread: one graph replays any offset),
// and also to k_rows / v_rows (B, KV, Dh) where given.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kRowThreads, 4) qkv_rope_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ bq,
    const T* __restrict__ bk, const T* __restrict__ bv,
    const T* __restrict__ qn, const T* __restrict__ kn,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    T* __restrict__ q_out, T* __restrict__ k_out, T* __restrict__ v_out,
    int B, int H, int KV, int Dh, int rot_half, float eps, int tab_rows,
    const int* __restrict__ off, int C, int slots, long long cache_stride,
    T* __restrict__ k_rows, T* __restrict__ v_rows, int rt) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float stage[kShared ? kRowThreads * N : 1];
  const int per = H + 2 * KV;
  const int grp = threadIdx.x / rt, c = threadIdx.x - grp * rt;
  const int r = blockIdx.x * (kRowThreads / rt) + grp;
  const bool row_live = r < B * per;   // B (H + 2 KV) < 2^31: the host's
  const int b = row_live ? r / per : 0;
  const int j = row_live ? r - b * per : 0;
  const bool live = row_live && c < Dh / N;
  const T* src;
  const T* bias;
  const T* norm;
  T* dst;
  T* dst2 = nullptr;           // the chunk's k / v rows, where asked for
  bool rope;
  if (j < H) {
    src = q + ((long long)b * H + j) * Dh;
    dst = q_out + ((long long)b * H + j) * Dh;
    bias = bq != nullptr ? bq + (long long)j * Dh : nullptr;
    norm = qn;
    rope = true;
  } else {
    const bool is_k = j < H + KV;
    const int h = is_k ? j - H : j - H - KV;
    const long long row = ((long long)b * KV + h) * Dh;
    src = (is_k ? k : v) + row;
    const T* bs = is_k ? bk : bv;
    bias = bs != nullptr ? bs + (long long)h * Dh : nullptr;
    norm = is_k ? kn : nullptr;
    rope = is_k;
    T* out = is_k ? k_out : v_out;
    if (off == nullptr) {
      dst = out + row;
    } else {
      const int s = b / C, cc = b - s * C;
      const int start = max(min(off[s], slots - C), 0);
      dst = out + s * cache_stride + ((long long)(start + cc) * KV + h) * Dh;
      T* rows = is_k ? k_rows : v_rows;
      if (rows != nullptr) dst2 = rows + row;
    }
  }
  rope = rope && rot_half > 0;
  float x[N] = {}, bb[N], g[N], cs[N], sn[N];
  if (live) {                      // every load before any use
    load16(src + c * N, x);
    if (bias != nullptr) load16(bias + c * N, bb);
    if (norm != nullptr) load16(norm + c * N, g);
  }
  if (live && rope) {
    const long long at = (long long)(b % tab_rows) * rot_half;
    chunk_tables<T, kShared>(cos_t + at, sin_t + at, c, rot_half, cs, sn);
  }
  row_chain<T, kShared>(x, bb, g, cs, sn, c, rt, live, bias != nullptr,
                        norm != nullptr, qn != nullptr || kn != nullptr, rope,
                        Dh, rot_half, eps, stage + grp * rt * N);
  if (!live) return;
  store16(dst + c * N, x);
  if (dst2 != nullptr) store16(dst2 + c * N, x);
}

// x * (1 / (1 + exp(-x))), every op rounded to T (common._silu); 1 / y is
// torch's reciprocal, then a product with 1.0 that changes nothing.
template <typename T>
__device__ __forceinline__ float silu(float x) {
  const float e = rnd<T>(expf(-x));
  const float d = rnd<T>(__fadd_rn(e, 1.0f));
  const float rc = rnd<T>(__fdiv_rn(1.0f, d));
  return rnd<T>(__fmul_rn(x, rc));
}

// x * (0.5 * (1 + tanh(c * (x + k * (x * x * x))))), every op rounded to
// T, k and c the constants rounded to T (common._gelu_tanh).
template <typename T>
__device__ __forceinline__ float gelu(float x, float k, float c) {
  const float x2 = rnd<T>(__fmul_rn(x, x));
  const float x3 = rnd<T>(__fmul_rn(x2, x));
  const float kx3 = rnd<T>(__fmul_rn(x3, k));
  const float in = rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(x, kx3)), c));
  const float th = rnd<T>(tanhf(in));
  const float half = rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(th, 1.0f)), 0.5f));
  return rnd<T>(__fmul_rn(x, half));
}

// out = act(gate) * up, 16 bytes a thread a step, grid-strided.
template <typename T, bool kGelu>
__global__ void __launch_bounds__(kActThreads) gated_act_kernel(
    const T* __restrict__ gate, const T* __restrict__ up,
    T* __restrict__ out, long long chunks, float k, float c) {
  constexpr int N = 16 / sizeof(T);
  for (long long i = blockIdx.x * (long long)kActThreads + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * kActThreads) {
    float g[N], u[N], y[N];
    load16(gate + i * N, g);
    load16(up + i * N, u);
#pragma unroll
    for (int e = 0; e < N; ++e)
      y[e] = __fmul_rn(kGelu ? gelu<T>(g[e], k, c) : silu<T>(g[e]), u[e]);
    store16(out + i * N, y);
  }
}

// ------------------------------------------------- the gate/up product
// gate_up_kernel: out = act(round(x @ w1)) * round(x @ w3) for the decode
// step's B <= 16 rows x (B, K) bf16 and the stored weights w1, w3 (K, N)
// bf16, each product an fp32 sum rounded once to bf16 (as a bf16 matmul
// returns it), the activation and the product with up the plain
// spelling's (silu / gelu above, gated_act_kernel's ops).
//
// Bound: bytes. The two weights are 2 K N bf16 (55.0 MB at qwen2-1.5b's
// 1536 x 8960: 16.4 us at 3.35 TB/s); x and out are a few KB, and the
// 4 B K N flops are ~2 B flops a weight byte, far below the tensor
// cores' balance. What the kernel needs is every SM streaming weights
// with enough bytes in flight, and the activation where gate and up
// already are: in registers, so neither is written to device memory.
//
// Design. A CTA takes 64 columns of both w1 and w3 (the same columns, so
// its epilogue holds gate and up of an element together) and all of K.
// One thread streams K through a ring of kGuStages stages with 2-D TMA
// loads (a 64 x 64 box of each weight, 128-byte swizzled, the ragged
// edges zero-filled) completing on an mbarrier a stage; the tensor maps
// are encoded once a weight address (gate_up_maps). Four warps each own
// 16 of the columns: for each 16 rows of K a warp reads its A operands
// (16 columns x 16 rows of w1, then of w3) with ldmatrix.trans straight
// from the swizzled stage and runs mma.sync m16n8k16 with the tokens on
// the N side (one or two 8-row tiles): x's 16 x 64 slice of the stage's
// rows of K rides in the same stage, a third TMA box (rows past B
// zero-filled; its map encoded at each launch, once at a graph's
// capture), read with ldmatrix, so no load waits in the loop but the
// stage's. Each sum runs over K in one order, fixed by K alone: a row's
// bits do not depend on B or on timing. Then the epilogue: gate and up
// rounded to bf16, the activation, their product rounded and stored.
// qwen2-1.5b's 8960 columns make 140 CTAs of 55 KB, one wave at up to
// three CTAs an SM.
constexpr int kGuBox = 64;                       // columns a CTA (one box)
constexpr int kGuK = 64;                         // rows of K a stage
constexpr int kGuThreads = 128;                  // 4 warps, 16 columns each
constexpr int kGuStages = 3;                     // the ring's stages
constexpr int kGuBoxBytes = kGuK * kGuBox * 2;   // one box, 8 KB
constexpr int kGuXBytes = 16 * kGuK * 2;         // x's box: 16 rows, 2 KB
constexpr int kGuStageBytes = 2 * kGuBoxBytes + kGuXBytes;
// 1024 bytes to align the ring, the ring, its mbarriers
constexpr int kGuSmem = 1024 + kGuStages * kGuStageBytes + 8 * kGuStages;
constexpr int kGuMaxRows = 16;                   // tokens, at most
constexpr int kGuMapBytes = 2 * sizeof(CUtensorMap);
constexpr int kGuEncodeFailed = 10000;           // + the encoder's CUresult

__device__ __forceinline__ uint32_t gu_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void gu_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   gu_smem_u32(bar)));
}

__device__ __forceinline__ void gu_mbar_expect_tx(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          gu_smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void gu_mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "GU_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra GU_WAIT;\n"
      "}\n" ::"r"(gu_smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One 64-column x 64-row box of a weight into shared memory.
__device__ __forceinline__ void gu_tma_load(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          gu_smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(gu_smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

__device__ __forceinline__ void gu_ldmatrix_x4_trans(uint32_t* r,
                                                     const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(gu_smem_u32(smem)));
}

__device__ __forceinline__ void gu_ldmatrix_x4(uint32_t* r,
                                               const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(gu_smem_u32(smem)));
}

__device__ __forceinline__ void gu_mma(float* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid: one CTA a 64-column tile; NT 8-row token tiles.
template <int NT, bool kGelu>
__global__ void __launch_bounds__(kGuThreads) gate_up_kernel(
    const __grid_constant__ CUtensorMap tm_w1,
    const __grid_constant__ CUtensorMap tm_w3,
    const __grid_constant__ CUtensorMap tm_x, __nv_bfloat16* __restrict__ out,
    int B, int K, int N, float gk, float gc) {
  extern __shared__ __align__(16) unsigned char gu_raw[];
  // the ring at a 1024-byte boundary (the 128-byte swizzle's period): a
  // stage is w1's box, then w3's, then x's (a multiple of 1024 bytes)
  unsigned char* ring = gu_raw + ((1024 - (gu_smem_u32(gu_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kGuStages * kGuStageBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kGuBox;
  const int n_it = (K + kGuK - 1) / kGuK;

  if (tid == 0) {
    for (int s = 0; s < kGuStages; ++s) gu_mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_stage = [&](int it) {
    const int s = it % kGuStages;
    unsigned char* st = ring + s * kGuStageBytes;
    gu_mbar_expect_tx(full + s, kGuStageBytes);
    gu_tma_load(st, &tm_w1, full + s, n0, it * kGuK);
    gu_tma_load(st + kGuBoxBytes, &tm_w3, full + s, n0, it * kGuK);
    gu_tma_load(st + 2 * kGuBoxBytes, &tm_x, full + s, it * kGuK, 0);
  };
  if (tid == 0)
    for (int it = 0; it < min(kGuStages, n_it); ++it) load_stage(it);

  float cg[NT][4], cu[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) cg[t][e] = cu[t][e] = 0.f;
  // this lane's ldmatrix row in a 16-row step and, for the warp's 16
  // columns (16 warp ..), its swizzled chunk: the 8 x 8 matrix j = lane /
  // 8 is rows 8 (j / 2) .. of columns 16 warp + 8 (j % 2) ..; the 128-byte
  // swizzle moves 16-byte chunk c of row r to c ^ (r % 8)
  const int lrow = 8 * ((lane >> 3) >> 1) + (lane & 7);
  // x's rows: the same lane's row lrow (token) and chunk 2 kk + (j % 2)
  const int xhalf = (lane >> 3) & 1;
  const int lbase = ((2 * warp + xhalf) ^ (lane & 7)) * 16;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kGuStages;
    gu_mbar_wait(full + s, (it / kGuStages) & 1);
    const unsigned char* w1s = ring + s * kGuStageBytes;
    const unsigned char* w3s = w1s + kGuBoxBytes;
    const unsigned char* xs = w1s + 2 * kGuBoxBytes;
#pragma unroll
    for (int kk = 0; kk < kGuK / 16; ++kk) {
      // B fragments: tokens 0-7 (k 16 kk + 0-7, 8-15), then tokens 8-15
      uint32_t xb[4];
      gu_ldmatrix_x4(xb, xs + lrow * 128 +
                             (((2 * kk + xhalf) ^ (lane & 7)) << 4));
      const int off = lbase + (16 * kk + lrow) * 128;
      uint32_t a1[4], a3[4];
      gu_ldmatrix_x4_trans(a1, w1s + off);
      gu_ldmatrix_x4_trans(a3, w3s + off);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        gu_mma(cg[t], a1, xb[2 * t], xb[2 * t + 1]);
        gu_mma(cu[t], a3, xb[2 * t], xb[2 * t + 1]);
      }
    }
    __syncthreads();                  // every warp is done with stage s
    if (tid == 0 && it + kGuStages < n_it) load_stage(it + kGuStages);
  }

  // accumulator e of token tile t: column 16 warp + gq + 8 (e / 2), token
  // 8 t + 2 tq + e % 2
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + 16 * warp + gq + 8 * (e >> 1);
      const int b = 8 * t + 2 * tq + (e & 1);
      if (b >= B || col >= N) continue;
      const float g = rnd<__nv_bfloat16>(cg[t][e]);
      const float u = rnd<__nv_bfloat16>(cu[t][e]);
      const float a = kGelu ? gelu<__nv_bfloat16>(g, gk, gc)
                            : silu<__nv_bfloat16>(g);
      out[(long long)b * N + col] = __float2bfloat16_rn(__fmul_rn(a, u));
    }
}

using GuEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

GuEncodeTiled gu_encoder() {
  static GuEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<GuEncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 (rows, cols) row-major matrix as boxes of box_cols x box_rows,
// 128-byte swizzled; reads past either edge are zero-filled. The weights
// (K, N) take 64 x 64 boxes, x (B, K) 64 x 16.
int gu_encode(CUtensorMap* map, const void* w, int rows, int cols,
              int box_cols, int box_rows) {
  const GuEncodeTiled fn = gu_encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kGuEncodeFailed + static_cast<int>(res);
}

template <int NT, bool kGelu>
int gu_launch(const CUtensorMap& m1, const CUtensorMap& m3, const void* x,
              void* out, int B, int K, int N, float gk, float gc,
              cudaStream_t stream) {
  CUtensorMap tx;
  const int enc = gu_encode(&tx, x, B, K, kGuK, 16);
  if (enc != 0) return enc;
  static bool allowed = false;   // per instantiation
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        gate_up_kernel<NT, kGelu>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kGuSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  gate_up_kernel<NT, kGelu><<<(N + kGuBox - 1) / kGuBox, kGuThreads,
                              kGuSmem, stream>>>(
      m1, m3, tx, static_cast<__nv_bfloat16*>(out), B, K, N, gk, gc);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- the decode step's qkv pass
// qkv_proj_kernel: the decode step's q, k and v for B <= 16 tokens x (B,
// K) bf16 against the stored weights wq (K, H Dh), wk and wv (K, KV Dh)
// bf16, each projection an fp32 sum rounded once to bf16 (as a bf16
// matmul returns it), then qkv_rope_kernel's chain op for op (row_chain:
// the bias, the qk norm, RoPE) in the epilogue; q to q_out (B, H, Dh), k
// and v straight into the token append's rows k_out / v_out (B, KV, Dh).
//
// Bound: bytes. The weights are 2 K (H + 2 KV) Dh bytes (6.29 MB at
// qwen2-1.5b: 1.88 us at 3.35 TB/s); x, the tables and the outputs are a
// few KB, and the flops are ~2 B a weight byte. The parent route ran three
// cuBLAS products and the row pass as four graph nodes, q, k and v going
// through device memory between them.
//
// Design. The epilogue needs a whole head row (the qk norm sums it, RoPE
// pairs channel i with i + rot_half), so a head row of q, k or v is the
// tile: Dh columns, Dh / 64 TMA boxes. qwen2-1.5b has only H + 2 KV = 16
// head rows, far too few CTAs to stream the weights, so K is split over a
// thread-block cluster of S CTAs a head row (kernels/fusions/kernel.
// plan_qkv: S a function of the shapes alone, at most one CTA an SM and at
// least 6 K tiles a rank: qwen2-1.5b's 16 head rows take 4, 64 CTAs; more
// ranks of fewer tiles measured no faster, launch/qkv_probes.py). Rank r
// streams its whole K tiles [r n / S, (r + 1) n / S)
// as gate_up_kernel streams K: one thread keeps a ring of kQpStages stages
// of 2-D TMA loads in flight (the head row's boxes of 64 rows of K, 128-
// byte swizzled, and x's 16 x 64 box), four warps each take 16 columns of
// every box, read with ldmatrix.trans, and run mma.sync m16n8k16 with the
// tokens on N. Then each rank pushes its fp32 partials of token b into
// the shared memory of rank b mod S (distributed shared memory), and after
// one cluster barrier rank r sums its tokens' partials in rank order 0 ..
// S - 1, rounds them to bf16 and runs the chain: every sum runs in an
// order fixed by the shapes, so a row's bits depend neither on B nor on
// timing. Rank r's 128 threads take its tokens a row at a time, Dh / 8
// lanes a row, as the row pass lays a row out.
constexpr int kQpBox = 64;                       // columns a TMA box
constexpr int kQpK = 64;                         // rows of K a stage
constexpr int kQpThreads = 128;                  // 4 warps
constexpr int kQpStages = 4;                     // the ring's stages
constexpr int kQpMaxRows = 16;                   // tokens, at most
constexpr int kQpMaxSplit = 8;                   // CTAs a cluster, at most
constexpr int kQpBoxBytes = kQpK * kQpBox * 2;   // 8 KB
constexpr int kQpXBytes = 16 * kQpK * 2;         // x's box, 2 KB
constexpr int kQpMapBytes = 3 * sizeof(CUtensorMap);

struct QpArgs {
  const __nv_bfloat16* bq;
  const __nv_bfloat16* bk;
  const __nv_bfloat16* bv;
  const __nv_bfloat16* qn;
  const __nv_bfloat16* kn;
  const float* cos_t;
  const float* sin_t;
  __nv_bfloat16* q_out;
  __nv_bfloat16* k_out;
  __nv_bfloat16* v_out;
  int B, K, H, KV, rot_half, tab_rows, split;
  float eps;
};

// The ring, its mbarriers and the partials of the tokens a rank owns
// (split x ceil(B / split) rows of Dh floats): the dynamic shared memory
// of a CTA.
__host__ __device__ constexpr int qp_stage_bytes(int boxes) {
  return boxes * kQpBoxBytes + kQpXBytes;
}
__host__ __device__ constexpr int qp_smem(int boxes, int part_rows) {
  return 1024 + kQpStages * qp_stage_bytes(boxes) + 16 * kQpStages +
         part_rows * boxes * kQpBox * 4;
}

__device__ __forceinline__ void qp_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void qp_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// grid: (H + 2 KV) x split CTAs, a cluster of `split` a head row; NB boxes
// a head row (Dh = 64 NB), NT 8-row token tiles.
template <int NB, int NT>
__global__ void __launch_bounds__(kQpThreads) qkv_proj_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_x, const QpArgs a) {
  constexpr int Dh = NB * kQpBox;
  constexpr int kStage = qp_stage_bytes(NB);
  constexpr int kRt = Dh / 8;                   // lanes a row: 8, 16, 32
  constexpr int kGroups = kQpThreads / kRt;     // rows the CTA takes at once
  extern __shared__ __align__(16) unsigned char qp_raw[];
  unsigned char* ring = qp_raw + ((1024 - (gu_smem_u32(qp_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kQpStages * kStage);
  float* part = reinterpret_cast<float*>(full + 2 * kQpStages);
  const int S = a.split;
  const int hr = blockIdx.x / S, rank = blockIdx.x - hr * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  if (S > 1) qp_cluster_arrive_relaxed();   // waited on before the push

  // the head row's weight, its columns, its outputs and chain operands
  const CUtensorMap* tm;
  int col0;
  __nv_bfloat16* out;
  int heads, h;
  const __nv_bfloat16* bias = nullptr;
  const __nv_bfloat16* norm;
  bool rope;
  if (hr < a.H) {
    tm = &tm_q, h = hr, heads = a.H, out = a.q_out, norm = a.qn, rope = true;
    if (a.bq != nullptr) bias = a.bq + (long long)h * Dh;
  } else if (hr < a.H + a.KV) {
    tm = &tm_k, h = hr - a.H, heads = a.KV, out = a.k_out, norm = a.kn;
    rope = true;
    if (a.bk != nullptr) bias = a.bk + (long long)h * Dh;
  } else {
    tm = &tm_v, h = hr - a.H - a.KV, heads = a.KV, out = a.v_out;
    norm = nullptr, rope = false;
    if (a.bv != nullptr) bias = a.bv + (long long)h * Dh;
  }
  col0 = h * Dh;
  rope = rope && a.rot_half > 0;
  const int n_k = (a.K + kQpK - 1) / kQpK;
  const int t0 = rank * n_k / S, t1 = (rank + 1) * n_k / S;
  const int n_it = t1 - t0;

  if (tid == 0) {
    // the two tensor maps' descriptors fetched ahead of the first loads
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(tm)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tm_x)) : "memory");
    for (int s = 0; s < kQpStages; ++s) gu_mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_stage = [&](int it) {
    const int s = it % kQpStages;
    unsigned char* st = ring + s * kStage;
    gu_mbar_expect_tx(full + s, kStage);
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
      gu_tma_load(st + bx * kQpBoxBytes, tm, full + s, col0 + bx * kQpBox,
                  (t0 + it) * kQpK);
    gu_tma_load(st + NB * kQpBoxBytes, &tm_x, full + s, (t0 + it) * kQpK, 0);
  };
  if (tid == 0)
    for (int it = 0; it < min(kQpStages, n_it); ++it) load_stage(it);

  float acc[NB][NT][4];
#pragma unroll
  for (int bx = 0; bx < NB; ++bx)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[bx][t][e] = 0.f;
  // ldmatrix rows and swizzled chunks as in gate_up_kernel
  const int lrow = 8 * ((lane >> 3) >> 1) + (lane & 7);
  const int xhalf = (lane >> 3) & 1;
  const int lbase = ((2 * warp + xhalf) ^ (lane & 7)) * 16;
#pragma unroll 1
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kQpStages;
    gu_mbar_wait(full + s, (it / kQpStages) & 1);
    const unsigned char* st = ring + s * kStage;
    const unsigned char* xs = st + NB * kQpBoxBytes;
#pragma unroll
    for (int kk = 0; kk < kQpK / 16; ++kk) {
      uint32_t xb[4];
      gu_ldmatrix_x4(xb, xs + lrow * 128 +
                             (((2 * kk + xhalf) ^ (lane & 7)) << 4));
      const int off = lbase + (16 * kk + lrow) * 128;
#pragma unroll
      for (int bx = 0; bx < NB; ++bx) {
        uint32_t w[4];
        gu_ldmatrix_x4_trans(w, st + bx * kQpBoxBytes + off);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          gu_mma(acc[bx][t], w, xb[2 * t], xb[2 * t + 1]);
      }
    }
    __syncthreads();                  // every warp is done with stage s
    if (tid == 0 && it + kQpStages < n_it) load_stage(it + kQpStages);
  }

  // the chain's operands for this thread's chunk c of the head row (the
  // bias and norm chunks, the same for every token) and of its first
  // token row (the table entries): loaded while the cluster's partials
  // come in
  const int rpo = (a.B + S - 1) / S;            // tokens a rank owns
  const int grp = tid / kRt, c = tid - grp * kRt;
  float bb[8], g[8], cs[8], sn[8];
  if (bias != nullptr) load16(bias + c * 8, bb);
  if (norm != nullptr) load16(norm + c * 8, g);
  auto tables = [&](int b) {
    const long long tab = (long long)(b % a.tab_rows) * a.rot_half;
    chunk_tables<__nv_bfloat16, false>(a.cos_t + tab, a.sin_t + tab, c,
                                       a.rot_half, cs, sn);
  };
  if (rope && grp < rpo && rank + S * grp < a.B) tables(rank + S * grp);

  // push: accumulator e of box bx, token tile t is column 64 bx + 16 warp
  // + gq + 8 (e / 2) of token 8 t + 2 tq + e % 2; token b's partial goes
  // to rank b mod S, at row (this rank, b / S)
  namespace cg = cooperative_groups;
  if (S > 1) qp_cluster_wait();                 // every CTA has started
#pragma unroll
  for (int bx = 0; bx < NB; ++bx)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = 8 * t + 2 * tq + (e & 1);
        if (b >= a.B) continue;
        const int col = bx * kQpBox + 16 * warp + gq + 8 * (e >> 1);
        float* dst = S > 1 ? cg::this_cluster().map_shared_rank(part, b % S)
                           : part;
        dst[(rank * rpo + b / S) * Dh + col] = acc[bx][t][e];
      }
  if (S > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();

  // this rank's tokens b = rank + S i, a row of kRt lanes each
  for (int i0 = 0; i0 < rpo; i0 += kGroups) {
    const int i = i0 + grp, b = rank + S * i;
    const bool live = i < rpo && b < a.B;
    float x[8] = {};
    if (live) {
      const float* p = part + i * Dh + c * 8;
      float4 lo = *reinterpret_cast<const float4*>(p);
      float4 hi = *reinterpret_cast<const float4*>(p + 4);
      float y[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      for (int r = 1; r < S; ++r) {          // the partials in rank order
        p += rpo * Dh;
        lo = *reinterpret_cast<const float4*>(p);
        hi = *reinterpret_cast<const float4*>(p + 4);
        const float z[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = __fadd_rn(y[k], z[k]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = y[k];
      rnd_pairs<__nv_bfloat16, 8>(x);
      if (rope && i0 > 0) tables(b);
    }
    row_chain<__nv_bfloat16, false>(
        x, bb, g, cs, sn, c, kRt, live, bias != nullptr, norm != nullptr,
        a.qn != nullptr || a.kn != nullptr, rope, Dh, a.rot_half, a.eps,
        nullptr);
    if (live) store16(out + ((long long)b * heads + h) * Dh + c * 8, x);
  }
}

template <int NB, int NT>
int qp_launch(const CUtensorMap* m, const void* x, const QpArgs& a,
              cudaStream_t stream) {
  CUtensorMap tx;
  const int enc = gu_encode(&tx, x, a.B, a.K, kQpK, 16);
  if (enc != 0) return enc;
  static bool allowed = false;   // per instantiation: the largest split
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        qkv_proj_kernel<NB, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        qp_smem(NB, kQpMaxRows + kQpMaxSplit - 1));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  const int S = a.split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.H + 2 * a.KV) * S);
  cfg.blockDim = dim3(kQpThreads);
  cfg.dynamicSmemBytes = qp_smem(NB, S * ((a.B + S - 1) / S));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  CUtensorMap mq = m[0], mk = m[1], mv = m[2];
  QpArgs args = a;
  void* params[] = {&mq, &mk, &mv, &tx, &args};
  const cudaError_t launched = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(qkv_proj_kernel<NB, NT>), params);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int qp_launch_rows(const CUtensorMap* m, const void* x, const QpArgs& a,
                   cudaStream_t s) {
  return a.B <= 8 ? qp_launch<NB, 1>(m, x, a, s) : qp_launch<NB, 2>(m, x, a, s);
}

template <typename T>
int norm_launch(const void* x, const void* delta, const void* scale,
                void* x_out, void* h_out, int rows, int D, float eps,
                int mode, int rt, int cpt, int rows_per_block,
                cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const int chunks = D / N;
  if (D < 1 || D % N || mode < kPlain || mode > kAddRounded ||
      (mode != kPlain && (delta == nullptr || x_out == nullptr)) ||
      rt < 32 || rt % 32 || rt > kNormMaxThreads || rows_per_block < 1 ||
      rt * rows_per_block > kNormMaxThreads ||
      (cpt > 0 && (long long)cpt * rt < chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = (unsigned)((rows + rows_per_block - 1) /
                                   rows_per_block);
  const int threads = rt * rows_per_block;
  const T* xs = static_cast<const T*>(x);
  const T* ds = static_cast<const T*>(delta);
  const T* gs = static_cast<const T*>(scale);
  T* xo = static_cast<T*>(x_out);
  T* ho = static_cast<T*>(h_out);
  switch (cpt) {
    case 1:
      rms_norm_kernel<T, 1><<<grid, threads, 0, s>>>(xs, ds, gs, xo, ho,
                                                     rows, D, eps, mode, rt);
      break;
    case 2:
      rms_norm_kernel<T, 2><<<grid, threads, 0, s>>>(xs, ds, gs, xo, ho,
                                                     rows, D, eps, mode, rt);
      break;
    case 4:
      rms_norm_kernel<T, 4><<<grid, threads, 0, s>>>(xs, ds, gs, xo, ho,
                                                     rows, D, eps, mode, rt);
      break;
    case 0:
      rms_norm_kernel<T, 0><<<grid, threads, 0, s>>>(xs, ds, gs, xo, ho,
                                                     rows, D, eps, mode, rt);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rope_launch(const void* q, const void* k, const void* v, const void* bq,
                const void* bk, const void* bv, const void* qn,
                const void* kn, const void* cos_t, const void* sin_t,
                void* q_out, void* k_out, void* v_out, int B, int H, int KV,
                int Dh, int rot_half, float eps, int tab_rows, const int* off,
                int C, int slots, long long cache_stride, void* k_rows,
                void* v_rows, int rt, int shared, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  if (Dh < 1 || Dh > kMaxHeadDim || Dh % N || Dh / N > 32 || rt > 32 ||
      rt < Dh / N || (rt & (rt - 1)) || 2 * rot_half > Dh || rot_half < 0 ||
      (shared == 0 && rot_half % N) ||
      (rot_half > 0 && (tab_rows < 1 || B % tab_rows)) ||
      (off != nullptr && (C < 1 || B % C || slots < C)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)B * (H + 2 * KV);
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kRowThreads / rt;
  const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
  const T* qs = static_cast<const T*>(q);
  const T* ks = static_cast<const T*>(k);
  const T* vs = static_cast<const T*>(v);
  const T* bqs = static_cast<const T*>(bq);
  const T* bks = static_cast<const T*>(bk);
  const T* bvs = static_cast<const T*>(bv);
  const T* qns = static_cast<const T*>(qn);
  const T* kns = static_cast<const T*>(kn);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  T* qo = static_cast<T*>(q_out);
  T* ko = static_cast<T*>(k_out);
  T* vo = static_cast<T*>(v_out);
  T* kr = static_cast<T*>(k_rows);
  T* vr = static_cast<T*>(v_rows);
  const int tr = tab_rows > 0 ? tab_rows : 1;
  if (shared)
    qkv_rope_kernel<T, true><<<grid, kRowThreads, 0, s>>>(
        qs, ks, vs, bqs, bks, bvs, qns, kns, cs, sn, qo, ko, vo, B, H, KV, Dh,
        rot_half, eps, tr, off, C, slots, cache_stride, kr, vr, rt);
  else
    qkv_rope_kernel<T, false><<<grid, kRowThreads, 0, s>>>(
        qs, ks, vs, bqs, bks, bvs, qns, kns, cs, sn, qo, ko, vo, B, H, KV, Dh,
        rot_half, eps, tr, off, C, slots, cache_stride, kr, vr, rt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int act_launch(const void* gate, const void* up, void* out, long long n,
               int use_gelu, float k, float c, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  if (n % N) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = n / N;
  const long long want = (chunks + kActThreads - 1) / kActThreads;
  const int blocks = (int)(want < kActMaxBlocks ? want : kActMaxBlocks);
  const T* g = static_cast<const T*>(gate);
  const T* u = static_cast<const T*>(up);
  T* o = static_cast<T*>(out);
  if (use_gelu)
    gated_act_kernel<T, true><<<blocks, kActThreads, 0, s>>>(g, u, o, chunks,
                                                             k, c);
  else
    gated_act_kernel<T, false><<<blocks, kActThreads, 0, s>>>(g, u, o, chunks,
                                                              k, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  if (err >= kGuEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (every T tensor). x, delta, x_out,
// h_out (rows, D) contiguous and 16-byte aligned, D a multiple of 16 bytes;
// scale (D,). mode 0: h_out only (delta, x_out may be null); 1: the
// residual sum read in fp32; 2: the residual sum rounded to T first. rt,
// cpt, rows_per_block: the launch geometry of the row length
// (kernels/fusions/kernel.norm_geometry): rt threads a row (a multiple of
// 32, at most 512), cpt chunks a thread held in registers (1, 2 or 4; 0
// streams), rows_per_block rows a block.
int rms_norm_launch(const void* x, const void* delta, const void* scale,
                    void* x_out, void* h_out, int rows, int D, float eps,
                    int mode, int rt, int cpt, int rows_per_block, int dtype,
                    void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return norm_launch<float>(x, delta, scale, x_out, h_out, rows, D, eps,
                              mode, rt, cpt, rows_per_block, s);
  if (dtype == 1)
    return norm_launch<__nv_bfloat16>(x, delta, scale, x_out, h_out, rows, D,
                                      eps, mode, rt, cpt, rows_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch of empty_kernel (one thread): the launch floor.
int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// q (B, H, Dh), k and v (B, KV, Dh), contiguous; biases (H or KV, Dh) or
// all null; qn, kn (Dh,) or null; cos_t, sin_t (B, rot_half) fp32 (null
// when rot_half is 0). Writes q_out (B, H, Dh), k_out and v_out (B, KV,
// Dh). rt, shared: the row pass's layout for the head row
// (kernels/fusions/kernel.rope_geometry): rt lanes a row, the RoPE
// partner from a lane (0) or from a copy of the row in shared memory (1).
int qkv_rope_launch(const void* q, const void* k, const void* v,
                    const void* bq, const void* bk, const void* bv,
                    const void* qn, const void* kn, const void* cos_t,
                    const void* sin_t, void* q_out, void* k_out,
                    void* v_out, int B, int H, int KV, int Dh, int rot_half,
                    float eps, int rt, int shared, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rope_launch<float>(q, k, v, bq, bk, bv, qn, kn, cos_t, sin_t,
                              q_out, k_out, v_out, B, H, KV, Dh, rot_half,
                              eps, B, nullptr, 1, 1, 0, nullptr, nullptr, rt,
                              shared, s);
  if (dtype == 1)
    return rope_launch<__nv_bfloat16>(q, k, v, bq, bk, bv, qn, kn, cos_t,
                                      sin_t, q_out, k_out, v_out, B, H, KV,
                                      Dh, rot_half, eps, B, nullptr, 1, 1, 0,
                                      nullptr, nullptr, rt, shared, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cache launch: N = nb * C rows, q (N, H, Dh), k and v (N, KV, Dh),
// contiguous; cos_t, sin_t (tab_rows, rot_half) fp32, tab_rows N or C;
// off (nb,) int32 on the device. Writes q_out (N, H, Dh) and each row's k
// and v into the caches k_cache / v_cache (nb, slots, KV, Dh; each
// sequence's (slots, KV, Dh) contiguous, the sequences cache_stride
// elements apart) at slot clamp(off[s], 0, slots - C) + c, and into
// k_rows / v_rows (N, KV, Dh) unless they are null; rt, shared as
// qkv_rope_launch's.
int qkv_rope_cache_launch(const void* q, const void* k, const void* v,
                          const void* bq, const void* bk, const void* bv,
                          const void* qn, const void* kn, const void* cos_t,
                          const void* sin_t, void* q_out, void* k_cache,
                          void* v_cache, void* k_rows, void* v_rows,
                          const void* off, int N, int H, int KV, int Dh,
                          int rot_half, int tab_rows, int rt, int shared,
                          int C, int slots, long long cache_stride,
                          float eps, int dtype, void* stream) {
  if (N == 0) return 0;
  if (off == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(off);
  if (dtype == 0)
    return rope_launch<float>(q, k, v, bq, bk, bv, qn, kn, cos_t, sin_t,
                              q_out, k_cache, v_cache, N, H, KV, Dh,
                              rot_half, eps, tab_rows, o, C, slots,
                              cache_stride, k_rows, v_rows, rt, shared, s);
  if (dtype == 1)
    return rope_launch<__nv_bfloat16>(q, k, v, bq, bk, bv, qn, kn, cos_t,
                                      sin_t, q_out, k_cache, v_cache, N, H,
                                      KV, Dh, rot_half, eps, tab_rows, o, C,
                                      slots, cache_stride, k_rows, v_rows, rt,
                                      shared, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gate, up, out: n elements, contiguous and 16-byte aligned, n a multiple
// of 16 bytes. use_gelu 0: SiLU; 1: the tanh GELU with its constants k
// (0.044715) and c (sqrt(2 / pi)) rounded to T.
int gated_act_launch(const void* gate, const void* up, void* out,
                     long long n, int use_gelu, float k, float c, int dtype,
                     void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return act_launch<float>(gate, up, out, n, use_gelu, k, c, s);
  if (dtype == 1)
    return act_launch<__nv_bfloat16>(gate, up, out, n, use_gelu, k, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor maps of the gate/up product's two weights, w1 and w3 (K, N)
// bf16 row-major, 16-byte aligned, N a multiple of 8, encoded into
// maps_out (kGuMapBytes bytes of host memory, w1's then w3's): once a
// weight address, by the caller, who passes them to every launch.
int gate_up_maps(const void* w1, const void* w3, int K, int N,
                 void* maps_out) {
  if (K < 1 || N < 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[2];
  int err = gu_encode(&m[0], w1, K, N, kGuBox, kGuK);
  if (err == 0) err = gu_encode(&m[1], w3, K, N, kGuBox, kGuK);
  if (err == 0) memcpy(maps_out, m, kGuMapBytes);
  return err;
}

// out (B, N) bf16 = act(x @ w1) * (x @ w3) for x (B, K) bf16, 1 <= B <=
// 16, K a multiple of 8, 16-byte aligned (its tensor map encoded here, a
// few microseconds of host time: once at a graph's capture); maps from
// gate_up_maps. One CTA a 64-column tile (kernels/fusions/kernel.
// plan_gate_up). use_gelu 0: SiLU; 1: the tanh GELU with its constants k
// and c rounded to bf16.
int gate_up_launch(const void* maps, const void* x, void* out, int B, int K,
                   int N, int use_gelu, float k, float c, void* stream) {
  if (B == 0) return 0;
  if (maps == nullptr || B < 1 || B > kGuMaxRows || K < 1 || K % 8 ||
      N < 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[2];
  memcpy(m, maps, kGuMapBytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 8)
    return use_gelu ? gu_launch<1, true>(m[0], m[1], x, out, B, K, N, k, c, s)
                    : gu_launch<1, false>(m[0], m[1], x, out, B, K, N, k, c,
                                          s);
  return use_gelu ? gu_launch<2, true>(m[0], m[1], x, out, B, K, N, k, c, s)
                  : gu_launch<2, false>(m[0], m[1], x, out, B, K, N, k, c, s);
}

// The tensor maps of the qkv pass's weights wq (K, H Dh), wk and wv (K,
// KV Dh) bf16 row-major (the stored (K, heads, Dh) tensors), 16-byte
// aligned, into maps_out (kQpMapBytes bytes of host memory: wq's, wk's,
// wv's): once a weight address, by the caller, who passes them to every
// launch.
int qkv_proj_maps(const void* wq, const void* wk, const void* wv, int K,
                  int H, int KV, int Dh, void* maps_out) {
  if (K < 8 || K % 8 || H < 1 || KV < 1 || Dh < kQpBox || Dh % kQpBox ||
      Dh > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3];
  int err = gu_encode(&m[0], wq, K, H * Dh, kQpBox, kQpK);
  if (err == 0) err = gu_encode(&m[1], wk, K, KV * Dh, kQpBox, kQpK);
  if (err == 0) err = gu_encode(&m[2], wv, K, KV * Dh, kQpBox, kQpK);
  if (err == 0) memcpy(maps_out, m, kQpMapBytes);
  return err;
}

// The decode step's qkv pass: x (B, K) bf16, 1 <= B <= 16, K a multiple of
// 8, 16-byte aligned (its tensor map encoded here: once at a graph's
// capture); maps from qkv_proj_maps; biases (H or KV, Dh) or all null;
// qn, kn (Dh,) or null; cos_t, sin_t (tab_rows, rot_half) fp32, rot_half
// a multiple of 8 (null when 0). Writes q_out (B, H, Dh), k_out and v_out
// (B, KV, Dh), contiguous bf16. Dh 64, 128 or 256; split: the CTAs of a
// head row's cluster (kernels/fusions/kernel.plan_qkv).
int qkv_proj_launch(const void* maps, const void* x, const void* bq,
                    const void* bk, const void* bv, const void* qn,
                    const void* kn, const void* cos_t, const void* sin_t,
                    void* q_out, void* k_out, void* v_out, int B, int K,
                    int H, int KV, int Dh, int rot_half, int tab_rows,
                    int split, float eps, void* stream) {
  if (B == 0) return 0;
  if (maps == nullptr || B < 1 || B > kQpMaxRows || K < 8 || K % 8 ||
      H < 1 || KV < 1 || split < 1 || split > kQpMaxSplit || rot_half < 0 ||
      rot_half % 8 || 2 * rot_half > Dh ||
      (rot_half > 0 && (tab_rows < 1 || B % tab_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const QpArgs a{static_cast<const bf*>(bq), static_cast<const bf*>(bk),
                 static_cast<const bf*>(bv), static_cast<const bf*>(qn),
                 static_cast<const bf*>(kn), static_cast<const float*>(cos_t),
                 static_cast<const float*>(sin_t), static_cast<bf*>(q_out),
                 static_cast<bf*>(k_out), static_cast<bf*>(v_out), B, K, H, KV,
                 rot_half, tab_rows > 0 ? tab_rows : 1, split, eps};
  CUtensorMap m[3];
  memcpy(m, maps, kQpMapBytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return qp_launch_rows<1>(m, x, a, s);
    case 128: return qp_launch_rows<2>(m, x, a, s);
    case 256: return qp_launch_rows<4>(m, x, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
