// Causal GQA flash attention for prefill, with an optional sliding window
// and tanh softcap.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention/
// kernel.py: flash_attention_kernel (with _flash_kernel).
//
// Bound: operations. Causal attention does 4 * D flops per live (query,
// key) pair (q.k and p.v) on inputs it reads once: at qwen2-1.5b's
// prefill shape (B=1, H=12, KV=2, S=2048, D=128) that is ~12.9 GFLOP
// against ~15 MB of q, k, v and output, ~13 us at the bf16 tensor-core
// peak against ~4.4 us of HBM traffic. Only the tensor cores reach that
// rate, so the bf16 kernel is built around Hopper's wgmma:
//
// - one CTA per (query tile of 64 x NWG rows, head, batch row), heaviest
//   tiles (the last, which see the most keys) launched first; the key
//   tiles walked are the live ones only, from the first tile the window
//   reaches to the causal diagonal (the Pallas kernel's `live` test);
// - q, k and v are read by TMA through 4-D tensor maps over the (D, S,
//   heads, B) view with the caller's strides, so the model's (B, S, H, D)
//   activations need no transpose copy. Tiles land in shared memory in
//   bf16 with the 128-byte swizzle wgmma descriptors expect, as panels of
//   64 columns: D is padded to the next multiple of 64 by the TMA's zero
//   fill past D (and past S), and the zeros add nothing to q.k or p.v;
// - a ring of K/V stages, each with an mbarrier that counts its TMA
//   bytes, runs `stages` key tiles ahead of NWG warpgroups that each own
//   64 query rows; the group that releases a stage last refills it. Two
//   groups take turns on the tensor cores (named barriers), so one's
//   softmax runs under the other's products;
// - S = Q K^T is m64 x BK x k16 wgmma steps over the padded D (both
//   operands K-major in shared memory), fp32 accumulators in registers,
//   issued together with the previous tile's P V so that the softmax of
//   one tile runs while the tensor cores finish the other;
//   scale, softcap, mask and the online softmax run on those registers,
//   the row statistics reduced over the 4 lanes that share a row;
// - O += P V is wgmma with P from registers: the fp32 score accumulator
//   layout is the bf16 A-fragment layout, so P is packed in place (the one
//   rounding the reference does not make: P to bf16). V's tile is the B
//   operand as it lies, made MN-major through the descriptor;
// - the epilogue divides by l (clamped at 1e-30), converts to bf16 and
//   stores through the output's strides, masked to i < S and d < D.
//
// fp32 inputs (used by the equivalence checks only) take the CUDA-core
// kernel below, which stages fp32 tiles in shared memory and does both
// products as fp32 FMAs in 4 x 4 patches a thread. The wrapper picks the
// kernel by dtype alone.
//
// The extend launch (a chunk of Sq queries against a cache of Sk keys):
// both kernels' launches take an int32 offset a batch row, read from
// device memory, so a captured graph replays the launch for every start.
// Query row i sits at position off[b] + i and sees keys j <= off[b] + i
// (and j > off[b] + i - window). This is the reference's attend_decode
// (src/repro/models/attention.py) over a plain cache, which XLA fuses
// under jit and no Pallas kernel computes. Keys past a CTA's live range
// may hold anything (a cache's unwritten slots): the fp32 kernel loads
// them as zeros, and the bf16 one zeroes their V rows in shared memory
// before its last P V, as 0 * NaN would survive a zero weight. A null
// offset is the prefill launch (off 0, Sk == Sq).
//
// In bf16 the extend launch is a kernel of its own, flash_extend_kernel
// (the prefill keeps flash_wgmma_kernel). Bound: operations, 7.33 us at
// qwen2-1.5b's 512-token chunk on 2048 cached tokens (~7.3 GFLOP); the
// K/V it reads (2.6 MB) stay in L2. A chunk is short (Sq 512 of 12
// heads: 48 query tiles of 128 rows, or 96 of 64), and each tile walks
// the whole cache, so a tile a CTA leaves the card short of work. The
// design:
// - a CTA is two consumer warpgroups on one query tile, taking turns on
//   the tensor cores as in the prefill; where the GQA group is even, the
//   two are two heads of the group over the same 64 rows, so each K/V
//   stage TMA brings serves both (a tile is read once a head pair, not
//   once a head); else one head's 128 rows;
// - a query tile's live key tiles are split into `slices` ranges of whole
//   tiles (slice s: [ceil(s n / S), ceil((s + 1) n / S)), any of them
//   empty), one CTA each, the S CTAs a thread-block cluster. Each CTA
//   works out its range from off[b] on the device; S and the grid are
//   fixed by the shapes and the SM count alone (kernels/flash_attention/
//   kernel.plan_extend), so one graph replays every start;
// - the S CTAs merge their (acc, m, l) through distributed shared memory:
//   after a cluster barrier each pushes its accumulators to the CTA that
//   owns their columns and its (m, l) to all, then each sums its columns
//   in slice order (the bits do not depend on timing) and stores them. No
//   fp32 partial goes to device memory; the merge takes (S ceil(D_pad / 8
//   / S) + S) x 4 KB of the CTA's freed ring;
// - a CTA holds an SM (its registers), so the CTAs run in waves of 132,
//   each as long as its heaviest CTA, and a split costs a merge: measured
//   on the H100, a CTA's launch, start and stores take ~6 us, a merge ~4.5
//   us more (more past 4 slices), a 2-warpgroup key tile ~2 us. The plan
//   weighs those: path A's chunk takes 2 slices, 96 CTAs in one wave
//   (3 or 4 slices put 144 or 192 in two).
//
// The tensor-map encoder is fetched through cudaGetDriverEntryPoint, so
// the library needs no -lcuda.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


namespace {

struct Strides {  // element strides of a (B, heads, S, D) view; D is unit
  long long b, h, s;
};

// ------------------------------------------------------------ fp32 kernel
constexpr float kNegInf = -2.0e38f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per loop step
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4-row patch
constexpr int kPS = kBK + 1;   // padded row stride of the probability tile

// rows [row0, row0 + n) of one head into an fp32 [n][stride] tile; rows
// at or past S (the rows' end, or a key range's) are zero.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n, int S, int D, int stride) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * stride + d] =
        row0 + r < S ? src[(long long)(row0 + r) * row_stride + d] : 0.f;
  }
}

template <int NJ>  // NJ = output columns per thread, >= D / 16
__global__ void __launch_bounds__(kThreads) flash_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, Strides qs,
    Strides ks, Strides vs, Strides os, int G, int Sq, int Sk, int D,
    float scale, int causal, int window, float softcap,
    const int* __restrict__ q_off) {
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
  const int off = q_off ? max(q_off[b], 0) : 0;  // position of row 0

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  load_tile(q_s, qb, qs.s, q0, kBQ, Sq, D, QS);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }

  // live key range: the causal diagonal above (at the tile's last row),
  // the window below; keys past it are loaded as zeros
  const int kv_end = causal ? min(Sk, off + min(Sq, q0 + kBQ)) : Sk;
  const int kv_begin =
      (causal && window > 0) ? max(0, off + q0 - window + 1) : 0;
  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    load_tile(k_s, kb, ks.s, k0, kBK, kv_end, D, QS);
    load_tile(v_s, vb, vs.s, k0, kBK, kv_end, D, D);
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
      const int i = off + q0 + tr + 16 * a;  // the row's position
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tc + 16 * c;
        float x = s[a][c] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool live = j < kv_end && (!causal || j <= i) &&
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

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + tr + 16 * a;
    if (i >= Sq) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tc + 16 * j;
      if (d < D) ob[(long long)i * os.s + d] = acc[a][j] * inv;
    }
  }
}

size_t fp32_smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * kPS);
}

template <int NJ>
int launch_fp32(const float* q, const float* k, const float* v, float* o,
                const long long* st, int B, int H, int KV, int Sq, int Sk,
                int D, float scale, int causal, int window, float softcap,
                const int* q_off, cudaStream_t stream) {
  const size_t smem = fp32_smem_bytes(D);
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fp32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fp32_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, qs, ks, vs, os, H / KV, Sq, Sk, D, scale, causal, window,
      softcap, q_off);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------- bf16 tensor cores
constexpr int kMaxStages = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = 10000;  // + the CUresult of the encoder

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
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
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

// One box of a 4-D tensor map into shared memory; completion counted in
// bytes on ``bar``. Boxes past the tensor's edge are zero-filled.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (start
// address, leading and stride byte offsets in 16-byte units, layout 1 =
// 128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Reads of an accumulator after a wgmma wait stay after it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A fragments of a register-A wgmma are read until its wait: keep
// them live and unchanged up to the fence.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (probabilities below 2^-126 of the row's largest add nothing).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<64> {
  // D (64 x 64, fp32 regs) (+)= A (smem desc, K-major) . B (smem desc, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  // D (64 x 128, fp32 regs) (+)= A (smem desc, K-major) . B (smem desc, K-major)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  // D (64 x 64, fp32 regs) (+)= A (bf16 regs) . B (smem desc, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRS<128> {
  // D (64 x 128, fp32 regs) (+)= A (bf16 regs) . B (smem desc, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRS<192> {
  // D (64 x 192, fp32 regs) (+)= A (bf16 regs) . B (smem desc, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRS<256> {
  // D (64 x 256, fp32 regs) (+)= A (bf16 regs) . B (smem desc, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};
// Tile shapes of the tensor-core kernel for a padded head dim DP and NWG
// warpgroups (64 query rows each). Mirrored by
// kernels/flash_attention/kernel.plan_bf16, which picks the stage count.
//
// Registers decide the shapes. A warpgroup holds the O accumulator (DP /
// 2 fp32 a thread), the scores (BK / 2) and P (BK / 4): ~190 registers a
// thread at DP = 128 with 128-key tiles, ~205 at DP = 256 with 64. The
// card allocates registers to warps in groups of four, so a dedicated
// producer warp would be charged a whole warpgroup and cap two consumer
// groups at 65536 / 384 = 168 registers; setmaxnreg does not lift that
// cap for the compiler (measured with nvcc 12.9: ptxas compiled the
// consumers of a 384-thread kernel at 168 registers whatever
// setmaxnreg.inc asked for, spilling and serializing the wgmmas at D >=
// 128). So the CTA is the consumer warpgroups alone, up to 255 registers
// a thread, and the ring is refilled by whichever group releases a stage
// last (see the kernel).
template <int DP, int NWG>
struct TcConfig {
  static constexpr int kBQ = 64 * NWG;
  static constexpr int kBK = DP <= 128 ? 128 : 64;
  static constexpr int kPanels = DP / 64;  // 64-column swizzled panels
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;  // K or V of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
};

// Phase probes: built with -DREPRO_FLASH_PHASES (launch/flash_phases.py),
// the first warp of each warpgroup of the heaviest CTA (blockIdx 0) stamps
// clock64() at 8 points of each key-tile iteration into g_phases, read
// back through flash_phases_read. Compiled out otherwise.
#ifdef REPRO_FLASH_PHASES
constexpr int kPhaseTiles = 64;
__device__ long long g_phases[2][kPhaseTiles][8];
#define PHASE(t, k)                                                     \
  do {                                                                  \
    if (blockIdx.x + blockIdx.y + blockIdx.z == 0 &&                    \
        threadIdx.x % 128 == 0 && (t) < kPhaseTiles)                    \
      g_phases[threadIdx.x / 128][(t)][(k)] = clock64();                \
  } while (0)
// The extend launch's probes, in the same build: thread 0 of every CTA
// (up to kProbeCtas) stamps clock64() at kExtPoints points (see
// flash_extend_kernel) and the global timer (ns) at its start and end,
// read back through flash_extend_probes_read.
constexpr int kProbeCtas = 1024;
constexpr int kExtPoints = 8;
__device__ long long g_ext_clocks[kProbeCtas][kExtPoints];
__device__ unsigned long long g_ext_times[kProbeCtas][2];
__device__ __forceinline__ int probe_cta() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define EXT_PROBE(k)                                                    \
  do {                                                                  \
    if (threadIdx.x == 0 && probe_cta() < kProbeCtas)                   \
      g_ext_clocks[probe_cta()][(k)] = clock64();                       \
  } while (0)
#define EXT_TIME(k)                                                     \
  do {                                                                  \
    if (threadIdx.x == 0 && probe_cta() < kProbeCtas)                   \
      g_ext_times[probe_cta()][(k)] = global_ns();                      \
  } while (0)
#else
#define PHASE(t, k) \
  do {              \
  } while (0)
#define EXT_PROBE(k) \
  do {               \
  } while (0)
#define EXT_TIME(k) \
  do {              \
  } while (0)
#endif

struct TcParams {
  long long os_b, os_h, os_s;  // output element strides
  int Sq, Sk, D, G, stages, causal, window;
  float scale, softcap;
};

// Named barriers 1 and 2 pass the tensor cores between two warpgroups;
// 3 holds the CTA while the extend launch zeroes a tile's tail.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
template <int kThreads>
__device__ __forceinline__ void cta_sync_3() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// S = Q K^T for one warpgroup: k16 steps over the padded D, 32 bytes
// apart inside a 64-column panel; both operands K-major.
template <int BK, int DP, int BQ>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2],
                                         const uint8_t* sq,
                                         const uint8_t* sk) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk % 4) * 32;
    WgmmaSS<BK>::ss(sc, desc_sw128(sq + (kk / 4) * BQ * 128 + off, 16, 1024),
                    desc_sw128(sk + (kk / 4) * BK * 128 + off, 16, 1024),
                    kk > 0);
  }
}

// O += P V: k16 steps over the tile's keys, 16 rows (2048 B) apart; V is
// MN-major, its 64-column panels BK * 128 bytes apart.
template <int BK, int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const uint8_t* sv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    WgmmaRS<DP>::rs(acc, pa[kk], desc_sw128(sv + kk * 2048, BK * 128, 1024),
                    1);
}

// The online softmax of one key tile on the score registers: scale,
// softcap, mask (where the tile crosses the diagonal, the window's edge or
// the end kv_end of the CTA's live keys), the row max over the 4 lanes of
// a row, then p = exp(x - m) in place. Rows are indices into the chunk;
// row i's position is off + i. Updates m and the per-thread partial row
// sums l (the 4 lanes of a row are added at the end) and returns the
// factors alpha that rescale the output accumulated so far. Without a
// softcap (and with a positive scale, which the max commutes with) the
// raw scores are used as they are and the scale is folded into the
// exponent's FMA. Maxima and sums run in four independent chains a row,
// so that the dependent latency of 32 steps does not serialize them.
template <int BK, typename Params>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const Params& p, int k0,
                                               int row, int col, int wrow0,
                                               int off, int kv_end) {
  row += off;    // positions from here on
  wrow0 += off;
  const bool masked = k0 + BK > kv_end ||
                      (p.causal && k0 + BK - 1 > wrow0) ||
                      (p.window > 0 && k0 <= wrow0 + 63 - p.window);
  const bool raw = p.softcap <= 0.f && p.scale > 0.f;
  float mx[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mx[0][c] = mx[1][c] = -INFINITY;
  if (!raw || masked) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      float x = sc[j];
      if (!raw) {
        x *= p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      }
      if (masked) {
        const int i = row + 8 * ((j % 4) / 2);
        const int key = k0 + 8 * (j / 4) + col + (j % 2);
        const bool live = key < kv_end && (!p.causal || key <= i) &&
                          (p.window <= 0 || key > i - p.window);
        if (!live) x = -INFINITY;
      }
      sc[j] = x;
      mx[(j % 4) / 2][(j / 4) % 4] = fmaxf(mx[(j % 4) / 2][(j / 4) % 4], x);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j)
      mx[(j % 4) / 2][(j / 4) % 4] =
          fmaxf(mx[(j % 4) / 2][(j / 4) % 4], sc[j]);
  }
  const float unit = raw ? p.scale : 1.f;  // sc * unit is the scaled score
  float mlog[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[r], v * unit);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = fast_exp2((m[r] - m_use) * kLog2e);
    m[r] = m_new;
    mlog[r] = m_use * kLog2e;
  }
  const float coef = unit * kLog2e;
  float sum[2][4] = {};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    const int r = (j % 4) / 2;
    sc[j] = fast_exp2(fmaf(sc[j], coef, -mlog[r]));
    sum[r][(j / 4) % 4] += sc[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] +
           ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// P to bf16 A fragments, in place: score registers 8kk .. 8kk + 7 are the
// four fragment registers of key step kk (rows r and r + 8, keys 2c, 2c+1
// and 8 + 2c, 8 + 2c + 1 of the step).
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 2; j += 2)
    pa[j / 8][(j % 8) / 2] = pack_bf16(sc[j], sc[j + 1]);
}

template <int DP, int NWG>
__global__ void __launch_bounds__(TcConfig<DP, NWG>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, const TcParams p) {
  using C = TcConfig<DP, NWG>;
  constexpr int BK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kMaxStages];
  __shared__ int released[kMaxStages];  // warpgroups done with a stage
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;                // [panel][kBQ rows][128 B]
  uint8_t* sKV = smem + C::kQBytes;  // [stage]{K, V}[panel][BK rows][128 B]
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const int q0 = qt * C::kBQ;
  const int off = 0;  // the prefill: query row i at position i
  // live key range: the causal diagonal above (at the tile's last row),
  // the window below; never empty, as the pipeline waits on its first
  // tile
  const int kv_end =
      p.causal ? min(p.Sk, off + min(p.Sq, q0 + C::kBQ)) : p.Sk;
  const int kv_begin = min(
      (p.causal && p.window > 0) ? max(0, off + q0 - p.window + 1) : 0,
      kv_end - 1);
  const int t_first = kv_begin / BK;
  const int n_tiles = (kv_end + BK - 1) / BK - t_first;
  auto kv_stage = [&](int t) {
    return sKV + (t % p.stages) * C::kStageBytes;
  };
  // K and V of key tile t into its stage, by TMA, counted on full[stage]
  auto load_kv = [&](int t) {
    uint64_t* bar = &full[t % p.stages];
    uint8_t* sk = kv_stage(t);
    const int k0 = (t_first + t) * BK;
    mbar_expect_tx(bar, C::kStageBytes);
    for (int pn = 0; pn < C::kPanels; ++pn) {
      tma_load_4d(sk + pn * BK * 128, &tm_k, bar, pn * 64, k0, kvh, b);
      tma_load_4d(sk + C::kTileBytes + pn * BK * 128, &tm_v, bar, pn * 64,
                  k0, kvh, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q, and the ring's first stages
    mbar_expect_tx(q_full, C::kQBytes);
    for (int pn = 0; pn < C::kPanels; ++pn)
      tma_load_4d(sQ + pn * C::kBQ * 128, &tm_q, q_full, pn * 64, q0, h, b);
    for (int t = 0; t < min(p.stages, n_tiles); ++t) load_kv(t);
  }
  // A stage is refilled (with the tile `stages` ahead) by the warpgroup
  // that releases it last: one thread of each group counts its release
  // after the group's wgmma_wait<0>, when its reads of the stage are over.
  auto release = [&](int t) {
    if (threadIdx.x % 128 == 0 &&
        atomicAdd(&released[t % p.stages], 1) % NWG == NWG - 1 &&
        t + p.stages < n_tiles)
      load_kv(t + p.stages);
  };

  {
    // ---- warpgroup wg: query rows q0 + 64 wg .. + 63
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int wrow0 = q0 + 64 * wg;                 // first row of the group
    const int row = wrow0 + 16 * (tid / 32) + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);  // + 8 n: this thread's column pairs
    const uint8_t* sQw = sQ + wg * 64 * 128;

    float acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // Software-pipelined over key tiles: S_t = Q K_t^T and O += P_{t-1}
    // V_{t-1} are issued together, and the softmax of S_t runs on the CUDA
    // cores while P_{t-1} V_{t-1} is still on the tensor cores.
    float sc[BK / 2], alpha[2];
    uint32_t pa[BK / 16][4];
    // Two warpgroups take turns on the tensor cores: each issues its
    // products after named_sync(its barrier) and hands over with
    // named_arrive(the other's), so one group's softmax runs while the
    // other's products do. Group 0 goes first.
    constexpr bool kPingPong = NWG == 2;
    auto take_turn = [&] {
      if (kPingPong) named_sync(1 + wg);
    };
    auto pass_turn = [&] {
      if (kPingPong) named_arrive(2 - wg);
    };
    if (kPingPong && wg == 1) named_arrive(1);
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    take_turn();
    wgmma_fence();
    issue_qk<BK, DP, C::kBQ>(sc, sQw, kv_stage(0));
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax<BK>(sc, m, l, alpha, p, t_first * BK, row, col, wrow0,
                       off, kv_end);
    pack_p<BK>(sc, pa);
    for (int t = 1; t < n_tiles; ++t) {
      PHASE(t, 0);
      mbar_wait(&full[t % p.stages], (t / p.stages) & 1);
      PHASE(t, 1);
      take_turn();
      PHASE(t, 2);
      wgmma_fence();
      issue_qk<BK, DP, C::kBQ>(sc, sQw, kv_stage(t));
      wgmma_commit();
      issue_pv<BK, DP>(acc, pa, kv_stage(t - 1) + C::kTileBytes);
      wgmma_commit();
      pass_turn();
      PHASE(t, 3);
      wgmma_wait<1>();  // S_t is done, P_{t-1} V_{t-1} may still run
      fence_regs(sc);
      PHASE(t, 4);
      online_softmax<BK>(sc, m, l, alpha, p, (t_first + t) * BK, row, col,
                         wrow0, off, kv_end);
      PHASE(t, 5);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      PHASE(t, 6);
      release(t - 1);
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] *= alpha[(j % 4) / 2];
      pack_p<BK>(sc, pa);
      PHASE(t, 7);
    }
    take_turn();
    wgmma_fence();
    issue_pv<BK, DP>(acc, pa, kv_stage(n_tiles - 1) + C::kTileBytes);
    wgmma_commit();
    if (wg == 0) pass_turn();  // group 1's last turn has no taker
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* ob = o + b * p.os_b + h * p.os_h;
#pragma unroll
    for (int j = 0; j < DP / 2; j += 2) {
      const int r = (j % 4) / 2;
      const int i = row + 8 * r;
      const int d = 8 * (j / 4) + col;
      if (i < p.Sq && d < p.D)
        *reinterpret_cast<__nv_bfloat162*>(ob + i * p.os_s + d) =
            __floats2bfloat162_rn(acc[j] * inv[r], acc[j + 1] * inv[r]);
    }
  }
}

// ------------------------------------------------- the extend launch
// A chunk of Sq queries at per-row offsets against Sk cached keys, in
// bf16 (the fp32 extend runs flash_fp32_kernel with its offsets). A CTA
// is two consumer warpgroups on one query tile: two heads of a GQA group
// over the same 64 rows (ExtParams::pair, G even), so each K/V stage the
// TMA brings serves both; else one head's 128 rows. The CTA's live key
// tiles are split into `slices` ranges of whole tiles, one CTA each, the
// slices of a tile forming a thread-block cluster; the CTAs merge their
// (acc, m, l) through distributed shared memory (no fp32 partial goes
// to device memory). The slice count and the grid come from the shapes
// and the SM count alone (plan_extend in kernels/flash_attention/
// kernel.py); each CTA reads off[b] and works out its tile range on the
// device, so a captured graph replays every start.
constexpr int kMaxSlices = 4;  // past 4 the merge costs more than it saves

struct ExtParams {
  long long os_b, os_h, os_s;  // output element strides
  int Sq, Sk, D, G, stages, causal, window, slices, pair;
  float scale, softcap;
  const int* off;  // (B,) position of query row 0
};

template <int DP>
__global__ void __launch_bounds__(256, 1)
    flash_extend_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, const ExtParams p) {
  using C = TcConfig<DP, 2>;
  constexpr int BK = C::kBK;
  constexpr int kQw = 64 * DP * 2;  // one warpgroup's Q tile, bytes
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kMaxStages];
  __shared__ int released[kMaxStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;            // [warpgroup][panel][64 rows][128 B]
  uint8_t* sKV = smem + 2 * kQw;  // [stage]{K, V}[panel][BK rows][128 B]
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  EXT_TIME(0);
  EXT_PROBE(0);

  const int slice = blockIdx.x % p.slices;  // the CTA's rank in its cluster
  const int tiles_q = gridDim.x / p.slices;
  const int qt = tiles_q - 1 - blockIdx.x / p.slices;  // heaviest first
  const int rows = p.pair ? 64 : 128;                   // the CTA's rows
  const int q0 = qt * rows;
  const int b = blockIdx.z;
  const int h_first = p.pair ? 2 * blockIdx.y : blockIdx.y;
  const int kvh = h_first / p.G;
  if (threadIdx.x == 0) {  // the barriers, and Q: it needs no offset
    for (const CUtensorMap* map : {&tm_q, &tm_k, &tm_v})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    mbar_init(q_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, 2 * kQw);
    for (int w = 0; w < 2; ++w)
      for (int pn = 0; pn < C::kPanels; ++pn)
        tma_load_4d(sQ + w * kQw + pn * 64 * 128, &tm_q, q_full, pn * 64,
                    q0 + (p.pair ? 0 : 64 * w), h_first + (p.pair ? w : 0),
                    b);
  }
  const int off = max(p.off[b], 0);  // position of row 0
  // the CTA's live keys: the causal diagonal at its last row above, the
  // window below; split into slices of whole tiles, any of them empty
  const int kv_end = min(p.Sk, off + min(p.Sq, q0 + rows));
  const int kv_begin = p.window > 0 ? max(0, off + q0 - p.window + 1) : 0;
  const int t_all = kv_begin / BK;
  const int n_all = max(0, (kv_end + BK - 1) / BK - t_all);
  // slice s takes tiles [ceil(s n / S), ceil((s + 1) n / S)) of the n:
  // a slice with more tiles comes first, and the last (the diagonal's,
  // masked) never has more than another
  const int t_first = t_all + (slice * n_all + p.slices - 1) / p.slices;
  const int n_tiles = t_all +
                      ((slice + 1) * n_all + p.slices - 1) / p.slices -
                      t_first;
  // V rows of the CTA's last tile past kv_end hold whatever the cache
  // does there: the slice that takes that tile zeroes them first
  const int t_last0 = (t_first + n_tiles - 1) * BK;
  const bool zero_tail = n_tiles > 0 && t_first + n_tiles == t_all + n_all &&
                         kv_end < min(p.Sk, t_last0 + BK);
  auto kv_stage = [&](int t) {
    return sKV + (t % p.stages) * C::kStageBytes;
  };
  auto load_kv = [&](int t) {
    uint64_t* bar = &full[t % p.stages];
    uint8_t* sk = kv_stage(t);
    const int k0 = (t_first + t) * BK;
    mbar_expect_tx(bar, C::kStageBytes);
    for (int pn = 0; pn < C::kPanels; ++pn) {
      tma_load_4d(sk + pn * BK * 128, &tm_k, bar, pn * 64, k0, kvh, b);
      tma_load_4d(sk + C::kTileBytes + pn * BK * 128, &tm_v, bar, pn * 64,
                  k0, kvh, b);
    }
  };

  if (threadIdx.x == 0)  // the ring's first stages
    for (int t = 0; t < min(p.stages, n_tiles); ++t) load_kv(t);
  __syncthreads();
  EXT_PROBE(1);
  auto release = [&](int t) {
    if (threadIdx.x % 128 == 0 &&
        atomicAdd(&released[t % p.stages], 1) % 2 == 1 &&
        t + p.stages < n_tiles)
      load_kv(t + p.stages);
  };

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int h = h_first + (p.pair ? wg : 0);   // the warpgroup's head
  const int wrow0 = q0 + (p.pair ? 0 : 64 * wg);
  const int row = wrow0 + 16 * (tid / 32) + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  const uint8_t* sQw = sQ + wg * kQw;
  float acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    // flash_wgmma_kernel's pipeline with NWG = 2: S_t and P_{t-1} V_{t-1}
    // issued together, the two warpgroups taking turns on the tensor cores
    float sc[BK / 2], alpha[2];
    uint32_t pa[BK / 16][4];
    auto take_turn = [&] { named_sync(1 + wg); };
    auto pass_turn = [&] { named_arrive(2 - wg); };
    if (wg == 1) named_arrive(1);
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    EXT_PROBE(2);
    take_turn();
    wgmma_fence();
    issue_qk<BK, DP, 64>(sc, sQw, kv_stage(0));
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax<BK>(sc, m, l, alpha, p, t_first * BK, row, col, wrow0,
                       off, kv_end);
    pack_p<BK>(sc, pa);
    for (int t = 1; t < n_tiles; ++t) {
      mbar_wait(&full[t % p.stages], (t / p.stages) & 1);
      take_turn();
      wgmma_fence();
      issue_qk<BK, DP, 64>(sc, sQw, kv_stage(t));
      wgmma_commit();
      issue_pv<BK, DP>(acc, pa, kv_stage(t - 1) + C::kTileBytes);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      online_softmax<BK>(sc, m, l, alpha, p, (t_first + t) * BK, row, col,
                         wrow0, off, kv_end);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(t - 1);
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] *= alpha[(j % 4) / 2];
      pack_p<BK>(sc, pa);
    }
    if (zero_tail) {  // as flash_wgmma_kernel's
      uint8_t* sv = kv_stage(n_tiles - 1) + C::kTileBytes;
      const int r0 = kv_end - t_last0;
      const int per_panel = (BK - r0) * 8;
      for (int i = threadIdx.x; i < C::kPanels * per_panel; i += 256) {
        const int pn = i / per_panel, piece = i - pn * per_panel;
        *reinterpret_cast<uint4*>(sv + pn * BK * 128 + r0 * 128 +
                                  piece * 16) = make_uint4(0, 0, 0, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cta_sync_3<256>();
    }
    take_turn();
    wgmma_fence();
    issue_pv<BK, DP>(acc, pa, kv_stage(n_tiles - 1) + C::kTileBytes);
    wgmma_commit();
    if (wg == 0) pass_turn();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
  } else {
    mbar_wait(q_full, 0);  // no CTA leaves or lends its shared memory
  }                        // with Q's TMA in flight
  EXT_PROBE(3);

  __nv_bfloat16* ob = o + b * p.os_b + h * p.os_h;
  // column pairs (8 g + col, + 1) of rows row, row + 8: registers 4g .. 4g+3
  auto store_group = [&](int g, const float (&a)[4], const float (&inv)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
      const int d = 8 * g + col;
      if (i < p.Sq && d < p.D)
        *reinterpret_cast<__nv_bfloat162*>(ob + i * p.os_s + d) =
            __floats2bfloat162_rn(a[2 * r] * inv[r], a[2 * r + 1] * inv[r]);
    }
  };
  if (p.slices == 1) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int g = 0; g < DP / 8; ++g) {
      const float a[4] = {acc[4 * g], acc[4 * g + 1], acc[4 * g + 2],
                          acc[4 * g + 3]};
      store_group(g, a, inv);
    }
    EXT_PROBE(7);
    EXT_TIME(1);
    return;
  }

  // The merge. Column group g (the 4 accumulators of a column pair of
  // both rows) is finished by slice owner(g) of the cluster: slice r owns
  // groups [r G / S, (r + 1) G / S). Once every CTA of the cluster is
  // past its last wgmma (the first cluster barrier: the ring and Q are
  // free), each pushes its partial into the owners' shared memory, a
  // float4 [slice][owned group][thread] each, and its (m, m, l, l) into
  // every CTA's [slice][thread] row: stores to distributed shared memory,
  // which need no round trip. After the second barrier each CTA sums its
  // groups' partials in slice order from its own shared memory, so the
  // bits do not depend on timing.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kGroups = DP / 8;
  const int S = p.slices;
  const int owned = (kGroups + S - 1) / S;  // groups a slice owns, at most
  float4* part = reinterpret_cast<float4*>(smem);
  cluster.sync();
  EXT_PROBE(4);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int owner = ((g + 1) * S - 1) / kGroups;
    float4* dst = cluster.map_shared_rank(part, owner);
    dst[(slice * owned + g - owner * kGroups / S) * 256 + threadIdx.x] =
        make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2],
                    acc[4 * g + 3]);
  }
  for (int r = 0; r < S; ++r)
    cluster.map_shared_rank(part, r)[(S * owned + slice) * 256 +
                                     threadIdx.x] =
        make_float4(m[0], m[1], l[0], l[1]);
  cluster.sync();
  EXT_PROBE(5);
  // the slices' (m, l) in slice order, then their partials summed in
  // slice order in place, in slot 0 of each owned group: runtime loops
  // over the S slices and the owned groups alone (an unrolled, predicated
  // loop over every slice and group issues each instruction anyway)
  const float4* mls = part + S * owned * 256 + threadIdx.x;
  float mx[2] = {-INFINITY, -INFINITY};
  for (int s = 0; s < S; ++s) {
    const float4 q = mls[s * 256];
    mx[0] = fmaxf(mx[0], q.x);
    mx[1] = fmaxf(mx[1], q.y);
  }
  const float mu0 = mx[0] == -INFINITY ? 0.f : mx[0];
  const float mu1 = mx[1] == -INFINITY ? 0.f : mx[1];
  const int g0 = slice * kGroups / S;
  const int n_own = (slice + 1) * kGroups / S - g0;
  float4* sum = part + threadIdx.x;  // slot 0: [owned group][thread]
  float lsum[2] = {0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    const float4 q = mls[s * 256];
    const float f0 = fast_exp2((q.x - mu0) * kLog2e);
    const float f1 = fast_exp2((q.y - mu1) * kLog2e);
    lsum[0] += f0 * q.z;
    lsum[1] += f1 * q.w;
    const float4* x = part + s * owned * 256 + threadIdx.x;
    for (int j = 0; j < n_own; ++j) {
      const float4 v = x[j * 256];
      float4 a = s == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : sum[j * 256];
      a.x += f0 * v.x;
      a.y += f0 * v.y;
      a.z += f1 * v.z;
      a.w += f1 * v.w;
      sum[j * 256] = a;
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    inv[r] = 1.f / fmaxf(lsum[r], 1e-30f);
  }
  EXT_PROBE(6);
  for (int j = 0; j < n_own; ++j) {
    const float4 a = sum[j * 256];
    const float v[4] = {a.x, a.y, a.z, a.w};
    store_group(g0 + j, v, inv);
  }
  EXT_PROBE(7);
  EXT_TIME(1);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
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
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map over the (D, S, heads, B) view of ``base`` (element
// strides st = {batch, head, position}), boxes of 64 columns x ``rows``
// rows with the 128-byte swizzle; reads past D or S are zero-filled.
int encode(CUtensorMap* map, const void* base, const long long* st, int B,
           int heads, int S, int D, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

template <int DP, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const long long* st, int B, int H, int KV, int Sq, int Sk,
                 int D, float scale, int causal, int window, float softcap,
                 int stages, cudaStream_t stream) {
  using C = TcConfig<DP, NWG>;
  if (stages < 2 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      1024 + C::kQBytes + static_cast<size_t>(stages) * C::kStageBytes;
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<DP, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  CUtensorMap tq, tk, tv;  // Q over Sq rows, K and V over Sk
  int err = encode(&tq, q, st, B, H, Sq, D, C::kBQ);
  if (err == 0) err = encode(&tk, k, st + 3, B, KV, Sk, D, C::kBK);
  if (err == 0) err = encode(&tv, v, st + 6, B, KV, Sk, D, C::kBK);
  if (err != 0) return err;
  const TcParams p{st[9],  st[10], st[11], Sq,    Sk,      D,
                   H / KV, stages, causal, window, scale, softcap};
  const dim3 grid((Sq + C::kBQ - 1) / C::kBQ, H, B);
  flash_wgmma_kernel<DP, NWG><<<grid, C::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int KV, int Sq,
                   int Sk, int D, float scale, int causal, int window,
                   float softcap, int stages, cudaStream_t s) {
  switch ((D + 63) / 64) {
    case 1:
      return launch_wgmma<64, NWG>(q, k, v, o, st, B, H, KV, Sq, Sk, D,
                                   scale, causal, window, softcap,
                                   stages, s);
    case 2:
      return launch_wgmma<128, NWG>(q, k, v, o, st, B, H, KV, Sq, Sk, D,
                                    scale, causal, window, softcap,
                                    stages, s);
    case 3:
      return launch_wgmma<192, NWG>(q, k, v, o, st, B, H, KV, Sq, Sk, D,
                                    scale, causal, window, softcap,
                                    stages, s);
    default:
      return launch_wgmma<256, NWG>(q, k, v, o, st, B, H, KV, Sq, Sk, D,
                                    scale, causal, window, softcap,
                                    stages, s);
  }
}

// The extend launch's host side: pair, slices and stages as planned by
// kernels/flash_attention/kernel.plan_extend. Q's map has 64-row boxes
// (one a warpgroup), K's and V's BK-row boxes over Sk.
template <int DP>
int launch_extend(const void* q, const void* k, const void* v, void* o,
                  const long long* st, int B, int H, int KV, int Sq, int Sk,
                  int D, float scale, int window, float softcap,
                  const int* q_off, int pair, int slices, int stages,
                  cudaStream_t stream) {
  using C = TcConfig<DP, 2>;
  if (stages < 2 || stages > kMaxStages || slices < 1 ||
      slices > kMaxSlices || (pair && (H / KV) % 2) || q_off == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 1024 + 2 * 64 * DP * 2 +
                      static_cast<size_t>(stages) * C::kStageBytes;
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_extend_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, st, B, H, Sq, D, 64);
  if (err == 0) err = encode(&tk, k, st + 3, B, KV, Sk, D, C::kBK);
  if (err == 0) err = encode(&tv, v, st + 6, B, KV, Sk, D, C::kBK);
  if (err != 0) return err;
  ExtParams p{st[9], st[10], st[11], Sq,    Sk,     D,     H / KV,
              stages, 1,     window, slices, pair,  scale, softcap,
              q_off};
  const int rows = pair ? 64 : 128;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sq + rows - 1) / rows * slices, pair ? H / 2 : H, B);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = slices > 1 ? 1 : 0;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  void* args[] = {&tq, &tk, &tv, &out, &p};
  const cudaError_t launched = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(flash_extend_kernel<DP>), args);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#ifdef REPRO_FLASH_PHASES
int flash_phases_read(void* out) {  // long long [2][kPhaseTiles][8]
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)));
}
// long long [kProbeCtas][kExtPoints], unsigned long long [kProbeCtas][2]
int flash_extend_probes_read(void* clocks, void* times) {
  cudaError_t err =
      cudaMemcpyFromSymbol(clocks, g_ext_clocks, sizeof(g_ext_clocks));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(times, g_ext_times, sizeof(g_ext_times));
  return static_cast<int>(err);
}
#endif

const char* repro_error_string(int err) {
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, H, Sq, D), k/v (B, KV, Sk, D), o (B, H, Sq, D), all float32
// with unit stride along D; strides holds the element strides (batch,
// head, position) of q, k, v and o, in that order. 1 <= D <= 256, H a
// multiple of KV, Sk >= 1; window <= 0 means none, softcap <= 0 means
// none. q_off: null (the prefill launch: Sk == Sq, query row i at
// position i) or an int32 (B,) device array, query row i of batch row b
// at position q_off[b] + i (the extend launch).
int flash_attention_fp32_launch(const void* q, const void* k, const void* v,
                                void* o, const long long* strides, int B,
                                int H, int KV, int Sq, int Sk, int D,
                                float scale, int causal, int window,
                                float softcap, const void* q_off,
                                void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (D < 1 || D > 256 || KV < 1 || H % KV || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const int* off = static_cast<const int*>(q_off);
  if (D <= 64)
    return launch_fp32<4>(qf, kf, vf, of, strides, B, H, KV, Sq, Sk, D,
                          scale, causal, window, softcap, off, s);
  if (D <= 128)
    return launch_fp32<8>(qf, kf, vf, of, strides, B, H, KV, Sq, Sk, D,
                          scale, causal, window, softcap, off, s);
  return launch_fp32<16>(qf, kf, vf, of, strides, B, H, KV, Sq, Sk, D,
                         scale, causal, window, softcap, off, s);
}

// The same contract in bfloat16, on the tensor cores, for the prefill
// launch alone (q_off null: the extend launch is flash_extend_bf16_launch).
// Also: D a multiple of 8, q, k and v 16-byte aligned with strides of
// whole 16-byte units (TMA's rules, checked by the wrapper); q_tile 64 or
// 128 query rows a CTA; stages the K/V ring's depth (2..4, planned by the
// wrapper so that the shared memory fits).
int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                void* o, const long long* strides, int B,
                                int H, int KV, int Sq, int Sk, int D,
                                float scale, int causal, int window,
                                float softcap, const void* q_off,
                                int q_tile, int stages, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || Sk < 1 ||
      q_off != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_tile == 64)
    return dispatch_wgmma<1>(q, k, v, o, strides, B, H, KV, Sq, Sk, D, scale,
                             causal, window, softcap, stages, s);
  if (q_tile == 128)
    return dispatch_wgmma<2>(q, k, v, o, strides, B, H, KV, Sq, Sk, D, scale,
                             causal, window, softcap, stages, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The extend launch in bfloat16 (flash_extend_kernel): the bf16 launch's
// contract with q_off an int32 (B,) device array, always causal; pair 1
// (H / KV even) puts two heads of a group on a CTA's 64 rows, 0 one
// head's 128 rows; slices (1..4) CTAs a query tile, a cluster, split its
// live key tiles; stages the K/V ring's depth (2..4).
int flash_extend_bf16_launch(const void* q, const void* k, const void* v,
                             void* o, const long long* strides, int B,
                             int H, int KV, int Sq, int Sk, int D,
                             float scale, int window, float softcap,
                             const void* q_off, int pair, int slices,
                             int stages, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(q_off);
  switch ((D + 63) / 64) {
    case 1:
      return launch_extend<64>(q, k, v, o, strides, B, H, KV, Sq, Sk, D,
                               scale, window, softcap, off, pair, slices,
                               stages, s);
    case 2:
      return launch_extend<128>(q, k, v, o, strides, B, H, KV, Sq, Sk, D,
                                scale, window, softcap, off, pair, slices,
                                stages, s);
    case 3:
      return launch_extend<192>(q, k, v, o, strides, B, H, KV, Sq, Sk, D,
                                scale, window, softcap, off, pair, slices,
                                stages, s);
    default:
      return launch_extend<256>(q, k, v, o, strides, B, H, KV, Sq, Sk, D,
                                scale, window, softcap, off, pair, slices,
                                stages, s);
  }
}

}  // extern "C"
