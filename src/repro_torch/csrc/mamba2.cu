// zamba2's Mamba2 mixer on the card: a one-token decode step of a layer
// in one launch (mamba2_step_kernel) and a prompt's chunked SSD with its D
// skip, gate and norm in one launch (ssd_chunk_kernel).
//
// Replaces no Pallas kernel. The reference's Mamba2 block
// (src/repro/models/mamba2.py) is einsums and elementwise chains that XLA
// fuses: its decode branch with the conv before it and the epilogue after
// it (mamba_apply, :172-200) and its chunked SSD (ssd_chunked, :89-156)
// with the same epilogue (:198-200). The port's plain spelling
// (repro_torch/models/mamba2.py) runs each op as a torch kernel of its
// own: ~75 kernels a decode layer, and over a prompt a Python loop over
// the chunks beside (B, nc, H, L, L) and (B, S, H, N) fp32 intermediates
// in device memory.
//
// Numerics. As in fusions.cu: every fp32 operation that the plain
// spelling runs as a torch kernel of its own is one __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn here (nvcc never contracts them into
// an FMA), every rounding to the compute dtype between two ops is a
// __float2bfloat16_rn, and expf, log1pf and rsqrtf are the functions
// torch's CUDA kernels call. So the decode step's conv output, its new
// conv state, dt and its new SSM state are the plain spelling's bits; its
// readout over N and the norm over P sum in an order of their own, fixed
// by the shapes alone (ref.py spells both orders): the readout a row's 4
// lanes of 16 consecutive n each, summed in order and added by a
// xor-shuffle tree; the norm 16 lanes of 4 consecutive p each, the same
// way. The chunked SSD's products are fp32 FMAs on the CUDA cores in an
// order of their own (no TF32).
//
// mamba2_step_kernel. Bound: bytes. The layer's fp32 SSM state, B x H x
// P x N x 4 bytes (2.62 MB at zamba2-2.7b's B 2), is read and written
// once; everything else is a few KB. The grid is (H / G, G, B): one head
// a CTA (160 CTAs at zamba2's B 2, each moving 32 KB), so the grid never
// depends on B beyond its last axis and a row's bits are the same alone
// and in a batch. A CTA starts one 1-D bulk copy (TMA) of its head's 16
// KB state row into shared memory, then computes the depthwise conv of
// its head's x channels and of its group's B and C channels while it
// lands. Every CTA of a (row, group) reads the group's old B / C conv
// state, then takes a ticket (an int32 counter of the (row, group), zero
// between launches); the CTA that draws the last shifts that state in
// place, every other having read it, and puts the counter back to zero
// (the x channels' state is each CTA's own). A state row is 4 lanes a p,
// 16 consecutive n a lane, read from shared memory and written to device
// memory as float4s; the head's gate and norm follow in the same launch.
//
// ssd_chunk_kernel. Bound: operations. A chunk of L tokens of a (row,
// head) takes four L x L x N-sized fp32 products (the scores C B^T, their
// product with x dt, the readout of the carried state, the state's
// update): 2.1 MFLOP at zamba2's L = N = P = 64, 10.7 GFLOP a layer at
// B 2 x 2000 tokens, ~0.16 ms at the 67 TFLOP/s fp32 peak. One CTA a
// (head, row) walks its chunks in order with the (P, N) state in shared
// memory, so nothing leaves the chip between chunks; each product is a
// 64 x 64 tile, a 4 x 4 register block a thread, both operands read as
// float4s from k-major staged tiles; the tail chunk is zero-filled, as
// the plain spelling's dt = 0 pad is (decay 1, no input). The gate and
// the norm over P run on the tile's rows in registers (a row's 16
// threads are one half-warp), and the final state is written once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDim = 64;            // P, N and the chunk at most: a tile's side
constexpr int kLd = kDim + 4;       // a staged tile's row stride (floats)
constexpr int kMaxConv = 8;         // d_conv at most
constexpr int kRowLanes = 4;        // lanes a state row (the readout)
constexpr int kLaneCols = kDim / kRowLanes;   // consecutive n a lane
constexpr int kNormLanes = 16;      // lanes of a norm's sum, 4 p a lane
constexpr int kChunkSmem = (6 * kDim * kLd + 4 * kDim) * 4;

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

// x * (1 / (1 + exp(-x))), every op rounded to T (common._silu); 1 / y is
// torch's reciprocal, then a product with 1.0 that changes nothing.
template <typename T>
__device__ __forceinline__ float silu(float x) {
  const float e = rnd<T>(expf(-x));
  const float d = rnd<T>(__fadd_rn(e, 1.0f));
  const float rc = rnd<T>(__fdiv_rn(1.0f, d));
  return rnd<T>(__fmul_rn(x, rc));
}

// torch's CUDA softplus at beta 1, threshold 20.
__device__ __forceinline__ float softplus(float a) {
  return a > 20.0f ? a : log1pf(expf(a));
}

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "M2_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra M2_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared, completing on ``bar`` with its bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------ decode step
struct StepParams {
  const void* z;        // (B, H, P)
  const void* x;        // (B, H * P), the x product
  const void* bm;       // (B, G * N)
  const void* cm;       // (B, G * N)
  const void* dt;       // (B, H), before dt_bias and the softplus
  const void* conv_w;   // (K, C), C = H P + 2 G N
  const void* conv_b;   // (C,)
  const void* dt_bias;  // (H,)
  const void* a_log;    // (H,)
  const void* d_skip;   // (H,)
  const void* norm;     // (H, P)
  void* conv_state;     // (B, K - 1, C), shifted in place
  float* ssm;           // (B, H, P, N), updated in place
  void* y;              // (B, H, P)
  int* tickets;         // (B, G), zero between launches
  int H, P, N, G, K;
  float eps;
};

// grid (H / G, G, B), kThreads threads: one head a CTA
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mamba2_step_kernel(const StepParams p) {
  __shared__ __align__(128) float st[kDim * kDim];  // the head's state row
  __shared__ __align__(8) uint64_t bar;
  __shared__ float xs[kDim];         // the conv'd x
  __shared__ float zs[kDim];         // SiLU(z)
  __shared__ float gs[kDim];         // the gated y
  __shared__ float wn[kDim];         // 1 + the norm's scale
  __shared__ float bc[2 * kDim];     // the group's conv'd B and C
  __shared__ float hd[3];            // the head's dt, decay and D
  __shared__ int last;               // this CTA drew the (row, group)'s last
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int H = p.H, P = p.P, N = p.N, G = p.G, K = p.K;
  const int PN = P * N, HP = H * P, GN = G * N;
  const int C = HP + 2 * GN;
  const int h = g * (H / G) + blockIdx.x;
  float* ssm = p.ssm + ((long long)b * H + h) * PN;
  if (tid == 0) {
    bar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    last = 0;
    bar_expect(&bar, PN * 4);
    bulk_load(st, ssm, PN * 4, &bar);
  }

  // the conv (common order: 0 + the products from the oldest input, then
  // the bias, each op rounded to T), then SiLU; the head's x channels'
  // state shifted here, the group's B / C channels' by the last CTA
  const T* xin = static_cast<const T*>(p.x) + (long long)b * HP;
  const T* bin = static_cast<const T*>(p.bm) + (long long)b * GN + g * N;
  const T* cin = static_cast<const T*>(p.cm) + (long long)b * GN + g * N;
  const T* w = static_cast<const T*>(p.conv_w);
  const T* cb = static_cast<const T*>(p.conv_b);
  T* cstate = static_cast<T*>(p.conv_state) + (long long)b * (K - 1) * C;
  for (int i = tid; i < P + 2 * N; i += kThreads) {
    int ch;
    T v;
    if (i < P) {
      ch = h * P + i;
      v = xin[ch];
    } else if (i < P + N) {
      ch = HP + g * N + (i - P);
      v = bin[i - P];
    } else {
      ch = HP + GN + g * N + (i - P - N);
      v = cin[i - P - N];
    }
    float xp[kMaxConv];
#pragma unroll
    for (int k = 0; k < kMaxConv; ++k)
      if (k < K - 1) xp[k] = to_float(cstate[(long long)k * C + ch]);
#pragma unroll
    for (int k = 0; k < kMaxConv; ++k)
      if (k == K - 1) xp[k] = to_float(v);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxConv; ++k)
      if (k < K)
        acc = rnd<T>(__fadd_rn(
            acc, rnd<T>(__fmul_rn(xp[k],
                                  to_float(w[(long long)k * C + ch])))));
    acc = rnd<T>(__fadd_rn(acc, to_float(cb[ch])));
    const float out = silu<T>(acc);
    if (i < P) {
      xs[i] = out;
#pragma unroll
      for (int k = 0; k + 1 < kMaxConv; ++k)
        if (k < K - 1)
          cstate[(long long)k * C + ch] = from_float<T>(xp[k + 1]);
    } else {
      bc[i - P] = out;
    }
  }
  // every value the recurrence and the norm read, loaded while the state
  // lands: SiLU(z), the norm's gains, dt's softplus and the decay
  const T* zin = static_cast<const T*>(p.z) + ((long long)b * H + h) * P;
  const T* nin = static_cast<const T*>(p.norm) + (long long)h * P;
  for (int i = tid; i < P; i += kThreads) {
    zs[i] = silu<T>(to_float(zin[i]));
    wn[i] = __fadd_rn(1.0f, to_float(nin[i]));
  }
  if (tid == 0) {
    const float dtv = softplus(__fadd_rn(
        to_float(static_cast<const T*>(p.dt)[(long long)b * H + h]),
        to_float(static_cast<const T*>(p.dt_bias)[h])));
    const float A = -expf(to_float(static_cast<const T*>(p.a_log)[h]));
    hd[0] = dtv;
    hd[1] = expf(__fmul_rn(dtv, A));
    hd[2] = to_float(static_cast<const T*>(p.d_skip)[h]);
  }
  __syncthreads();
  // this CTA has read the group's old B / C conv state: its ticket
  int* ticket = p.tickets + (long long)b * G + g;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }

  // the recurrence and its readout, once the state has landed
  const int row = tid / kRowLanes, n0 = (tid % kRowLanes) * kLaneCols;
  bar_wait(&bar, 0);
  float v = 0.0f;
  if (row < P && n0 < N) {
    const float dA = hd[1];
    const float xb = __fmul_rn(xs[row], hd[0]);
    const float* hs = st + row * N + n0;
    float* hg = ssm + row * N + n0;
#pragma unroll
    for (int q = 0; q < kLaneCols; q += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hs + q);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
      float nv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        nv[e] = __fadd_rn(__fmul_rn(dA, hv[e]),
                          __fmul_rn(xb, bc[n0 + q + e]));
        const float pr = __fmul_rn(bc[N + n0 + q + e], nv[e]);
        v = (q == 0 && e == 0) ? pr : __fadd_rn(v, pr);
      }
      *reinterpret_cast<float4*>(hg + q) =
          make_float4(nv[0], nv[1], nv[2], nv[3]);
    }
  }
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
  if (tid % kRowLanes == 0 && row < P) {
    // the D skip, rounded to T, times SiLU(z) in fp32
    const float y2 = __fadd_rn(v, __fmul_rn(xs[row], hd[2]));
    gs[row] = __fmul_rn(rnd<T>(y2), zs[row]);
  }
  __syncthreads();

  // the norm over P, by the first warp
  if (tid < 32) {
    float s = 0.0f;
    if (tid < kNormLanes) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = tid * 4 + e;
        const float q = sq(pp < P ? gs[pp] : 0.0f);
        s = e == 0 ? q : __fadd_rn(s, q);
      }
    }
#pragma unroll
    for (int off = 1; off < kNormLanes; off <<= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    s = __shfl_sync(0xffffffffu, s, 0);
    const float inv_p = __fdiv_rn(1.0f, static_cast<float>(P));
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(s, inv_p), p.eps));
    T* yo = static_cast<T*>(p.y) + ((long long)b * H + h) * P;
    for (int pp = tid; pp < P; pp += 32)
      yo[pp] = from_float<T>(__fmul_rn(__fmul_rn(gs[pp], rs), wn[pp]));
  }

  // the last ticket: every CTA of the (row, group) has read the old B / C
  // conv state; shift it in place, and zero the counter for the next
  // launch (``last`` was written before the barrier after the recurrence)
  if (last) {
    __threadfence();
    for (int i = tid; i < 2 * N; i += kThreads) {
      const bool is_c = i >= N;
      const int n = is_c ? i - N : i;
      T* cs = cstate + HP + (is_c ? GN : 0) + g * N + n;
      for (int k = 0; k + 2 < K; ++k)
        cs[(long long)k * C] = cs[(long long)(k + 1) * C];
      cs[(long long)(K - 2) * C] = (is_c ? cin : bin)[n];
    }
    if (tid == 0) *ticket = 0;
  }
}

template <typename T>
int step_launch(const StepParams& prm, int B, cudaStream_t stream) {
  mamba2_step_kernel<T>
      <<<dim3(prm.H / prm.G, prm.G, B), kThreads, 0, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ chunked SSD
struct ChunkParams {
  const void* x;     // (B, S, H, P) after the conv and SiLU; (H, P) dense
  const void* bm;    // (B, S, G, N); (G, N) dense
  const void* cm;
  const void* z;     // (B, S, H, P); (H, P) dense
  const float* dt;   // (B, S, H) after the softplus; H dense
  long long x_bs, x_ts, b_bs, b_ts, c_bs, c_ts, z_bs, z_ts, dt_bs, dt_ts;
  const void* a_log;     // (H,)
  const void* d_skip;    // (H,)
  const void* norm;      // (H, P)
  const float* init;     // (B, H, P, N) or null (zeros)
  float* state;          // (B, H, P, N): the final state (may be init)
  void* y;               // (B, S, H, P) contiguous
  int S, H, P, N, G, L;
  float eps;
};

// acc[i][j] += sum_k a[k][r0 + i] b[k][c0 + j], both tiles k-major with
// rows kLd floats apart
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float* a,
                                         const float* b, int k_end, int r0,
                                         int c0) {
#pragma unroll 4
  for (int k = 0; k < k_end; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kLd + r0);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd + c0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// grid (H, B), kThreads threads, kChunkSmem bytes
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_kernel(const ChunkParams p) {
  extern __shared__ __align__(128) float sm[];
  float* ht = sm;                  // [n][p] the carried state
  float* ct = ht + kDim * kLd;     // [n][l] C^T
  float* bt = ct + kDim * kLd;     // [n][m] B^T
  float* bn = bt + kDim * kLd;     // [m][n] B decayed to the chunk's end
  float* xb = bn + kDim * kLd;     // [m][p] x dt
  float* sc = xb + kDim * kLd;     // [m][l] the decayed scores
  float* dts = sc + kDim * kLd;    // [l] dt
  float* cum = dts + kDim;         // [l] the inclusive sum of dt A
  float* eout = cum + kDim;        // [l] exp(total - cum)
  float* ein = eout + kDim;        // [l] exp(cum)
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = p.H, P = p.P, N = p.N;
  const int g = h / (H / p.G);
  const int r0 = (tid / 16) * 4, c0 = (tid % 16) * 4;
  const T* x = static_cast<const T*>(p.x) + b * p.x_bs + (long long)h * P;
  const T* z = static_cast<const T*>(p.z) + b * p.z_bs + (long long)h * P;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_bs + (long long)g * N;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_bs + (long long)g * N;
  const float* dt = p.dt + b * p.dt_bs + h;
  T* y = static_cast<T*>(p.y) + ((long long)b * p.S * H + h) * P;
  const long long yts = (long long)H * P;
  const float A = -expf(to_float(static_cast<const T*>(p.a_log)[h]));
  const float Dv = to_float(static_cast<const T*>(p.d_skip)[h]);
  const float inv_p = __fdiv_rn(1.0f, static_cast<float>(P));
  float wn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wn[j] = c0 + j < P ? __fadd_rn(1.0f, to_float(static_cast<const T*>(
                                             p.norm)[h * P + c0 + j]))
                       : 0.0f;
  const long long so = ((long long)b * H + h) * P * N;
  for (int e = tid; e < kDim * kDim; e += kThreads) {
    const int pp = e / kDim, n = e % kDim;
    ht[n * kLd + pp] = p.init != nullptr && pp < P && n < N
                           ? p.init[so + pp * N + n]
                           : 0.0f;
  }

  // a thread's column k of 16 rows of each raw tile (C, B, x) and, below
  // kDim, one token's dt: loaded for chunk c + 1 while chunk c's state
  // update runs, stored at chunk c + 1's start
  const int k = tid % kDim, l0 = tid / kDim;
  constexpr int kRows = kDim * kDim / kThreads;
  constexpr int kStep = kThreads / kDim;
  float cv[kRows], bv[kRows], xv[kRows], dtv = 0.0f;
  auto load_raw = [&](int t) {
    const int n_live = min(p.L, p.S - t);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int l = l0 + i * kStep;
      const long long tok = t + l;
      const bool bc_live = l < n_live && k < N, x_live = l < n_live && k < P;
      cv[i] = bc_live ? to_float(cm[tok * p.c_ts + k]) : 0.0f;
      bv[i] = bc_live ? to_float(bm[tok * p.b_ts + k]) : 0.0f;
      xv[i] = x_live ? to_float(x[tok * p.x_ts + k]) : 0.0f;
    }
    if (tid < kDim)
      dtv = tid < n_live ? dt[(long long)(t + tid) * p.dt_ts] : 0.0f;
  };
  load_raw(0);

  for (int t0 = 0; t0 < p.S; t0 += p.L) {
    const int Lc = min(p.L, p.S - t0);
    __syncthreads();                 // the last chunk's tiles are consumed
    if (tid < kDim) dts[tid] = dtv;
    __syncthreads();
    if (tid == 0) {  // in token order, as ref.py
      float c = 0.0f;
      for (int l = 0; l < kDim; ++l) {
        const float da = __fmul_rn(dts[l], A);
        c = l == 0 ? da : __fadd_rn(c, da);
        cum[l] = c;
      }
    }
    __syncthreads();
    const float total = cum[kDim - 1];
    if (tid < kDim) {
      eout[tid] = expf(__fsub_rn(total, cum[tid]));
      ein[tid] = expf(cum[tid]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {  // the chunk's tiles
      const int l = l0 + i * kStep;
      ct[k * kLd + l] = cv[i];
      bt[k * kLd + l] = bv[i];
      bn[l * kLd + k] = __fmul_rn(bv[i], eout[l]);
      xb[l * kLd + k] = __fmul_rn(xv[i], dts[l]);
    }
    __syncthreads();

    {  // sc[m][l] = (B_m . C_l) exp(cum_l - cum_m) for m <= l, else 0
      float acc[4][4] = {};
      tile_fma(acc, bt, ct, N, r0, c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = r0 + i, l = c0 + j;
          o[j] = m <= l ? __fmul_rn(acc[i][j],
                                    expf(__fsub_rn(cum[l], cum[m])))
                        : 0.0f;
        }
        *reinterpret_cast<float4*>(sc + (r0 + i) * kLd + c0) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // y[l][p]: the chunk's own tokens, then the carried state's readout
    float yd[4][4] = {}, yo[4][4] = {};
    tile_fma(yd, sc, xb, p.L, r0, c0);
    tile_fma(yo, ct, ht, N, r0, c0);
    // the D skip, the gate and the norm over P: a row's 16 threads are
    // one half-warp; the tile's x and z loaded first, all at once
    float xs[4][4], zv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long tok = t0 + r0 + i;
        const bool live = r0 + i < Lc && c0 + j < P;
        xs[i][j] = live ? to_float(x[tok * p.x_ts + c0 + j]) : 0.0f;
        zv[i][j] = live ? to_float(z[tok * p.z_ts + c0 + j]) : 0.0f;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = r0 + i;
      const bool live = l < Lc;
      const long long tok = t0 + l;
      float gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[j] = 0.0f;
        if (live && c0 + j < P) {
          const float yv = __fadd_rn(yd[i][j], __fmul_rn(ein[l], yo[i][j]));
          const float y2 = __fadd_rn(yv, __fmul_rn(xs[i][j], Dv));
          gv[j] = __fmul_rn(rnd<T>(y2), silu<T>(zv[i][j]));
        }
      }
      float s = sq(gv[0]);
      s = __fadd_rn(s, sq(gv[1]));
      s = __fadd_rn(s, sq(gv[2]));
      s = __fadd_rn(s, sq(gv[3]));
#pragma unroll
      for (int off = 1; off < kNormLanes; off <<= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      const float rs = rsqrtf(__fadd_rn(__fmul_rn(s, inv_p), p.eps));
      if (live) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < P)
            y[tok * yts + c0 + j] =
                from_float<T>(__fmul_rn(__fmul_rn(gv[j], rs), wn[j]));
      }
    }
    if (t0 + p.L < p.S) load_raw(t0 + p.L);
    __syncthreads();                 // every readout of the state is done

    {  // ht[n][p] = exp(total) ht[n][p] + sum_m bn[m][n] xb[m][p]
      float u[4][4] = {};
      tile_fma(u, bn, xb, p.L, r0, c0);
      const float et = expf(total);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = ht + (r0 + i) * kLd + c0 + j;
          *hp = __fadd_rn(__fmul_rn(et, *hp), u[i][j]);
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads)
    p.state[so + e] = ht[(e % N) * kLd + e / N];
}

template <typename T>
int chunk_launch(const ChunkParams& prm, int B, cudaStream_t stream) {
  auto kernel = ssd_chunk_kernel<T>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  kernel<<<dim3(prm.H, B), kThreads, kChunkSmem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// The widths both kernels take: P at most a tile, N whole 16-float lanes
// of at most a tile, heads a whole number of groups.
bool dims_ok(int H, int P, int N, int G) {
  return P >= 1 && P <= kDim && N >= 16 && N <= kDim && N % 16 == 0 &&
         G >= 1 && H >= G && H % G == 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One decode step of one Mamba2 layer (one token a row). z (B, H, P), x
// (B, H P), bm and cm (B, G N), dt (B, H), conv_w (K, C), conv_b (C,),
// dt_bias, a_log, d_skip (H,), norm (H, P), conv_state (B, K - 1, C) and
// y (B, H, P) in the compute dtype (dtype 0 float32, 1 bfloat16), every
// tensor contiguous; ssm (B, H, P, N) fp32, 16-byte aligned; tickets (B
// G) int32 on the device, all zero (and left so). Shifts conv_state and
// updates ssm in place, writes the normed y. One launch.
int mamba2_step_launch(const void* z, const void* x, const void* bm,
                       const void* cm, const void* dt, const void* conv_w,
                       const void* conv_b, const void* dt_bias,
                       const void* a_log, const void* d_skip,
                       const void* norm, void* conv_state, void* ssm,
                       void* y, void* tickets, int B, int H, int P, int N,
                       int G, int K, float eps, int dtype, void* stream) {
  if (B == 0) return 0;
  if (!dims_ok(H, P, N, G) || B < 0 || B > 65535 || G > 65535 || K < 2 ||
      K > kMaxConv || tickets == nullptr || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(ssm) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepParams prm{z, x, bm, cm, dt, conv_w, conv_b, dt_bias, a_log,
                       d_skip, norm, conv_state, static_cast<float*>(ssm),
                       y, static_cast<int*>(tickets), H, P, N, G, K, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? step_launch<__nv_bfloat16>(prm, B, s)
                    : step_launch<float>(prm, B, s);
}

// A prompt's SSD, chunk after chunk, with the D skip, the gate and the
// norm. x, z (B, S, H, P), bm, cm (B, S, G, N) in the compute dtype at
// the given batch and token strides (elements; the inner two dims
// dense), dt (B, S, H) fp32 at its strides, a_log, d_skip (H,) and norm
// (H, P) in the compute dtype, init (B, H, P, N) fp32 or null, state (B,
// H, P, N) fp32 (the final state; may be init: read once, written
// once), y (B, S, H, P) contiguous in the compute dtype. One launch.
int ssd_chunk_launch(const void* x, long long x_bs, long long x_ts,
                     const void* bm, long long b_bs, long long b_ts,
                     const void* cm, long long c_bs, long long c_ts,
                     const void* z, long long z_bs, long long z_ts,
                     const void* dt, long long dt_bs, long long dt_ts,
                     const void* a_log, const void* d_skip, const void* norm,
                     const void* init, void* state, void* y, int B, int S,
                     int H, int P, int N, int G, int L, float eps, int dtype,
                     void* stream) {
  if (B == 0) return 0;
  if (!dims_ok(H, P, N, G) || B < 0 || B > 65535 || S < 1 || L < 1 ||
      L > kDim || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChunkParams prm{x, bm, cm, z, static_cast<const float*>(dt),
                        x_bs, x_ts, b_bs, b_ts, c_bs, c_ts, z_bs, z_ts,
                        dt_bs, dt_ts, a_log, d_skip, norm,
                        static_cast<const float*>(init),
                        static_cast<float*>(state), y, S, H, P, N, G, L,
                        eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? chunk_launch<__nv_bfloat16>(prm, B, s)
                    : chunk_launch<float>(prm, B, s);
}

}  // extern "C"
