// Decode attention's dense launch in bf16: one query a row against a
// layer's dense (B, T, KV, D) cache, each row's splits one thread-block
// cluster that merges them in distributed shared memory.
//
// Replaces no Pallas kernel: the reference's one-token step is
// attend_decode at C == 1 (src/repro/models/attention.py:272), which XLA
// fuses. It took decode_attention.cu's paged split kernels over the cache
// (dense_decode_launch) before this kernel; that launch keeps fp32 (the
// equivalence checks) and the head dims this file has no instantiation
// for.
//
// Bound: bytes. A row reads its live K and V rows once and does about G
// flops a byte, far below the card's flop:byte balance, so the floor is
// (live K/V bytes) / HBM bandwidth: ~38 MB, 11.3 us, at gemma2-9b's
// global layer. What it takes is every SM streaming with bytes in flight
// and no serial tail.
//
// Design. The grid is (cluster, KV / heads, B): a CTA takes `heads` KV
// heads of a row (several at once where a head's row is short, so one
// token's load is their contiguous bytes: 640 at zamba2-2.7b's Dh 80, 4
// heads) and one split of `split` tokens; the `cluster` splits of a (row,
// head group) are one thread-block cluster. The plan is the host's
// (plan_dense_split in kernels/decode_attention/kernel.py), passed to each
// launch and checked here against the kernel's bounds and shared memory:
// a function of (T, KV, G, D) alone, never of B or the offsets, sized so
// that path E's shapes fill the 132 SMs in about one wave (gemma2-9b 8 x
// 14 CTAs, zamba2-2.7b at B 2 2 x 8 x 8); a row's bits do not depend on
// the batch or on a graph replay.
//
// A CTA is one producer warp and kConsumers consumer warps. The producer
// sets up the barriers and starts at once (the consumers load Q
// meanwhile): a ring stage is kStageTokens tokens of the CTA's heads, K
// and V, each head's row as box_count(D) TMA boxes of 16 tokens x
// box_width(D) elements through 4-D tensor maps over the cache's strides
// (encoded once a cache address, dense_cluster_maps), the width 8 times
// an odd number so the box's rows read conflict-free (ldmatrix). Stage i
// goes into slot i % stages once its slot's last stage is consumed (the
// slot's empty mbarrier, one arrival a head), completing on full mbarrier
// i % nb with the bytes it expects. Consumer warp c takes head c / wph
// (wph = kConsumers / heads warps a head) and the stages i == c (mod
// wph); nb, the stages rounded up to a multiple of wph, makes each full
// barrier one warp's, waited on phase after phase, whatever the ring's
// depth. (One 1-D bulk copy a token row, 512 bytes at gemma2-9b's heads,
// held the producer to ~50 cycles a copy: the loads alone took 27 us.)
//
// A warp's 16 tokens are the m rows of mma.sync m16n8k16 products, the
// query heads the n columns (G <= 8 a tile, NT tiles): S^T = K Q^T (K by
// ldmatrix, Q^T's fragments in registers; even and odd k steps in two
// accumulators), the scores scaled and softcapped in fp32 (CAP: gemma2's
// __fmul_rn(tanhf(__fdiv_rn(s, cap)), cap)), an fp32 online softmax a
// query head (its 16 tokens across 8 lanes; rescaled only when the max
// grows), then O^T += V^T P^T with V^T by ldmatrix.trans and P^T's bf16
// hi + lo parts moved by shuffles from the score layout to the B
// operand's. At G = 1 or 2 this spends half the products (and a quarter
// of the softcaps) of the query heads as m rows, where 14 or 15 of 16
// rows were zero; measured per stage, that was the kernel's bound (the
// warps are latency-bound: a CTA sharing its SM was no slower). Only live
// rows are loaded: the last stage's V rows past the row's length are
// zeroed in shared memory before its P V (P is 0 there; stale bits could
// be NaN).
//
// The merge. The warps of a head merge in warp order into the CTA's
// record (m, l, acc for each of its heads x G query heads). Each CTA then
// pushes it through distributed shared memory (stores, no round trip):
// m and l to every rank, and element e of acc to the rank that finishes
// it, rank e / chunk (chunk the power of two at or above E / C, E =
// heads G D), into an inbox
// no other use of shared memory overlaps. After one cluster barrier each
// rank merges its elements from its inbox in rank order (m = max m_s; l =
// sum l_s e^(m_s - m), acc likewise, s = 0, 1, ...) and writes acc / max(
// l, 1e-30) in bf16. No workspace, no counters, no block waits on another
// outside its cluster; the order of every sum is fixed by the plan and
// the row's length.
//
// Contracts. Row b attends over its first min(offsets[b] + 1, T) slots
// (the new token written already; a ring's T slots, once full, hold
// exactly the window); nothing past them enters the result, so dead
// slots may hold anything. An empty split leaves m = -2e38, l = 0 and
// acc = 0, which the merge weighs by exactly 0.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

// ---- Measurement probes (launch/dense_probes.py). Compiled in only with
// -DREPRO_DENSE_PROBES: thread 0 of every CTA (up to kProbeCtas; lane 0
// of the producer warp for its own points) stamps clock64() at
// kProbePoints points: start, set up, first stage in (consumer warp 0),
// warp 0's last stage done, producer done, consumers done, the CTA's
// record, the cluster's first barrier, end; then warp 0's cycles waiting
// for stages, computing them, and the producer's waiting for free stages;
// and the global timer (ns) at its start and end, and its SM.
// -DREPRO_DENSE_SKIP=1 drops the consumers' arithmetic, =2 the producer's
// loads (a stage arrives empty): timings of the load pipeline and of the
// compute alone, wrong outputs by design. In the library the port loads
// every PROBE_* below is empty and REPRO_DENSE_SKIP is 0.
#ifndef REPRO_DENSE_SKIP
#define REPRO_DENSE_SKIP 0
#endif
#ifdef REPRO_DENSE_PROBES
constexpr int kProbeCtas = 1024;
constexpr int kProbePoints = 12;
__device__ long long g_probe_clocks[kProbeCtas][kProbePoints];
__device__ unsigned long long g_probe_times[kProbeCtas][3];
__device__ __forceinline__ int probe_cta() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned sm_id() {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  return sm;
}
#define PROBE_AT(k, v)                                   \
  do {                                                   \
    if (probe_cta() < kProbeCtas)                        \
      g_probe_clocks[probe_cta()][(k)] = (v);            \
  } while (0)
#define PROBE(k) PROBE_AT(k, clock64())
#define PROBE_TIME(k)                                    \
  do {                                                   \
    if (probe_cta() < kProbeCtas)                        \
      g_probe_times[probe_cta()][(k)] = global_ns();     \
  } while (0)
#define PROBE_SM()                                       \
  do {                                                   \
    if (probe_cta() < kProbeCtas)                        \
      g_probe_times[probe_cta()][2] = sm_id();           \
  } while (0)
#define PROBE_SUM(x) long long x = 0
#define PROBE_CLOCK(x) const long long x = clock64()
#define PROBE_ADD(x, v) x += (v)

// long long [kProbeCtas][kProbePoints], unsigned long long [kProbeCtas][3]
// (start and end ns, SM id)
extern "C" int dense_probes_read(void* clocks, void* times) {
  cudaError_t err = cudaMemcpyFromSymbol(clocks, g_probe_clocks,
                                         sizeof(g_probe_clocks));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(times, g_probe_times, sizeof(g_probe_times));
  return static_cast<int>(err);
}
#else
#define PROBE_AT(k, v) do {} while (0)
#define PROBE(k) do {} while (0)
#define PROBE_TIME(k) do {} while (0)
#define PROBE_SM() do {} while (0)
#define PROBE_SUM(x) do {} while (0)
#define PROBE_CLOCK(x) do {} while (0)
#define PROBE_ADD(x, v) do {} while (0)
#endif
// ---- end of the measurement probes

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -2.0e38f;
constexpr int kConsumers = 4;                    // consumer warps a CTA
constexpr int kThreads = 32 * (kConsumers + 1);  // and the producer warp
constexpr int kStageTokens = 16;                 // tokens a ring stage
constexpr int kMaxStages = 8;
constexpr int kMaxBars = 2 * kMaxStages;  // full barriers: stages rounded up
constexpr int kMaxCluster = 16;
constexpr int kBarBytes = 256;           // kMaxBars + kMaxStages mbarriers
constexpr int kSmemLimit = 232448;       // bytes a Hopper block may use
constexpr int kEncodeFailed = 10000;     // + the CUresult of the encoder
constexpr int kMapBytes = 2 * sizeof(CUtensorMap);   // K's and V's maps

// A head's row of D elements arrives as box_count(D) TMA boxes of 16
// tokens x box_width(D) elements (past D zero-filled): the width 8 times
// an odd number, so a box's rows lie an odd number of 16-byte units apart
// in shared memory and ldmatrix reads 8 of them without bank conflicts.
// Box x starts at element x box_step(D), a multiple of 16, so each k step
// of 16 elements lies in one box (at D 256 the boxes overlap by 8).
__host__ __device__ constexpr int box_count(int D) {
  return D <= 248 ? 1 : 2;
}
__host__ __device__ constexpr int box_step(int D) {
  return D <= 248 ? 0 : 128;
}
__host__ __device__ constexpr int box_width(int D) {
  return ((D + box_count(D) - 1) / box_count(D) + 7) / 8 % 2
             ? ((D + box_count(D) - 1) / box_count(D) + 7) / 8 * 8
             : ((D + box_count(D) - 1) / box_count(D) + 7) / 8 * 8 + 8;
}

// A call's geometry: the host's plan (heads, cluster, split, stages,
// chunk) and the shared memory it lays out (checked_plan).
struct Plan {
  int heads;     // KV heads a CTA
  int cluster;   // CTAs (splits) a (row, head group)
  int split;     // tokens a split, a multiple of kStageTokens
  int stages;    // ring stages
  int chunk;     // output elements a rank finishes: a power of two at or
                 // above ceil(heads G D / cluster), 1 << chunk_log
  int chunk_log;
  int q_bytes;   // Q's rows in shared memory
  int in_bytes;  // the rank's inbox: the ranks' pushed partials, m and l
  int smem;      // dynamic shared memory a CTA
};

// Elements of K (or of V) a ring stage holds: the CTA's heads' boxes.
__host__ __device__ __forceinline__ int stage_elems(int heads, int D) {
  return heads * box_count(D) * kStageTokens * box_width(D);
}

// The merge's local fp32 scratch (over the drained ring): the warps'
// records [kConsumers][G][D] acc, [kConsumers][G] m and l; the ranks'
// weights [C][P] and the row's l [P] (P = heads G).
__host__ __device__ __forceinline__ int merge_floats(int heads, int G, int D,
                                                    int C) {
  const int P = heads * G;
  return kConsumers * G * (D + 2) + C * P + P;
}

struct Params {
  const __nv_bfloat16* q;    // (B, KV * G, D)
  const int* offsets;        // (B,)
  __nv_bfloat16* out;        // (B, KV * G, D)
  int T, KV, G, heads, split, stages, chunk, chunk_log, q_bytes, in_bytes;
  float scale, cap;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
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
      "DENSE_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra DENSE_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map into shared memory, completing on ``bar``
// with its bytes; what lies past the tensor's edges is zero-filled.
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// gemma2's tanh softcap of an fp32 score, as the reference spells it.
template <bool CAP>
__device__ __forceinline__ float capped(float s, float cap) {
  if constexpr (CAP)
    return __fmul_rn(tanhf(__fdiv_rn(s, cap)), cap);
  else
    return s;
}

// The producer warp's lane 0: the split's stages in order, each the CTA's
// heads' K and V boxes of 16 tokens (tokens past the row's length are
// loaded with the last stage and never enter the result). Stage i goes to
// ring slot i % stages once the stage before it in that slot is consumed
// (its empty barrier, one arrival a head), and completes on full barrier
// i % nb with the bytes of its boxes.
template <int D>
__device__ __forceinline__ void produce(
    const CUtensorMap* tk, const CUtensorMap* tv, const Params& p,
    __nv_bfloat16* ring, uint64_t* full, uint64_t* empty, int nb, int b,
    int h0, int t0, int rows_all) {
  constexpr int W = box_width(D), NBX = box_count(D);
  const int n = (rows_all + kStageTokens - 1) / kStageTokens;
  const int elems = stage_elems(p.heads, D);
  const uint32_t bytes = 4u * elems;               // K's and V's boxes
  PROBE_SUM(waited);
  for (int i = 0; i < n; ++i) {
    const int slot = i % p.stages;
    PROBE_CLOCK(w0);
    if (i >= p.stages) bar_wait(empty + slot, (i / p.stages - 1) & 1);
    PROBE_ADD(waited, clock64() - w0);
    uint64_t* bar = full + i % nb;
    if (REPRO_DENSE_SKIP == 2) {
      bar_arrive(bar);
      continue;
    }
    bar_expect(bar, bytes);
    __nv_bfloat16* kd = ring + (size_t)slot * 2 * elems;
    const int tok = t0 + i * kStageTokens;
    for (int hh = 0; hh < p.heads; ++hh)
      for (int x = 0; x < NBX; ++x) {
        const int off = (hh * NBX + x) * kStageTokens * W;
        tma_load_4d(kd + off, tk, bar, x * box_step(D), h0 + hh, tok, b);
        tma_load_4d(kd + elems + off, tv, bar, x * box_step(D), h0 + hh, tok,
                    b);
      }
  }
  PROBE(4);
  PROBE_AT(11, waited);
}

// Where element k16 + e (k16 a multiple of 16, e < 16) of token r of head
// hh lies in a stage's K (or V): its box's rows of box_width(D); with
// k16 known at compile time the box and offset are constants.
template <int D>
__device__ __forceinline__ int ring_at(int r, int hh, int k16, int e) {
  constexpr int W = box_width(D), NBX = box_count(D);
  const int x = NBX == 1 ? 0 : k16 / box_step(D);
  const int off = NBX == 1 ? k16 : k16 - x * box_step(D);
  return ((hh * NBX + x) * kStageTokens + r) * W + off + e;
}

// grid (cluster, KV / heads, B), cluster (cluster, 1, 1); D = 16 DT; NT
// n tiles of 8 query heads (G <= 8 NT).
template <int DT, int NT, bool CAP>
__global__ void __launch_bounds__(kThreads, 2)
    dense_cluster_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const Params p) {
  constexpr int D = 16 * DT;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, C = gridDim.x, b = blockIdx.z;
  const int heads = p.heads, G = p.G, P = heads * G;
  const int h0 = blockIdx.y * heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int W = box_width(D), NBX = box_count(D);
  const int elems = stage_elems(heads, D);
  const int wph = kConsumers / heads;                 // warps a head
  const int nb = (p.stages + wph - 1) / wph * wph;    // full barriers
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [kMaxBars]
  uint64_t* empty = full + kMaxBars;                     // [kMaxStages]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + kBarBytes);
  float* inbox = reinterpret_cast<float*>(smem + kBarBytes + p.q_bytes);
  float* in_m = inbox + C * p.chunk;                     // [C][P]
  float* in_l = in_m + C * P;                            // [C][P]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      smem + kBarBytes + p.q_bytes + p.in_bytes);
  const int len = max(0, min(p.offsets[b] + 1, p.T));
  const int t0 = rank * p.split;
  const int rows_all = max(0, min(len, t0 + p.split) - t0);
  if (threadIdx.x == 0) {
    PROBE(0);
    PROBE_TIME(0);
    PROBE_SM();
  }
  // the cluster's CTAs have all started before any pushes to another
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // consumer warp `warp` < kConsumers: head h = warp / wph of the CTA, the
  // split's stages i == j (mod wph); full barrier i % nb (nb a multiple
  // of wph) is waited on by that warp alone, phase after phase
  const int gq = lane >> 2, tq = lane & 3;     // fragment row / column
  const int h = warp / wph, j = warp - h * wph;
  float o[DT][NT][4];    // O^T: d rows 16 md + gq (+8), heads 8 nt + 2 tq (+1)
  float m[NT][2], l[NT][2];   // query heads 8 nt + 2 tq + c
#pragma unroll
  for (int md = 0; md < DT; ++md)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[md][nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m[nt][c] = kNegInf;
      l[nt][c] = 0.f;
    }

  if (warp == kConsumers) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tk))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tv))
                   : "memory");
      for (int s = 0; s < nb; ++s) bar_init(full + s, 1);
      for (int s = 0; s < p.stages; ++s)
        bar_init(empty + s, heads);   // one warp of each head a stage
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    // the barriers are set up: the consumers may wait on them
    asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
    if (threadIdx.x == 32 * kConsumers) PROBE(1);
    if (lane == 0)
      produce<D>(&tk, &tv, p, ring, full, empty, nb, b, h0, t0, rows_all);
    __syncwarp();
  } else {
    // Q's rows, a head's G rows of 16 (the rest zero), 16-byte chunks
    {
      const int chunks = D / 8;
      const __nv_bfloat16* qh = p.q + ((long long)b * p.KV + h0) * G * D;
      for (int c = threadIdx.x; c < heads * 16 * chunks;
           c += 32 * kConsumers) {
        const int row = c / chunks, jj = c - row * chunks;
        const int hh = row >> 4, g = row & 15;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (g < G)
          val = *reinterpret_cast<const uint4*>(qh + (hh * G + g) * D +
                                                8 * jj);
        *reinterpret_cast<uint4*>(q_s + row * (D + 8) + 8 * jj) = val;
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    // Q^T as the B operand (k = d, n = query head): head 8 nt + gq
    uint32_t qb[NT][DT][2];
    const __nv_bfloat16* qw = q_s + h * 16 * (D + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        const __nv_bfloat16* r = qw + (8 * nt + gq) * (D + 8) + 16 * kk +
                                 2 * tq;
        qb[nt][kk][0] = *reinterpret_cast<const uint32_t*>(r);
        qb[nt][kk][1] = *reinterpret_cast<const uint32_t*>(r + 8);
      }
    const int n = (rows_all + kStageTokens - 1) / kStageTokens;
    PROBE_SUM(waited);
    PROBE_SUM(busy);
    for (int i = j; i < n; i += wph) {
      const int slot = i % p.stages;
      PROBE_CLOCK(w0);
      bar_wait(full + i % nb, (i / nb) & 1);
      PROBE_CLOCK(w1);
      PROBE_ADD(waited, w1 - w0);
      if (threadIdx.x == 0 && i == j) PROBE_AT(2, w1);
      if (REPRO_DENSE_SKIP == 1) {
        __syncwarp();
        if (lane == 0) bar_arrive(empty + slot);
        continue;
      }
      const __nv_bfloat16* ks = ring + (size_t)slot * 2 * elems;
      __nv_bfloat16* vs = ring + (size_t)slot * 2 * elems + elems;
      const int live = min(kStageTokens, rows_all - i * kStageTokens);
      if (live < kStageTokens) {   // the split's last stage: zero V's tail
        for (int c = lane; c < (kStageTokens - live) * NBX * (W / 8);
             c += 32) {
          const int r = live + c / (NBX * (W / 8));
          const int x = c / (W / 8) % NBX, jj = c % (W / 8);
          *reinterpret_cast<uint4*>(
              vs + ((h * NBX + x) * kStageTokens + r) * W + 8 * jj) =
              make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      // S^T = K Q^T, the stage's 16 tokens the m rows; two accumulators
      // (even and odd k steps) halve the chain of dependent products
      float sa[NT][4], sb[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[nt][e] = sb[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        uint32_t ka[4];
        ldmatrix_x4(ka, ks + ring_at<D>((lane & 7) + 8 * ((lane >> 3) & 1),
                                        h, 16 * kk, 8 * (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16((kk & 1) ? sb[nt] : sa[nt], ka, qb[nt][kk][0],
                   qb[nt][kk][1]);
      }
      // the online softmax of query head 8 nt + 2 tq + c over the tokens
      // gq and gq + 8 this lane holds (a head's 16 tokens across the
      // lanes of one tq), then P^T's hi and lo parts gathered into the B
      // operand of O^T += V^T P^T: lane (gq, tq) takes head gq's tokens
      // 2 tq, 2 tq + 1 (and + 8) from lanes 8 tq + gq / 2 (+ 4)
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float pr[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x0 =
              capped<CAP>((sa[nt][c] + sb[nt][c]) * p.scale, p.cap);
          const float x1 =
              capped<CAP>((sa[nt][2 + c] + sb[nt][2 + c]) * p.scale, p.cap);
          const bool v0 = gq < live, v1 = gq + 8 < live;
          float mx = fmaxf(v0 ? x0 : kNegInf, v1 ? x1 : kNegInf);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          if (mx > m[nt][c]) {
            const float alpha = expf(m[nt][c] - mx);
            l[nt][c] *= alpha;
#pragma unroll
            for (int md = 0; md < DT; ++md) {
              o[md][nt][c] *= alpha;
              o[md][nt][2 + c] *= alpha;
            }
            m[nt][c] = mx;
          }
          pr[c] = v0 ? expf(x0 - m[nt][c]) : 0.f;
          pr[2 + c] = v1 ? expf(x1 - m[nt][c]) : 0.f;
          l[nt][c] += pr[c];
          l[nt][c] += pr[2 + c];
        }
        // this lane's P^T words: tokens gq (pr 0, 1) and gq + 8 (pr 2, 3),
        // heads 2 tq (low half) and 2 tq + 1 (high half)
        const uint32_t h01 = pack_bf16(pr[0], pr[1]);
        const uint32_t h23 = pack_bf16(pr[2], pr[3]);
        const __nv_bfloat162 v01 =
            *reinterpret_cast<const __nv_bfloat162*>(&h01);
        const __nv_bfloat162 v23 =
            *reinterpret_cast<const __nv_bfloat162*>(&h23);
        const uint32_t l01 = pack_bf16(pr[0] - __low2float(v01),
                                       pr[1] - __high2float(v01));
        const uint32_t l23 = pack_bf16(pr[2] - __low2float(v23),
                                       pr[3] - __high2float(v23));
        const int src = 8 * tq + (gq >> 1);
        const uint32_t sel = (gq & 1) ? 0x7632u : 0x5410u;
        const uint32_t ha = __shfl_sync(0xffffffffu, h01, src);
        const uint32_t hb = __shfl_sync(0xffffffffu, h01, src + 4);
        const uint32_t hc = __shfl_sync(0xffffffffu, h23, src);
        const uint32_t hd = __shfl_sync(0xffffffffu, h23, src + 4);
        const uint32_t la = __shfl_sync(0xffffffffu, l01, src);
        const uint32_t lb = __shfl_sync(0xffffffffu, l01, src + 4);
        const uint32_t lc = __shfl_sync(0xffffffffu, l23, src);
        const uint32_t ld = __shfl_sync(0xffffffffu, l23, src + 4);
        bh[nt][0] = __byte_perm(ha, hb, sel);
        bh[nt][1] = __byte_perm(hc, hd, sel);
        bl[nt][0] = __byte_perm(la, lb, sel);
        bl[nt][1] = __byte_perm(lc, ld, sel);
      }
      // O^T += V^T P^T, d the m rows (V^T by ldmatrix.trans), P in hi + lo
#pragma unroll
      for (int md = 0; md < DT; ++md) {
        uint32_t va[4];
        ldmatrix_x4_trans(va, vs + ring_at<D>((lane & 7) + 8 * (lane >> 4), h,
                                              16 * md, 8 * ((lane >> 3) & 1)));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(o[md][nt], va, bh[nt][0], bh[nt][1]);
          mma_bf16(o[md][nt], va, bl[nt][0], bl[nt][1]);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + slot);
      PROBE_ADD(busy, clock64() - w1);
    }
    if (threadIdx.x == 0) {
      PROBE(3);
      PROBE_AT(9, waited);
      PROBE_AT(10, busy);
    }
    // a head's l: the sums of its 8 lanes, in a fixed tree
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], 4);
        l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], 8);
        l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], 16);
      }
    // every consumer is done with the ring: its records overwrite it
    asm volatile("bar.sync 2, %0;\n" ::"n"(32 * kConsumers) : "memory");
    if (threadIdx.x == 0) PROBE(5);
  }

  float* wacc = reinterpret_cast<float*>(ring);        // [kConsumers][G][D]
  float* wm = wacc + kConsumers * G * D;               // [kConsumers][G]
  float* wl = wm + kConsumers * G;                     // [kConsumers][G]
  float* wts = wl + kConsumers * G;                    // [C][P]
  float* lfin = wts + C * P;                           // [P]
  if (warp < kConsumers) {
#pragma unroll
    for (int md = 0; md < DT; ++md)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = 8 * nt + 2 * tq + (e & 1);
          if (g < G)
            wacc[(warp * G + g) * D + 16 * md + gq + 8 * (e >> 1)] =
                o[md][nt][e];
        }
    if (gq == 0)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int g = 8 * nt + 2 * tq + c;
          if (g < G) {
            wm[warp * G + g] = m[nt][c];
            wl[warp * G + g] = l[nt][c];
          }
        }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // the CTA's record, a head's warps merged in warp order, pushed to the
  // cluster: m and l to every rank (query head t by warp t mod 5, rank s
  // by its lane s), each element to the rank finishing it (its thread
  // weighs the warps' partials itself)
  for (int t = warp; t < P; t += kConsumers + 1) {
    const int hh = t / G, g = t - hh * G;
    float mx = kNegInf;
    for (int jj = 0; jj < wph; ++jj)
      mx = fmaxf(mx, wm[(hh * wph + jj) * G + g]);
    float sum = 0.f;
    for (int jj = 0; jj < wph; ++jj) {
      const int w = (hh * wph + jj) * G + g;
      sum += wl[w] * expf(wm[w] - mx);
    }
    if (lane < C) {
      *cluster.map_shared_rank(in_m + rank * P + t, lane) = mx;
      *cluster.map_shared_rank(in_l + rank * P + t, lane) = sum;
    }
  }
  for (int e = threadIdx.x; e < P * D; e += kThreads) {
    const int t = e / D, d = e - t * D;
    const int hh = t / G, g = t - hh * G;
    const int w0 = hh * wph * G + g;           // warp jj's: w0 + jj G
    float mx = kNegInf;
    for (int jj = 0; jj < wph; ++jj) mx = fmaxf(mx, wm[w0 + jj * G]);
    float a = 0.f;
    for (int jj = 0; jj < wph; ++jj)
      a += wacc[(w0 + jj * G) * D + d] * expf(wm[w0 + jj * G] - mx);
    const int r = e >> p.chunk_log;
    *cluster.map_shared_rank(inbox + rank * p.chunk + (e - (r << p.chunk_log)),
                             r) = a;
  }
  if (threadIdx.x == 0) PROBE(6);
  cluster.sync();
  if (threadIdx.x == 0) PROBE(7);
  // the row's merge of this rank's elements, from its inbox, in rank order:
  // query head t by warp t mod 5, rank s's weight by its lane s, l summed
  // in rank order by lane 0
  for (int t = warp; t < P; t += kConsumers + 1) {
    const float ms = lane < C ? in_m[lane * P + t] : kNegInf;
    float mx = ms;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane < C) wts[lane * P + t] = expf(ms - mx);
    __syncwarp();
    if (lane == 0) {
      float sum = 0.f;
      for (int s = 0; s < C; ++s) sum += in_l[s * P + t] * wts[s * P + t];
      lfin[t] = sum;
    }
  }
  __syncthreads();
  const int e0 = rank << p.chunk_log, e1 = min(P * D, e0 + p.chunk);
  __nv_bfloat16* out = p.out + ((long long)b * p.KV + h0) * G * D;
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const int t = e / D;
    float a = 0.f;
    for (int s = 0; s < C; ++s)
      a += inbox[s * p.chunk + e - e0] * wts[s * P + t];
    out[e] = __float2bfloat16(a / fmaxf(lfin[t], 1e-30f));
  }
  if (threadIdx.x == 0) {
    PROBE(8);
    PROBE_TIME(1);
  }
}

// An instantiation's dynamic shared memory raised (never lowered) to the
// plan's, and clusters past 8 allowed once.
template <int DT, int NT, bool CAP>
int prepare(const Plan& pl) {
  auto kernel = dense_cluster_kernel<DT, NT, CAP>;
  static int allowed = 48 * 1024;
  static bool non_portable = false;
  if (pl.smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = pl.smem;
  }
  if (pl.cluster > 8 && !non_portable) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    non_portable = true;
  }
  return 0;
}

template <int DT, int NT, bool CAP>
int launch(const CUtensorMap* maps, const Params& prm, const Plan& pl, int B,
           cudaStream_t stream) {
  const int err = prepare<DT, NT, CAP>(pl);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, prm.KV / pl.heads, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = stream;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, dense_cluster_kernel<DT, NT, CAP>, maps[0], maps[1], prm);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: the head dims of the old tensor-core route, one n
// tile of query heads (G <= 8) or two (G <= 16, head dims up to 128); -1
// for any other.
template <bool CAP>
int launch_dim(int D, int G, const CUtensorMap* maps, const Params& prm,
               const Plan& pl, int B, cudaStream_t stream) {
#define DENSE_LAUNCH(HD)                                                  \
  if (D == HD && G <= 8)                                                  \
    return launch<HD / 16, 1, CAP>(maps, prm, pl, B, stream);             \
  if (D == HD && HD <= 128)                                               \
    return launch<HD / 16, (HD <= 128 ? 2 : 1), CAP>(maps, prm, pl, B,    \
                                                      stream);
  DENSE_LAUNCH(16) DENSE_LAUNCH(64) DENSE_LAUNCH(80) DENSE_LAUNCH(128)
  DENSE_LAUNCH(256)
#undef DENSE_LAUNCH
  return -1;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point
// query (the library needs no -lcuda).
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

// A bf16 tensor map over the (D, KV, T, B) view of a dense cache (heads D
// apart, tokens tok_stride and rows row_stride elements apart), boxes of
// box_width(D) elements x 1 head x kStageTokens tokens x 1 row, no
// swizzle; reads past D or T are zero-filled.
int encode_cache(CUtensorMap* map, const void* base, int B, int T, int KV,
                 int D, long long row_stride, long long tok_stride) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)tok_stride * 2,
                                 (cuuint64_t)row_stride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_width(D), 1,
                             (cuuint32_t)kStageTokens, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

// The host's plan (plan_dense_split) checked against what the kernel
// holds: G query heads a KV head (at most two n tiles, one above D 128),
// 1, 2 or 4 KV heads a CTA dividing KV, a cluster the kernel allows whose
// splits of whole stages cover T, a ring of 1 to kMaxStages stages, ranks
// that finish every output element; then the shared memory it lays out,
// within a block's.
int checked_plan(int T, int KV, int G, int D, int heads, int cluster,
                 int split, int stages, int chunk, Plan* pl) {
  const bool ok =
      T >= 1 && KV >= 1 && G >= 1 && G <= 16 && (D <= 128 || G <= 8) &&
      (heads == 1 || heads == 2 || heads == 4) && KV % heads == 0 &&
      cluster >= 1 && cluster <= kMaxCluster && split >= kStageTokens &&
      split % kStageTokens == 0 && (long long)cluster * split >= T &&
      stages >= 1 && stages <= kMaxStages && chunk >= 1 &&
      (chunk & (chunk - 1)) == 0 &&
      (long long)chunk * cluster >= (long long)heads * G * D;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  pl->heads = heads;
  pl->cluster = cluster;
  pl->split = split;
  pl->stages = stages;
  pl->chunk = chunk;
  pl->chunk_log = 0;
  while ((1 << pl->chunk_log) < chunk) ++pl->chunk_log;
  const int P = heads * G;
  pl->q_bytes = 2 * heads * 16 * (D + 8);
  pl->in_bytes = (4 * (cluster * chunk + 2 * cluster * P) + 127) / 128 * 128;
  const long long ring = 2LL * 2 * stage_elems(heads, D) * stages;
  const long long merge = 4LL * merge_floats(heads, G, D, cluster);
  const long long smem = kBarBytes + pl->q_bytes + pl->in_bytes +
                         (ring > merge ? ring : merge);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  pl->smem = static_cast<int>(smem);
  return 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The tensor maps of a dense cache's k and v (B, T, KV, D) bf16, rows
// row_stride and tokens tok_stride elements apart (heads D apart, elements
// contiguous, every address and stride 16-byte aligned), into maps_out
// (kMapBytes bytes of host memory, k's then v's): once a cache address,
// by the caller, who passes them to every launch.
int dense_cluster_maps(const void* k, const void* v, int B, int T, int KV,
                       int D, long long row_stride, long long tok_stride,
                       void* maps_out) {
  if (B < 1 || T < 1 || KV < 1 || D < 8 || D % 8 || row_stride < 0 ||
      tok_stride < (long long)KV * D)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[2];
  int err = encode_cache(&m[0], k, B, T, KV, D, row_stride, tok_stride);
  if (err == 0)
    err = encode_cache(&m[1], v, B, T, KV, D, row_stride, tok_stride);
  if (err == 0) memcpy(maps_out, m, kMapBytes);
  return err;
}

// q (B, KV*G, D) bf16 contiguous; maps from dense_cluster_maps for the
// cache's k and v (B, T, KV, D); offsets (B,) int32 on the device: row b
// attends over its first min(offsets[b] + 1, T) tokens. cap > 0: each fp32
// score s becomes tanh(s / cap) * cap before the row's max. Writes the
// normalized output (B, KV*G, D) in bf16. D one of 16, 64, 80, 128, 256;
// G <= 16 (8 above D 128). heads, cluster, split, stages, chunk: the
// host's plan (plan_dense_split), refused here unless checked_plan takes
// it. One launch.
int dense_cluster_launch(const void* maps, const void* q, const void* offsets,
                         void* o_out, int B, int T, int KV, int G, int D,
                         int heads, int cluster, int split, int stages,
                         int chunk, float scale, float cap, void* stream) {
  if (B == 0) return 0;
  Plan pl;
  const int bad = checked_plan(T, KV, G, D, heads, cluster, split, stages,
                               chunk, &pl);
  if (bad != 0 || maps == nullptr || !(cap >= 0.f))
    return bad != 0 ? bad : static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[2];
  memcpy(m, maps, kMapBytes);
  const Params prm{static_cast<const __nv_bfloat16*>(q),
                   static_cast<const int*>(offsets),
                   static_cast<__nv_bfloat16*>(o_out),
                   T, KV, G, pl.heads, pl.split, pl.stages, pl.chunk,
                   pl.chunk_log, pl.q_bytes, pl.in_bytes, scale, cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = cap > 0.f ? launch_dim<true>(D, G, m, prm, pl, B, s)
                            : launch_dim<false>(D, G, m, prm, pl, B, s);
  return err == -1 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

}  // extern "C"
