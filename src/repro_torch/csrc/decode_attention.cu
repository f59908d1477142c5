// Paged GQA decode attention over a layer-stacked KV page pool, split-KV.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/decode_attention/
// kernel.py: paged_decode_attention_kernel (with _decode_kernel).
//
// Bound: bytes. A decode step reads every live K and V row of each
// sequence once and does 4*G flops per element it reads (about G flops a
// byte in bf16), far below the card's flop:byte balance, so the floor is
// (live K/V bytes) / HBM bandwidth. What it takes is many blocks with
// bytes in flight.
//
// Design. The TPU kernel walks a row's pages in sequence, carrying m, l
// and acc from one grid step to the next. Here each row's live tokens are
// cut into splits of kSplitTokens tokens (a whole number of pages: the
// split depends on `page` alone, never on the batch, the table width or
// the lengths), and one block takes one (split, KV head, row): grid
// (max_splits, KV, B), max_splits from the table width, so the host never
// reads the lengths. A block whose split starts at or past the row's
// length exits at once. Inside a block, K and V tiles are copied in their
// stored dtype into a ring of kStages shared-memory stages with 16-byte
// cp.async copies, so the next tiles load while one is computed, and each
// warp keeps an fp32 online softmax (m, l, acc; NEG_INF = -2e38) over its
// own tokens, rescaling only when the max grows (a factor of exactly 1
// otherwise). Two split kernels, picked by dtype and head dim:
// - tc_split_kernel, bf16 at the head dims of the repo's paged families
//   and smoke models: the G heads of the KV head are the 16 rows of an
//   mma.sync m16n8k16 product (rows past G are zero), S = Q K^T and
//   O += P V on the tensor cores, P split into bf16 hi + lo parts so that
//   P V keeps ~16 bits of each probability. The flops are few (about G a
//   byte); what the tensor cores remove is the per-token instruction
//   stream of the CUDA-core kernel, which held its time at ~30 us a block
//   of 256 tokens even with no loads.
// - split_kernel, fp32 (the equivalence checks) and any other head dim:
//   every lane holds the G query heads for its 4-element slices of D in
//   registers, dots them with its slice of a K row, and a xor-shuffle tree
//   gives every lane the same scores, CS tokens at a time.
// At the end of the split the warps merge in warp order and the block
// writes the split's partial (acc, m, l) and a poison flag to an fp32
// workspace the wrapper allocates. Then the row's splits are merged, in
// the same launch (one launch a call): each block, once its record is
// written (or at once, when its split starts past the row's length or is
// poisoned), makes its writes visible (__threadfence) and draws a ticket
// from an int32 counter of its (row, KV head) with one atomicAdd. The
// block that draws the last ticket, max_splits - 1, merges the row's
// splits 0, 1, ..., n-1 in that order with its own threads (m = max m_s;
// l = sum l_s e^(m_s - m); acc likewise) from its shared memory, where
// it stages the records with 16-byte cp.async copies past L1 (.cg: L1 is
// not coherent across blocks), all in flight at once: the merge is bound
// by round trips to L2. It writes the residuals or the normalized output
// and sets its counter back to 0 for the next call. No block waits for another, so nothing can deadlock, and which
// block merges changes nothing: the merge's order and ops are fixed. The
// counters live in a buffer the wrapper keeps a stream (all zero between
// calls: every row's counter is reset by its last block).
//
// The new token's merge. The paged decode step attends over the pages
// and merges the new token's own (k, v), which no page holds yet,
// exactly (repro_torch/serving/paged_runtime.py; the reference's
// src/repro/serving/paged_runtime.py:411-421, which XLA fuses). Given
// k_new and v_new, the row's merge does that merge itself: the token is
// one more split, m = s = q . k_new * scale, l = 1, acc = v_new, merged
// after the others with the plain spelling's ops (each fp32 op an
// __f*_rn, so none is contracted into an FMA), and the normalized output
// is written in q's dtype. The dots are G <= 16 of length D <= 256 a
// block, summed in a fixed order (lane l takes d = l, l + 32, ..., then a
// xor tree): so the result equals the plain merge fed the kernel's
// residuals up to the order of that one sum.
//
// The dense launch (dense_decode_launch). Model.forward's one-token step
// (the reference's attend_decode at C == 1, src/repro/models/attention.py
// :272, which XLA fuses) attends over a layer's dense (B, T, KV, D) cache,
// not over pages. In bf16 at the tensor-core head dims that is a kernel
// of its own (dense_decode.cu); in fp32 (the equivalence checks) and at
// other head dims the CUDA-core split kernel reads it by its row and token
// strides (KvRows, no table), each row's live length from the step's
// device offsets, min(offset + 1, T) (the new token is written first, as
// the reference orders it; a ring's T slots, once full, hold exactly the
// positions of the window). Its splits are kSplitTokens tokens, so
// max_splits = ceil(T / kSplitTokens) depends on T alone and a row's bits
// not on B. The last split reads only up to the row's length, never past
// it. gemma2's tanh softcap applies to each fp32 score before the max
// (CAP: the kernels are instantiated with and without it, so the paged
// step's code is unchanged).
//
// Contracts. Only live slots (ip * page < len) are read, so dead table
// slots may hold anything. A live id outside the pool marks its split
// poisoned by an explicit flag (fmaxf would drop a NaN m), and the merge
// then writes NaN to all of the row's outputs. A zero-length row has no
// split: the merge over zero splits yields exactly m = -2e38, l = 0,
// acc = 0. A row's result depends on its own pages and length alone (its
// splits, each warp's tokens and every reduction order are fixed by them),
// so a batched call, one-row calls and wider tables agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kSplitTokens = 128;  // tokens a split, rounded to whole pages
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;         // K/V tiles in flight a block
constexpr int kStageBytes = 32768; // bytes of K (and of V) a stage
constexpr int kMaxTile = 64;       // tokens a stage, at most

__host__ __device__ __forceinline__ int split_pages(int page) {
  return page >= kSplitTokens ? 1 : kSplitTokens / page;
}

// Tokens a stage: a power of two, at most kMaxTile, K rows within
// kStageBytes (D <= 256, so at least 32 for fp32 and 64 for bf16).
__host__ __device__ __forceinline__ int tile_tokens(int D, int esz) {
  int t = kMaxTile;
  while (t > kWarps && t * D * esz > kStageBytes) t >>= 1;
  return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive elements of a row as floats.
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Where a call's K/V rows lie and how long each row is. Paged: token t of
// row b is slot t % page of page tables[b][t / page] of the layer's pool
// (layer_offset elements in), and a row's live length is lens[b], at most
// the table's n_tab * page tokens. Dense (tables null): a (B, T, KV, D)
// cache read by its strides, token t of row b at b * row_stride + t *
// tok_stride, and lens holds each row's offset: the new token, already
// written, makes its live length lens[b] + 1, at most T.
struct KvRows {
  const int* tables;
  long long layer_offset;
  long long row_stride;
  long long tok_stride;
  int cap;         // n_tab * page, or T
  int len_bias;    // 0 paged, 1 dense
};

__device__ __forceinline__ int live_len(const int* lens, int b,
                                        const KvRows& rows) {
  return max(0, min(lens[b] + rows.len_bias, rows.cap));
}

// gemma2's tanh softcap of an fp32 score, as the reference spells it
// (tanh(s / cap) * cap); without CAP the score as it is.
template <bool CAP>
__device__ __forceinline__ float capped(float s, float cap) {
  if constexpr (CAP)
    return __fmul_rn(tanhf(__fdiv_rn(s, cap)), cap);
  else
    return s;
}

// One workspace record a (row, KV head, split): acc [G][D], m [G], l [G],
// poison flag, padded to 16 bytes (the row's merge stages the records
// with 16-byte copies).
__host__ __device__ __forceinline__ int record_floats(int G, int D) {
  return (G * D + 2 * G + 1 + 3) & ~3;
}
__host__ __device__ __forceinline__ int flag_index(int G, int D) {
  return G * D + 2 * G;
}

// The split this block takes: tokens [t0, t1) of its row. False when the
// split starts at or past the row's length (nothing to do), or when a
// live page id of the split lies outside the pool (its record's poison
// flag is set). Uniform across the block.
__device__ __forceinline__ bool begin_split(
    const KvRows& rows, const int* __restrict__ lens,
    float* __restrict__ ws, int KV, int G, int D, int P, int page, int n_tab,
    int spp, int max_splits, int& t0, int& t1, const int*& row_table,
    long long& row_offset, float*& rec) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = live_len(lens, b, rows);
  t0 = split * spp * page;
  if (t0 >= len) return false;
  t1 = min(len, t0 + spp * page);
  const int R = record_floats(G, D);
  rec = ws + (((long long)b * KV + kvh) * max_splits + split) * R;
  if (rows.tables == nullptr) {        // dense: no page id to check
    row_table = nullptr;
    row_offset = (long long)b * rows.row_stride;
    return true;
  }
  row_table = rows.tables + (long long)b * n_tab;
  row_offset = rows.layer_offset;
  int out_of_pool = 0;
  for (int ip = t0 / page + threadIdx.x; ip < (t1 + page - 1) / page;
       ip += blockDim.x) {
    const int pid = row_table[ip];
    out_of_pool |= (pid < 0 || pid >= P);
  }
  if (__syncthreads_or(out_of_pool)) {
    if (threadIdx.x == 0) rec[flag_index(G, D)] = 1.f;
    return false;
  }
  return true;
}

// One K/V tile of `rows` live tokens from token `first` of the row into a
// ring stage (rows `rs` elements apart): a warp issues whole rows, one
// page-table read a row (none for a dense cache: row_table null, the
// token's row at row_offset + tok * tok_stride), lanes on its 16-byte
// chunks. With zero_tail, the stage's rows past `rows` are zeroed (a
// tensor-core product multiplies them by a probability of 0, which must
// not meet a NaN).
template <typename T>
__device__ __forceinline__ void issue_tile(
    T* ks, T* vs, int rs, int first, int rows, int tile, bool zero_tail,
    const int* __restrict__ row_table, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, long long row_offset, long long tok_stride,
    int KV, int kvh, int D, int page) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = D / V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    const int tok = first + r;
    const long long base =
        row_offset +
        (row_table != nullptr
             ? ((long long)row_table[tok / page] * page + tok % page) *
                   ((long long)KV * D)
             : (long long)tok * tok_stride) +
        (long long)kvh * D;
    for (int j = lane; j < chunks; j += 32) {
      cp_async16(ks + r * rs + j * V, k_pool + base + j * V);
      cp_async16(vs + r * rs + j * V, v_pool + base + j * V);
    }
  }
  if (zero_tail) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = threadIdx.x; c < (tile - rows) * chunks; c += blockDim.x) {
      const int r = rows + c / chunks, j = c % chunks;
      *reinterpret_cast<uint4*>(ks + r * rs + j * V) = zero;
      *reinterpret_cast<uint4*>(vs + r * rs + j * V) = zero;
    }
  }
}

// The block's warps hold partial (acc, m, l) over their tokens in shared
// memory, acc_w [warps][hs][D], m_w and l_w [warps][hs] (head g of warp w
// at w * hs + g): merge them in warp order into the split's record.
__device__ __forceinline__ void finish_split(
    float* __restrict__ rec, const float* acc_w, const float* m_w,
    const float* l_w, int warps, int hs, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
    for (int w = 0; w < warps; ++w) mx = fmaxf(mx, m_w[w * hs + g]);
    float a = 0.f;
    for (int w = 0; w < warps; ++w)
      a += acc_w[(w * hs + g) * D + d] * expf(m_w[w * hs + g] - mx);
    rec[i] = a;
  }
  const int g = threadIdx.x;
  if (g < G) {
    float mx = kNegInf;
    for (int w = 0; w < warps; ++w) mx = fmaxf(mx, m_w[w * hs + g]);
    float sum = 0.f;
    for (int w = 0; w < warps; ++w)
      sum += l_w[w * hs + g] * expf(m_w[w * hs + g] - mx);
    rec[G * D + g] = mx;
    rec[G * D + G + g] = sum;
  }
  if (threadIdx.x == 0) rec[flag_index(G, D)] = 0.f;
}

// The split's partial on the CUDA cores. GMAX >= G heads, NU 4-element
// slices of D a lane (D <= 128 * NU); CAP: the scores softcapped.
template <typename T, int GMAX, int NU, bool CAP>
__device__ __forceinline__ void split_partial(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const KvRows& rows,
    const int* __restrict__ lens, float* __restrict__ ws, int KV, int G,
    int D, int P, int page, int n_tab, int spp, int max_splits, int tile,
    float scale, float cap) {
  // tokens a warp scores together: their scores live in registers
  constexpr int CS = GMAX >= 16 ? 2 : (GMAX >= 8 ? 4 : 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int t0, t1;
  const int* row_table;
  long long row_offset;
  float* rec;
  if (!begin_split(rows, lens, ws, KV, G, D, P, page, n_tab, spp,
                   max_splits, t0, t1, row_table, row_offset, rec))
    return;

  // the G query heads of this KV head, this lane's slices of D
  float qr[GMAX][NU][4];
  const T* qh = q + ((long long)b * KV * G + (long long)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = (u * 32 + lane) * 4 + c;
        qr[g][u][c] = (g < G && e < D) ? to_float(qh[g * D + e]) : 0.f;
      }
  float m[GMAX], l[GMAX], acc[GMAX][NU][4];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][u][c] = 0.f;
  }

  T* ring = reinterpret_cast<T*>(smem_raw);   // [kStages][K, V][tile][D]
  const int n_tiles = (t1 - t0 + tile - 1) / tile;
  auto issue = [&](int it) {
    if (it < n_tiles) {
      T* ks = ring + (size_t)(it % kStages) * 2 * tile * D;
      issue_tile(ks, ks + (size_t)tile * D, D, t0 + it * tile,
                 min(tile, t1 - t0 - it * tile), tile, false, row_table,
                 k_pool, v_pool, row_offset, rows.tok_stride, KV, kvh, D,
                 page);
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  const int per_warp = tile / kWarps;
  for (int it = 0; it < n_tiles; ++it) {
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* ks = ring + (size_t)(it % kStages) * 2 * tile * D;
    const T* vs = ks + (size_t)tile * D;
    const int first = t0 + it * tile;
    // the warp's tokens of the tile, CS at a time: CS independent dots
    // and shuffle trees in flight, then one max, rescale and P.V update
    for (int i0 = 0; i0 < per_warp; i0 += CS) {
      const int r0 = warp * per_warp + i0;
      if (first + r0 >= t1) break;
      float s[CS][GMAX], vf[CS][NU][4];
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const bool live = i0 + j < per_warp && first + r0 + j < t1;
        float kf[NU][4];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int e = (u * 32 + lane) * 4;
          if (live && e < D) {
            load4(ks + (r0 + j) * D + e, kf[u]);
            load4(vs + (r0 + j) * D + e, vf[j][u]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) kf[u][c] = vf[j][u][c] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float d = 0.f;
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c) d = fmaf(qr[g][u][c], kf[u][c], d);
          s[j][g] = d;
        }
      }
      // xor tree: every lane ends with the same sums (a + b == b + a)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < CS; ++j)
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], off);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) continue;    // unrolled: g stays a constant
        float mx = m[g];
#pragma unroll
        for (int j = 0; j < CS; ++j)
          if (i0 + j < per_warp && first + r0 + j < t1)
            mx = fmaxf(mx, capped<CAP>(s[j][g] * scale, cap));
        if (mx > m[g]) {         // warp-uniform: rescale when the max grows
          const float alpha = expf(m[g] - mx);
          l[g] *= alpha;
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[g][u][c] *= alpha;
          m[g] = mx;
        }
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          const float p = (i0 + j < per_warp && first + r0 + j < t1)
                              ? expf(capped<CAP>(s[j][g] * scale, cap) - m[g])
                              : 0.f;
          l[g] += p;
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[g][u][c] = fmaf(p, vf[j][u][c], acc[g][u][c]);
        }
      }
    }
    __syncthreads();   // the stage is refilled by the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps in warp order, through the (drained) ring
  float* acc_w = reinterpret_cast<float*>(smem_raw);  // [kWarps][G][D]
  float* m_w = acc_w + kWarps * G * D;                 // [kWarps][G]
  float* l_w = m_w + kWarps * G;                       // [kWarps][G]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = (u * 32 + lane) * 4 + c;
        if (e < D) acc_w[(warp * G + g) * D + e] = acc[g][u][c];
      }
    if (lane == 0) {
      m_w[warp * G + g] = m[g];
      l_w[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  finish_split(rec, acc_w, m_w, l_w, kWarps, G, G, D);
}

constexpr int kTcThreads = 128;    // 4 warps, 16 tokens of a tile each
constexpr int kTcTile = 64;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 pools, D = 16 * DT: the same split on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators). A warp takes 16 tokens of each
// 64-token tile: S = Q K^T with the G heads as the 16 rows of A (rows
// past G are zero), K^T's fragments read straight from the padded rows
// (one 32-bit load each), masked and scaled, then the online softmax on
// the accumulator fragments (a quad of lanes holds a head's row), and
// O += P V with P taken from S's registers and V through ldmatrix.trans.
// P enters the product as bf16 hi + lo parts, two products, so P V keeps
// ~16 bits of each probability (not bf16's 8): the residuals stay those
// of an fp32 softmax.
template <int DT, bool CAP>
__device__ __forceinline__ void tc_split_partial(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const KvRows& rows,
    const int* __restrict__ lens, float* __restrict__ ws, int KV, int G,
    int P, int page, int n_tab, int spp, int max_splits, float scale,
    float cap) {
  constexpr int D = 16 * DT;
  constexpr int RS = D + 8;      // padded rows: conflict-free 16-byte rows
  constexpr int TW = kTcThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;      // fragment row / column
  int t0, t1;
  const int* row_table;
  long long row_offset;
  float* rec;
  if (!begin_split(rows, lens, ws, KV, G, D, P, page, n_tab, spp,
                   max_splits, t0, t1, row_table, row_offset, rec))
    return;

  // A fragments of Q (16 heads x D), zero past G
  uint32_t qa[DT][4];
  const __nv_bfloat16* qh =
      q + ((long long)b * KV * G + (long long)kvh * G) * D;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = gq + 8 * (r & 1), col = 16 * kk + 2 * tq + 8 * (r >> 1);
      qa[kk][r] = row < G ? *reinterpret_cast<const uint32_t*>(
                                qh + row * D + col)
                          : 0u;
    }
  float o[2 * DT][4];
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // heads gq, gq + 8

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int n_tiles = (t1 - t0 + kTcTile - 1) / kTcTile;
  auto issue = [&](int it) {
    if (it < n_tiles) {
      __nv_bfloat16* ks = ring + (size_t)(it % kStages) * 2 * kTcTile * RS;
      issue_tile(ks, ks + kTcTile * RS, RS, t0 + it * kTcTile,
                 min(kTcTile, t1 - t0 - it * kTcTile), kTcTile, true,
                 row_table, k_pool, v_pool, row_offset, rows.tok_stride, KV,
                 kvh, D, page);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < n_tiles; ++it) {
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const __nv_bfloat16* ks =
        ring + (size_t)(it % kStages) * 2 * kTcTile * RS;
    const __nv_bfloat16* vs = ks + kTcTile * RS;
    const int r0 = warp * 16;
    const int live = t1 - (t0 + it * kTcTile) - r0;   // of the warp's 16
    if (live > 0) {
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
        const __nv_bfloat16* kr = ks + (r0 + nt * 8 + gq) * RS + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < DT; ++kk)
          mma_bf16(sc[nt], qa[kk],
                   *reinterpret_cast<const uint32_t*>(kr + 16 * kk),
                   *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8));
      }
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {          // head gq + 8h
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = nt * 8 + 2 * tq + e < live;
            const float x = capped<CAP>(sc[nt][2 * h + e] * scale, cap);
            sc[nt][2 * h + e] = x;
            if (ok) mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (mx > m[h]) {
          const float alpha = expf(m[h] - mx);
          l[h] *= alpha;
#pragma unroll
          for (int n = 0; n < 2 * DT; ++n) {
            o[n][2 * h] *= alpha;
            o[n][2 * h + 1] *= alpha;
          }
          m[h] = mx;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = nt * 8 + 2 * tq + e < live
                       ? expf(sc[nt][2 * h + e] - m[h]) : 0.f;
            l[h] += p[e];
          }
          // A fragment register: row gq + 8h, tokens 8nt + 2tq, +1
          const uint32_t hi = pack_bf16(p[0], p[1]);
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(&hi);
          ph[h + 2 * nt] = hi;
          pl[h + 2 * nt] = pack_bf16(p[0] - __low2float(hv),
                                     p[1] - __high2float(hv));
        }
      }
#pragma unroll
      for (int nd = 0; nd < DT; ++nd) {      // d columns 16nd .. 16nd + 15
        uint32_t vb[4];
        // matrices: tokens +0..7 / +8..15 x d +0..7, then d +8..15
        const int row = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4_trans(vb, vs + row * RS + 16 * nd + 8 * (lane >> 4));
        mma_bf16(o[2 * nd], ph, vb[0], vb[1]);
        mma_bf16(o[2 * nd], pl, vb[0], vb[1]);
        mma_bf16(o[2 * nd + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * nd + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // a head's l: the quad's partial sums, in a fixed tree
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* acc_w = reinterpret_cast<float*>(smem_raw);   // [TW][16][D]
  float* m_w = acc_w + TW * 16 * D;                      // [TW][16]
  float* l_w = m_w + TW * 16;                            // [TW][16]
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc_w[(warp * 16 + gq + 8 * (e >> 1)) * D + 8 * n + 2 * tq + (e & 1)] =
          o[n][e];
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_w[warp * 16 + gq + 8 * h] = m[h];
      l_w[warp * 16 + gq + 8 * h] = l[h];
    }
  }
  __syncthreads();
  finish_split(rec, acc_w, m_w, l_w, TW, 16, G, D);
}

constexpr int kCombineChunk = 64;   // splits whose weights a block stages
constexpr int kMaxGD = 2048;        // G * D, at most (G <= 16, 8 above D 128)
// the merge's shared scratch (the split's ring, drained): m, l and the
// token's score a head, the weights e^(m_s - m) of a chunk of splits, the
// row's sums (kMaxGD fp32), q's G rows and the new token's k and v (4
// bytes an element at most), the bulk copy's mbarrier (16 bytes); the
// staged records follow it
constexpr int kMergeSmemBytes =
    4 * (3 * 16 + kCombineChunk * 16 + kMaxGD + kMaxGD + 2 * 256) + 16;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Where a row's merge writes, and the new token to merge (k_new null:
// none). With k_new set, o_out is the normalized output with the token
// merged; else o_out, or acc_out, m_out and l_out (the residuals).
template <typename T>
struct RowMerge {
  int* counters;          // [B * KV] tickets, zero between calls
  float* acc_out;
  T* o_out;
  float* m_out;
  float* l_out;
  const T* k_new;
  const T* v_new;
  float scale;
};

// The block's ticket, drawn once its record (if any) is written: the
// block's threads meet at a barrier, then one thread adds one to its
// (row, KV head)'s counter with an acquire-release atomic at GPU scope
// (cumulative: the block's writes before the barrier are released with
// it, and the block that draws the last ticket acquires every other
// block's). True, uniformly across the block, in the block that draws
// the last ticket, max_splits - 1: every split of the row has then
// written its record (or has none).
__device__ __forceinline__ bool last_ticket(int* __restrict__ counters,
                                            int max_splits) {
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    int t;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(counters + blockIdx.z * gridDim.y + blockIdx.y)
                 : "memory");
    last = t == max_splits - 1;
  }
  return __syncthreads_or(last) != 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory in one bulk copy, completing on
// ``bar``. The async proxy reads what other blocks wrote through the
// generic proxy once this thread has acquired it and fenced the proxies.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "MERGE_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra MERGE_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The row's merge, run by the block that drew its last ticket: output
// element i < G*D (and head g's m and l) is the merge of the row's splits
// 0 .. n-1 in that order. It runs once a launch, so it is bound by round
// trips to L2 and by fetching its own instructions, not by bytes: one
// thread stages the row's records (written by other blocks) into the
// block's shared memory with one bulk copy (TMA, through L2), q's G rows
// and the new token's k and v come with 4-byte cp.async copies, and the
// block then merges from shared memory in short loops (the tail's code
// runs once a launch: unrolled, it costs more to fetch than it saves). A
// row whose records do not fit the
// block's shared memory at once is staged in chunks, its m first read
// from device memory. With mg.k_new set the new token is merged after the
// splits (see the top of the file). Sets the row's counter back to 0.
template <typename T>
__device__ __forceinline__ void merge_row(
    const float* __restrict__ ws, const int* __restrict__ lens,
    const T* __restrict__ q, const RowMerge<T>& mg, const KvRows& rows,
    int KV, int G, int D, int page, int spp, int max_splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_row = reinterpret_cast<float*>(smem_raw);   // [16]
  float* l_row = m_row + 16;                            // [16]
  float* s_row = l_row + 16;                            // [16]
  float(*w_s)[16] = reinterpret_cast<float(*)[16]>(s_row + 16);
  float* acc_s = s_row + 16 + kCombineChunk * 16;       // [G * D]
  T* q_s = reinterpret_cast<T*>(acc_s + kMaxGD);        // [G][D]
  T* k_s = reinterpret_cast<T*>(acc_s + 2 * kMaxGD);    // [D]
  T* v_s = k_s + 256;                                   // [D]
  uint64_t* bar = reinterpret_cast<uint64_t*>(acc_s + 2 * kMaxGD + 512);
  float* stage = reinterpret_cast<float*>(smem_raw + kMergeSmemBytes);
  const int kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int threads = blockDim.x, warps = threads >> 5;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = live_len(lens, b, rows);
  const int split_tokens = spp * page;
  const int n = (len + split_tokens - 1) / split_tokens;
  const int R = record_floats(G, D), GD = G * D;
  const float* rec = ws + ((long long)b * KV + kvh) * max_splits * R;
  unsigned dyn_smem;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_smem));
  // splits staged at once (the plan leaves room for one at least)
  const int chunk = min(kCombineChunk,
                        (int)((dyn_smem - kMergeSmemBytes) / (4 * R)));
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(bar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) bulk_load(stage, rec, 4u * min(chunk, n) * R, bar);
  }
  if (mg.k_new != nullptr) {           // q's rows, k_new, v_new: 4 bytes a copy
    constexpr int E = 4 / sizeof(T);
    const long long hk = ((long long)b * KV + kvh) * D;
    for (int k = tid; k < GD / E; k += threads)
      cp_async4(q_s + E * k, q + hk * G + E * k);
    for (int k = tid; k < D / E; k += threads) {
      cp_async4(k_s + E * k, mg.k_new + hk + E * k);
      cp_async4(v_s + E * k, mg.v_new + hk + E * k);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  const bool whole = n <= chunk;
  __syncthreads();                     // the barrier's init, q, k and v
  if (whole && n > 0) bar_wait(bar, 0);
  if (mg.k_new != nullptr) {           // the new token's scores
    for (int g = warp; g < G; g += warps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot = __fadd_rn(dot, __fmul_rn(to_float(q_s[g * D + d]),
                                       to_float(k_s[d])));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, off));
      if (lane == 0) s_row[g] = __fmul_rn(dot, mg.scale);
    }
  }

  // m = max over the splits (in any order: fmaxf drops a NaN, the flag
  // marks poison): from the staged records when the row fits, else from
  // device memory
  int poisoned = 0;
  for (int g = warp; g < G; g += warps) {
    float mx = kNegInf;
    for (int s = lane; s < n; s += 32) {
      const float* r = whole ? stage + s * R : rec + (long long)s * R;
      mx = fmaxf(mx, whole ? r[GD + g] : __ldcg(r + GD + g));
      poisoned |= (whole ? r[flag_index(G, D)]
                         : __ldcg(r + flag_index(G, D))) != 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) {
      m_row[g] = mx;
      l_row[g] = 0.f;
    }
  }
  const bool bad = __syncthreads_or(poisoned);

  // each of the thread's elements (and a head's l) summed over the splits
  // in split order, a chunk of staged records at a time
  float lsum = 0.f;
  for (int i = tid; i < GD; i += threads) acc_s[i] = 0.f;
  for (int s0 = 0, phase = 0; s0 < n; s0 += chunk) {
    const int cnt = min(chunk, n - s0);
    if (!whole) {
      if (s0 > 0) {
        __syncthreads();               // every thread is done with the stage
        if (tid == 0)
          bulk_load(stage, rec + (long long)s0 * R, 4u * cnt * R, bar);
      }
      bar_wait(bar, phase);
      phase ^= 1;
    }
    for (int k = tid; k < cnt * G; k += threads) {
      const int s = k / G, h = k - s * G;
      w_s[s][h] = expf(stage[s * R + GD + h] - m_row[h]);
    }
    __syncthreads();
    for (int i = tid; i < GD; i += threads) {
      const int g = i / D;
      float a = acc_s[i];
#pragma unroll 4
      for (int s = 0; s < cnt; ++s) a += stage[s * R + i] * w_s[s][g];
      acc_s[i] = a;
    }
    if (tid < G)
      for (int s = 0; s < cnt; ++s)
        lsum += stage[s * R + GD + G + tid] * w_s[s][tid];
  }

  __syncthreads();                     // the weights are read no more
  // a head's merge of the new token: m2 = maximum(m, s); alpha = exp(m -
  // m2); p = exp(s - m2); l2 = l * alpha + p (the same for each element of
  // the head); then acc2 = acc * alpha + p * v and o = acc2 / clamp_min(
  // l2, 1e-30), NaN kept as torch keeps it
  const float nan = __int_as_float(0x7fc00000);
  if (tid < G) {
    l_row[tid] = lsum;
    if (mg.k_new != nullptr) {
      const float m = m_row[tid], sc = s_row[tid];
      const float m2 = (m != m || sc != sc) ? nan : fmaxf(m, sc);
      const float alpha = expf(__fsub_rn(m, m2));
      const float p = expf(__fsub_rn(sc, m2));
      const float l2 = __fadd_rn(__fmul_rn(lsum, alpha), p);
      w_s[0][tid] = alpha;
      w_s[1][tid] = p;
      w_s[2][tid] = l2 != l2 ? l2 : fmaxf(l2, 1e-30f);
    }
  }
  __syncthreads();
  const long long row = ((long long)b * KV + kvh) * G;
  for (int i = tid; i < GD; i += threads) {
    const int g = i / D;
    const float acc = acc_s[i];
    if (mg.k_new != nullptr) {
      const float acc2 = __fadd_rn(__fmul_rn(acc, w_s[0][g]),
                                   __fmul_rn(w_s[1][g], to_float(v_s[i % D])));
      store(mg.o_out + row * D + i, bad ? nan : __fdiv_rn(acc2, w_s[2][g]));
    } else if (mg.o_out != nullptr) {
      store(mg.o_out + row * D + i,
            bad ? nan : acc / fmaxf(l_row[g], 1e-30f));
    } else {
      mg.acc_out[row * D + i] = bad ? nan : acc;
    }
  }
  if (tid < G && mg.m_out != nullptr) {
    mg.m_out[row + tid] = bad ? nan : m_row[tid];
    mg.l_out[row + tid] = bad ? nan : l_row[tid];
  }
  if (tid == 0) mg.counters[b * KV + kvh] = 0;
}

// grid (max_splits, KV, B): a block's split on the CUDA cores, then its
// ticket; the last block of a (row, KV head) merges the row.
template <typename T, int GMAX, int NU, bool CAP>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, KvRows rows,
    const int* __restrict__ lens, float* __restrict__ ws, int KV, int G,
    int D, int P, int page, int n_tab, int spp, int max_splits, int tile,
    float scale, float cap, RowMerge<T> mg) {
  split_partial<T, GMAX, NU, CAP>(q, k_pool, v_pool, rows, lens, ws, KV, G,
                                  D, P, page, n_tab, spp, max_splits, tile,
                                  scale, cap);
  if (last_ticket(mg.counters, max_splits))
    merge_row<T>(ws, lens, q, mg, rows, KV, G, D, page, spp, max_splits);
}

// The same on the tensor cores (bf16, D = 16 * DT).
template <int DT, bool CAP>
__global__ void __launch_bounds__(kTcThreads) tc_split_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, KvRows rows,
    const int* __restrict__ lens, float* __restrict__ ws, int KV, int G,
    int P, int page, int n_tab, int spp, int max_splits, float scale,
    float cap, RowMerge<__nv_bfloat16> mg) {
  tc_split_partial<DT, CAP>(q, k_pool, v_pool, rows, lens, ws, KV, G, P,
                            page, n_tab, spp, max_splits, scale, cap);
  if (last_ticket(mg.counters, max_splits))
    merge_row<__nv_bfloat16>(ws, lens, q, mg, rows, KV, G, 16 * DT, page,
                             spp, max_splits);
}

// One instantiation's dynamic shared memory, raised past 48 KB once.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return static_cast<int>(err);
}

// One call's arguments, as every split kernel takes them.
template <typename T>
struct Call {
  const T* q;
  const T* k;
  const T* v;
  KvRows rows;
  const int* lens;
  float* ws;
  int KV, G, D, P, page, n_tab, spp, max_splits;
  float scale, cap;   // cap > 0: the scores softcapped
  RowMerge<T> mg;
};

template <typename T, int GMAX, int NU, bool CAP>
int launch_split(dim3 grid, size_t smem, int tile, cudaStream_t stream,
                 const Call<T>& c) {
  static size_t allowed = 48 * 1024;
  const int err = allow_smem(split_kernel<T, GMAX, NU, CAP>, smem, allowed);
  if (err != 0) return err;
  split_kernel<T, GMAX, NU, CAP><<<grid, kThreads, smem, stream>>>(
      c.q, c.k, c.v, c.rows, c.lens, c.ws, c.KV, c.G, c.D, c.P, c.page,
      c.n_tab, c.spp, c.max_splits, tile, c.scale, c.cap, c.mg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NU, bool CAP>
int dispatch_heads(dim3 grid, size_t smem, int tile, cudaStream_t stream,
                   const Call<T>& c) {
#define REPRO_SPLIT(GM) \
  return launch_split<T, GM, NU, CAP>(grid, smem, tile, stream, c)
  if (c.G <= 1) REPRO_SPLIT(1);
  if (c.G <= 2) REPRO_SPLIT(2);
  if (c.G <= 4) REPRO_SPLIT(4);
  if (c.G <= 8) REPRO_SPLIT(8);
  if (NU == 1 && c.G <= 16) REPRO_SPLIT(16);
#undef REPRO_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DT, bool CAP>
int launch_tc(dim3 grid, cudaStream_t stream,
              const Call<__nv_bfloat16>& c) {
  constexpr int D = 16 * DT;
  const size_t ring = (size_t)kStages * 2 * kTcTile * (D + 8) * 2;
  const size_t merge = sizeof(float) * (kTcThreads / 32) * 16 * (D + 2);
  size_t smem = ring > merge ? ring : merge;
  const size_t least = kMergeSmemBytes + 4 * record_floats(c.G, D);
  if (smem < least) smem = least;   // the row's merge stages a record
  static size_t allowed = 48 * 1024;
  const int err = allow_smem(tc_split_kernel<DT, CAP>, smem, allowed);
  if (err != 0) return err;
  tc_split_kernel<DT, CAP><<<grid, kTcThreads, smem, stream>>>(
      c.q, c.k, c.v, c.rows, c.lens, c.ws, c.KV, c.G, c.P, c.page, c.n_tab,
      c.spp, c.max_splits, c.scale, c.cap, c.mg);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core split for bf16 at the head dims of the repo's paged
// families, gemma2's and zamba2's and the smoke models'; -1 where it has
// no instantiation.
int dispatch_tc(dim3 grid, cudaStream_t stream,
                const Call<__nv_bfloat16>& c) {
#define REPRO_TC(HD) \
  if (c.D == HD) return launch_tc<HD / 16, false>(grid, stream, c);
  REPRO_TC(16) REPRO_TC(64) REPRO_TC(80) REPRO_TC(128) REPRO_TC(256)
#undef REPRO_TC
  return -1;
}

template <typename T, bool CAP>
int launch_call(dim3 grid, cudaStream_t stream, const Call<T>& c) {
  int err = -1;
  // the softcap is the dense launch's alone, which sends no bf16 head dim
  // of the tensor-core split here (dense_decode.cu takes those)
  if constexpr (sizeof(T) == 2 && !CAP) err = dispatch_tc(grid, stream, c);
  if (err != -1) return err;
  // fp32, or a head dim without a tensor-core kernel
  const int tile = tile_tokens(c.D, sizeof(T));
  const size_t ring = (size_t)kStages * 2 * tile * c.D * sizeof(T);
  const size_t merge = sizeof(float) * (size_t)kWarps * c.G * (c.D + 2);
  size_t smem = ring > merge ? ring : merge;
  const size_t least = kMergeSmemBytes + 4 * record_floats(c.G, c.D);
  if (smem < least) smem = least;
  return c.D <= 128
             ? dispatch_heads<T, 1, CAP>(grid, smem, tile, stream, c)
             : dispatch_heads<T, 2, CAP>(grid, smem, tile, stream, c);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const KvRows& rows, const void* lens, void* ws, void* counters,
           void* acc_out, void* o_out, void* m_out, void* l_out,
           const void* k_new, const void* v_new, int B, int KV, int G, int D,
           int P, int page, int n_tab, float scale, float cap, int spp,
           cudaStream_t stream) {
  const int esz = sizeof(T);
  if (D < 1 || D > 256 || D % (16 / esz) || G < 1 || G > 16 ||
      (D > 128 && G > 8) || page < 1 || n_tab < 1 || spp < 1 ||
      counters == nullptr || (o_out == nullptr && acc_out == nullptr) ||
      (k_new != nullptr && (v_new == nullptr || o_out == nullptr)) ||
      !(cap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const int max_splits = (n_tab + spp - 1) / spp;
  const dim3 grid(max_splits, KV, B);
  const Call<T> c{static_cast<const T*>(q),
                  static_cast<const T*>(k_pool),
                  static_cast<const T*>(v_pool),
                  rows,
                  static_cast<const int*>(lens),
                  static_cast<float*>(ws),
                  KV, G, D, P, page, n_tab, spp, max_splits, scale, cap,
                  RowMerge<T>{static_cast<int*>(counters),
                              static_cast<float*>(acc_out),
                              static_cast<T*>(o_out),
                              static_cast<float*>(m_out),
                              static_cast<float*>(l_out),
                              static_cast<const T*>(k_new),
                              static_cast<const T*>(v_new), scale}};
  return cap > 0.f ? launch_call<T, true>(grid, stream, c)
                   : launch_call<T, false>(grid, stream, c);
}

template <typename... Args>
int by_dtype(int dtype, Args... args) {
  if (dtype == 0) return launch<float>(args...);
  if (dtype == 1) return launch<__nv_bfloat16>(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q and both pools). ws: fp32
// workspace of B * KV * max_splits * R floats, 16-byte aligned, R = G*D +
// 2G + 1 rounded up to a multiple of 4 (record_floats), max_splits =
// ceil(n_tab / split pages); counters: B * KV int32, all zero (and left
// all zero: each row's last block resets its own), used by no other call
// running at the same time. split_pages: pages a split, 0 for the default
// (kSplitTokens tokens); other values are for measurements. With o_out
// set the normalized output (B, KV*G, D) in q's dtype is written and
// m_out/l_out may be null; otherwise acc_out (B, KV, G, D) fp32 and
// m_out, l_out (B, KV, G) fp32 are the unnormalized online-softmax
// residuals. k_new, v_new (B, KV, D) in q's dtype, or null: set, the new
// token is merged into o_out (which must be set). One launch: the splits,
// each row merged by its last block.
int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                        const void* tables, const void* lens, void* ws,
                        void* counters, void* acc_out, void* o_out,
                        void* m_out, void* l_out, const void* k_new,
                        const void* v_new, int B, int KV, int G, int D, int P,
                        int page, int n_tab, int layer, float scale,
                        int dtype, int split_pages_arg, void* stream) {
  if (B == 0) return 0;
  if (tables == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int spp = split_pages_arg > 0 ? split_pages_arg : split_pages(page);
  const KvRows rows{static_cast<const int*>(tables),
                    (long long)layer * P * page * (long long)KV * D, 0, 0,
                    n_tab * page, 0};
  return by_dtype(dtype, q, k_pool, v_pool, rows, lens, ws, counters,
                  acc_out, o_out, m_out, l_out, k_new, v_new, B, KV, G, D, P,
                  page, n_tab, scale, 0.f, spp,
                  static_cast<cudaStream_t>(stream));
}

// The split kernels over a dense cache, in fp32 and at the bf16 head dims
// dense_decode.cu has no instantiation for (the host's plan sends it the
// rest): k and v (B, T, KV, D) with
// rows row_stride and tokens tok_stride elements apart (heads D apart,
// elements contiguous, 16-byte aligned), offsets (B,) int32 on the device:
// row b attends over its first min(offsets[b] + 1, T) tokens, the new
// token written at its slot already (a ring's slots, once full, all hold
// positions inside the window). Splits of kSplitTokens tokens: max_splits
// = ceil(T / kSplitTokens), a function of T alone. cap > 0: each fp32
// score s is softcapped, tanh(s / cap) * cap, before the row's max. The
// normalized output (B, KV*G, D) in q's dtype; ws and counters as above.
int dense_decode_launch(const void* q, const void* k, const void* v,
                        const void* offsets, void* ws, void* counters,
                        void* o_out, int B, int T, int KV, int G, int D,
                        long long row_stride, long long tok_stride,
                        float scale, float cap, int dtype, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || row_stride < 0 || tok_stride < (long long)KV * D)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tab = (T + kSplitTokens - 1) / kSplitTokens;
  const KvRows rows{nullptr, 0, row_stride, tok_stride, T, 1};
  return by_dtype(dtype, q, k, v, rows, offsets, ws, counters,
                  static_cast<void*>(nullptr), o_out,
                  static_cast<void*>(nullptr), static_cast<void*>(nullptr),
                  static_cast<const void*>(nullptr),
                  static_cast<const void*>(nullptr), B, KV, G, D, 0,
                  kSplitTokens, n_tab, scale, cap, 1,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
