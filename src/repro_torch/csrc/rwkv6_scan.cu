// Chunked RWKV6 WKV: linear attention with a per-channel, data-dependent
// decay, the bonus u, and a carried (K, K) fp32 state.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/rwkv6_scan/
// kernel.py: rwkv6_scan_kernel (with _rwkv_kernel).
//
// Bound: bytes, nearly level with operations. At rwkv6-3b's prefill shape
// (B=1, T=2048, H=40, K=L=64) the function reads r, k, v and the log-decay
// and writes o (5 x 21 MB) plus the states, ~106 MB: ~32 us at the card's
// HBM rate; its ~2.0 GFLOP of fp32 products take ~30 us at the fp32 peak.
//
// Of the four products a chunk does, three do not depend on the carried
// state: the intra-chunk scores, their product with v and the chunk's
// state summary U = k_out^T v. Only the readout r_in . S and the carry
// S' = exp(total) (.) S + U run in chunk order, and column x of S depends
// on column x of U alone. So the scan is two launches on one stream.
//
// Pass 1, wkv_chunk_kernel, one block a (chunk, head, batch row): 1280
// blocks at B=1, three to an SM (no state in shared memory; its tiles are
// reused phase by phase). It stages the chunk's r, k, v and log-decay with
// cp.async, forms the diagonal bonus and the chunk's cumulative log-decay
// (chunk_cumsum, a four-way split prefix sum a channel), then r and k
// centred on the chunk's mid-point decay (exponents clipped at +-38), k
// decayed to the chunk's end (clipped), r decayed from the chunk's start
// and exp(total) (neither clipped). It writes o = scores v + diag v, and
// hands U, r_in and exp(total) to pass 2 through a workspace, so pass 2
// does no prefix sum of its own. The three products are fp32 FMA on 4 x 4
// register tiles fed by 16-byte shared loads (r and k centred are stored
// transposed for that) and skip what the strictly-lower scores make zero:
// only the 4 x 4 blocks on or below the diagonal are computed, and row i
// of o sums its first i scores.
//
// Pass 2, wkv_carry_kernel<VS>, one block a (slice of VS state columns,
// head, batch row): the slice of S in shared memory twice (read, then
// written) and, for each chunk in order, one barrier, o[:, slice] +=
// r_in S[:, slice] and S[:, slice] = exp(total) S + U[:, slice]. The
// readout runs on 4 x 4 tiles of (rows, columns), each summed over K by
// 64 / VS adjacent lanes and combined by xor shuffles. Its loads (r_in,
// the U and o slices, exp(total)) do not depend on S: cp.async keeps the
// next kStages - 1 chunks of them in flight.
//
// What holds it (probes of edited copies on the H100, PERF.md): the
// products of both passes wait on shared-memory loads (a 4 x 4 tile
// takes 8 floats for 16 FMAs, and the load path serves 32 floats a clock
// an SM against 128 FMAs); pass 2 spends ~2 us a chunk, its memory
// traffic and its readout one after the other. The first, plain design
// had one block a (batch row, head): 40 blocks on 132 SMs walking the 32
// chunks in order with every load unhidden, ~1 ms.
//
// Every sum stays inside one (batch row, head), so a row's output and
// state do not depend on B, bit for bit. Each sums the terms of the plain
// chunked version (kernels/rwkv6_scan/ref.py: wkv_chunk_pass,
// wkv_carry_pass), in another fp32 order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kClip = 38.0f;
constexpr int kThreads = 256;  // both passes
constexpr int kMax = 64;       // largest K and L
constexpr int kParts = 4;      // prefix-sum segments per channel
constexpr int kSeg = kMax / kParts;   // tokens a segment at most
constexpr int kSlice = 32;     // state columns a carry block, by default
constexpr int kStages = 3;     // pass 2: chunks staged at once
static_assert(kParts * kMax <= kThreads, "one (segment, channel) a thread");

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -kClip), kClip));
}

// Row stride (floats) of a staged tile whose rows hold n values: n rounded
// up to a multiple of 4, plus 4, so 16-byte accesses stay aligned.
__host__ __device__ __forceinline__ int tile_ld(int n) {
  return (n + 3) / 4 * 4 + 4;
}

__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue cp.async copies of a (rows, cols) fp32 tile, global rows gld
// floats apart, shared rows sld apart. vec: 16-byte copies (cols, gld,
// sld and both addresses multiples of 4 floats); else 4-byte ones.
__device__ __forceinline__ void stage_tile(float* dst, int sld,
                                           const float* src, long long gld,
                                           int rows, int cols, int vec) {
  if (vec) {
    const int q = cols >> 2;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int t = i / q, c = (i - t * q) << 2;
      cp_async16(dst + t * sld + c, src + t * gld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int t = i / cols, c = i - t * cols;
      cp_async4(dst + t * sld + c, src + t * gld + c);
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[a][e] += x[a] y[e] for a 4 x 4 register tile
__device__ __forceinline__ void fma_tile(float (&acc)[4][4], float4 x,
                                         float4 y) {
  const float xa[4] = {x.x, x.y, x.z, x.w}, ye[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(xa[a], ye[e], acc[a][e]);
}

// Store n <= 4 consecutive floats; one 16-byte store when n == 4 and vec.
__device__ __forceinline__ void store_row(float* dst, const float* x, int n,
                                          int vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    for (int e = 0; e < n; ++e) dst[e] = x[e];
  }
}

// The chunk's cumulative log-decay per channel, a four-way split prefix
// sum over time, one (segment p, channel c) a thread: part_s
// ([kParts][K]) gets each segment's sum, then each thread walks its
// segment's tokens and calls visit(s, t, c, excl, cum, total) with the
// token's index s in the segment, the exclusive and inclusive sums and
// the chunk's total. lw is the staged (L, K) log-decay, rows ld apart.
// Barrier between the two steps, none after the walk.
template <class Visit>
__device__ __forceinline__ void chunk_cumsum(const float* lw, int ld, int L,
                                             int K, float* part_s,
                                             Visit&& visit) {
  const int seg = (L + kParts - 1) / kParts;
  const int p = threadIdx.x / K, c = threadIdx.x - p * K;
  const bool own = threadIdx.x < kParts * K;
  const int t0 = p * seg, t1 = min(L, t0 + seg);
  if (own) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      if (t0 + j < t1) s += lw[(t0 + j) * ld + c];
    part_s[p * K + c] = s;
  }
  __syncthreads();
  if (own) {
    float run = 0.f, tot = 0.f;
    for (int q = 0; q < kParts; ++q) {
      if (q < p) run += part_s[q * K + c];
      tot += part_s[q * K + c];
    }
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const int t = t0 + j;
      if (t < t1) {
        const float excl = run;
        run += lw[t * ld + c];
        visit(j, t, c, excl, run, tot);
      }
    }
  }
}

// Pass 1's shared memory (floats): region a holds r, then r centred
// transposed, then the scores transposed; k then k_out; v; region w holds
// the log-decay, then k centred transposed; the bonus, u, partial sums.
struct ChunkSmem {
  int ld, lt, a, w;
  __host__ __device__ ChunkSmem(int K, int L)
      : ld(tile_ld(K)), lt(tile_ld(L)),
        a(imax(imax(L * tile_ld(K), K * tile_ld(L)), L * tile_ld(L))),
        w(imax(L * tile_ld(K), K * tile_ld(L))) {}
  __host__ __device__ size_t floats(int K, int L) const {
    return (size_t)a + 2 * L * ld + w + L + K + kParts * K;
  }
};

// The workspace pass 1 writes and pass 2 reads, in records of one
// (batch row, head, chunk), n_rec of them: U (K, K), then r_in (L, K),
// then exp(total) (K).
struct Workspace {
  float *u, *r_in, *dec;
  __device__ Workspace(float* ws, long long n_rec, long long rec, int K,
                       int L)
      : u(ws + rec * K * K),
        r_in(ws + n_rec * K * K + rec * L * K),
        dec(ws + n_rec * ((long long)K * K + (long long)L * K) + rec * K) {}
};

// r, k, v, lw, o: contiguous (B, T, H, K); u (H, K). Grid (nc, H, B).
// Writes o = scores v + diag v and the workspace.
__global__ void __launch_bounds__(kThreads, 3) wkv_chunk_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, float* __restrict__ o,
    float* __restrict__ ws, int H, int T, int K, int L, int vec) {
  extern __shared__ __align__(16) float smem[];
  const ChunkSmem lay(K, L);
  const int ld = lay.ld, lt = lay.lt;
  float* r_s = smem;                 // [L][ld] r
  float* f_t = smem;                 //   then [K][lt] r centred
  float* s_t = smem;                 //   then [L][lt] the scores, [j][i]
  float* k_s = smem + lay.a;         // [L][ld] k, then k_out
  float* v_s = k_s + L * ld;         // [L][ld] v
  float* w_s = v_s + L * ld;         // [L][ld] log-decay
  float* g_t = w_s;                  //   then [K][lt] k centred
  float* diag_s = w_s + lay.w;       // [L]
  float* u_s = diag_s + L;           // [K]
  float* part_s = u_s + K;           // [kParts][K]

  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long row = (long long)H * K;  // elements per time step
  const long long base =
      ((long long)b * T + (long long)n * L) * row + (long long)h * K;
  const Workspace out(ws, (long long)gridDim.z * H * gridDim.x,
                      ((long long)b * H + h) * gridDim.x + n, K, L);

  stage_tile(r_s, ld, r + base, row, L, K, vec);
  stage_tile(k_s, ld, k + base, row, L, K, vec);
  stage_tile(v_s, ld, v + base, row, L, K, vec);
  stage_tile(w_s, ld, lw + base, row, L, K, vec);
  cp_async_commit();
  for (int i = tid; i < K; i += kThreads) u_s[i] = u[(long long)h * K + i];
  cp_async_wait<0>();
  __syncthreads();

  // diagonal bonus from the raw r, k: four threads a token, each a
  // quarter of the channels (c = q, q + 4, ...), summed by two shuffles
  {
    const int q = tid & 3;
    for (int t0 = 0; t0 < L; t0 += kThreads / 4) {
      const int t = t0 + (tid >> 2);
      float d = 0.f;
      if (t < L)
#pragma unroll 4
        for (int c = q; c < K; c += 4)
          d = fmaf(r_s[t * ld + c] * u_s[c], k_s[t * ld + c], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (t < L && q == 0) diag_s[t] = d;
    }
  }

  // decay factors: k_out in place, r_in and exp(total) to the workspace,
  // r and k centred kept in registers until every raw value is read
  float f_r[kSeg], g_r[kSeg];
  chunk_cumsum(w_s, ld, L, K, part_s,
               [&](int s, int t, int c, float excl, float cum, float tot) {
                 const float mid = tot * 0.5f;
                 const float rv = r_s[t * ld + c], kv = k_s[t * ld + c];
                 f_r[s] = rv * clip_exp(excl - mid);
                 g_r[s] = kv * clip_exp(mid - cum);
                 k_s[t * ld + c] = kv * clip_exp(tot - cum);
                 out.r_in[t * K + c] = rv * expf(excl);
                 if (t == 0) out.dec[c] = expf(tot);
               });
  __syncthreads();
  if (tid < kParts * K) {  // rows of the transposed tiles
    const int seg = (L + kParts - 1) / kParts;
    const int p = tid / K, c = tid - p * K, t0 = p * seg;
    if (L % (4 * kParts) == 0) {  // whole segments of 4-token steps
#pragma unroll
      for (int j = 0; j < kSeg; j += 4)
        if (j < seg) {
          *reinterpret_cast<float4*>(f_t + c * lt + t0 + j) =
              make_float4(f_r[j], f_r[j + 1], f_r[j + 2], f_r[j + 3]);
          *reinterpret_cast<float4*>(g_t + c * lt + t0 + j) =
              make_float4(g_r[j], g_r[j + 1], g_r[j + 2], g_r[j + 3]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
        if (t0 + j < min(L, t0 + seg)) {
          f_t[c * lt + t0 + j] = f_r[j];
          g_t[c * lt + t0 + j] = g_r[j];
        }
    }
  }
  __syncthreads();

  // intra-chunk scores S[i][j] = f_i . g_j for j < i: the 4 x 4 blocks on
  // or below the diagonal, (tr, tc) with tc <= tr, on the first threads
  const int nb = (L + 3) / 4;
  {
    int tr = 0, tc = tid;
    while (tc > tr) tc -= ++tr;
    const bool active = tr < nb;
    float s[4][4] = {};
    if (active) {
#pragma unroll 4
      for (int c = 0; c < K; ++c)
        fma_tile(s, lds4(f_t + c * lt + 4 * tr), lds4(g_t + c * lt + 4 * tc));
    }
    __syncthreads();  // r and k centred read: the scores take region a
    if (active) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * tc + e;
        if (j >= L) continue;
        float col[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) col[a] = j < 4 * tr + a ? s[a][e] : 0.f;
        *reinterpret_cast<float4*>(s_t + j * lt + 4 * tr) =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
  }
  __syncthreads();

  // o = scores v + diag * v (row i sums j < i) and U = k_out^T v, each on
  // 4 x 4 tiles: rows 4 tr .., columns 4 tc ..
  const int tr = tid >> 4, tc = tid & 15, nx = min(4, K - 4 * tc);
  if (4 * tr < L && nx > 0) {
    float acc[4][4] = {};
    const int jmax = min(L, 4 * tr + 3);
#pragma unroll 4
    for (int j = 0; j < jmax; ++j)
      fma_tile(acc, lds4(s_t + j * lt + 4 * tr), lds4(v_s + j * ld + 4 * tc));
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * tr + a;
      if (i >= L) continue;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = acc[a][e] + diag_s[i] * v_s[i * ld + 4 * tc + e];
      store_row(o + base + (long long)i * row + 4 * tc, y, nx, vec);
    }
  }
  if (4 * tr < K && nx > 0) {
    float acc[4][4] = {};
#pragma unroll 4
    for (int j = 0; j < L; ++j)
      fma_tile(acc, lds4(k_s + j * ld + 4 * tr), lds4(v_s + j * ld + 4 * tc));
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (4 * tr + a < K)
        store_row(out.u + (4 * tr + a) * K + 4 * tc, acc[a], nx, vec);
  }
}

__host__ __device__ __forceinline__ int carry_stage_floats(int K, int L,
                                                           int VS) {
  return L * tile_ld(K) + K * VS + L * VS + tile_ld(K);
}

// o: contiguous (B, T, H, K) holding pass 1's output; ws pass 1's
// workspace; s0 (B, H, K, K) or null (zero state); s_out (B, H, K, K).
// Grid (ceil(K / VS), H, B). The readout is 4 x 4 tiles of (rows, slice
// columns), each summed over K by kSplit adjacent lanes (channels 4 q ..
// 4 q + 3 for q = sp, sp + kSplit, ...) and combined by xor shuffles.
template <int VS>
__global__ void __launch_bounds__(kThreads) wkv_carry_kernel(
    const float* __restrict__ ws, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ s_out, int H, int T, int K,
    int L, int vec) {
  constexpr int kTX = VS / 4;                          // column tiles
  constexpr int kSplit = kThreads / (kTX * kMax / 4);  // lanes a tile
  extern __shared__ __align__(16) float smem[];
  const int ld = tile_ld(K), kq = (K + 3) / 4;
  // a stage: [L][ld] r_in, [K][VS] U slice, [L][VS] o slice, [K] decay
  const int stage = carry_stage_floats(K, L, VS);
  // the carried slice of S and its update, [K][VS] each, rows up to
  // 4 kq zero
  float* s_cur = smem + kStages * stage;
  float* s_nxt = s_cur + 4 * kq * VS;

  const int x0 = blockIdx.x * VS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, sp = tid % kSplit;
  const int tx = tid / kSplit % kTX, ty = tid / (kSplit * kTX);
  const int nv = min(VS, K - x0);
  const int nc = T / L;
  const long long row = (long long)H * K;
  const long long base = (long long)b * T * row + (long long)h * K;
  const long long sbase = ((long long)b * H + h) * K * K;
  const long long n_rec = (long long)gridDim.z * H * nc;
  const long long rec0 = ((long long)b * H + h) * nc;

  // chunk n's loads into its stage; a group is committed either way, so
  // that the count of groups in flight stays kStages - 1
  auto issue = [&](int n) {
    if (n < nc) {
      float* st = smem + (n % kStages) * stage;
      const Workspace in(const_cast<float*>(ws), n_rec, rec0 + n, K, L);
      stage_tile(st, ld, in.r_in, K, L, K, vec);
      stage_tile(st + L * ld, VS, in.u + x0, K, K, nv, vec);
      stage_tile(st + L * ld + K * VS, VS,
                 o + base + (long long)n * L * row + x0, row, L, nv, vec);
      stage_tile(st + L * ld + K * VS + L * VS, ld, in.dec, 0, 1, K, vec);
    }
    cp_async_commit();
  };
  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int i = tid; i < 4 * kq * VS; i += kThreads) {
    const int c = i / VS, x = i - c * VS;
    s_cur[i] = s0 != nullptr && c < K && x < nv
                   ? s0[sbase + (long long)c * K + x0 + x] : 0.f;
    s_nxt[i] = 0.f;
  }
  // r_in's channels past K (up to 4 kq) are never staged: zero
  for (int i = tid; i < kStages * L * (4 * kq - K); i += kThreads) {
    const int s = i / (L * (4 * kq - K)), j = i - s * L * (4 * kq - K);
    const int t = j / (4 * kq - K);
    smem[s * stage + t * ld + K + j - t * (4 * kq - K)] = 0.f;
  }

  for (int n = 0; n < nc; ++n) {
    const float* r_b = smem + (n % kStages) * stage;
    const float* u_b = r_b + L * ld;
    const float* o_b = u_b + K * VS;
    const float* dec_b = o_b + L * VS;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk n staged; chunk n - 1 done with its stage
    issue(n + kStages - 1);

    // o[:, slice] += r_in S[:, slice], S read before it is written
    float acc[4][4] = {};
    if (4 * ty < L) {
#pragma unroll 2
      for (int q = sp; q < kq; q += kSplit) {
        const float4 s4[4] = {lds4(s_cur + (4 * q) * VS + 4 * tx),
                              lds4(s_cur + (4 * q + 1) * VS + 4 * tx),
                              lds4(s_cur + (4 * q + 2) * VS + 4 * tx),
                              lds4(s_cur + (4 * q + 3) * VS + 4 * tx)};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 ra = lds4(r_b + (4 * ty + a) * ld + 4 * q);
          const float rc[4] = {ra.x, ra.y, ra.z, ra.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float se[4] = {s4[i].x, s4[i].y, s4[i].z, s4[i].w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[a][e] = fmaf(rc[i], se[e], acc[a][e]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 1; m < kSplit; m <<= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[a][e] += __shfl_xor_sync(0xffffffffu, acc[a][e], m);
    const int ncol = min(4, nv - 4 * tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * ty + a;
      if (a % kSplit != sp || t >= L || ncol <= 0) continue;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = o_b[t * VS + 4 * tx + e] + acc[a][e];
      store_row(o + base + ((long long)n * L + t) * row + x0 + 4 * tx, y,
                ncol, vec);
    }
    // S' = exp(total) S + U, into the other buffer, 4 columns a step
    for (int i = tid; i < K * kTX; i += kThreads) {
      const int c = i / kTX, x = 4 * (i - c * kTX);
      const float4 sv = lds4(s_cur + c * VS + x), uv = lds4(u_b + c * VS + x);
      const float d = dec_b[c];
      *reinterpret_cast<float4*>(s_nxt + c * VS + x) = make_float4(
          x < nv ? d * sv.x + uv.x : 0.f, x + 1 < nv ? d * sv.y + uv.y : 0.f,
          x + 2 < nv ? d * sv.z + uv.z : 0.f,
          x + 3 < nv ? d * sv.w + uv.w : 0.f);
    }
    float* swap = s_cur;
    s_cur = s_nxt;
    s_nxt = swap;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < K * VS; i += kThreads) {
    const int c = i / VS, x = i - c * VS;
    if (x < nv) s_out[sbase + (long long)c * K + x0 + x] = s_cur[i];
  }
}

size_t chunk_smem_bytes(int K, int L) {
  return sizeof(float) * ChunkSmem(K, L).floats(K, L);
}

size_t carry_smem_bytes(int K, int L, int VS) {
  return sizeof(float) * ((size_t)kStages * carry_stage_floats(K, L, VS) +
                          2 * (size_t)((K + 3) / 4 * 4) * VS);
}

// Raise a kernel's dynamic shared memory limit once, to what it needs,
// and ask for the largest shared-memory carveout, so that as many blocks
// as their shared memory allows share an SM.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int VS>
cudaError_t launch_carry(const float* ws, const float* s0, float* o,
                         float* s_out, int B, int T, int H, int K, int L,
                         int vec, cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t smem = carry_smem_bytes(K, L, VS);
  const cudaError_t err = allow_smem(wkv_carry_kernel<VS>, smem, &allowed);
  if (err != cudaSuccess) return err;
  wkv_carry_kernel<VS><<<dim3((K + VS - 1) / VS, H, B), kThreads, smem,
                         stream>>>(ws, s0, o, s_out, H, T, K, L, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fp32 throughout. r, k, v, logw and o contiguous (B, T, H, K); u (H, K);
// s0 (B, H, K, K) or null for a zero state; s_out (B, H, K, K); ws a
// workspace of B * H * (T / L) * (K * K + L * K + K) floats. 1 <= K, L <=
// 64, T a multiple of L; slice the state columns a carry block (8, 16 or
// 32; 0 for kSlice). Two launches (one when T = 0).
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* logw, const void* u, const void* s0,
                      void* o, void* s_out, void* ws, int B, int T, int H,
                      int K, int L, int slice, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (slice == 0) slice = kSlice;
  if (K < 1 || K > kMax || L < 1 || L > kMax || T % L ||
      (slice != 8 && slice != 16 && slice != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = K % 4 == 0 && L % 4 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(logw) && aligned16(o) &&
                  aligned16(ws);
  float *wsf = static_cast<float*>(ws), *of = static_cast<float*>(o);
  if (T > 0) {
    static size_t allowed = 0;
    const size_t smem = chunk_smem_bytes(K, L);
    cudaError_t err = allow_smem(wkv_chunk_kernel, smem, &allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv_chunk_kernel<<<dim3(T / L, H, B), kThreads, smem, st>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(logw),
        static_cast<const float*>(u), of, wsf, H, T, K, L, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* s0f = static_cast<const float*>(s0);
  float* sf = static_cast<float*>(s_out);
  cudaError_t err;
  switch (slice) {
    case 8:
      err = launch_carry<8>(wsf, s0f, of, sf, B, T, H, K, L, vec, st);
      break;
    case 16:
      err = launch_carry<16>(wsf, s0f, of, sf, B, T, H, K, L, vec, st);
      break;
    default:
      err = launch_carry<32>(wsf, s0f, of, sf, B, T, H, K, L, vec, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
