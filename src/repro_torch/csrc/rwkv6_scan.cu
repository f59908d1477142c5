// Chunked RWKV6 WKV: linear attention with a per-channel, data-dependent
// decay, the bonus u, and a carried (K, K) fp32 state.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/rwkv6_scan/
// kernel.py: rwkv6_scan_kernel (with _rwkv_kernel).
//
// Bound: operations. Each chunk of L tokens does four (L x K x K-sized)
// fp32 products (intra-chunk scores, their product with v, the readout
// of the carried state, the state update): at rwkv6-3b's prefill shape
// (B=1, T=2048, H=40, K=L=64) ~2.7 GFLOP a layer, ~40 us at the card's
// fp32 peak, against ~106 MB of r, k, v, log-decay, output and state,
// ~32 us at its HBM rate. Design of this first, plain kernel: one thread
// block per (batch row, head) holds the head's (K, K) state in shared
// memory and walks the chunks in order (the TPU grid's sequential chunk
// axis). Each chunk's r, k, v and log-decay rows are staged in shared
// memory (rows padded to K+1 floats against bank conflicts); each channel's
// cumulative log-decay is a four-way split prefix sum, from which the
// decay factors are formed once per element: r and k centred on the
// chunk's mid-point decay with exponents clipped at +-38 (the scores),
// r decayed from the chunk start (the readout), k decayed to the chunk
// end (the update). The three products and the diagonal bonus are plain
// fp32 FMA loops, each of the 256 threads computing a 4 x 4 patch; the
// state is read for the readout before it is overwritten by the update.
// Identical math to the Pallas kernel; two calls with the state carried
// equal one call. With B*H blocks and no tensor cores the card is mostly
// idle at B=1; splitting the state's columns over blocks is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kClip = 38.0f;
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 patch
constexpr int kMax = 64;       // largest K and L
constexpr int kParts = 4;      // prefix-sum segments per channel

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -kClip), kClip));
}

// r, k, v, logw, o: contiguous (B, T, H, K); u (H, K); s0 / s_out
// (B, H, K, K). s0 may be null (zero state).
__global__ void __launch_bounds__(kThreads) wkv_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ s_out, int H, int T, int K,
    int L) {
  extern __shared__ float smem[];
  const int KP = K + 1, LP = L + 1;
  float* r_s = smem;               // [L][K+1] r, then r * exp(excl)
  float* k_s = r_s + L * KP;       // [L][K+1] k, then k * exp(tot - cum)
  float* f_s = k_s + L * KP;       // [L][K+1] log-decay, then r centred
  float* g_s = f_s + L * KP;       // [L][K+1] k centred
  float* v_s = g_s + L * KP;       // [L][K]
  float* sc_s = v_s + L * K;       // [L][L+1] intra-chunk scores
  float* st_s = sc_s + L * LP;     // [K][K] carried state
  float* diag_s = st_s + K * K;    // [L]
  float* dec_s = diag_s + L;       // [K] exp(chunk total log-decay)
  float* u_s = dec_s + K;          // [K]
  float* part_s = u_s + K;         // [kParts][K] partial sums

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const long long row = (long long)H * K;  // elements per time step
  const long long base = (long long)b * T * row + (long long)h * K;
  const long long sbase = ((long long)b * H + h) * K * K;

  for (int i = tid; i < K * K; i += kThreads)
    st_s[i] = s0 != nullptr ? s0[sbase + i] : 0.f;
  for (int i = tid; i < K; i += kThreads) u_s[i] = u[(long long)h * K + i];

  const int seg = (L + kParts - 1) / kParts;
  for (int t0 = 0; t0 < T; t0 += L) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, c = i - t * K;
      const long long g = base + (long long)(t0 + t) * row + c;
      r_s[t * KP + c] = r[g];
      k_s[t * KP + c] = k[g];
      f_s[t * KP + c] = lw[g];
      v_s[t * K + c] = v[g];
    }
    __syncthreads();

    // diagonal bonus from the raw r, k; partial log-decay sums
    for (int t = tid; t < L; t += kThreads) {
      float d = 0.f;
      for (int c = 0; c < K; ++c)
        d = fmaf(r_s[t * KP + c] * u_s[c], k_s[t * KP + c], d);
      diag_s[t] = d;
    }
    for (int i = tid; i < kParts * K; i += kThreads) {
      const int p = i / K, c = i - p * K;
      float s = 0.f;
      for (int t = p * seg; t < min(L, (p + 1) * seg); ++t) s += f_s[t * KP + c];
      part_s[p * K + c] = s;
    }
    __syncthreads();

    // decay factors, one (segment, channel) per thread
    for (int i = tid; i < kParts * K; i += kThreads) {
      const int p = i / K, c = i - p * K;
      float run = 0.f, tot = 0.f;
      for (int q = 0; q < kParts; ++q) {
        if (q < p) run += part_s[q * K + c];
        tot += part_s[q * K + c];
      }
      const float mid = tot * 0.5f;
      if (p == 0) dec_s[c] = expf(tot);
      for (int t = p * seg; t < min(L, (p + 1) * seg); ++t) {
        const float excl = run;
        run += f_s[t * KP + c];  // cum
        const float rv = r_s[t * KP + c], kv = k_s[t * KP + c];
        f_s[t * KP + c] = rv * clip_exp(excl - mid);
        g_s[t * KP + c] = kv * clip_exp(mid - run);
        r_s[t * KP + c] = rv * expf(excl);
        k_s[t * KP + c] = kv * clip_exp(tot - run);
      }
    }
    __syncthreads();

    // intra-chunk scores, strictly lower triangular
    {
      float s[4][4] = {};
      for (int c = 0; c < K; ++c) {
        float fa[4], gb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = tr + 16 * a;
          fa[a] = i < L ? f_s[i * KP + c] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = tc + 16 * e;
          gb[e] = j < L ? g_s[j * KP + c] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[a][e] = fmaf(fa[a], gb[e], s[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = tr + 16 * a, j = tc + 16 * e;
          if (i < L && j < L) sc_s[i * LP + j] = j < i ? s[a][e] : 0.f;
        }
    }
    __syncthreads();

    // o = scores v + diag * v + r_in S
    {
      float acc[4][4] = {};
      for (int j = 0; j < L; ++j) {
        float sa[4], vb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = tr + 16 * a;
          sa[a] = i < L ? sc_s[i * LP + j] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = tc + 16 * e;
          vb[e] = c < K ? v_s[j * K + c] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(sa[a], vb[e], acc[a][e]);
      }
      for (int c = 0; c < K; ++c) {
        float ra[4], sb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = tr + 16 * a;
          ra[a] = i < L ? r_s[i * KP + c] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = tc + 16 * e;
          sb[e] = x < K ? st_s[c * K + x] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(ra[a], sb[e], acc[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = tr + 16 * a;
        if (i >= L) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = tc + 16 * e;
          if (x < K)
            o[base + (long long)(t0 + i) * row + x] =
                acc[a][e] + diag_s[i] * v_s[i * K + x];
        }
      }
    }
    __syncthreads();  // every readout of the state is done

    // S' = diag(exp(total)) S + sum_j k_out_j v_j^T
    {
      float acc[4][4] = {};
      for (int j = 0; j < L; ++j) {
        float ka[4], vb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int c = tr + 16 * a;
          ka[a] = c < K ? k_s[j * KP + c] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = tc + 16 * e;
          vb[e] = x < K ? v_s[j * K + x] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(ka[a], vb[e], acc[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int c = tr + 16 * a;
        if (c >= K) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = tc + 16 * e;
          if (x < K) st_s[c * K + x] = dec_s[c] * st_s[c * K + x] + acc[a][e];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < K * K; i += kThreads) s_out[sbase + i] = st_s[i];
}

size_t smem_bytes(int K, int L) {
  return sizeof(float) * (4 * (size_t)L * (K + 1) + (size_t)L * K +
                          (size_t)L * (L + 1) + (size_t)K * K + L + 2 * K +
                          kParts * K);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fp32 throughout. r, k, v, logw and o contiguous (B, T, H, K); u (H, K);
// s0 (B, H, K, K) or null for a zero state; s_out (B, H, K, K).
// 1 <= K, L <= 64 and T a multiple of L.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* logw, const void* u, const void* s0,
                      void* o, void* s_out, int B, int T, int H, int K, int L,
                      void* stream) {
  if (B == 0 || H == 0) return 0;
  if (K < 1 || K > kMax || L < 1 || L > kMax || T % L)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(K, L);
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  wkv_kernel<<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out), H, T, K, L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
