// Flash attention backward for Hopper (sm_90a): causal / sliding-window GQA.
//
// Replaces: the gradient of
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention.
// The Pallas kernel has no custom_vjp; the JAX train step differentiates
// the attention op by autodiff (through chunked_attention off the TPU).
// This kernel computes that same gradient, the FlashAttention-2 backward,
// recomputing P from the row log-sum-exp the forward kernel saved:
//
//   D_i = rowsum(dO * O)                       (float32, one pass)
//   P   = exp(S * scale - lse),  S = Q K^T      (inside the causal/window band)
//   dV  = P^T dO,   dP = dO V^T,   dS = P * (dP - D)
//   dK  = dS^T Q * scale,          dQ = dS K * scale
//
// What bounds it on an H100: at the training shape of gpt2-350m (b=1,
// s=1024, H=K=16, D=64, causal, bf16) the function needs ~5.4e9 flops
// (2.5x the forward's) against ~17 MB of traffic (q, k, v, o, dO, lse in;
// dq, dk, dv out): ~5.4 us at 989 TFLOP/s, so the floor is the tensor
// cores.  This first version does its arithmetic in float32 on the CUDA
// cores and is bound by the shared-memory loads that feed its FMAs (about
// five 4-byte loads for four FMAs), far above that floor, like the forward.
//
// Design, with no atomics, so the gradients are bit-identical from run to
// run:
// * bwd_dot_kernel: one warp per (batch, query row, head) computes D_i.
// * bwd_dkdv_kernel: one block of 256 threads per (k tile of 32 keys, KV
//   head, batch) holds its K and V tile in shared memory and walks the G
//   query heads of its KV head and, for each, the 32-row q tiles inside the
//   band.  dK and dV of its 32 keys stay in registers (thread t owns key
//   t/8 and columns t%8 + 8i) across all of them, so GQA's sum over the
//   group happens in registers, never in device memory.
// * bwd_dq_kernel: one block per (q tile of 32 rows, head, batch) walks the
//   k tiles inside the band and keeps dQ of its rows in registers.
// Both recompute P and dS for their tile pair the same way (scores()):
// thread t owns score row t/8 and columns t%8 + 8j.  Rows and keys past sq
// and sk are loaded as zeros and masked in-kernel (no padded copy); a row
// the mask leaves with no key (lse = NEG_INF) gets P = 0 and so zero
// gradients.  All sums are float32; tiles are float32 in shared memory with
// rows padded by one word against bank conflicts.  Tensor-core MMA and TMA
// staging are left for the PR that makes this fast.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;
using repro::warp_sum;

constexpr int BQ = 32;        // query rows per tile
constexpr int BK = 32;        // keys per tile
constexpr int NT = 256;       // threads: 8 per score row / per key
constexpr int CPT = BK / 8;   // score columns per thread
constexpr int LP = BK + 1;    // padded row stride of the P and dS tiles
static_assert(BQ == BK, "load_tile stages q and k tiles of the same height");

template <int D>
constexpr int smem_floats() {
  return 2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * LP + 2 * BQ;
}

// D_i = sum_d dO[i, d] * O[i, d] for every (b, i, h) row; Di is (b, H, sq).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ Di, int sq, int H, long long rows) {
  const long long row = ((long long)blockIdx.x * NT + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long b = row / ((long long)sq * H);
    const int rem = (int)(row % ((long long)sq * H));
    const int i = rem / H, h = rem % H;
    Di[(b * H + h) * sq + i] = acc;
  }
}

// Rows r0.. of a (b, s, heads, D) tensor into a (BQ, D + 1) float tile,
// zeros past s.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int r0, int s, int heads,
                                          int head) {
  for (int e = threadIdx.x; e < BQ * D; e += NT) {
    const int rr = e / D, d = e % D;
    const int ri = r0 + rr;
    dst[rr * (D + 1) + d] =
        ri < s ? to_f(src[(((size_t)b * s + ri) * heads + head) * D + d]) : 0.f;
  }
}

// P and dS of the (q tile at q0, k tile at k0) pair into Ps and dSs.
template <int D, bool WANT_P>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* lse_s, const float* Di_s,
                                       float* Ps, float* dSs, int q0, int k0,
                                       int sq, int sk, int causal, int window,
                                       float scale) {
  constexpr int LD = D + 1;
  const int r = threadIdx.x >> 3;
  const int c0 = threadIdx.x & 7;
  float s[CPT], dp[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float qv = Qs[r * LD + d];
    const float ov = dOs[r * LD + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      s[j] = fmaf(qv, Ks[(c0 + 8 * j) * LD + d], s[j]);
      dp[j] = fmaf(ov, Vs[(c0 + 8 * j) * LD + d], dp[j]);
    }
  }
  const int qi = q0 + r;
  const float l = lse_s[r], di = Di_s[r];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int kp = k0 + c0 + 8 * j;
    const bool live = qi < sq && kp < sk && (!causal || kp <= qi) &&
                      (!window || kp > qi - window);
    const float p = live ? expf(s[j] * scale - l) : 0.f;
    if (WANT_P) Ps[r * LP + c0 + 8 * j] = p;
    dSs[r * LP + c0 + 8 * j] = p * (dp[j] - di);
  }
}

// lse and D of the q tile's rows into shared memory (0 past sq).
__device__ __forceinline__ void load_rows(float* lse_s, float* Di_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ Di, int b,
                                          int h, int H, int q0, int sq) {
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    const size_t off = ((size_t)b * H + h) * sq + qi;
    lse_s[threadIdx.x] = qi < sq ? lse[off] : 0.f;
    Di_s[threadIdx.x] = qi < sq ? Di[off] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ Di,
                T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int H,
                int K, int causal, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;             // (BK, LD)
  float* Vs = Ks + BK * LD;     // (BK, LD)
  float* Qs = Vs + BK * LD;     // (BQ, LD)
  float* dOs = Qs + BQ * LD;    // (BQ, LD)
  float* Ps = dOs + BQ * LD;    // (BQ, LP)
  float* dSs = Ps + BQ * LP;    // (BQ, LP)
  float* lse_s = dSs + BQ * LP; // (BQ)
  float* Di_s = lse_s + BQ;     // (BQ)

  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int c = threadIdx.x >> 3;   // key within the tile
  const int d0 = threadIdx.x & 7;

  load_tile<T, D>(Ks, k, b, k0, sk, K, kh);
  load_tile<T, D>(Vs, v, b, k0, sk, K, kh);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // the q tiles whose rows see a key of this tile: row i sees key j iff
  // j <= i (causal) and i < j + window (window)
  const int q_first = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window ? min(sq, k0 + BK - 1 + window) : sq;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = q_first; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous pair's readers are done
      load_tile<T, D>(Qs, q, b, q0, sq, H, h);
      load_tile<T, D>(dOs, dout, b, q0, sq, H, h);
      load_rows(lse_s, Di_s, lse, Di, b, h, H, q0, sq);
      __syncthreads();
      scores<D, true>(Qs, dOs, Ks, Vs, lse_s, Di_s, Ps, dSs, q0, k0, sq, sk,
                      causal, window, scale);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float p = Ps[r * LP + c];
        const float ds = dSs[r * LP + c];
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          dv_acc[i] = fmaf(p, dOs[r * LD + d0 + 8 * i], dv_acc[i]);
          dk_acc[i] = fmaf(ds, Qs[r * LD + d0 + 8 * i], dk_acc[i]);
        }
      }
    }
  }

  const int kj = k0 + c;
  if (kj < sk) {
    const size_t off = (((size_t)b * sk + kj) * K + kh) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[off + d0 + 8 * i] = from_f<T>(dk_acc[i] * scale);
      dv[off + d0 + 8 * i] = from_f<T>(dv_acc[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ Di,
              T* __restrict__ dq, int sq, int sk, int H, int K, int causal,
              int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* dSs = dOs + BQ * LD + BQ * LP;  // the P tile's room is unused here
  float* lse_s = dSs + BQ * LP;
  float* Di_s = lse_s + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int r = threadIdx.x >> 3;
  const int d0 = threadIdx.x & 7;

  load_tile<T, D>(Qs, q, b, q0, sq, H, h);
  load_tile<T, D>(dOs, dout, b, q0, sq, H, h);
  load_rows(lse_s, Di_s, lse, Di, b, h, H, q0, sq);

  float dq_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dq_acc[i] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    if (causal && k0 > q0 + BQ - 1) break;               // past the diagonal
    if (window && k0 + BK - 1 <= q0 - window) continue;  // before the band
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k, b, k0, sk, K, kh);
    load_tile<T, D>(Vs, v, b, k0, sk, K, kh);
    __syncthreads();
    scores<D, false>(Qs, dOs, Ks, Vs, lse_s, Di_s, nullptr, dSs, q0, k0, sq,
                     sk, causal, window, scale);
    __syncwarp();  // row r's dS values come from lanes of this warp only
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = dSs[r * LP + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        dq_acc[i] = fmaf(ds, Ks[c * LD + d0 + 8 * i], dq_acc[i]);
    }
  }

  const int qi = q0 + r;
  if (qi < sq) {
    T* row = dq + (((size_t)b * sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) row[d0 + 8 * i] = from_f<T>(dq_acc[i] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* Di, void* dq,
                   void* dk, void* dv, int b, int sq, int sk, int H, int K,
                   int causal, int window, float scale, cudaStream_t stream) {
  const long long rows = (long long)b * sq * H;
  const unsigned dot_blocks = (unsigned)((rows * 32 + NT - 1) / NT);
  bwd_dot_kernel<T, D><<<dot_blocks, NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), Di, sq, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem = smem_floats<D>() * (int)sizeof(float);
  auto dkdv = bwd_dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((sk + BK - 1) / BK, K, b), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, Di,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, H, K, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((sq + BQ - 1) / BQ, H, b), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, Di,
      static_cast<T*>(dq), sq, sk, H, K, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* Di, void* dq, void* dk, void* dv, int b, int sq,
                     int sk, int H, int K, int causal, int window, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, Di, dq, dk, dv, b, sq, sk, H, K, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, Di, dq, dk, dv, b, sq, sk, H, K, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, Di, dq, dk, dv, b, sq, sk, H, K, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (b, sq, H, D); k, v, dk, dv (b, sk, K, D), all contiguous
// and of one dtype; lse (b, H, sq) float32 from the forward kernel; Di
// (b, H, sq) float32 scratch.  Returns the cudaError_t of the first launch
// that failed (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* Di, void* dq, void* dk, void* dv,
                                         int b, int sq, int sk, int H, int K,
                                         int D, int dtype, int causal,
                                         int window, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* di = static_cast<float*>(Di);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, o, dout, l, di, dq, dk, dv, b, sq, sk, H, K, causal, window, scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, di, dq, dk, dv, b, sq, sk, H, K, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
