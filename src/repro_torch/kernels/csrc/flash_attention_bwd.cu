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
// cores.  This design does 7 products where FlashAttention-2 does 5 (S
// and dP are recomputed in both passes, the price of having no atomics),
// so its own floor is 1.4x that.
//
// Three kernels, with no atomics, so the gradients are bit-identical from
// run to run:
// * bwd_dot_kernel: one warp per (batch, query row, head) computes D_i.
// * dK, dV: one block per (k tile of 64 keys, KV head, batch) walks the G
//   query heads of its KV head and, for each, the q tiles inside the band.
//   dK and dV of its keys stay in float32 registers across all of them, so
//   GQA's sum over the group happens in registers, never in device memory.
// * dQ: one block per (q tile, head, batch) walks the k tiles inside the
//   band and keeps dQ of its rows in registers.
//
// bfloat16 bodies, on the tensor cores (mma.sync.m16n8k16 through
// ldmatrix, mma.cuh): four warps, each owning 16 keys (dK, dV) or 16 query
// rows (dQ).  The dK/dV block computes S^T = K Q^T and dP^T = V dO^T for
// its keys against a q tile (64 rows; 32 at D = 128, to keep dK, dV, S^T
// and dP^T in 255 registers), P^T and dS^T in float32 registers, rounds
// them to bf16 in registers -- as FlashAttention-2 does -- and feeds them
// as the A fragments of dV += P^T dO and dK += dS^T Q (dO and Q through
// ldmatrix.trans).  The dQ block computes S and dP for its rows against
// each 64-key tile and dQ += dS K the same way.  Q/dO (and lse, D_i) tiles
// in the dK/dV block, K/V tiles in the dQ block, stream through a
// two-stage cp.async ring of XOR-swizzled tiles; the block's own K/V (or
// Q/dO) are staged once.  The mask is evaluated only on tile pairs that
// cross the diagonal, the window's edge, sq or sk; rows and keys past sq
// and sk are zero-filled by the copy and never stored.  A row the mask
// leaves with no key (lse = NEG_INF) gets P = 0 and so zero gradients.
// The gradients leave through the warp's own rows of a staged tile as
// 16-byte stores.  Registers: up to 252 a thread at D = 64 and 128 (no
// spills).  On an H100 at the training shape the three kernels together
// take about what PyTorch's FlashAttention-2 backward takes, with two
// more products; cuDNN's (PyTorch's default) is faster still.
//
// D = 192 (deepseek-v2's MLA training: qk width dn + dr, v zero-padded to
// it; b=1, s=1024, H=K=128, causal) needs its own partition.  The function
// needs ~1.29e11 flops (~0.130 ms at 989 TFLOP/s) against ~403 MB of
// traffic (~0.120 ms at 3.35 TB/s): both bounds are close.  Four warps
// owning 16 keys each would hold dK and dV of their keys in 2 x 96
// float32 registers a thread before S^T, dP^T and their bf16 fragments --
// past the 255 a thread may have (at D = 128 the q tile already had to
// shrink to 32 rows to fit).  So the dK/dV block runs 8 warps as two
// groups over the same 64 keys, paired warp w with warp w + 4 (the same
// 16 keys), and splits D between them: group 0 keeps dK and dV of columns
// 0..95, group 1 of columns 96..191 (2 x 48 accumulators a thread).  The
// score products are not repeated: for each 64-row q tile group 0 computes
// S^T = K Q^T and P^T (mask, exp against lse), group 1 dP^T = V dO^T;
// group 0 hands P^T to its partner through shared memory in float32 (the
// C fragments, lane for lane, 16 KB), the partner forms dS^T = P^T (dP^T -
// D_i) and hands it back as bf16 A fragments (8 KB); each pair meets at a
// named barrier of its own 64 threads, so a pair waits only on itself.
// Group 0 runs its half of dV += P^T dO while group 1 forms dS^T.  Both
// groups then round the same float32 P and dS, so every column sees the
// numbers the 4-warp kernel would give.  Shared memory: 169 KB a block
// (K, V, two stages of Q, dO, lse, D_i, and the exchange), one block of
// 256 threads an SM.  The dQ block keeps its 4 warps and 64 query rows
// with 32-key tiles at D = 192 (dQ's 96 accumulators a thread, S and dP
// of 32 keys): no exchange, the same products.
//
// D = 160 (stablelm-12b's training: b=1, s=1024, H=32, K=8, causal) takes
// the same two blocks.  The 4-warp dK/dV block would hold 2 x 80 float32
// accumulators a thread before S^T, dP^T and their fragments, past 255
// registers; a 32-row q tile would halve the products a K/V tile's load
// buys.  So the split block runs at D/2 = 80 columns a warp group (10
// n-tiles of 8: 2 x 40 accumulators a thread), and the dQ block at 32-key
// tiles (80 accumulators).  A 160-wide row is 20 16-byte chunks, no power
// of two: Tile<160> gives each row 24 chunk slots (the forward's layout),
// so the XOR swizzle stays inside each 8-chunk group and the head dim is
// not padded (zero columns would cost a fifth more products).  The
// function needs 5 products of 2 x 32 x 524,800 x 160 flops at that shape
// (2.69e10, ~0.027 ms at 989 TFLOP/s) against ~52 MB (~0.016 ms).
//
// float32 keeps the first version's bodies on the CUDA cores, chosen by
// the template type (TF32 cannot hold the 2e-5 the float32 callers are
// held to): 256 threads, 32 x 32 float32 tiles with rows padded by one
// word, thread t owning score row t/8 and columns t%8 + 8j, P and dS
// through shared memory.  No main path runs it on the card.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::from_f;
using repro::to_f;
using repro::warp_sum;

// the float32 bodies' tiles
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

// ------------------------------------------------- float32, CUDA cores --

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

// ---------------------------------------------------------------- bf16 --

using repro::bf16;
using repro::Tile;

constexpr int MMA_THREADS = 128;  // four warps
constexpr int MMA_KEYS = 64;      // keys per k tile
constexpr int MMA_ROWS = 64;      // query rows of a dQ block
constexpr float LOG2E = 1.4426950408889634f;

// query rows per q tile of the dK/dV block
template <int D>
struct DkdvRows {
  static constexpr int value = D <= 64 ? 64 : 32;
};

template <int D>
constexpr int dkdv_smem_bytes() {
  constexpr int QR = DkdvRows<D>::value;
  return (2 * Tile<D>::elems(MMA_KEYS) + 4 * Tile<D>::elems(QR)) * (int)sizeof(bf16) +
         4 * QR * (int)sizeof(float);
}

// keys per k tile of the dQ block: 32 at D = 160 and 192, where dQ alone
// is 80 and 96 float32 registers a thread
template <int D>
struct DqKeys {
  static constexpr int value = D > 128 ? 32 : MMA_KEYS;
};

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * Tile<D>::elems(MMA_ROWS) + 4 * Tile<D>::elems(DqKeys<D>::value)) *
         (int)sizeof(bf16);
}

// the dK/dV block of D = 160 and 192: two groups of four warps split D
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_QR = 64;  // query rows per q tile

template <int D>
constexpr int dkdv_split_smem_bytes() {
  constexpr int QR = SPLIT_QR;
  return (2 * Tile<D>::elems(MMA_KEYS) + 4 * Tile<D>::elems(QR)) * (int)sizeof(bf16) +
         4 * QR * (int)sizeof(float) +            // lse, D_i: 2 stages each
         4 * (QR / 8) * 4 * 32 * (int)sizeof(float) +   // P^T, float32 C fragments
         4 * (QR / 16) * 4 * 32 * (int)sizeof(uint32_t);  // dS^T, bf16 A fragments
}

// the 64 threads of warps w and w + 4 (w < 4) wait for each other
__device__ __forceinline__ void pair_sync(int w4) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + w4) : "memory");
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ Di,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int H,
             int K, int causal, int window, float scale) {
  constexpr int KEYS = MMA_KEYS, QR = DkdvRows<D>::value, THREADS = MMA_THREADS;
  constexpr int KE = Tile<D>::elems(KEYS), QE = Tile<D>::elems(QR);
  extern __shared__ uint4 smem_mma[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_mma);          // (KEYS, D)
  bf16* Vs = Ks + KE;                                     // (KEYS, D)
  bf16* Qs = Vs + KE;                                     // 2 stages of (QR, D)
  bf16* dOs = Qs + 2 * QE;                                // 2 stages of (QR, D)
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * QE);  // 2 stages of (QR)
  float* Di_s = lse_s + 2 * QR;                           // 2 stages of (QR)

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * KEYS;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const long long qstride = (long long)H * D, kstride = (long long)K * D;
  const bf16* kb = k + ((size_t)b * sk * K + kh) * D;
  const bf16* vb = v + ((size_t)b * sk * K + kh) * D;

  // the q tiles whose rows see a key of this tile: row i sees key j iff
  // j <= i (causal) and i < j + window (window); for each of the G heads
  const int qt_first = causal ? k0 / QR : 0;
  const int q_end = window ? min(sq, k0 + KEYS - 1 + window) : sq;
  const int nq = max(0, (q_end + QR - 1) / QR - qt_first);
  const int n_it = G * nq;

  // step `it` (head kh * G + it / nq, q tile qt_first + it % nq) into stage st
  auto load_step = [&](int it, int st) {
    const int hh = kh * G + it / nq;
    const int q0 = (qt_first + it % nq) * QR;
    const size_t off = ((size_t)b * sq * H + hh) * D;
    repro::load_tile<D, QR, THREADS>(Qs + st * QE, q + off, qstride, q0, sq);
    repro::load_tile<D, QR, THREADS>(dOs + st * QE, dout + off, qstride, q0, sq);
    if (threadIdx.x < QR) {
      const int qi = q0 + threadIdx.x;
      const size_t r = ((size_t)b * H + hh) * sq + (qi < sq ? qi : 0);
      repro::cp_async4(lse_s + st * QR + threadIdx.x, lse + r, qi < sq);
      repro::cp_async4(Di_s + st * QR + threadIdx.x, Di + r, qi < sq);
    }
  };

  repro::load_tile<D, KEYS, THREADS>(Ks, kb, kstride, k0, sk);
  repro::load_tile<D, KEYS, THREADS>(Vs, vb, kstride, k0, sk);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < n_it) load_step(i, i);
    repro::cp_async_commit();
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const int key0 = k0 + 16 * w + g;  // this thread's keys: key0 and key0 + 8
  const float sl2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    repro::cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt_first + it % nq) * QR;
    const bf16* Qt = Qs + st * QE;
    const bf16* dOt = dOs + st * QE;
    const float* lt = lse_s + st * QR;
    const float* dt = Di_s + st * QR;

    float s[QR / 8][4], dp[QR / 8][4];
#pragma unroll
    for (int n = 0; n < QR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    repro::mma_abt<D, QR / 8>(s, Ks, 16 * w, Qt, lane);    // S^T = K Q^T
    repro::mma_abt<D, QR / 8>(dp, Vs, 16 * w, dOt, lane);  // dP^T = V dO^T

    const bool edge = q0 + QR > sq || k0 + KEYS > sk || (causal && k0 + KEYS - 1 > q0) ||
                      (window && k0 <= q0 + QR - 1 - window);
#pragma unroll
    for (int n = 0; n < QR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * n + 2 * t + (e & 1);  // the column's query row in the tile
        float p = exp2f(s[n][e] * sl2 - lt[ql] * LOG2E);
        if (edge) {
          const int qi = q0 + ql, kp = key0 + 8 * (e >> 1);
          const bool live = qi < sq && kp < sk && (!causal || kp <= qi) &&
                            (!window || kp > qi - window);
          p = live ? p : 0.f;  // a select: p may be inf off the band
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dt[ql]);
      }
    uint32_t pa[QR / 16][4], da[QR / 16][4];
    repro::c_to_a<QR / 8>(pa, s);
    repro::c_to_a<QR / 8>(da, dp);
    repro::mma_ab<D, QR / 16>(dv_acc, pa, dOt, lane);  // dV += P^T dO
    repro::mma_ab<D, QR / 16>(dk_acc, da, Qt, lane);   // dK += dS^T Q

    __syncthreads();  // every warp is done with this stage
    if (it + 2 < n_it) load_step(it + 2, st);
    repro::cp_async_commit();
  }

  repro::cp_async_wait<0>();  // with no q tile, K and V may still be arriving
  __syncthreads();
  // through the warp's own rows of the K and V tiles, which no other warp reads
  const size_t off = ((size_t)b * sk * K + kh) * D;
  repro::store_rows<D>(dk_acc, scale, scale, Ks, 16 * w, dk + off, kstride, k0 + 16 * w, sk,
                       lane);
  repro::store_rows<D>(dv_acc, 1.f, 1.f, Vs, 16 * w, dv + off, kstride, k0 + 16 * w, sk, lane);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
bwd_dkdv_split_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ Di,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int H,
                   int K, int causal, int window, float scale) {
  constexpr int KEYS = MMA_KEYS, QR = SPLIT_QR, THREADS = SPLIT_THREADS;
  constexpr int DH = D / 2;  // the columns of dK and dV a group keeps
  constexpr int KE = Tile<D>::elems(KEYS), QE = Tile<D>::elems(QR);
  constexpr int NP = QR / 8, NA = QR / 16;  // C and A fragments of a q tile
  extern __shared__ uint4 smem_mma[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_mma);          // (KEYS, D)
  bf16* Vs = Ks + KE;                                     // (KEYS, D)
  bf16* Qs = Vs + KE;                                     // 2 stages of (QR, D)
  bf16* dOs = Qs + 2 * QE;                                // 2 stages of (QR, D)
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * QE);  // 2 stages of (QR)
  float* Di_s = lse_s + 2 * QR;                           // 2 stages of (QR)
  float* Px = Di_s + 2 * QR;                              // (4, NP, 4, 32) P^T
  uint32_t* dSx = reinterpret_cast<uint32_t*>(Px + 4 * NP * 4 * 32);  // (4, NA, 4, 32)

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = w >> 2, w4 = w & 3;  // group, and the pair's 16 keys
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * KEYS;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const long long qstride = (long long)H * D, kstride = (long long)K * D;
  const bf16* kb = k + ((size_t)b * sk * K + kh) * D;
  const bf16* vb = v + ((size_t)b * sk * K + kh) * D;

  const int qt_first = causal ? k0 / QR : 0;
  const int q_end = window ? min(sq, k0 + KEYS - 1 + window) : sq;
  const int nq = max(0, (q_end + QR - 1) / QR - qt_first);
  const int n_it = G * nq;

  auto load_step = [&](int it, int st) {
    const int hh = kh * G + it / nq;
    const int q0 = (qt_first + it % nq) * QR;
    const size_t off = ((size_t)b * sq * H + hh) * D;
    repro::load_tile<D, QR, THREADS>(Qs + st * QE, q + off, qstride, q0, sq);
    repro::load_tile<D, QR, THREADS>(dOs + st * QE, dout + off, qstride, q0, sq);
    if (threadIdx.x < QR) {
      const int qi = q0 + threadIdx.x;
      const size_t r = ((size_t)b * H + hh) * sq + (qi < sq ? qi : 0);
      repro::cp_async4(lse_s + st * QR + threadIdx.x, lse + r, qi < sq);
      repro::cp_async4(Di_s + st * QR + threadIdx.x, Di + r, qi < sq);
    }
  };

  repro::load_tile<D, KEYS, THREADS>(Ks, kb, kstride, k0, sk);
  repro::load_tile<D, KEYS, THREADS>(Vs, vb, kstride, k0, sk);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < n_it) load_step(i, i);
    repro::cp_async_commit();
  }

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const int key0 = k0 + 16 * w4 + g;  // this thread's keys: key0 and key0 + 8
  const int c0 = grp * (DH / 8);      // this group's first column chunk
  const float sl2 = scale * LOG2E;
  float* px = Px + w4 * NP * 4 * 32 + lane;
  uint32_t* dsx = dSx + w4 * NA * 4 * 32 + lane;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    repro::cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt_first + it % nq) * QR;
    const bf16* Qt = Qs + st * QE;
    const bf16* dOt = dOs + st * QE;

    uint32_t pa[NA][4], da[NA][4];
    if (grp == 0) {
      // S^T = K Q^T, then P^T = exp(S^T scale - lse) inside the band
      const float* lt = lse_s + st * QR;
      float s[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      repro::mma_abt<D, NP>(s, Ks, 16 * w4, Qt, lane);
      const bool edge = q0 + QR > sq || k0 + KEYS > sk || (causal && k0 + KEYS - 1 > q0) ||
                        (window && k0 <= q0 + QR - 1 - window);
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * n + 2 * t + (e & 1);  // the column's query row in the tile
          float p = exp2f(s[n][e] * sl2 - lt[ql] * LOG2E);
          if (edge) {
            const int qi = q0 + ql, kp = key0 + 8 * (e >> 1);
            const bool live = qi < sq && kp < sk && (!causal || kp <= qi) &&
                              (!window || kp > qi - window);
            p = live ? p : 0.f;  // a select: p may be inf off the band
          }
          s[n][e] = p;
          px[(n * 4 + e) * 32] = p;
        }
      repro::c_to_a<NP>(pa, s);
      pair_sync(w4);                                           // P^T is out
      repro::mma_ab_cols<D, DH, NA>(dv_acc, pa, dOt, c0, lane);  // dV += P^T dO
      pair_sync(w4);                                           // dS^T is in
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) da[j][r] = dsx[(j * 4 + r) * 32];
    } else {
      // dP^T = V dO^T, then dS^T = P^T (dP^T - D_i) from the partner's P^T
      const float* dt = Di_s + st * QR;
      float dp[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
      repro::mma_abt<D, NP>(dp, Vs, 16 * w4, dOt, lane);
      pair_sync(w4);                                           // P^T is out
      float p[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[n][e] = px[(n * 4 + e) * 32];
          dp[n][e] = p[n][e] * (dp[n][e] - dt[8 * n + 2 * t + (e & 1)]);
        }
      repro::c_to_a<NP>(pa, p);
      repro::c_to_a<NP>(da, dp);
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsx[(j * 4 + r) * 32] = da[j][r];
      pair_sync(w4);                                           // dS^T is in
      repro::mma_ab_cols<D, DH, NA>(dv_acc, pa, dOt, c0, lane);  // dV += P^T dO
    }
    repro::mma_ab_cols<D, DH, NA>(dk_acc, da, Qt, c0, lane);     // dK += dS^T Q

    __syncthreads();  // every warp is done with this stage and the exchange
    if (it + 2 < n_it) load_step(it + 2, st);
    repro::cp_async_commit();
  }

  repro::cp_async_wait<0>();  // with no q tile, K and V may still be arriving
  __syncthreads();
  // through the pair's rows of the K and V tiles, each group its own chunks
  const size_t off = ((size_t)b * sk * K + kh) * D;
  repro::store_rows_cols<D, DH>(dk_acc, scale, scale, Ks, 16 * w4, c0, dk + off, kstride,
                                k0 + 16 * w4, sk, lane);
  repro::store_rows_cols<D, DH>(dv_acc, 1.f, 1.f, Vs, 16 * w4, c0, dv + off, kstride,
                                k0 + 16 * w4, sk, lane);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ Di,
           bf16* __restrict__ dq, int sq, int sk, int H, int K, int causal,
           int window, float scale) {
  constexpr int KEYS = DqKeys<D>::value, ROWS = MMA_ROWS, THREADS = MMA_THREADS;
  constexpr int QE = Tile<D>::elems(ROWS), KE = Tile<D>::elems(KEYS);
  extern __shared__ uint4 smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // (ROWS, D)
  bf16* dOs = Qs + QE;                            // (ROWS, D)
  bf16* Ks = dOs + QE;                            // 2 stages of (KEYS, D)
  bf16* Vs = Ks + 2 * KE;                         // 2 stages of (KEYS, D)

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * ROWS;
  const int q_last = min(q0 + ROWS, sq) - 1;
  const int n_kt = (sk + KEYS - 1) / KEYS;
  const int kt_end = causal ? min(n_kt, q_last / KEYS + 1) : n_kt;
  const int kt_begin = (window && q0 - window + 1 > 0) ? (q0 - window + 1) / KEYS : 0;

  const long long qstride = (long long)H * D, kstride = (long long)K * D;
  const size_t qoff = ((size_t)b * sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * sk * K + kh) * D;
  const bf16* vb = v + ((size_t)b * sk * K + kh) * D;

  repro::load_tile<D, ROWS, THREADS>(Qs, q + qoff, qstride, q0, sq);
  repro::load_tile<D, ROWS, THREADS>(dOs, dout + qoff, qstride, q0, sq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kt_begin + i < kt_end) {
      repro::load_tile<D, KEYS, THREADS>(Ks + i * KE, kb, kstride, (kt_begin + i) * KEYS, sk);
      repro::load_tile<D, KEYS, THREADS>(Vs + i * KE, vb, kstride, (kt_begin + i) * KEYS, sk);
    }
    repro::cp_async_commit();
  }

  // lse (in log2 units) and D_i of this thread's rows, row0 and row0 + 8;
  // rows past sq are never stored
  const int row0 = q0 + 16 * w + g;
  float l2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    const size_t r = ((size_t)b * H + h) * sq + qi;
    l2[i] = qi < sq ? lse[r] * LOG2E : 0.f;
    di[i] = qi < sq ? Di[r] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    repro::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * KE;
    const bf16* Vt = Vs + st * KE;

    float s[KEYS / 8][4], dp[KEYS / 8][4];
#pragma unroll
    for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    repro::mma_abt<D, KEYS / 8>(s, Qs, 16 * w, Kt, lane);    // S = Q K^T
    repro::mma_abt<D, KEYS / 8>(dp, dOs, 16 * w, Vt, lane);  // dP = dO V^T

    const int k0 = kt * KEYS;
    const bool edge = q0 + ROWS > sq || k0 + KEYS > sk || (causal && k0 + KEYS - 1 > q0) ||
                      (window && k0 <= q_last - window);
#pragma unroll
    for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] * sl2 - l2[e >> 1]);
        if (edge) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const int qi = row0 + 8 * (e >> 1);
          const bool live = qi < sq && kp < sk && (!causal || kp <= qi) &&
                            (!window || kp > qi - window);
          p = live ? p : 0.f;  // a select: p may be inf off the band
        }
        dp[n][e] = p * (dp[n][e] - di[e >> 1]);
      }
    uint32_t da[KEYS / 16][4];
    repro::c_to_a<KEYS / 8>(da, dp);
    repro::mma_ab<D, KEYS / 16>(dq_acc, da, Kt, lane);  // dQ += dS K

    __syncthreads();  // every warp is done with this stage
    if (kt + 2 < kt_end) {
      repro::load_tile<D, KEYS, THREADS>(Ks + st * KE, kb, kstride, (kt + 2) * KEYS, sk);
      repro::load_tile<D, KEYS, THREADS>(Vs + st * KE, vb, kstride, (kt + 2) * KEYS, sk);
    }
    repro::cp_async_commit();
  }

  repro::cp_async_wait<0>();  // with no k tile, Q may still be arriving
  __syncthreads();
  repro::store_rows<D>(dq_acc, scale, scale, Qs, 16 * w, dq + qoff, qstride, q0 + 16 * w, sq,
                       lane);
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

  if constexpr (std::is_same<T, float>::value) {
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
  } else {
    if constexpr (D > 128) {  // 160, 192: the split dK/dV block, two groups of four warps
      constexpr int dkdv_smem = dkdv_split_smem_bytes<D>();
      auto dkdv = bwd_dkdv_split_mma<D>;
      err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
      if (err != cudaSuccess) return err;
      dkdv<<<dim3((sk + MMA_KEYS - 1) / MMA_KEYS, K, b), SPLIT_THREADS, dkdv_smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, Di,
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, H, K, causal, window,
          scale);
    } else {
      constexpr int dkdv_smem = dkdv_smem_bytes<D>();
      auto dkdv = bwd_dkdv_mma<D>;
      err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
      if (err != cudaSuccess) return err;
      dkdv<<<dim3((sk + MMA_KEYS - 1) / MMA_KEYS, K, b), MMA_THREADS, dkdv_smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, Di,
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, H, K, causal, window,
          scale);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    constexpr int dq_smem = dq_smem_bytes<D>();
    auto dqk = bwd_dq_mma<D>;
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (err != cudaSuccess) return err;
    dqk<<<dim3((sq + MMA_ROWS - 1) / MMA_ROWS, H, b), MMA_THREADS, dq_smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, Di,
        static_cast<bf16*>(dq), sq, sk, H, K, causal, window, scale);
  }
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
    case 160: return launch<T, 160>(q, k, v, o, dout, lse, Di, dq, dk, dv, b, sq, sk, H, K, causal, window, scale, s);
    case 192: return launch<T, 192>(q, k, v, o, dout, lse, Di, dq, dk, dv, b, sq, sk, H, K, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (b, sq, H, D); k, v, dk, dv (b, sk, K, D), all contiguous,
// 16-byte aligned and of one dtype; lse (b, H, sq) float32 from the forward kernel; Di
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
