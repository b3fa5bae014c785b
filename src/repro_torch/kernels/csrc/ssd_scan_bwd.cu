// The gradient of the Mamba2 SSD chunked scan for Hopper (sm_90a), one B/C
// group: given dy (and, optionally, the final state's gradient), dx, ddt_raw,
// dA_log, dB, dC, dD and ddt_bias of ssd_scan.cu's function.
//
// Replaces: no Pallas kernel.  The JAX package's ssd_scan
// (src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan) has no VJP; it trains by
// autodiff of the chunked form (src/repro/models/mamba2.py::ssd_chunked).
// This is that gradient written out, chunk by chunk, as ref.py's
// ssd_scan_bwd_ref computes it (see there for the terms).
//
// What bounds it on an H100: a call reads x, dt_raw, B, C and dy once and
// writes dx, ddt_raw, dB, dC and the (h,) gradients once: at mamba2-130m's
// training microbatch (b=1, s=1024, h=24, P=64, N=128, bf16) 10,584,640 B,
// 0.0032 ms at 3.35 TB/s.  The six P x N products that every chunk length
// needs come to 2.42 GFLOP there (0.0024 ms on the bf16 tensor cores), so the
// bytes bind.  This design runs the products on the tensor cores; what still
// goes through device memory is each chunk's state and state gradient (25 MB
// at the training shape), written by kernels 1 and 2 and read by kernel 3.
//
// bfloat16 design (chunk L = 64 rows; a ragged tail padded with dt = 0, as
// the forward pads it), grids at the training shape (nc = 16 chunks):
//   1. ssd_bwd_chunk_mma, grid (chunk, head, batch) = (16, 24, 1), P / 16
//      warps: each chunk's state update (w o x)^T B and the gradient it sends
//      back from its outputs, (e o dy)^T C, P x N float32 on mma.sync, with
//      w_j = dt_j exp(cum_L - cum_j), e_i = exp(cum_i) and cum the in-chunk
//      cumsum of dt A, and its summed log-decay.  The head-0 block of a chunk
//      also writes the chunk's C.B^T (L x L float32): once per (batch,
//      chunk), b nc times a call, since B and C are one group for all heads.
//   2. ssd_bwd_pass<true>, elementwise, grid (P N / 2048, head, 2 batch) =
//      (4, 24, 2): the sequential passes over the chunks, forward for the
//      state entering each chunk and in reverse (the second half of the
//      grid) for the gradient of the state leaving it, in place, the running
//      sums float32, each eight floats written back in their own 32 bytes as
//      eight bf16 hi and eight lo: the tiles kernel 3 copies (cp.async).
//   3. ssd_bwd_grads_mma, grid (head group, chunk, batch) = (6, 16, 1) in
//      clusters of the 6 groups of a (batch, chunk), 8 warps, a block walking
//      its group's 4 heads.  The host sizes the groups from the clusters the
//      card holds at once: an H100 holds 15 clusters of 8, so 8 groups of 3
//      heads would take two waves for the 16 chunks.  Warps 0-3 take 16 rows
//      j each of G B_j, sum_i M_ij dy_i and dx (M = (C.B^T) o exp(cum_i -
//      cum_j), formed per head from the shared tile) and add (w o x) G into
//      the group's dB; warps 4-7 take 16 rows i each of dy.x^T, Q = dy.x^T o
//      decay o dt_j, the row and column sums of Z = M o dy.x^T that the
//      gradient of cum needs, <G, S>, S C_i, and add (e o dy) S into the
//      group's dC.  Q is summed over the group's heads in shared memory (its
//      owner thread adds, in head order), and after the last head Q^T C joins
//      dB and Q B joins dC: one L x L x N product each a block, since C and B
//      are the group's.  After a head's products the next head's tiles load
//      while warp 0 turns the head's vectors into ddt_raw and the head's
//      shares of dA_log, dD and ddt_bias.  The group's dB and dC (L x N
//      float32) then go to its shared memory, and block k of the cluster sums
//      rows k L / G .. of every block's, over the blocks in rank order
//      through distributed shared memory, and writes them.
//   4. ssd_bwd_sum_vec: the (h,) vectors over the (batch, chunk) slots.
// No atomics: every sum runs in a fixed order, so a call's result does not
// change between runs.  Scratch (float32): the per-chunk states and
// gradients (b, nc, h, P, N) each, C.B^T (b, nc, L, L), the log-decays and
// the vectors' shares -- 25,434,112 B at the training shape; no (b, s, h, N)
// array, since the heads' dB and dC are summed on chip.  Shared memory: 50,688
// B a chunk block, 156,992 B a grads block (one an SM; the training grid is
// 96 blocks on 132 SMs).
//
// Rounding before an mma, as ssd_scan.cu: B, C, x and dy are bf16 already, so
// C.B^T and dy.x^T go in as they are (exact products, float32 sums).  Every
// float32 operand goes in as two bf16 halves, hi = bf16(v) and lo = bf16(v -
// hi), through two mma's: w o x and e o dy (split in registers as their
// fragments are loaded: ssd_bwd_chunk_mma's A operands, and the A operands of
// (w o x) G and (e o dy) S), M and Q (formed in registers from float32
// shared memory), and the states S and G (split by the pass, kernel 2).
// Where both operands are float32 -- (w o x) G and (e o dy) S -- three mma's
// take hi.hi + hi.lo + lo.hi.  The dcum / ddt vector terms whose products
// cancel in math stay on the CUDA cores in float32, each such product rounded
// once (__fmul_rn), so that at one row dA_log comes out 0.
//
// float32 keeps the first version's body on the CUDA cores (TF32 cannot hold
// the 2e-3 the float32 callers are held to), chosen by the dtype: every
// product a float32 sum from operands in padded shared memory, the pass of
// kernel 2 in float32, the heads' dB and dC shares through (b, s, h, N)
// float32 arrays summed by a further kernel.  No main path runs it on the
// card.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::bf16;
using repro::from_f;
using repro::to_f;
using repro::Tile;

constexpr int L = 64;      // rows per chunk
constexpr int NT = 256;    // threads per block of the float32 body

// out(r, c) = sum_k A(k, r) B(k, c) for r < R, c < CC, k < K, where A(k, r) =
// a[k * ak + r * ar] and B(k, c) = b[k * bk + c * bc] lie in shared memory.
// Each thread takes 4 x 4 tiles of the output and hands each to
// epi(r0, c0, acc); a given (R, CC) maps a tile to the same thread whatever
// the operands, so two products of one shape may add into one output.
template <int R, int CC, int K, typename Epi>
__device__ __forceinline__ void mm(const float* a, int ak, int ar, const float* b, int bk,
                                   int bc, Epi epi) {
  static_assert(R % 4 == 0 && CC % 4 == 0, "4 x 4 tiles");
  constexpr int NCT = CC / 4, TILES = (R / 4) * NCT;
  for (int t = threadIdx.x; t < TILES; t += NT) {
    const int r0 = (t / NCT) * 4, c0 = (t % NCT) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[k * ak + (r0 + i) * ar];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b[k * bk + (c0 + j) * bc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    epi(r0, c0, acc);
  }
}

// rows t0 .. t0 + L - 1 of a (rows, W)-wide matrix with row stride ld into
// dst[i * (W + 1) + c] as float; rows at or past S are zeros
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long ld,
                                          int t0, int S) {
  for (int e = threadIdx.x; e < L * W; e += NT) {
    const int i = e / W, c = e % W, t = t0 + i;
    dst[i * (W + 1) + c] = t < S ? to_f(src[(size_t)t * ld + c]) : 0.f;
  }
}

constexpr int VPER = L / 32;     // consecutive rows of a chunk a lane takes in its vectors

// a lane's rows of dt_raw for the chunk at row t0 (0 at or past S)
template <typename T>
__device__ __forceinline__ void dt_rows(float (&raw)[VPER], const T* __restrict__ dt_raw,
                                        size_t row0, int H, int t0, int S) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < VPER; ++k) {
    const int t = t0 + lane * VPER + k;
    raw[k] = t < S ? to_f(dt_raw[(row0 + t) * H]) : 0.f;
  }
}

// The chunk's vectors, by one warp from its lanes' rows of dt_raw (dt_rows):
// dt = softplus(r), r = dt_raw + dt_bias (0 at or past S), cum the inclusive
// cumsum of dt A, e = exp(cum), te = exp(cum_L - cum) and w = dt te; r is
// kept for softplus' derivative.
__device__ __forceinline__ void chunk_vectors_from(const float (&raw)[VPER], int t0, int S,
                                                   float A, float dtb, float* r_, float* dt_,
                                                   float* cum_, float* e_, float* te_,
                                                   float* w_) {
  const int lane = threadIdx.x & 31;
  float d[VPER], v[VPER];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < VPER; ++k) {
    const int i = lane * VPER + k, t = t0 + i;
    d[k] = 0.f;
    float r = 0.f;
    if (t < S) {                // softplus, as jax.nn.softplus
      r = raw[k] + dtb;
      d[k] = fmaxf(r, 0.f) + log1pf(expf(-fabsf(r)));
    }
    r_[i] = r;
    run += d[k] * A;
    v[k] = run;
  }
  float incl = run;             // inclusive scan of the lanes' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int k = 0; k < VPER; ++k) {
    const int i = lane * VPER + k;
    const float c = incl - run + v[k];
    dt_[i] = d[k];
    cum_[i] = c;
    e_[i] = expf(c);
    te_[i] = expf(last - c);
    w_[i] = d[k] * te_[i];
  }
}

// the chunk's vectors, by one warp, dt_raw at the head's column
template <typename T>
__device__ __forceinline__ void chunk_vectors(const T* __restrict__ dt_raw, size_t row0, int H,
                                              int t0, int S, float A, float dtb, float* r_,
                                              float* dt_, float* cum_, float* e_, float* te_,
                                              float* w_) {
  float raw[VPER];
  dt_rows(raw, dt_raw, row0, H, t0, S);
  chunk_vectors_from(raw, t0, S, A, dtb, r_, dt_, cum_, e_, te_, w_);
}

// the sum of v over the block, on every thread (red: NT / 32 floats)
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = repro::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <int P, int N>
constexpr int chunk_smem() {
  return (2 * L * (P + 1) + 2 * L * (N + 1) + 6 * L) * 4;
}

// float32 1. Grid (nc, H, b).  upd and dsy (b, nc, H, P, N) float32: the chunk's
// sum_j w_j x_j B_j^T and sum_i e_i dy_i C_i^T; cum_l (b, nc, H) its summed
// log-decay.
template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_bwd_chunk(const T* __restrict__ x, const T* __restrict__ dt_raw,
              const float* __restrict__ A_log, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const float* __restrict__ dt_bias,
              const T* __restrict__ dy, float* __restrict__ upd, float* __restrict__ dsy,
              float* __restrict__ cum_l, int S, int H) {
  extern __shared__ __align__(16) float chunk_mem[];
  float* xw = chunk_mem;               // (L, P + 1) w_j x_j
  float* dye = xw + L * (P + 1);       // (L, P + 1) e_i dy_i
  float* Bs = dye + L * (P + 1);       // (L, N + 1)
  float* Cs = Bs + L * (N + 1);        // (L, N + 1)
  float* r_ = Cs + L * (N + 1);
  float* dt_ = r_ + L;
  float* cum_ = dt_ + L;
  float* e_ = cum_ + L;
  float* te_ = e_ + L;
  float* w_ = te_ + L;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L;
  const float A = -expf(A_log[h]);
  if (threadIdx.x < 32)
    chunk_vectors(dt_raw + h, (size_t)b * S, H, t0, S, A, dt_bias[h], r_, dt_, cum_, e_, te_,
                  w_);
  const size_t xoff = (size_t)b * S * H * P + (size_t)h * P;
  load_rows<T, P>(xw, x + xoff, (long long)H * P, t0, S);
  load_rows<T, P>(dye, dy + xoff, (long long)H * P, t0, S);
  load_rows<T, N>(Bs, Bm + (size_t)b * S * N, N, t0, S);
  load_rows<T, N>(Cs, Cm + (size_t)b * S * N, N, t0, S);
  __syncthreads();
  for (int e = threadIdx.x; e < L * P; e += NT) {
    const int i = e / P, p = e % P;
    xw[i * (P + 1) + p] *= w_[i];
    dye[i * (P + 1) + p] *= e_[i];
  }
  __syncthreads();
  const size_t slot = ((size_t)b * nc + c) * H + h;
  float* u = upd + slot * P * N;
  float* g = dsy + slot * P * N;
  mm<P, N, L>(xw, P + 1, 1, Bs, N + 1, 1, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) u[(r0 + i) * N + c0 + j] = acc[i][j];
  });
  mm<P, N, L>(dye, P + 1, 1, Cs, N + 1, 1, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[(r0 + i) * N + c0 + j] = acc[i][j];
  });
  if (threadIdx.x == 0) cum_l[slot] = cum_[L - 1];
}

template <int P, int N>
constexpr int grads_smem() {
  return (2 * L * (P + 1) + 3 * L * (N + 1) + 3 * L * (L + 1) + L * (P + 1) + 16 * L +
          NT / 32 + 4) * 4;
}

// float32 3. Grid (nc, H, b).  states / grads: the passes' outputs.  Writes dx and
// ddt_raw (in T, rows < S), the head's dB and dC, dbp and dcp (b, S, H, N)
// float32, and the chunk's partial sums vec (3, b, nc, H): dA, dD, ddt_bias.
template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_bwd_grads(const T* __restrict__ x, const T* __restrict__ dt_raw,
              const float* __restrict__ A_log, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const float* __restrict__ Dv,
              const float* __restrict__ dt_bias, const T* __restrict__ dy,
              const float* __restrict__ states, const float* __restrict__ grads,
              T* __restrict__ dx, T* __restrict__ ddt_raw, float* __restrict__ dbp,
              float* __restrict__ dcp, float* __restrict__ vec, int S, int H) {
  constexpr int XP = P + 1, BN = N + 1, LL = L + 1;
  extern __shared__ __align__(16) float grads_mem[];
  float* xs = grads_mem;               // (L, P + 1)
  float* dys = xs + L * XP;            // (L, P + 1)
  float* Bs = dys + L * XP;            // (L, N + 1)
  float* Cs = Bs + L * BN;             // (L, N + 1)
  float* SG = Cs + L * BN;             // (P, N + 1): G, then S
  float* Mm = SG + L * BN;             // (L, L + 1) M_ij = (C_i.B_j) decay_ij
  float* Qm = Mm + L * LL;             // (L, L + 1) Q_ij = (dy_i.x_j) decay_ij dt_j
  float* Zm = Qm + L * LL;             // (L, L + 1) M_ij (dy_i.x_j)
  float* tmp = Zm + L * LL;            // (L, P + 1): G B_j, then S C_i
  float* r_ = tmp + L * XP;
  float* dt_ = r_ + L;
  float* cum_ = dt_ + L;
  float* e_ = cum_ + L;
  float* te_ = e_ + L;
  float* w_ = te_ + L;
  float* u_ = w_ + L;                  // x_j . G B_j
  float* yo_ = u_ + L;                 // e_i dy_i . S C_i
  float* da_ = yo_ + L;                // dcum, then its reverse cumsum
  float* red = da_ + L;                // NT / 32 + 4
  static_assert(P <= L, "S and G fit the L-row buffer");

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int t0 = c * L, tid = threadIdx.x;
  const float A = -expf(A_log[h]), Dh = Dv[h];
  const size_t slot = ((size_t)b * nc + c) * H + h;
  const float* Sg = states + slot * P * N;
  const float* Gg = grads + slot * P * N;
  if (tid < 32)
    chunk_vectors(dt_raw + h, (size_t)b * S, H, t0, S, A, dt_bias[h], r_, dt_, cum_, e_, te_,
                  w_);
  const size_t xoff = (size_t)b * S * H * P + (size_t)h * P;
  load_rows<T, P>(xs, x + xoff, (long long)H * P, t0, S);
  load_rows<T, P>(dys, dy + xoff, (long long)H * P, t0, S);
  load_rows<T, N>(Bs, Bm + (size_t)b * S * N, N, t0, S);
  load_rows<T, N>(Cs, Cm + (size_t)b * S * N, N, t0, S);
  for (int e = tid; e < P * N; e += NT) SG[(e / N) * BN + e % N] = Gg[e];
  // <G, S> and this chunk's dD share: sum dy . x (padded rows are 0)
  float gs = 0.f;
  for (int e = tid; e < P * N; e += NT) gs += Gg[e] * Sg[e];
  __syncthreads();
  float dd = 0.f;
  for (int e = tid; e < L * P; e += NT) dd += xs[(e / P) * XP + e % P] * dys[(e / P) * XP + e % P];
  gs = block_sum(gs, red);
  dd = block_sum(dd, red);

  // M = (C B^T) o decay, then Q and Z from dy x^T
  mm<L, L, N>(Cs, 1, BN, Bs, 1, BN, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ii = r0 + i, jj = c0 + j;
        Mm[ii * LL + jj] = jj <= ii ? acc[i][j] * expf(cum_[ii] - cum_[jj]) : 0.f;
      }
  });
  __syncthreads();
  mm<L, L, P>(dys, 1, XP, xs, 1, XP, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ii = r0 + i, jj = c0 + j;
        const float dec = jj <= ii ? expf(cum_[ii] - cum_[jj]) : 0.f;
        Qm[ii * LL + jj] = acc[i][j] * dec * dt_[jj];
        Zm[ii * LL + jj] = Mm[ii * LL + jj] * acc[i][j];
      }
  });
  // G B_j into tmp; x_j^T G times w_j is the head's first share of dB
  mm<L, P, N>(Bs, 1, BN, SG, 1, BN, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tmp[(r0 + i) * XP + c0 + j] = acc[i][j];
  });
  float* dbh = dbp + ((size_t)b * S * H + h) * N;       // row t at t * H * N
  float* dch = dcp + ((size_t)b * S * H + h) * N;
  mm<L, N, P>(xs, 1, XP, SG, BN, 1, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + r0 + i;
      if (t >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) dbh[(size_t)t * H * N + c0 + j] = w_[r0 + i] * acc[i][j];
    }
  });
  __syncthreads();
  if (tid < L) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += xs[tid * XP + p] * tmp[tid * XP + p];
    u_[tid] = s;
  }
  // dx_j = dt_j sum_i M_ij dy_i + w_j G B_j + D dy_j
  T* dxb = dx + xoff;
  mm<L, P, L>(Mm, LL, 1, dys, XP, 1, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jj = r0 + i, t = t0 + jj;
      if (t >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = c0 + j;
        dxb[(size_t)t * H * P + p] = from_f<T>(dt_[jj] * acc[i][j] + w_[jj] * tmp[jj * XP + p] +
                                               Dh * dys[jj * XP + p]);
      }
    }
  });
  __syncthreads();                     // G and tmp are read for the last time
  for (int e = tid; e < P * N; e += NT) SG[(e / N) * BN + e % N] = Sg[e];
  __syncthreads();
  // S C_i into tmp; e_i dy_i^T S is the head's first share of dC
  mm<L, P, N>(Cs, 1, BN, SG, 1, BN, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tmp[(r0 + i) * XP + c0 + j] = acc[i][j];
  });
  mm<L, N, P>(dys, 1, XP, SG, BN, 1, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + r0 + i;
      if (t >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) dch[(size_t)t * H * N + c0 + j] = e_[r0 + i] * acc[i][j];
    }
  });
  // the second shares, by the threads that wrote the first: dC_i += sum_j
  // Q_ij B_j, dB_j += sum_i Q_ij C_i
  mm<L, N, L>(Qm, 1, LL, Bs, BN, 1, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + r0 + i;
      if (t >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) dch[(size_t)t * H * N + c0 + j] += acc[i][j];
    }
  });
  mm<L, N, L>(Qm, LL, 1, Cs, BN, 1, [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + r0 + i;
      if (t >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) dbh[(size_t)t * H * N + c0 + j] += acc[i][j];
    }
  });
  __syncthreads();
  if (tid < L) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += dys[tid * XP + p] * tmp[tid * XP + p];
    yo_[tid] = e_[tid] * s;
  }
  __syncthreads();

  // the gradient of cum: dcum_k = sum_j Z_kj dt_j - dt_k sum_i Z_ik + yo_k -
  // w_k u_k, and cum_L's share, exp(cum_L) <G, S> + sum_j w_j u_j, which
  // every row's log-decay takes; ddt's direct part sum_i Z_ik + te_k u_k.
  // The products that cancel are rounded once each (__fmul_rn: no fused
  // multiply-add), so that terms that cancel in math cancel exactly: at one
  // row, dA_log is 0, as the plain version gives.
  if (tid < L) {
    const int k = tid;
    float row = 0.f, col = 0.f;
    for (int j = 0; j < L; ++j) row += Zm[k * LL + j] * dt_[j];
    for (int i = 0; i < L; ++i) col += Zm[i * LL + k];
    da_[k] = ((row - __fmul_rn(dt_[k], col)) + yo_[k]) - __fmul_rn(w_[k], u_[k]);
    yo_[k] = col + te_[k] * u_[k];
  }
  __syncthreads();
  float da_dt = 0.f, dr = 0.f;
  if (tid < L) {
    float s = expf(cum_[L - 1]) * gs;
    for (int j = 0; j < L; ++j) s += __fmul_rn(w_[j], u_[j]);
    for (int k = tid; k < L; ++k) s += da_[k];       // the reverse cumsum
    const int t = t0 + tid;
    if (t < S) {                         // softplus' derivative: sigmoid(r)
      dr = (yo_[tid] + A * s) / (1.f + expf(-r_[tid]));
      ddt_raw[((size_t)b * S + t) * H + h] = from_f<T>(dr);
    }
    da_dt = dt_[tid] * s;
  }
  da_dt = block_sum(da_dt, red);
  dr = block_sum(dr, red);
  if (tid == 0) {
    const size_t total = (size_t)gridDim.z * nc * H;
    vec[slot] = da_dt;
    vec[total + slot] = dd;
    vec[2 * total + slot] = dr;
  }
}

// float32 4a. dB and dC (rows, N) in T from the heads' shares (rows, H, N) float32,
// summed over the heads in order.  Grid over rows * N.
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_sum_bc(const float* __restrict__ dbp, const float* __restrict__ dcp, T* __restrict__ dB,
               T* __restrict__ dC, long long rows, int H, int N) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= rows * N) return;
  const long long row = e / N, n = e % N;
  const float* pb = dbp + row * H * N + n;
  const float* pc = dcp + row * H * N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[(size_t)h * N];
    sc += pc[(size_t)h * N];
  }
  dB[e] = from_f<T>(sb);
  dC[e] = from_f<T>(sc);
}

// 4. The (H,) gradients from the chunks' partials vec (3, nbc, H), summed
// over the nbc = b * nc (batch, chunk) slots in order: dA_log = A dA.
__global__ void __launch_bounds__(128)
ssd_bwd_sum_vec(const float* __restrict__ vec, const float* __restrict__ A_log,
                float* __restrict__ dA_log, float* __restrict__ dD, float* __restrict__ ddt_bias,
                int nbc, int H) {
  const int h = blockIdx.x * 128 + threadIdx.x;
  if (h >= H) return;
  const size_t total = (size_t)nbc * H;
  float a = 0.f, d = 0.f, r = 0.f;
  for (int i = 0; i < nbc; ++i) {
    a += vec[(size_t)i * H + h];
    d += vec[total + (size_t)i * H + h];
    r += vec[2 * total + (size_t)i * H + h];
  }
  dA_log[h] = a * -expf(A_log[h]);
  dD[h] = d;
  ddt_bias[h] = r;
}

// ------------------------------------------------------- bfloat16 path --

constexpr int LP = L + 4;      // padded row of the float32 L x L tiles
constexpr int GNT = 256;       // threads per block of ssd_bwd_grads_mma
constexpr int MAX_GROUPS = 8;  // head groups, the blocks of a cluster (portable size)

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// two floats as bf16 halves hi + lo, lo = bf16(v - hi), the first in the low half
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const float ah = bf_round(a), bh = bf_round(b);
  hi = repro::pack_bf16(ah, bh);
  lo = repro::pack_bf16(a - ah, b - bh);
}

// a register of two bf16 values, scaled by s0 and s1 in float32, as hi + lo
__device__ __forceinline__ void scale_split(uint32_t in, float s0, float s1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&in);
  split_pair(__low2float(v) * s0, __high2float(v) * s1, hi, lo);
}

// st (rows p0..p0+15 of P x N, float32 C fragments) += sum over the chunk's L
// rows j of s_j X_j^T Bt_j: X and Bt bf16 Tiles of L rows, s float32, the
// scaled X split into hi + lo as its fragments are loaded (ldmatrix.trans:
// register q holds rows j = 16 kk + 2t (+1), + 8 for q >= 2).  A k-step
// loads all its B fragments first, then runs the hi products over every n
// tile and then the lo ones, so that two products into one accumulator are
// N / 8 apart.
template <int P, int N>
__device__ __forceinline__ void scaled_xt_b(float (&st)[N / 8][4], const bf16* Xs,
                                            const float* s, const bf16* Bt, int p0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
    uint32_t xa[4], ah[4], al[4], bb[N / 16][4];
    repro::ldsm_x4_t(xa, Xs + Tile<P>::at(16 * kk + repro::b_row(lane),
                                          p0 / 8 + repro::b_chunk(lane)));
#pragma unroll
    for (int dp = 0; dp < N / 16; ++dp)
      repro::ldsm_x4_t(bb[dp], Bt + Tile<N>::at(16 * kk + repro::a_row(lane),
                                                2 * dp + repro::a_chunk(lane)));
    const int j = 16 * kk + 2 * t;
    scale_split(xa[0], s[j], s[j + 1], ah[0], al[0]);
    scale_split(xa[1], s[j], s[j + 1], ah[1], al[1]);
    scale_split(xa[2], s[j + 8], s[j + 9], ah[2], al[2]);
    scale_split(xa[3], s[j + 8], s[j + 9], ah[3], al[3]);
#pragma unroll
    for (int dp = 0; dp < N / 16; ++dp) {
      repro::mma_bf16(st[2 * dp], ah, bb[dp][0], bb[dp][1]);
      repro::mma_bf16(st[2 * dp + 1], ah, bb[dp][2], bb[dp][3]);
    }
#pragma unroll
    for (int dp = 0; dp < N / 16; ++dp) {
      repro::mma_bf16(st[2 * dp], al, bb[dp][0], bb[dp][1]);
      repro::mma_bf16(st[2 * dp + 1], al, bb[dp][2], bb[dp][3]);
    }
  }
}

// rows p0..p0+15 of a float32 C-fragment tile W columns wide into out (rows
// ld apart)
template <int W>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ out, int ld,
                                               const float (&st)[W / 8][4], int p0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    *reinterpret_cast<float2*>(out + (p0 + g) * ld + 8 * n + 2 * t) = make_float2(st[n][0], st[n][1]);
    *reinterpret_cast<float2*>(out + (p0 + g + 8) * ld + 8 * n + 2 * t) =
        make_float2(st[n][2], st[n][3]);
  }
}

// shared memory of ssd_bwd_chunk_mma, in bytes: x, dy, B and C of the chunk
// (bf16 Tiles), the chunk's vectors
template <int P, int N>
struct ChunkSmem {
  static constexpr int BYTES = (2 * Tile<P>::elems(L) + 2 * Tile<N>::elems(L)) * 2 + 6 * L * 4;
};

// 1. Grid (nc, H, b), P / 16 warps, each 16 rows of P.  The chunk's state
// update sum_j w_j x_j B_j^T into upd and the gradient it sends back from its
// outputs, sum_i e_i dy_i C_i^T, into dsy, both (b, nc, H, P, N) float32;
// the summed log-decay into cum_l (b, nc, H); the head-0 block also the
// chunk's C.B^T into cb (b, nc, L, L): once per (batch, chunk).
template <int P, int N>
__global__ void __launch_bounds__(2 * P)
ssd_bwd_chunk_mma(const bf16* __restrict__ x, const bf16* __restrict__ dt_raw,
                  const float* __restrict__ A_log, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const float* __restrict__ dt_bias,
                  const bf16* __restrict__ dy, float* __restrict__ upd, float* __restrict__ dsy,
                  float* __restrict__ cum_l, float* __restrict__ cb, int S, int H) {
  constexpr int NT = 2 * P, NW = P / 16;
  extern __shared__ __align__(128) unsigned char chunk_mma_mem[];
  bf16* Xs = reinterpret_cast<bf16*>(chunk_mma_mem);
  bf16* DYs = Xs + Tile<P>::elems(L);
  bf16* Bs = DYs + Tile<P>::elems(L);
  bf16* Cs = Bs + Tile<N>::elems(L);
  float* r_ = reinterpret_cast<float*>(Cs + Tile<N>::elems(L));
  float* dt_ = r_ + L;
  float* cum_ = dt_ + L;
  float* e_ = cum_ + L;
  float* te_ = e_ + L;
  float* w_ = te_ + L;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, p0 = 16 * warp;
  const int t0 = c * L;
  const size_t xoff = (size_t)b * S * H * P + (size_t)h * P;
  repro::load_tile<P, L, NT>(Xs, x + xoff, (long long)H * P, t0, S);
  repro::load_tile<P, L, NT>(DYs, dy + xoff, (long long)H * P, t0, S);
  repro::load_tile<N, L, NT>(Bs, Bm + (size_t)b * S * N, N, t0, S);
  repro::load_tile<N, L, NT>(Cs, Cm + (size_t)b * S * N, N, t0, S);
  repro::cp_async_commit();
  if (warp == 0)
    chunk_vectors(dt_raw + h, (size_t)b * S, H, t0, S, -expf(A_log[h]), dt_bias[h], r_, dt_,
                  cum_, e_, te_, w_);
  repro::cp_async_wait<0>();
  __syncthreads();
  if (h == 0) {                // C.B^T of the chunk, once per (batch, chunk)
    float* out = cb + ((size_t)b * nc + c) * L * L;
    for (int r0 = 16 * warp; r0 < L; r0 += 16 * NW) {
      float acc[L / 8][4] = {};
      repro::mma_abt<N, L / 8>(acc, Cs, r0, Bs, lane);
      store_rows_f32<L>(out, L, acc, r0, lane);
    }
  }
  const size_t slot = (((size_t)b * nc + c) * H + h) * P * N;
  float st[N / 8][4] = {};
  scaled_xt_b<P, N>(st, Xs, w_, Bs, p0, lane);
  store_rows_f32<N>(upd + slot, N, st, p0, lane);
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) st[n][q] = 0.f;
  scaled_xt_b<P, N>(st, DYs, e_, Cs, p0, lane);
  store_rows_f32<N>(dsy + slot, N, st, p0, lane);
  if (threadIdx.x == 0) cum_l[((size_t)b * nc + c) * H + h] = cum_[L - 1];
}

// 2. Grid (P N / 8 / 256, H, 2 b): blockIdx.z = 2 batch + direction.  In
// place over the chunks, the running sum in float32, eight elements a thread:
// direction 0 turns upd[c] into the state entering chunk c (0 for the
// first), direction 1 dsy[c] into the gradient of the state leaving it
// (d_state, or 0, for the last).  HILO (the bfloat16 body): each group of
// eight floats a thread reads is written back in its own 32 bytes as bf16
// halves, the eight hi then the eight lo -- one 16-byte chunk of each of the
// tiles ssd_bwd_grads_mma loads; otherwise as float32.  Two chunks' loads in
// flight a thread.
template <bool HILO>
__global__ void __launch_bounds__(256)
ssd_bwd_pass(float* __restrict__ upd, float* __restrict__ dsy, const float* __restrict__ cum_l,
             const float* __restrict__ d_state, int nc, int H, int PN) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 8, h = blockIdx.y;
  const int b = blockIdx.z >> 1, rev = blockIdx.z & 1;
  if (e >= PN) return;
  float* base = rev ? dsy : upd;
  float run[8] = {};
  if (rev && d_state) {
    const float* ds = d_state + ((size_t)b * H + h) * PN + e;
    const float4 u = ld4(ds), w = ld4(ds + 4);
    run[0] = u.x; run[1] = u.y; run[2] = u.z; run[3] = u.w;
    run[4] = w.x; run[5] = w.y; run[6] = w.z; run[7] = w.w;
  }
  constexpr int AHEAD = 2;
  for (int k0 = 0; k0 < nc; k0 += AHEAD) {
    float4 v[AHEAD][2];
    float d[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int c = rev ? nc - 1 - (k0 + k) : k0 + k;
      if (k0 + k < nc) {
        const size_t slot = ((size_t)b * nc + c) * H + h;
        v[k][0] = ld4(base + slot * PN + e);
        v[k][1] = ld4(base + slot * PN + e + 4);
        d[k] = expf(cum_l[slot]);
      }
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int c = rev ? nc - 1 - (k0 + k) : k0 + k;
      if (k0 + k < nc) {
        float* dst = base + (((size_t)b * nc + c) * H + h) * PN + e;
        if (HILO) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_pair(run[2 * q], run[2 * q + 1], hi[q], lo[q]);
          reinterpret_cast<uint4*>(dst)[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          reinterpret_cast<uint4*>(dst)[1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        } else {
          reinterpret_cast<float4*>(dst)[0] = make_float4(run[0], run[1], run[2], run[3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(run[4], run[5], run[6], run[7]);
        }
        const float in[8] = {v[k][0].x, v[k][0].y, v[k][0].z, v[k][0].w,
                             v[k][1].x, v[k][1].y, v[k][1].z, v[k][1].w};
#pragma unroll
        for (int q = 0; q < 8; ++q) run[q] = fmaf(run[q], d[k], in[q]);
      }
    }
  }
}

// A P x N state as ssd_bwd_pass<true> leaves it into the bf16 Tiles Th and Tl
// by the block's NT threads: 16-byte cp.async, neighbouring threads on
// neighbouring 16 bytes (piece 2 g of group g is its hi chunk, 2 g + 1 its lo)
template <int P, int N, int NT>
__device__ __forceinline__ void load_state(bf16* Th, bf16* Tl, const float* __restrict__ src) {
  for (int e = threadIdx.x; e < P * N / 4; e += NT) {
    const int g = e >> 1;
    repro::cp_async16((e & 1 ? Tl : Th) + Tile<N>::at(g / (N / 8), g % (N / 8)), src + 4 * e,
                      true);
  }
}

// shared memory of ssd_bwd_grads_mma, in bytes: B, C, x and dy of the chunk
// (bf16 Tiles), the state room (a head's G and S as bf16 hi + lo Tiles; at the
// end the group's dB and dC, L rows of N + 8 floats each), C.B^T and the
// summed Q (float32, rows of LP), the vectors
template <int P, int N>
struct GradsSmem {
  static constexpr int RN = N + 8;   // row of the dB / dC room: no bank conflicts
  static constexpr int TILES = (2 * Tile<N>::elems(L) + 2 * Tile<P>::elems(L)) * 2;
  static constexpr int STATES = 4 * Tile<N>::elems(P) * 2;   // a head's G and S, hi + lo
  static constexpr int RED = 2 * L * RN * 4;
  static constexpr int ROOM = STATES > RED ? STATES : RED;
  static constexpr int BYTES = TILES + ROOM + 2 * L * LP * 4 + (13 * L + 16) * 4;
};

// The A fragment (16 x 16) of rows a0..a0+15 and columns k0..k0+15 of a
// matrix whose float32 value at (row, col) is f(row, col), as bf16 hi + lo:
// register q holds rows a0 + g (+8 for odd q) and columns k0 + 2t (+1), +8 for
// q >= 2.
template <typename F>
__device__ __forceinline__ void frag_from(uint32_t (&hi)[4], uint32_t (&lo)[4], int a0, int k0,
                                          int lane, F f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = a0 + g + ((q & 1) ? 8 : 0), col = k0 + 2 * t + ((q & 2) ? 8 : 0);
    split_pair(f(row, col), f(row, col + 1), hi[q], lo[q]);
  }
}

// acc (16 x N) += A Bt with A (16 x 16) as hi + lo fragments and Bt rows
// k0..k0+15 of a bf16 Tile<N> (the k rows), read transposed: all B fragments
// first, then the hi products over every n tile, then the lo ones
template <int N>
__device__ __forceinline__ void mma_hilo_b(float (&acc)[N / 8][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const bf16* Bt, int k0,
                                           int lane) {
  uint32_t bb[N / 16][4];
#pragma unroll
  for (int dp = 0; dp < N / 16; ++dp)
    repro::ldsm_x4_t(bb[dp], Bt + Tile<N>::at(k0 + repro::a_row(lane),
                                              2 * dp + repro::a_chunk(lane)));
#pragma unroll
  for (int dp = 0; dp < N / 16; ++dp) {
    repro::mma_bf16(acc[2 * dp], ah, bb[dp][0], bb[dp][1]);
    repro::mma_bf16(acc[2 * dp + 1], ah, bb[dp][2], bb[dp][3]);
  }
#pragma unroll
  for (int dp = 0; dp < N / 16; ++dp) {
    repro::mma_bf16(acc[2 * dp], al, bb[dp][0], bb[dp][1]);
    repro::mma_bf16(acc[2 * dp + 1], al, bb[dp][2], bb[dp][3]);
  }
}

// acc (rows r0..r0+15 x N) += (s o X) (Th + Tl): X a bf16 Tile<P> of L rows,
// s its float32 row scale, Th and Tl a P x N float32 matrix as bf16 Tiles;
// both operands float32, so hi.hi + hi.lo + lo.hi, each pass over two
// 16-column blocks (four n tiles) before the next
template <int P, int N>
__device__ __forceinline__ void scaled_x_state(float (&acc)[N / 8][4], const bf16* Xs,
                                               const float* s, const bf16* Th, const bf16* Tl,
                                               int r0, int lane) {
  constexpr int DG = N / 16 >= 2 ? 2 : 1;   // 16-column blocks a pass
  const int g = lane >> 2;
  const float s0 = s[r0 + g], s1 = s[r0 + g + 8];
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
    uint32_t xa[4], ah[4], al[4];
    repro::ldsm_x4(xa, Xs + Tile<P>::at(r0 + repro::a_row(lane), 2 * kk + repro::a_chunk(lane)));
    scale_split(xa[0], s0, s0, ah[0], al[0]);
    scale_split(xa[1], s1, s1, ah[1], al[1]);
    scale_split(xa[2], s0, s0, ah[2], al[2]);
    scale_split(xa[3], s1, s1, ah[3], al[3]);
#pragma unroll
    for (int d0 = 0; d0 < N / 16; d0 += DG) {
      uint32_t bh[DG][4], bl[DG][4];
#pragma unroll
      for (int d = 0; d < DG; ++d) {
        const int off = Tile<N>::at(16 * kk + repro::a_row(lane), 2 * (d0 + d) + repro::a_chunk(lane));
        repro::ldsm_x4_t(bh[d], Th + off);
        repro::ldsm_x4_t(bl[d], Tl + off);
      }
#pragma unroll
      for (int d = 0; d < DG; ++d) {
        repro::mma_bf16(acc[2 * (d0 + d)], ah, bh[d][0], bh[d][1]);
        repro::mma_bf16(acc[2 * (d0 + d) + 1], ah, bh[d][2], bh[d][3]);
      }
#pragma unroll
      for (int d = 0; d < DG; ++d) {
        repro::mma_bf16(acc[2 * (d0 + d)], ah, bl[d][0], bl[d][1]);
        repro::mma_bf16(acc[2 * (d0 + d) + 1], ah, bl[d][2], bl[d][3]);
      }
#pragma unroll
      for (int d = 0; d < DG; ++d) {
        repro::mma_bf16(acc[2 * (d0 + d)], al, bh[d][0], bh[d][1]);
        repro::mma_bf16(acc[2 * (d0 + d) + 1], al, bh[d][2], bh[d][3]);
      }
    }
  }
}

// the sums of a 16-row band's two rows over the quad's lanes (t), on every lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// 3. Grid (G, nc, b) in clusters of the G head groups of a (batch, chunk),
// 256 threads; group k takes heads k hpg .. (k + 1) hpg - 1 (below H).
// states / grads: ssd_bwd_pass<true>'s; cb: C.B^T.  Writes dx, ddt_raw, dB, dC
// (bf16, rows < S) and the (chunk, head) shares vec (3, b, nc, H): dA, dD,
// ddt_bias.
template <int P, int N>
__global__ void __launch_bounds__(GNT, 1)
ssd_bwd_grads_mma(const bf16* __restrict__ x, const bf16* __restrict__ dt_raw,
                  const float* __restrict__ A_log, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const float* __restrict__ Dv,
                  const float* __restrict__ dt_bias, const bf16* __restrict__ dy,
                  const float* __restrict__ states, const float* __restrict__ grads,
                  const float* __restrict__ cb, bf16* __restrict__ dx,
                  bf16* __restrict__ ddt_raw, bf16* __restrict__ dB, bf16* __restrict__ dC,
                  float* __restrict__ vec, int S, int H, int hpg) {
  using SM = GradsSmem<P, N>;
  constexpr int RN = SM::RN;
  extern __shared__ __align__(128) unsigned char grads_mma_mem[];
  bf16* Bs = reinterpret_cast<bf16*>(grads_mma_mem);
  bf16* Cs = Bs + Tile<N>::elems(L);
  bf16* Xs = Cs + Tile<N>::elems(L);
  bf16* DYs = Xs + Tile<P>::elems(L);
  unsigned char* room = grads_mma_mem + SM::TILES;
  float* CB = reinterpret_cast<float*>(room + SM::ROOM);  // (L, LP)
  float* QS = CB + L * LP;             // (L, LP): Q summed over the group's heads
  float* r_ = QS + L * LP;
  float* dt_ = r_ + L;
  float* cum_ = dt_ + L;
  float* e_ = cum_ + L;
  float* te_ = e_ + L;
  float* w_ = te_ + L;
  float* u_ = w_ + L;                  // x_j . G B_j
  float* yo_ = u_ + L;                 // e_i dy_i . S C_i
  float* zr_ = yo_ + L;                // sum_j Z_ij dt_j
  float* mcp = zr_ + L;                // (4, L): sum_i Z_ij over each 16-row band
  float* red = mcp + 4 * L;            // <G, S> (4) and dD (4) by warp of 4-7

  const int gi = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * (warp & 3);
  const bool side_a = warp < 4;        // rows j: dx and dB; else rows i: Q and dC
  const int i0 = r0 + g, i1 = i0 + 8;
  const int t0 = c * L;

  repro::load_tile<N, L, GNT>(Bs, Bm + (size_t)b * S * N, N, t0, S);
  repro::load_tile<N, L, GNT>(Cs, Cm + (size_t)b * S * N, N, t0, S);
  const float* cbc = cb + ((size_t)b * nc + c) * L * L;
  for (int e = tid; e < L * L / 4; e += GNT)
    repro::cp_async16(CB + (e / (L / 4)) * LP + (e % (L / 4)) * 4, cbc + 4 * e, true);
  repro::cp_async_commit();
  for (int e = tid; e < L * LP; e += GNT) QS[e] = 0.f;

  float acc_bc[N / 8][4];              // the group's dB (side a) or dC rows
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_bc[n][q] = 0.f;

  // a head's x and dy, and its G and S as bf16 hi + lo, into their tiles
  bf16* Gh = reinterpret_cast<bf16*>(room);
  bf16* Gl = Gh + Tile<N>::elems(P);
  bf16* Sh = Gl + Tile<N>::elems(P);
  bf16* Sl = Sh + Tile<N>::elems(P);
  auto load_head = [&](int h) {
    const size_t xoff = (size_t)b * S * H * P + (size_t)h * P;
    repro::load_tile<P, L, GNT>(Xs, x + xoff, (long long)H * P, t0, S);
    repro::load_tile<P, L, GNT>(DYs, dy + xoff, (long long)H * P, t0, S);
    const size_t slot = (((size_t)b * nc + c) * H + h) * P * N;
    load_state<P, N, GNT>(Gh, Gl, grads + slot);
    load_state<P, N, GNT>(Sh, Sl, states + slot);
    repro::cp_async_commit();
  };
  const int h_begin = gi * hpg, h_end = min(H, (gi + 1) * hpg);
  load_head(h_begin);
  if (warp == 0)
    chunk_vectors(dt_raw + h_begin, (size_t)b * S, H, t0, S, -expf(A_log[h_begin]),
                  dt_bias[h_begin], r_, dt_, cum_, e_, te_, w_);
  for (int h = h_begin; h < h_end; ++h) {
    const float A = -expf(A_log[h]);
    const size_t slot = ((size_t)b * nc + c) * H + h;
    const size_t xoff = (size_t)b * S * H * P + (size_t)h * P;
    repro::cp_async_wait<0>();
    __syncthreads();                   // the head's tiles and vectors are in
    float raw_next[VPER];              // warp 0: the next head's dt_raw, for its vectors
    if (warp == 0 && h + 1 < h_end) dt_rows(raw_next, dt_raw + h + 1, (size_t)b * S, H, t0, S);
    if (!side_a) {  // <G, S> = (Gh + Gl) . (Sh + Sl), by warps 4-7
      float gs = 0.f;
      for (int e = tid - GNT / 2; e < P * (N / 8); e += GNT / 2) {
        const int off = Tile<N>::at(e / (N / 8), e % (N / 8));
        const uint4 v[4] = {*reinterpret_cast<const uint4*>(Gh + off),
                            *reinterpret_cast<const uint4*>(Gl + off),
                            *reinterpret_cast<const uint4*>(Sh + off),
                            *reinterpret_cast<const uint4*>(Sl + off)};
        const __nv_bfloat162* q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          gs += (__low2float(q[0][k]) + __low2float(q[1][k])) *
                (__low2float(q[2][k]) + __low2float(q[3][k]));
          gs += (__high2float(q[0][k]) + __high2float(q[1][k])) *
                (__high2float(q[2][k]) + __high2float(q[3][k]));
        }
      }
      gs = repro::warp_sum(gs);
      if (lane == 0) red[warp - 4] = gs;
    }

    if (side_a) {
      // G B_j, then u_j = x_j . G B_j
      float gb[P / 8][4] = {};
      repro::mma_abt<N, P / 8>(gb, Bs, r0, Gh, lane);
      repro::mma_abt<N, P / 8>(gb, Bs, r0, Gl, lane);
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const bf16* x0 = Xs + Tile<P>::at(i0, n) + 2 * t;
        const bf16* x1 = Xs + Tile<P>::at(i1, n) + 2 * t;
        u0 += __bfloat162float(x0[0]) * gb[n][0] + __bfloat162float(x0[1]) * gb[n][1];
        u1 += __bfloat162float(x1[0]) * gb[n][2] + __bfloat162float(x1[1]) * gb[n][3];
      }
      u0 = quad_sum(u0);
      u1 = quad_sum(u1);
      if (t == 0) {
        u_[i0] = u0;
        u_[i1] = u1;
      }
      // dx_j = dt_j (sum_i M_ij dy_i + te_j G B_j) + D dy_j (w_j = dt_j te_j):
      // the sum over the column tiles i >= j accumulates onto te_j G B_j,
      // M^T formed from C.B^T
      const float te0 = te_[i0], te1 = te_[i1];
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        gb[n][0] *= te0;
        gb[n][1] *= te0;
        gb[n][2] *= te1;
        gb[n][3] *= te1;
      }
      for (int kc = r0 / 16; kc < L / 16; ++kc) {
        uint32_t ah[4], al[4];
        frag_from(ah, al, r0, 16 * kc, lane, [&](int j, int i) {
          return i >= j ? CB[i * LP + j] * expf(cum_[i] - cum_[j]) : 0.f;
        });
        mma_hilo_b<P>(gb, ah, al, DYs, 16 * kc, lane);
      }
      const float Dh = Dv[h];
      const float dt0 = dt_[i0], dt1 = dt_[i1];
      bf16* dxb = dx + xoff;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const bf16* y0 = DYs + Tile<P>::at(i0, n) + 2 * t;
        const bf16* y1 = DYs + Tile<P>::at(i1, n) + 2 * t;
        if (t0 + i0 < S)
          *reinterpret_cast<uint32_t*>(dxb + (size_t)(t0 + i0) * H * P + 8 * n + 2 * t) =
              repro::pack_bf16(dt0 * gb[n][0] + Dh * __bfloat162float(y0[0]),
                               dt0 * gb[n][1] + Dh * __bfloat162float(y0[1]));
        if (t0 + i1 < S)
          *reinterpret_cast<uint32_t*>(dxb + (size_t)(t0 + i1) * H * P + 8 * n + 2 * t) =
              repro::pack_bf16(dt1 * gb[n][2] + Dh * __bfloat162float(y1[0]),
                               dt1 * gb[n][3] + Dh * __bfloat162float(y1[1]));
      }
      // the head's (w o x) G joins the group's dB
      scaled_x_state<P, N>(acc_bc, Xs, w_, Gh, Gl, r0, lane);
    } else {
      // dy.x^T of rows i; M, Q and Z = M o dy.x^T by element
      float dyx[L / 8][4] = {};
      repro::mma_abt<P, L / 8>(dyx, DYs, r0, Xs, lane);
      float zr0 = 0.f, zr1 = 0.f, dd = 0.f;
      float zc[L / 8][2];
#pragma unroll
      for (int n = 0; n < L / 8; ++n) {
        zc[n][0] = zc[n][1] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = q < 2 ? i0 : i1, j = 8 * n + 2 * t + (q & 1);
          const float dec = j <= i ? expf(cum_[i] - cum_[j]) : 0.f;
          const float v = dyx[n][q];
          const float z = CB[i * LP + j] * dec * v;
          QS[i * LP + j] += v * dec * dt_[j];
          if (q < 2)
            zr0 = fmaf(z, dt_[j], zr0);
          else
            zr1 = fmaf(z, dt_[j], zr1);
          zc[n][q & 1] += z;
          if (i == j) dd += v;
        }
      }
      zr0 = quad_sum(zr0);
      zr1 = quad_sum(zr1);
      if (t == 0) {
        zr_[i0] = zr0;
        zr_[i1] = zr1;
      }
#pragma unroll
      for (int n = 0; n < L / 8; ++n)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = zc[n][k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) mcp[(warp - 4) * L + 8 * n + 2 * t + k] = v;
        }
      dd = repro::warp_sum(dd);
      if (lane == 0) red[8 + warp - 4] = dd;
      // S C_i, then yo_i = e_i dy_i . S C_i
      float sc[P / 8][4] = {};
      repro::mma_abt<N, P / 8>(sc, Cs, r0, Sh, lane);
      repro::mma_abt<N, P / 8>(sc, Cs, r0, Sl, lane);
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const bf16* d0 = DYs + Tile<P>::at(i0, n) + 2 * t;
        const bf16* d1 = DYs + Tile<P>::at(i1, n) + 2 * t;
        y0 += __bfloat162float(d0[0]) * sc[n][0] + __bfloat162float(d0[1]) * sc[n][1];
        y1 += __bfloat162float(d1[0]) * sc[n][2] + __bfloat162float(d1[1]) * sc[n][3];
      }
      y0 = quad_sum(y0);
      y1 = quad_sum(y1);
      if (t == 0) {
        yo_[i0] = e_[i0] * y0;
        yo_[i1] = e_[i1] * y1;
      }
      // the head's (e o dy) S joins the group's dC
      scaled_x_state<P, N>(acc_bc, DYs, e_, Sh, Sl, r0, lane);
    }
    __syncthreads();                   // the head's tiles are read: the next one's load
    if (h + 1 < h_end) load_head(h + 1);

    // Warp 0: the gradient of cum, dcum_k = sum_j Z_kj dt_j - dt_k sum_i Z_ik
    // + yo_k - w_k u_k, and cum_L's share, exp(cum_L) <G, S> + sum_j w_j u_j,
    // which every row's log-decay takes; ddt's direct part sum_i Z_ik + te_k
    // u_k.  The products that cancel are rounded once each (__fmul_rn: no
    // fused multiply-add), so that terms that cancel in math cancel exactly:
    // at one row, dA_log is 0, as the plain version gives.
    if (warp == 0) {
      float gs = 0.f, dd = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) gs += red[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) dd += red[8 + k];
      // rows lane and lane + 32: dcum, ddt's direct part, w u rounded once
      float da[2], ddt[2], wu[2];
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int k = lane + 32 * k2;
        const float col = ((mcp[k] + mcp[L + k]) + mcp[2 * L + k]) + mcp[3 * L + k];
        wu[k2] = __fmul_rn(w_[k], u_[k]);
        da[k2] = ((zr_[k] - __fmul_rn(dt_[k], col)) + yo_[k]) - wu[k2];
        ddt[k2] = col + te_[k] * u_[k];
      }
      const float base = expf(cum_[L - 1]) * gs + repro::warp_sum(wu[0] + wu[1]);
      // the reverse cumsum of dcum, s_k = base + sum_{m >= k} dcum_m: a
      // suffix scan of each half over the lanes, the upper half's total
      // added to the lower
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_down_sync(0xffffffffu, da[k2], o);
          if (lane + o < 32) da[k2] += v;
        }
      da[0] += __shfl_sync(0xffffffffu, da[1], 0);
      float da_dt = 0.f, drs = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int k = lane + 32 * k2, tt = t0 + k;
        const float s = base + da[k2];
        if (tt < S) {                  // softplus' derivative: sigmoid(r)
          const float dr = (ddt[k2] + A * s) / (1.f + expf(-r_[k]));
          ddt_raw[((size_t)b * S + tt) * H + h] = __float2bfloat16(dr);
          drs += dr;
        }
        da_dt += dt_[k] * s;
      }
      da_dt = repro::warp_sum(da_dt);
      drs = repro::warp_sum(drs);
      if (lane == 0) {
        const size_t total = (size_t)gridDim.z * nc * H;
        vec[slot] = da_dt;
        vec[total + slot] = dd;
        vec[2 * total + slot] = drs;
      }
      if (h + 1 < h_end)
        chunk_vectors_from(raw_next, t0, S, -expf(A_log[h + 1]), dt_bias[h + 1], r_, dt_, cum_,
                           e_, te_, w_);
    }
  }
  __syncthreads();                     // Q is summed over the group's heads

  // dB_j += sum_i Q_ij C_i (i >= j), dC_i += sum_j Q_ij B_j (j <= i)
  if (side_a) {
    for (int kc = r0 / 16; kc < L / 16; ++kc) {
      uint32_t ah[4], al[4];
      frag_from(ah, al, r0, 16 * kc, lane, [&](int j, int i) { return QS[i * LP + j]; });
      mma_hilo_b<N>(acc_bc, ah, al, Cs, 16 * kc, lane);
    }
  } else {
    for (int kc = 0; kc <= r0 / 16; ++kc) {
      uint32_t ah[4], al[4];
      frag_from(ah, al, r0, 16 * kc, lane, [&](int i, int j) { return QS[i * LP + j]; });
      mma_hilo_b<N>(acc_bc, ah, al, Bs, 16 * kc, lane);
    }
  }
  // the group's rows of dB and dC into the state room (no longer read) ...
  float* RB = reinterpret_cast<float*>(room);          // (L, RN)
  float* RC = RB + L * RN;
  float* R = side_a ? RB : RC;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    *reinterpret_cast<float2*>(R + i0 * RN + 8 * n + 2 * t) = make_float2(acc_bc[n][0], acc_bc[n][1]);
    *reinterpret_cast<float2*>(R + i1 * RN + 8 * n + 2 * t) = make_float2(acc_bc[n][2], acc_bc[n][3]);
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  // ... and block k of the cluster sums rows k rpb .. of every group's, over
  // the groups in order, 4 columns a thread, all of a step's remote loads in
  // flight at once
  const int G = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int rpb = (L + G - 1) / G, row0 = rank * rpb, rows = max(0, min(L, row0 + rpb) - row0);
  for (int e = tid; e < 2 * rows * (N / 4); e += GNT) {
    const int which = e / (rows * (N / 4)), f = e % (rows * (N / 4));
    const int row = row0 + f / (N / 4), n = (f % (N / 4)) * 4;
    const float* src = (which ? RC : RB) + row * RN + n;
    float4 v[MAX_GROUPS];
#pragma unroll
    for (int k = 0; k < MAX_GROUPS; ++k)
      if (k < G) v[k] = ld4(cl.map_shared_rank(src, k));
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAX_GROUPS; ++k) {
      if (k >= G) break;
      s.x += v[k].x;
      s.y += v[k].y;
      s.z += v[k].z;
      s.w += v[k].w;
    }
    if (t0 + row < S)
      *reinterpret_cast<uint2*>((which ? dC : dB) + ((size_t)b * S + t0 + row) * N + n) =
          make_uint2(repro::pack_bf16(s.x, s.y), repro::pack_bf16(s.z, s.w));
  }
  cl.sync();                           // no block leaves while its rows are read
}

// The head groups of ssd_bwd_grads_mma's grid for (b, nc, H): hpg heads a
// block, G = ceil(H / hpg) blocks (at most 8) a cluster.  The clusters of G
// blocks the card holds at once (one block an SM) set how many waves the b
// nc clusters take, and a block's time grows with its heads: hpg minimizes
// waves x hpg (ties: the smaller hpg).  At b=1, s=1024, h=24 the H100 holds
// 15 clusters of 8, so 8 groups of 3 take two waves and 6 groups of 4 one.
template <int P, int N>
int resident_clusters(int G) {
  static int cache[MAX_GROUPS + 1] = {};   // per (P, N) for the process; 0: not asked yet
  if (cache[G] == 0) {
    auto kern = ssd_bwd_grads_mma<P, N>;
    constexpr int smem = GradsSmem<P, N>::BYTES;
    int n = 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G, 1, 1);
    cfg.blockDim = dim3(GNT);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess || n < 1)
      n = 1;
    cache[G] = n;
  }
  return cache[G];
}

template <int P, int N>
int heads_per_group(int b, int nc, int H) {
  const long long clusters = (long long)b * nc;
  int best = 0;
  long long best_cost = 0;
  for (int hpg = (H + MAX_GROUPS - 1) / MAX_GROUPS; hpg <= H; ++hpg) {
    const int G = (H + hpg - 1) / hpg;
    if (hpg > 1 && (H + hpg - 2) / (hpg - 1) == G) continue;   // same G, fewer heads
    const long long waves = (clusters + resident_clusters<P, N>(G) - 1) /
                            resident_clusters<P, N>(G);
    if (best == 0 || waves * hpg < best_cost) {
      best = hpg;
      best_cost = waves * hpg;
    }
  }
  return best;
}

struct Args {
  const void *x, *dt_raw, *B, *C, *dy;
  const float *A_log, *D, *dt_bias, *d_state;
  void *dx, *ddt_raw, *dB, *dC;
  float *dA_log, *dD, *ddt_bias, *states, *grads, *cum_l, *cb, *dbp, *dcp, *vec;
  int b, S, H;
};

template <bool HILO>
cudaError_t launch_pass(const Args& a, int nc, int PN, cudaStream_t stream) {
  ssd_bwd_pass<HILO><<<dim3((PN / 8 + 255) / 256, a.H, 2 * a.b), 256, 0, stream>>>(
      a.states, a.grads, a.cum_l, a.d_state, nc, a.H, PN);
  return cudaGetLastError();
}

cudaError_t launch_sum_vec(const Args& a, int nc, cudaStream_t stream) {
  ssd_bwd_sum_vec<<<(a.H + 127) / 128, 128, 0, stream>>>(a.vec, a.A_log, a.dA_log, a.dD,
                                                         a.ddt_bias, a.b * nc, a.H);
  return cudaGetLastError();
}

// float32: the first version's CUDA-core body
template <int P, int N>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  const int nc = (a.S + L - 1) / L;
  const float* x = static_cast<const float*>(a.x);
  const float* dt_raw = static_cast<const float*>(a.dt_raw);
  const float* B = static_cast<const float*>(a.B);
  const float* C = static_cast<const float*>(a.C);
  const float* dy = static_cast<const float*>(a.dy);
  constexpr int sm1 = chunk_smem<P, N>(), sm3 = grads_smem<P, N>();
  auto k1 = ssd_bwd_chunk<float, P, N>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, sm1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc, a.H, a.b), NT, sm1, stream>>>(x, dt_raw, a.A_log, B, C, a.dt_bias, dy, a.states,
                                               a.grads, a.cum_l, a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_pass<false>(a, nc, P * N, stream);
  if (err != cudaSuccess) return err;
  auto k3 = ssd_bwd_grads<float, P, N>;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, sm3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(nc, a.H, a.b), NT, sm3, stream>>>(
      x, dt_raw, a.A_log, B, C, a.D, a.dt_bias, dy, a.states, a.grads, static_cast<float*>(a.dx),
      static_cast<float*>(a.ddt_raw), a.dbp, a.dcp, a.vec, a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)a.b * a.S;
  ssd_bwd_sum_bc<float><<<(unsigned)((rows * N + 255) / 256), 256, 0, stream>>>(
      a.dbp, a.dcp, static_cast<float*>(a.dB), static_cast<float*>(a.dC), rows, a.H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_vec(a, nc, stream);
}

// bfloat16: the tensor-core body
template <int P, int N>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const int nc = (a.S + L - 1) / L;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* dt_raw = static_cast<const bf16*>(a.dt_raw);
  const bf16* B = static_cast<const bf16*>(a.B);
  const bf16* C = static_cast<const bf16*>(a.C);
  const bf16* dy = static_cast<const bf16*>(a.dy);
  constexpr int sm1 = ChunkSmem<P, N>::BYTES;
  auto k1 = ssd_bwd_chunk_mma<P, N>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, sm1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc, a.H, a.b), 2 * P, sm1, stream>>>(x, dt_raw, a.A_log, B, C, a.dt_bias, dy,
                                                  a.states, a.grads, a.cum_l, a.cb, a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_pass<true>(a, nc, P * N, stream);
  if (err != cudaSuccess) return err;
  constexpr int sm3 = GradsSmem<P, N>::BYTES;
  auto k3 = ssd_bwd_grads_mma<P, N>;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, sm3);
  if (err != cudaSuccess) return err;
  const int hpg = heads_per_group<P, N>(a.b, nc, a.H), G = (a.H + hpg - 1) / hpg;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, nc, a.b);
  cfg.blockDim = dim3(GNT);
  cfg.dynamicSmemBytes = sm3;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k3, x, dt_raw, a.A_log, B, C, a.D, a.dt_bias, dy,
                           (const float*)a.states, (const float*)a.grads, (const float*)a.cb,
                           static_cast<bf16*>(a.dx), static_cast<bf16*>(a.ddt_raw),
                           static_cast<bf16*>(a.dB), static_cast<bf16*>(a.dC), a.vec, a.S, a.H,
                           hpg);
  if (err != cudaSuccess) return err;
  return launch_sum_vec(a, nc, stream);
}

template <bool BF16>
cudaError_t launch_pn(int P, int N, const Args& a, cudaStream_t stream) {
  if (P == 32 && N == 16) return BF16 ? launch_bf16<32, 16>(a, stream) : launch_fp32<32, 16>(a, stream);
  if (P == 32 && N == 128)
    return BF16 ? launch_bf16<32, 128>(a, stream) : launch_fp32<32, 128>(a, stream);
  if (P == 64 && N == 128)
    return BF16 ? launch_bf16<64, 128>(a, stream) : launch_fp32<64, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Inputs as ssd_scan's -- x (b, S, H, P), dt_raw (b, S, H), B and C (b, S, N),
// all contiguous in one dtype (0 = float32, 1 = bfloat16), A_log, D, dt_bias
// (H,) float32 -- and dy (b, S, H, P) in that dtype, d_state (b, H, P, N)
// float32 or null (no gradient on the final state).  Outputs dx, ddt_raw,
// dB, dC in that dtype and shape, dA_log, dD, ddt_bias (H,) float32.
// Scratch, float32, nc = ceil(S / 64): states and grads (b, nc, H, P, N),
// cum_l (b, nc, H), vec (3, b, nc, H); bfloat16 only: cb (b, nc, 64, 64);
// float32 only: dbp and dcp (b, S, H, N) (the other dtype's may be null).
// The (P, N) pairs built: mamba2-130m's (64, 128), one of its model ranks'
// at t = 16 (32, 128) and its smoke config's (32, 16).  Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt_raw, const void* A_log,
                                  const void* B, const void* C, const void* D,
                                  const void* dt_bias, const void* dy, const void* d_state,
                                  void* dx, void* ddt_raw, void* dA_log, void* dB, void* dC,
                                  void* dD, void* ddt_bias, void* states, void* grads,
                                  void* cum_l, void* cb, void* dbp, void* dcp, void* vec, int b,
                                  int S, int H, int P, int N, int dtype, void* stream) {
  Args a;
  a.x = x;
  a.dt_raw = dt_raw;
  a.B = B;
  a.C = C;
  a.dy = dy;
  a.A_log = static_cast<const float*>(A_log);
  a.D = static_cast<const float*>(D);
  a.dt_bias = static_cast<const float*>(dt_bias);
  a.d_state = static_cast<const float*>(d_state);
  a.dx = dx;
  a.ddt_raw = ddt_raw;
  a.dB = dB;
  a.dC = dC;
  a.dA_log = static_cast<float*>(dA_log);
  a.dD = static_cast<float*>(dD);
  a.ddt_bias = static_cast<float*>(ddt_bias);
  a.states = static_cast<float*>(states);
  a.grads = static_cast<float*>(grads);
  a.cum_l = static_cast<float*>(cum_l);
  a.cb = static_cast<float*>(cb);
  a.dbp = static_cast<float*>(dbp);
  a.dcp = static_cast<float*>(dcp);
  a.vec = static_cast<float*>(vec);
  a.b = b;
  a.S = S;
  a.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_pn<false>(P, N, a, s);
  if (dtype == 1) return (int)launch_pn<true>(P, N, a, s);
  return (int)cudaErrorInvalidValue;
}

// rows per chunk of the backward's walk
extern "C" int repro_ssd_scan_bwd_chunk() { return L; }

// heads a block of the bfloat16 gradient's grid at (b, S, H, P, N) on the
// current device (ceil(H / it) blocks a cluster), or -1 for an unbuilt (P, N)
extern "C" int repro_ssd_scan_bwd_heads_per_group(int b, int S, int H, int P, int N) {
  const int nc = (S + L - 1) / L;
  if (P == 32 && N == 16) return heads_per_group<32, 16>(b, nc, H);
  if (P == 32 && N == 128) return heads_per_group<32, 128>(b, nc, H);
  if (P == 64 && N == 128) return heads_per_group<64, 128>(b, nc, H);
  return -1;
}

