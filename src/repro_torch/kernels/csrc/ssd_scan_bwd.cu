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
// writes dx, ddt_raw, dB and dC once (mamba2-130m's training microbatch,
// b=1, s=1024, h=24, P=64, N=128, bf16: ~10 MB, ~3 us at 3.35 TB/s).  The
// chunked form's products come to ~4 GFLOP there (~4 us on the bf16 tensor
// cores), so on the card's float32 CUDA cores, where this first version runs
// them, the operations bind it.
//
// Design (chunk L = 64 rows; a ragged tail padded with dt = 0, as the
// forward pads it):
//   1. ssd_bwd_chunk, grid (chunk, head, batch): each chunk's state update
//      sum_j w_j x_j B_j^T and the gradient it sends back from its outputs,
//      sum_i exp(cum_i) dy_i C_i^T (P x N each, float32), and its summed
//      log-decay;
//   2. ssd_bwd_pass, elementwise over (P x N, head, batch): the sequential
//      passes over the chunks, forward for the state entering each chunk and
//      in reverse for the gradient of the state leaving it, each written in
//      place of its input;
//   3. ssd_bwd_grads, grid (chunk, head, batch): with those two states, the
//      chunk's L x L products C.B^T and dy.x^T (masked and decayed), dx, the
//      head's share of dB and dC (float32, per head), the gradient of the
//      in-chunk cumsum of dt A and through it ddt_raw, and the chunk's share
//      of dA_log, dD and ddt_bias;
//   4. ssd_bwd_sum_bc and ssd_bwd_sum_vec: dB and dC summed over the heads,
//      and the (h,) vectors over the chunks and the batch, in a fixed order.
// Every product is a float32 sum on the CUDA cores from operands staged in
// shared memory (rows padded by one word), each thread a 4 x 4 tile of the
// output; no atomics, so a call's result does not change between runs.
// bfloat16 and float32 inputs take the same path (float32 from the load).
// Nothing of this is tuned: the tensor cores (mma.sync on the bf16 operands,
// as ssd_scan.cu does) and a shared C.B^T per (batch, chunk) are left for
// later.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int L = 64;      // rows per chunk
constexpr int NT = 256;    // threads per block

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

// The chunk's vectors, by warp 0: dt = softplus(r), r = dt_raw + dt_bias (0
// at or past S), cum the inclusive cumsum of dt A, e = exp(cum), te =
// exp(cum_L - cum) and w = dt te; r is kept for softplus' derivative.
template <typename T>
__device__ __forceinline__ void chunk_vectors(const T* __restrict__ dt_raw, size_t row0, int H,
                                              int t0, int S, float A, float dtb, float* r_,
                                              float* dt_, float* cum_, float* e_, float* te_,
                                              float* w_) {
  const int lane = threadIdx.x;
  constexpr int PER = L / 32;   // consecutive rows a lane
  float d[PER], v[PER];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane * PER + k, t = t0 + i;
    d[k] = 0.f;
    float r = 0.f;
    if (t < S) {                // softplus, as jax.nn.softplus
      r = to_f(dt_raw[(row0 + t) * H]) + dtb;
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
  for (int k = 0; k < PER; ++k) {
    const int i = lane * PER + k;
    const float c = incl - run + v[k];
    dt_[i] = d[k];
    cum_[i] = c;
    e_[i] = expf(c);
    te_[i] = expf(last - c);
    w_[i] = d[k] * te_[i];
  }
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

// 1. Grid (nc, H, b).  upd and dsy (b, nc, H, P, N) float32: the chunk's
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

// 2. Grid (P N / 4 / 256, H, b).  In place: upd[c] becomes the state entering
// chunk c (0 for the first) and dsy[c] the gradient of the state leaving it
// (d_state, or 0, for the last).
__global__ void __launch_bounds__(256)
ssd_bwd_pass(float* __restrict__ upd, float* __restrict__ dsy, const float* __restrict__ cum_l,
             const float* __restrict__ d_state, int nc, int H, int PN) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4, h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const size_t slot = ((size_t)b * nc + c) * H + h;
    const float d = expf(cum_l[slot]);
    float4* p = reinterpret_cast<float4*>(upd + slot * PN + e);
    const float4 v = *p;
    *p = run;
    run = make_float4(fmaf(run.x, d, v.x), fmaf(run.y, d, v.y), fmaf(run.z, d, v.z),
                      fmaf(run.w, d, v.w));
  }
  run = d_state ? *reinterpret_cast<const float4*>(d_state + ((size_t)b * H + h) * PN + e)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const size_t slot = ((size_t)b * nc + c) * H + h;
    const float d = expf(cum_l[slot]);
    float4* p = reinterpret_cast<float4*>(dsy + slot * PN + e);
    const float4 v = *p;
    *p = run;
    run = make_float4(fmaf(run.x, d, v.x), fmaf(run.y, d, v.y), fmaf(run.z, d, v.z),
                      fmaf(run.w, d, v.w));
  }
}

template <int P, int N>
constexpr int grads_smem() {
  return (2 * L * (P + 1) + 3 * L * (N + 1) + 3 * L * (L + 1) + L * (P + 1) + 16 * L +
          NT / 32 + 4) * 4;
}

// 3. Grid (nc, H, b).  states / grads: the passes' outputs.  Writes dx and
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

// 4a. dB and dC (rows, N) in T from the heads' shares (rows, H, N) float32,
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

// 4b. The (H,) gradients from the chunks' partials vec (3, nbc, H), summed
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

struct Args {
  const void *x, *dt_raw, *B, *C, *dy;
  const float *A_log, *D, *dt_bias, *d_state;
  void *dx, *ddt_raw, *dB, *dC;
  float *dA_log, *dD, *ddt_bias, *states, *grads, *cum_l, *dbp, *dcp, *vec;
  int b, S, H;
};

template <typename T, int P, int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int nc = (a.S + L - 1) / L;
  const T* x = static_cast<const T*>(a.x);
  const T* dt_raw = static_cast<const T*>(a.dt_raw);
  const T* B = static_cast<const T*>(a.B);
  const T* C = static_cast<const T*>(a.C);
  const T* dy = static_cast<const T*>(a.dy);
  constexpr int sm1 = chunk_smem<P, N>(), sm3 = grads_smem<P, N>();
  auto k1 = ssd_bwd_chunk<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, sm1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(nc, a.H, a.b), NT, sm1, stream>>>(x, dt_raw, a.A_log, B, C, a.dt_bias, dy, a.states,
                                               a.grads, a.cum_l, a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_pass<<<dim3((P * N / 4 + 255) / 256, a.H, a.b), 256, 0, stream>>>(
      a.states, a.grads, a.cum_l, a.d_state, nc, a.H, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto k3 = ssd_bwd_grads<T, P, N>;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, sm3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(nc, a.H, a.b), NT, sm3, stream>>>(
      x, dt_raw, a.A_log, B, C, a.D, a.dt_bias, dy, a.states, a.grads, static_cast<T*>(a.dx),
      static_cast<T*>(a.ddt_raw), a.dbp, a.dcp, a.vec, a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)a.b * a.S;
  ssd_bwd_sum_bc<T><<<(unsigned)((rows * N + 255) / 256), 256, 0, stream>>>(
      a.dbp, a.dcp, static_cast<T*>(a.dB), static_cast<T*>(a.dC), rows, a.H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_sum_vec<<<(a.H + 127) / 128, 128, 0, stream>>>(a.vec, a.A_log, a.dA_log, a.dD,
                                                         a.ddt_bias, a.b * nc, a.H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pn(int P, int N, const Args& a, cudaStream_t stream) {
  if (P == 32 && N == 16) return launch<T, 32, 16>(a, stream);
  if (P == 64 && N == 128) return launch<T, 64, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Inputs as ssd_scan's -- x (b, S, H, P), dt_raw (b, S, H), B and C (b, S, N),
// all contiguous in one dtype (0 = float32, 1 = bfloat16), A_log, D, dt_bias
// (H,) float32 -- and dy (b, S, H, P) in that dtype, d_state (b, H, P, N)
// float32 or null (no gradient on the final state).  Outputs dx, ddt_raw,
// dB, dC in that dtype and shape, dA_log, dD, ddt_bias (H,) float32.
// Scratch, float32, nc = ceil(S / 64): states and grads (b, nc, H, P, N),
// cum_l (b, nc, H), dbp and dcp (b, S, H, N), vec (3, b, nc, H).  The
// (P, N) pairs built: mamba2-130m's (64, 128) and its smoke config's
// (32, 16).  Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt_raw, const void* A_log,
                                  const void* B, const void* C, const void* D,
                                  const void* dt_bias, const void* dy, const void* d_state,
                                  void* dx, void* ddt_raw, void* dA_log, void* dB, void* dC,
                                  void* dD, void* ddt_bias, void* states, void* grads,
                                  void* cum_l, void* dbp, void* dcp, void* vec, int b, int S,
                                  int H, int P, int N, int dtype, void* stream) {
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
  a.dbp = static_cast<float*>(dbp);
  a.dcp = static_cast<float*>(dcp);
  a.vec = static_cast<float*>(vec);
  a.b = b;
  a.S = S;
  a.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_pn<float>(P, N, a, s);
  if (dtype == 1) return (int)launch_pn<__nv_bfloat16>(P, N, a, s);
  return (int)cudaErrorInvalidValue;
}

// rows per chunk of the backward's walk
extern "C" int repro_ssd_scan_bwd_chunk() { return L; }
