// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a), one B/C
// group: y = SSD(x, dt, A, B, C) + D x and the final state.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan (the Pallas TPU
// kernel `_kernel`, whose grid walks (batch, head, chunk) with the chunk axis
// sequential and carries the P x N state in VMEM scratch).
//
// What bounds it on an H100: a call reads x, dt_raw, B and C once and writes
// y and the float32 state once (mamba2-130m's prefill, b=8, s=512, h=24,
// P=64, N=128, bf16: 33.75 MB, ~10.1 us at 3.35 TB/s; one 32,768-token
// prompt: 220.5 MB, ~66 us).  The chunked form's products (C.B^T, W.x,
// C.state, x^T.B) come to ~5.6 GFLOP at the prefill and ~45 GFLOP at 32k,
// ~5.7 and ~46 us on the bf16 tensor cores but ~84 us and ~0.7 ms at the
// card's float32 rate: the products must run on the tensor cores for the
// bytes to bind.  The recurrence is sequential in the chunks, and a walk of
// one block per (head, batch) leaves most SMs idle at b = 1, so the scan is
// split in parallel phases.
//
// bfloat16 design (chunk L = 64 rows, segments of `cps` chunks chosen on the
// host from (b, s, h) and the SM count, kernels/meta.py's ssd_segment_chunks):
//   0. ssd_cb, grid (chunk, batch): C.B^T of each chunk (L x L float32, from
//      mma.sync on the bf16 B and C, exact products with float32 sums), once
//      per (batch, chunk) and shared by all heads -- B and C are one group;
//   1. ssd_seg_state, grid (segment, head, batch), every segment but the
//      last: walks the segment's chunks from a zero state, state <- state
//      exp(cum_L) + (dt_j exp(cum_L - cum_j) x_j)^T B on the tensor cores,
//      the state in float32 mma accumulators (a warp owns 16 of the P rows),
//      and writes it with the segment's summed log-decay;
//   2. ssd_state_pass, elementwise over (P x N, head, batch): the short
//      sequential pass over the segment states, rewriting each in place as
//      the state entering the next segment;
//   3. ssd_chunk_scan, grid (segment, head, batch): walks the segment's
//      chunks from that entering state (zero for the first) and writes
//      y = exp(cum_i) C.state + W x + D x, W = (C B^T) o exp(cum_i - cum_j) o
//      dt_j for j <= i (tiles above the diagonal skipped), then updates the
//      state as in 1; the last segment writes the final state.
// At the prefill that is 2 segments of 4 chunks (384 blocks of 4 warps on
// 132 SMs), at 32k 11 segments of 47 chunks (264 blocks); the intermediates
// are C.B^T, (b, s, L) float32 (1.0 and 8.4 MB), and the segment states,
// (b, nseg - 1, h, P, N) float32 with their log-decays (6.3 and 7.9 MB),
// against 33.8 and 220.5 MB of inputs and outputs.
//
// Rounding before an mma: B, C and x are bf16 already.  Three operands are
// float32 and are rounded to bf16 -- W, the decay-scaled x (dt_j exp(cum_L -
// cum_j) x_j) and the carried state -- and each goes in as two bf16 halves,
// hi = bf16(v) and lo = bf16(v - hi), through two mma's, so those products
// keep ~16 bits of mantissa: the whole-model check of mamba2-130m has the
// least headroom of the repo's checks, and the products are not what
// bounds the kernel.  Tiles are staged by 16-byte cp.async into the
// swizzled layout of mma.cuh and read by ldmatrix (the decay-scaled x
// transposed); the per-chunk dt = softplus(dt_raw + dt_bias), its cumsum
// of dt A and the derived vectors are one warp's shuffle scan.  A ragged
// tail is padded with dt = 0, as the Pallas kernel pads: no decay, no input.
// y leaves through shared memory as 16-byte stores; rows past s are never
// stored.
//
// float32 keeps the first version's body on the CUDA cores (TF32 cannot
// hold the 2e-3 the float32 callers are held to), chosen by the dtype: one
// 256-thread block per (head, batch) walks the 64-row chunks with the
// float32 state in shared memory.  No main path runs it on the card.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::bf16;
using repro::from_f;
using repro::to_f;
using repro::Tile;

constexpr int WALK_NT = 256;   // threads per block of the float32 walk
constexpr int L = 64;          // rows per chunk
constexpr int LP = L + 4;      // padded row of the float32 L x L tiles


__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 v) {
  acc[0] += a * v.x;
  acc[1] += a * v.y;
  acc[2] += a * v.z;
  acc[3] += a * v.w;
}

template <int P, int N>
constexpr int smem_floats() {
  return L * P + 2 * N * LP + L * LP + N * P + 4 * L;
}

// x (b, S, H, P), dt_raw (b, S, H), B and C (b, S, N) in T; A_log, D and
// dt_bias (H,) float32.  y (b, S, H, P) in T, state (b, H, P, N) float32.
// Grid (H, b).
template <typename T, int P, int N>
__global__ void __launch_bounds__(WALK_NT)
ssd_chunk_walk(const T* __restrict__ x, const T* __restrict__ dt_raw,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ dt_bias, T* __restrict__ y,
               float* __restrict__ state_out, int S, int H) {
  static_assert(P % 4 == 0 && WALK_NT % (P / 4) == 0 && L % (WALK_NT / (P / 4)) == 0,
                "the y tiles must cover the chunk");
  static_assert(L % 32 == 0 && WALK_NT % (L / 4) == 0 && L % (WALK_NT / (L / 4)) == 0,
                "the W tiles must cover the chunk");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // (L, P)   x of the chunk
  float* bT = xs + L * P;           // (N, LP)  B of the chunk, transposed
  float* cT = bT + N * LP;          // (N, LP)  C of the chunk, transposed
  float* w = cT + N * LP;           // (L, LP)  W
  float* st = w + L * LP;           // (N, P)   the carried state, transposed
  float* cum = st + N * P;          // (L)      inclusive cumsum of dt A
  float* dts = cum + L;             // (L)      dt
  float* ecum = dts + L;            // (L)      exp(cum_i)
  float* wst = ecum + L;            // (L)      dt_j exp(cum_L - cum_j)

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float A = -expf(A_log[h]);
  const float dtb = dt_bias[h], Dh = Dv[h];
  for (int e = tid; e < N * P; e += WALK_NT) st[e] = 0.f;
  __syncthreads();

  const int nc = (S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    // 1. stage the chunk; rows past the sequence are zeros with dt = 0
    for (int e = tid; e < L * P; e += WALK_NT) {
      const int i = e / P, t = t0 + i;
      xs[e] = t < S ? to_f(x[(((size_t)b * S + t) * H + h) * P + e % P]) : 0.f;
    }
    for (int e = tid; e < L * N; e += WALK_NT) {
      const int i = e / N, n = e % N, t = t0 + i;
      const size_t g = ((size_t)b * S + t) * N + n;
      bT[n * LP + i] = t < S ? to_f(Bm[g]) : 0.f;
      cT[n * LP + i] = t < S ? to_f(Cm[g]) : 0.f;
    }
    if (tid < 32) {                 // warp 0: dt and the cumsum of dt A
      constexpr int PER = L / 32;   // consecutive rows a lane
      float v[PER];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = tid * PER + k, t = t0 + i;
        float d = 0.f;
        if (t < S) {                // softplus, as jax.nn.softplus
          const float r = to_f(dt_raw[((size_t)b * S + t) * H + h]) + dtb;
          d = fmaxf(r, 0.f) + log1pf(expf(-fabsf(r)));
        }
        dts[i] = d;
        run += d * A;
        v[k] = run;
      }
      float incl = run;             // inclusive scan of the lanes' sums
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) cum[tid * PER + k] = incl - run + v[k];
    }
    __syncthreads();
    if (tid < L) {
      ecum[tid] = expf(cum[tid]);
      wst[tid] = dts[tid] * expf(cum[L - 1] - cum[tid]);
    }
    {  // 2. W = (C B^T) o exp(cum_i - cum_j) o dt_j, j <= i
      constexpr int TJ = L / 4, TI = WALK_NT / TJ, RI = L / TI;
      const int tj = tid % TJ, ti = tid / TJ;
      float acc[RI][4] = {};
      for (int k = 0; k < N; ++k) {
        const float4 bv = ld4(bT + k * LP + 4 * tj);
#pragma unroll
        for (int r = 0; r < RI; ++r) fma4(acc[r], cT[k * LP + ti + TI * r], bv);
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int i = ti + TI * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * tj + q;
          w[i * LP + j] = j <= i ? acc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();
    {  // 3. y = W x + exp(cum_i) C . state + D x
      constexpr int TP = P / 4, TI = WALK_NT / TP, RI = L / TI;
      const int tp = tid % TP, ti = tid / TP;
      float yd[RI][4] = {}, yo[RI][4] = {};
      for (int j = 0; j < L; ++j) {
        const float4 xv = ld4(xs + j * P + 4 * tp);
#pragma unroll
        for (int r = 0; r < RI; ++r) fma4(yd[r], w[(ti + TI * r) * LP + j], xv);
      }
      for (int n = 0; n < N; ++n) {
        const float4 sv = ld4(st + n * P + 4 * tp);
#pragma unroll
        for (int r = 0; r < RI; ++r) fma4(yo[r], cT[n * LP + ti + TI * r], sv);
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int i = ti + TI * r, t = t0 + i;
        if (t >= S) continue;
        T* yrow = y + (((size_t)b * S + t) * H + h) * P + 4 * tp;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          yrow[q] = from_f<T>(yd[r][q] + yo[r][q] * ecum[i] + Dh * xs[i * P + 4 * tp + q]);
      }
    }
    __syncthreads();
    {  // 4. state <- state exp(cum_L) + sum_j (dt_j exp(cum_L - cum_j) x_j) B_j^T
      constexpr int TP = P / 4, TN = WALK_NT / TP, RN = (N + TN - 1) / TN;
      const int tp = tid % TP, tn = tid / TP;
      const float decay = expf(cum[L - 1]);
      float acc[RN][4];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int n = tn + TN * r;
        const float4 sv = n < N ? ld4(st + n * P + 4 * tp) : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[r][0] = sv.x * decay;
        acc[r][1] = sv.y * decay;
        acc[r][2] = sv.z * decay;
        acc[r][3] = sv.w * decay;
      }
      for (int j = 0; j < L; ++j) {
        float4 xv = ld4(xs + j * P + 4 * tp);
        const float ws = wst[j];
        xv.x *= ws;
        xv.y *= ws;
        xv.z *= ws;
        xv.w *= ws;
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const int n = tn + TN * r;
          if (n < N) fma4(acc[r], bT[n * LP + j], xv);
        }
      }
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int n = tn + TN * r;
        if (n < N)
          *reinterpret_cast<float4*>(st + n * P + 4 * tp) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();
  }
  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += WALK_NT) so[e] = st[(e % N) * P + e / N];
}

// ------------------------------------------------------- bfloat16 path --

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Warp 0 of a block, dt_raw at the block's head: dt = softplus(dt_raw + dt_bias) (0 past the sequence),
// the inclusive cumsum of dt A over the chunk, exp(cum_i) and dt_j
// exp(cum_L - cum_j).  Returns cum_L on every lane.
__device__ __forceinline__ float chunk_vectors(const bf16* __restrict__ dt_raw, size_t row0,
                                               int H, int t0, int S, float A, float dtb,
                                               float* dts, float* cum, float* ecum,
                                               float* wv, int lane) {
  constexpr int PER = L / 32;   // consecutive rows a lane
  float d[PER], v[PER];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane * PER + k, t = t0 + i;
    d[k] = 0.f;
    if (t < S) {                // softplus, as jax.nn.softplus
      const float r = __bfloat162float(dt_raw[(row0 + t) * H]) + dtb;
      d[k] = fmaxf(r, 0.f) + log1pf(expf(-fabsf(r)));
    }
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
    dts[i] = d[k];
    cum[i] = c;
    ecum[i] = expf(c);
    wv[i] = d[k] * expf(last - c);
  }
  return last;
}

// The decay-scaled x of a chunk, wv_j x_j, as two bf16 Tiles hi + lo.
template <int P, int NT>
__device__ __forceinline__ void scale_x(const bf16* Xs, const float* wv, bf16* Xh, bf16* Xl) {
  constexpr int C = Tile<P>::C;
  for (int e = threadIdx.x; e < L * C; e += NT) {
    const int j = e / C, c = e % C;
    const int off = Tile<P>::at(j, c);
    const uint4 raw = *reinterpret_cast<const uint4*>(Xs + off);
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t hi[4], lo[4];
    const float w = wv[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&in[q]);
      const float a = __low2float(h2) * w, b = __high2float(h2) * w;
      const float ah = bf_round(a), bh = bf_round(b);
      hi[q] = repro::pack_bf16(ah, bh);
      lo[q] = repro::pack_bf16(a - ah, b - bh);
    }
    *reinterpret_cast<uint4*>(Xh + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(Xl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// st (rows p0..p0+15 of the P x N state, float32 C fragments) <- st
// exp(cum_L) + (Xh + Xl)^T B over the chunk's L rows, on the tensor cores.
template <int P, int N>
__device__ __forceinline__ void update_state(float (&st)[N / 8][4], float decay, const bf16* Xh,
                                             const bf16* Xl, const bf16* Bs, int p0, int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) st[n][q] *= decay;
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
    // A = (scaled x)^T: rows p, k = j; ldmatrix.trans of the x rows j
    const int ao = Tile<P>::at(16 * kk + repro::b_row(lane), p0 / 8 + repro::b_chunk(lane));
    uint32_t ah[4], al[4];
    repro::ldsm_x4_t(ah, Xh + ao);
    repro::ldsm_x4_t(al, Xl + ao);
#pragma unroll
    for (int dp = 0; dp < N / 16; ++dp) {
      uint32_t bb[4];
      repro::ldsm_x4_t(bb, Bs + Tile<N>::at(16 * kk + repro::a_row(lane),
                                            2 * dp + repro::a_chunk(lane)));
      repro::mma_bf16(st[2 * dp], ah, bb[0], bb[1]);
      repro::mma_bf16(st[2 * dp + 1], ah, bb[2], bb[3]);
      repro::mma_bf16(st[2 * dp], al, bb[0], bb[1]);
      repro::mma_bf16(st[2 * dp + 1], al, bb[2], bb[3]);
    }
  }
}

// 0. C.B^T of chunk c of batch b: (b, nc, L, L) float32.  Grid (nc, b), 4
// warps, each 16 rows i x all L columns j.
template <int N>
__global__ void __launch_bounds__(128)
ssd_cb(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, float* __restrict__ cb, int S) {
  __shared__ __align__(128) bf16 Cs[Tile<N>::elems(L)];
  __shared__ __align__(128) bf16 Bs[Tile<N>::elems(L)];
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  repro::load_tile<N, L, 128>(Cs, Cm + (size_t)b * S * N, N, c * L, S);
  repro::load_tile<N, L, 128>(Bs, Bm + (size_t)b * S * N, N, c * L, S);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  float acc[L / 8][4] = {};
  repro::mma_abt<N, L / 8>(acc, Cs, 16 * warp, Bs, lane);
  const int g = lane >> 2, t = lane & 3;
  float* out = cb + ((size_t)b * nc + c) * L * L;
#pragma unroll
  for (int n = 0; n < L / 8; ++n) {
    const int i = 16 * warp + g, j = 8 * n + 2 * t;
    *reinterpret_cast<float2*>(out + i * L + j) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (i + 8) * L + j) = make_float2(acc[n][2], acc[n][3]);
  }
}

// shared memory of ssd_seg_state: x and B of a chunk (two stages), the
// scaled x in two halves, the chunk's vectors
template <int P, int N>
constexpr int seg_smem() {
  return (2 * (Tile<P>::elems(L) + Tile<N>::elems(L)) + 2 * Tile<P>::elems(L)) * 2 +
         4 * L * 4;
}

// 1. The state each segment but the last leaves behind from a zero state,
// and its summed log-decay.  Grid (nseg - 1, H, b), P / 16 warps.
template <int P, int N>
__global__ void __launch_bounds__(2 * P)
ssd_seg_state(const bf16* __restrict__ x, const bf16* __restrict__ dt_raw,
              const float* __restrict__ A_log, const bf16* __restrict__ Bm,
              const float* __restrict__ dt_bias, float* __restrict__ states,
              float* __restrict__ segld, int S, int H, int cps) {
  constexpr int NT = 2 * P;
  extern __shared__ __align__(128) unsigned char seg_mem[];
  bf16* Xs = reinterpret_cast<bf16*>(seg_mem);           // 2 stages
  bf16* Bs = Xs + 2 * Tile<P>::elems(L);                 // 2 stages
  bf16* Xh = Bs + 2 * Tile<N>::elems(L);
  bf16* Xl = Xh + Tile<P>::elems(L);
  float* dts = reinterpret_cast<float*>(Xl + Tile<P>::elems(L));
  float* cum = dts + L;
  float* ecum = cum + L;
  float* wv = ecum + L;

  const int sg = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nseg1 = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (S + L - 1) / L;
  const int c0 = sg * cps, c1 = min(c0 + cps, nc);
  const float A = -expf(A_log[h]), dtb = dt_bias[h];
  const bf16* xb = x + (size_t)b * S * H * P + (size_t)h * P;
  const bf16* bb = Bm + (size_t)b * S * N;

  auto load = [&](int c, int stage) {
    repro::load_tile<P, L, NT>(Xs + stage * Tile<P>::elems(L), xb, (long long)H * P, c * L, S);
    repro::load_tile<N, L, NT>(Bs + stage * Tile<N>::elems(L), bb, N, c * L, S);
    repro::cp_async_commit();
  };

  float st[N / 8][4] = {};
  float ld = 0.f;
  load(c0, 0);
  for (int c = c0; c < c1; ++c) {
    const int stage = (c - c0) & 1;
    if (c + 1 < c1) {
      load(c + 1, stage ^ 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    float cl = 0.f;
    if (warp == 0)
      cl = chunk_vectors(dt_raw + h, (size_t)b * S, H, c * L, S, A, dtb, dts, cum, ecum, wv, lane);
    __syncthreads();
    scale_x<P, NT>(Xs + stage * Tile<P>::elems(L), wv, Xh, Xl);
    __syncthreads();
    update_state<P, N>(st, expf(cum[L - 1]), Xh, Xl, Bs + stage * Tile<N>::elems(L),
                       16 * warp, lane);
    ld += cl;
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3, p = 16 * warp + g;
  float* out = states + (((size_t)b * nseg1 + sg) * H + h) * P * N;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    *reinterpret_cast<float2*>(out + p * N + 8 * n + 2 * t) = make_float2(st[n][0], st[n][1]);
    *reinterpret_cast<float2*>(out + (p + 8) * N + 8 * n + 2 * t) =
        make_float2(st[n][2], st[n][3]);
  }
  if (threadIdx.x == 0) segld[((size_t)b * nseg1 + sg) * H + h] = ld;
}

// 2. In place over each (batch, head)'s nseg - 1 segment states: slot s
// becomes the state entering segment s + 1.  Grid (P N / 4 / 256, H, b).
__global__ void __launch_bounds__(256)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ segld, int nseg1, int H,
               int PN) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4, h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nseg1; ++s) {
    const size_t slot = ((size_t)b * nseg1 + s) * H + h;
    const float d = expf(segld[slot]);
    float4* p = reinterpret_cast<float4*>(states + slot * PN + e);
    const float4 v = *p;
    run = make_float4(fmaf(run.x, d, v.x), fmaf(run.y, d, v.y), fmaf(run.z, d, v.z),
                      fmaf(run.w, d, v.w));
    *p = run;
  }
}

// shared memory of ssd_chunk_scan: x, B, C and C.B^T of a chunk, the
// entering state and the scaled x in two bf16 halves each, the vectors
template <int P, int N>
constexpr int scan_smem() {
  return (Tile<P>::elems(L) + 2 * Tile<N>::elems(L) + 2 * Tile<N>::elems(P) +
          2 * Tile<P>::elems(L)) * 2 + (L * LP + 4 * L) * 4;
}

// 3. y of every chunk of a segment and, for the last segment, the final
// state.  Grid (nseg, H, b), P / 16 warps.
template <int P, int N>
__global__ void __launch_bounds__(2 * P)
ssd_chunk_scan(const bf16* __restrict__ x, const bf16* __restrict__ dt_raw,
               const float* __restrict__ A_log, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ dt_bias, const float* __restrict__ cb,
               const float* __restrict__ states, bf16* __restrict__ y,
               float* __restrict__ state_out, int S, int H, int cps) {
  constexpr int NT = 2 * P, NW = P / 16, BANDS = L / 16;
  extern __shared__ __align__(128) unsigned char scan_mem[];
  bf16* Xs = reinterpret_cast<bf16*>(scan_mem);
  bf16* Bs = Xs + Tile<P>::elems(L);
  bf16* Cs = Bs + Tile<N>::elems(L);
  bf16* Sh = Cs + Tile<N>::elems(L);            // entering state, P rows of N
  bf16* Sl = Sh + Tile<N>::elems(P);
  bf16* Xh = Sl + Tile<N>::elems(P);            // scaled x; then the y stage
  bf16* Xl = Xh + Tile<P>::elems(L);
  float* CB = reinterpret_cast<float*>(Xl + Tile<P>::elems(L));   // (L, LP)
  float* dts = CB + L * LP;
  float* cum = dts + L;
  float* ecum = cum + L;
  float* wv = ecum + L;

  const int sg = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nseg = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, p0 = 16 * warp;
  const int nc = (S + L - 1) / L;
  const int c0 = sg * cps, c1 = min(c0 + cps, nc);
  const float A = -expf(A_log[h]), dtb = dt_bias[h], Dh = Dv[h];
  const bf16* xb = x + (size_t)b * S * H * P + (size_t)h * P;
  const bf16* bb = Bm + (size_t)b * S * N;
  const bf16* cc = Cm + (size_t)b * S * N;
  bf16* yb = y + (size_t)b * S * H * P + (size_t)h * P;

  float st[N / 8][4] = {};
  if (sg > 0) {                   // the state entering this segment
    const float* in = states + (((size_t)b * (nseg - 1) + sg - 1) * H + h) * P * N;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float2 u = *reinterpret_cast<const float2*>(in + (p0 + g) * N + 8 * n + 2 * t);
      const float2 v = *reinterpret_cast<const float2*>(in + (p0 + g + 8) * N + 8 * n + 2 * t);
      st[n][0] = u.x; st[n][1] = u.y; st[n][2] = v.x; st[n][3] = v.y;
    }
  }

  for (int c = c0; c < c1; ++c) {
    const int t0 = c * L;
    repro::load_tile<P, L, NT>(Xs, xb, (long long)H * P, t0, S);
    repro::load_tile<N, L, NT>(Bs, bb, N, t0, S);
    repro::load_tile<N, L, NT>(Cs, cc, N, t0, S);
    const float* cbc = cb + ((size_t)b * nc + c) * L * L;
    for (int e = threadIdx.x; e < L * L / 4; e += NT)
      repro::cp_async16(CB + (e / (L / 4)) * LP + (e % (L / 4)) * 4, cbc + 4 * e, true);
    repro::cp_async_commit();
    if (warp == 0)
      chunk_vectors(dt_raw + h, (size_t)b * S, H, t0, S, A, dtb, dts, cum, ecum, wv, lane);
    // the state entering this chunk, as bf16 hi + lo, rows p0..p0+15
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      float hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hi[q] = bf_round(st[n][q]);
        lo[q] = st[n][q] - hi[q];
      }
      const int o0 = Tile<N>::at(p0 + g, n) + 2 * t, o1 = Tile<N>::at(p0 + g + 8, n) + 2 * t;
      *reinterpret_cast<uint32_t*>(Sh + o0) = repro::pack_bf16(hi[0], hi[1]);
      *reinterpret_cast<uint32_t*>(Sh + o1) = repro::pack_bf16(hi[2], hi[3]);
      *reinterpret_cast<uint32_t*>(Sl + o0) = repro::pack_bf16(lo[0], lo[1]);
      *reinterpret_cast<uint32_t*>(Sl + o1) = repro::pack_bf16(lo[2], lo[3]);
    }
    repro::cp_async_wait<0>();
    __syncthreads();
    scale_x<P, NT>(Xs, wv, Xh, Xl);

    // y of the warp's row bands: exp(cum_i) C.state + W x + D x
    float yacc[BANDS / NW][P / 8][4];
#pragma unroll
    for (int k = 0; k < BANDS / NW; ++k) {
      const int r0 = 16 * (warp + NW * k);
      float (&ya)[P / 8][4] = yacc[k];
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) ya[n][q] = 0.f;
      repro::mma_abt<N, P / 8>(ya, Cs, r0, Sh, lane);
      repro::mma_abt<N, P / 8>(ya, Cs, r0, Sl, lane);
      const int i0 = r0 + g, i1 = i0 + 8;
      const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        ya[n][0] *= e0; ya[n][1] *= e0; ya[n][2] *= e1; ya[n][3] *= e1;
      }
      // W x over the column tiles j <= i (kc <= the band)
      for (int kc = 0; kc <= r0 / 16; ++kc) {
        float w[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = q < 2 ? i0 : i1, j = 16 * kc + 8 * u + 2 * t + (q & 1);
            w[u][q] = j <= i ? CB[i * LP + j] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
        }
        uint32_t ah[4], al[4];
        float wh[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q) wh[u][q] = bf_round(w[u][q]);
        ah[0] = repro::pack_bf16(wh[0][0], wh[0][1]);
        ah[1] = repro::pack_bf16(wh[0][2], wh[0][3]);
        ah[2] = repro::pack_bf16(wh[1][0], wh[1][1]);
        ah[3] = repro::pack_bf16(wh[1][2], wh[1][3]);
        al[0] = repro::pack_bf16(w[0][0] - wh[0][0], w[0][1] - wh[0][1]);
        al[1] = repro::pack_bf16(w[0][2] - wh[0][2], w[0][3] - wh[0][3]);
        al[2] = repro::pack_bf16(w[1][0] - wh[1][0], w[1][1] - wh[1][1]);
        al[3] = repro::pack_bf16(w[1][2] - wh[1][2], w[1][3] - wh[1][3]);
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          uint32_t xv[4];
          repro::ldsm_x4_t(xv, Xs + Tile<P>::at(16 * kc + repro::a_row(lane),
                                                2 * dp + repro::a_chunk(lane)));
          repro::mma_bf16(ya[2 * dp], ah, xv[0], xv[1]);
          repro::mma_bf16(ya[2 * dp + 1], ah, xv[2], xv[3]);
          repro::mma_bf16(ya[2 * dp], al, xv[0], xv[1]);
          repro::mma_bf16(ya[2 * dp + 1], al, xv[2], xv[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {     // + D x
        const int off0 = Tile<P>::at(i0, n) + 2 * t, off1 = Tile<P>::at(i1, n) + 2 * t;
        ya[n][0] += Dh * __bfloat162float(Xs[off0]);
        ya[n][1] += Dh * __bfloat162float(Xs[off0 + 1]);
        ya[n][2] += Dh * __bfloat162float(Xs[off1]);
        ya[n][3] += Dh * __bfloat162float(Xs[off1 + 1]);
      }
    }
    __syncthreads();              // Xh and Xl are complete
    update_state<P, N>(st, expf(cum[L - 1]), Xh, Xl, Bs, p0, lane);
    __syncthreads();              // no warp reads Xh any more: it stages y
#pragma unroll
    for (int k = 0; k < BANDS / NW; ++k) {
      const int r0 = 16 * (warp + NW * k);
      repro::store_rows<P>(yacc[k], 1.f, 1.f, Xh, r0, yb, (long long)H * P, t0 + r0, S, lane);
    }
    __syncthreads();              // the next chunk's loads overwrite the tiles
  }
  if (sg == nseg - 1) {
    float* so = state_out + ((size_t)b * H + h) * P * N;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      *reinterpret_cast<float2*>(so + (p0 + g) * N + 8 * n + 2 * t) =
          make_float2(st[n][0], st[n][1]);
      *reinterpret_cast<float2*>(so + (p0 + g + 8) * N + 8 * n + 2 * t) =
          make_float2(st[n][2], st[n][3]);
    }
  }
}

template <int P, int N>
cudaError_t launch_bf16(const bf16* x, const bf16* dt_raw, const float* A_log, const bf16* B,
                        const bf16* C, const float* D, const float* dt_bias, bf16* y,
                        float* state, float* cb, float* states, float* segld, int b, int S,
                        int H, int cps, cudaStream_t stream) {
  if (cps < 1) return cudaErrorInvalidValue;
  const int nc = (S + L - 1) / L;
  const int nseg = (nc + cps - 1) / cps;
  ssd_cb<N><<<dim3(nc, b), 128, 0, stream>>>(B, C, cb, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nseg > 1) {
    constexpr int smem1 = seg_smem<P, N>();
    auto k1 = ssd_seg_state<P, N>;
    err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (err != cudaSuccess) return err;
    k1<<<dim3(nseg - 1, H, b), 2 * P, smem1, stream>>>(x, dt_raw, A_log, B, dt_bias, states,
                                                       segld, S, H, cps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_state_pass<<<dim3((P * N / 4 + 255) / 256, H, b), 256, 0, stream>>>(states, segld,
                                                                           nseg - 1, H, P * N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int smem3 = scan_smem<P, N>();
  auto k3 = ssd_chunk_scan<P, N>;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (err != cudaSuccess) return err;
  k3<<<dim3(nseg, H, b), 2 * P, smem3, stream>>>(x, dt_raw, A_log, B, C, D, dt_bias, cb, states,
                                                 y, state, S, H, cps);
  return cudaGetLastError();
}

cudaError_t launch_walk(int P, int N, const void* x, const void* dt_raw, const float* A_log,
                        const void* B, const void* C, const float* D, const float* dt_bias,
                        void* y, float* state, int b, int S, int H, cudaStream_t stream) {
  auto go = [&](auto kern, int smem) -> cudaError_t {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(H, b), WALK_NT, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt_raw), A_log,
        static_cast<const float*>(B), static_cast<const float*>(C), D, dt_bias,
        static_cast<float*>(y), state, S, H);
    return cudaGetLastError();
  };
  if (P == 32 && N == 16)
    return go(ssd_chunk_walk<float, 32, 16>, smem_floats<32, 16>() * (int)sizeof(float));
  if (P == 64 && N == 128)
    return go(ssd_chunk_walk<float, 64, 128>, smem_floats<64, 128>() * (int)sizeof(float));
  return cudaErrorInvalidValue;
}

}  // namespace

// x (b, S, H, P), dt_raw (b, S, H), B and C (b, S, N), all contiguous in one
// dtype (0 = float32, 1 = bfloat16); A_log, D, dt_bias (H,) float32; outputs
// y (b, S, H, P) in that dtype and state (b, H, P, N) float32.  Scratch,
// bfloat16 only (float32 calls may pass null): cb (b, nc, 64, 64) float32
// with nc = ceil(S / 64), states (b, nseg - 1, H, P, N) and segld
// (b, nseg - 1, H) float32 with nseg = ceil(nc / cps), cps chunks a segment
// (the wrapper's plan, kernels/meta.py's ssd_segment_chunks; unused in
// float32).  The (P, N) pairs built:
// mamba2-130m's (64, 128) and its smoke config's (32, 16).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt_raw, const void* A_log,
                              const void* B, const void* C, const void* D,
                              const void* dt_bias, void* y, void* state, void* cb,
                              void* states, void* segld, int b, int S, int H, int P, int N,
                              int cps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(A_log);
  const float* dv = static_cast<const float*>(D);
  const float* db = static_cast<const float*>(dt_bias);
  float* st = static_cast<float*>(state);
  if (dtype == 0)
    return (int)launch_walk(P, N, x, dt_raw, al, B, C, dv, db, y, st, b, S, H, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dr = static_cast<const bf16*>(dt_raw);
  const bf16* bm = static_cast<const bf16*>(B);
  const bf16* cm = static_cast<const bf16*>(C);
  bf16* yb = static_cast<bf16*>(y);
  float* cbf = static_cast<float*>(cb);
  float* sts = static_cast<float*>(states);
  float* sl = static_cast<float*>(segld);
  if (P == 32 && N == 16)
    return (int)launch_bf16<32, 16>(xb, dr, al, bm, cm, dv, db, yb, st, cbf, sts, sl, b, S, H,
                                    cps, s);
  if (P == 64 && N == 128)
    return (int)launch_bf16<64, 128>(xb, dr, al, bm, cm, dv, db, yb, st, cbf, sts, sl, b, S, H,
                                     cps, s);
  return (int)cudaErrorInvalidValue;
}

// rows per chunk
extern "C" int repro_ssd_scan_chunk() { return L; }
