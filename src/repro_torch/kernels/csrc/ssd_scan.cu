// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a), one B/C
// group: y = SSD(x, dt, A, B, C) + D x and the final state.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan (the Pallas TPU
// kernel `_kernel`, whose grid walks (batch, head, chunk) with the chunk axis
// sequential and carries the P x N state in VMEM scratch).
//
// What bounds it on an H100: a call reads x, dt_raw, B and C once and writes
// y and the float32 state once (mamba2-130m's prefill, b=8, s=512, h=24,
// P=64, N=128, bf16: 33.75 MB, ~10.1 us at 3.35 TB/s).  Its products inside
// a chunk (C.B^T, W.x, C.state, x^T.B) come to ~5.6 GFLOP at this shape,
// ~5.7 us on the bf16 tensor cores, so the ideal kernel is bound by bytes.
// This one computes on the CUDA cores in float32 (67 TFLOP/s peak, ~84 us
// for those flops), so it is bound by operations and shared-memory reads.
//
// Design: the recurrence is sequential in the chunks, and blocks on a GPU run
// in no order, so one block per (head, batch) walks its chunks of L = 64 rows
// in a loop and keeps the P x N float32 state in shared memory for the whole
// walk (32 KB at P=64, N=128); the final state is a plain store.  One launch
// a layer.  For each chunk the block
//   1. stages x (L x P), B and C (L x N, transposed, rows padded to L + 4
//      floats so that the column reads below do not collide in banks) as
//      float32, computes dt = softplus(dt_raw + dt_bias) (0 past the end of
//      the sequence, as the Pallas kernel's padding rows) and the inclusive
//      cumsum of dt A with one warp's shuffle scan;
//   2. forms W = (C B^T) o exp(cum_i - cum_j) o dt_j on j <= i and 0 above the
//      diagonal -- exp is taken only where j <= i, where the exponent is <= 0;
//   3. writes y = W x + exp(cum_i) C . state + D x for the chunk's rows, the
//      state being the one carried in;
//   4. updates state <- state exp(cum_L) + sum_j dt_j exp(cum_L - cum_j) x_j B_j^T.
// Each product is register-tiled (4 columns x 4-8 rows a thread, 256
// threads).  B and C are shared by all heads (one group): a later design can
// compute C.B^T once per (batch, chunk) instead of once per head.  The chunk
// length differs from the plain version's 128; chunking is exact in math, so
// the two differ by rounding only.
//
// Known weakness: at b=1 this runs h = 24 blocks on 132 SMs, each sequential
// over s / 64 chunks.  The chunk-parallel form (chunk states in parallel, a
// short inter-chunk pass, chunk outputs in parallel) on the tensor cores is
// the speed step for a later version.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int NT = 256;     // threads per block
constexpr int L = 64;       // rows per chunk
constexpr int LP = L + 4;   // padded row of the transposed B, C and of W

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
__global__ void __launch_bounds__(NT)
ssd_chunk_walk(const T* __restrict__ x, const T* __restrict__ dt_raw,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ dt_bias, T* __restrict__ y,
               float* __restrict__ state_out, int S, int H) {
  static_assert(P % 4 == 0 && NT % (P / 4) == 0 && L % (NT / (P / 4)) == 0,
                "the y tiles must cover the chunk");
  static_assert(L % 32 == 0 && NT % (L / 4) == 0 && L % (NT / (L / 4)) == 0,
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
  for (int e = tid; e < N * P; e += NT) st[e] = 0.f;
  __syncthreads();

  const int nc = (S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    // 1. stage the chunk; rows past the sequence are zeros with dt = 0
    for (int e = tid; e < L * P; e += NT) {
      const int i = e / P, t = t0 + i;
      xs[e] = t < S ? to_f(x[(((size_t)b * S + t) * H + h) * P + e % P]) : 0.f;
    }
    for (int e = tid; e < L * N; e += NT) {
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
      constexpr int TJ = L / 4, TI = NT / TJ, RI = L / TI;
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
      constexpr int TP = P / 4, TI = NT / TP, RI = L / TI;
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
      constexpr int TP = P / 4, TN = NT / TP, RN = (N + TN - 1) / TN;
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
  for (int e = tid; e < P * N; e += NT) so[e] = st[(e % N) * P + e / N];
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* dt_raw, const float* A_log,
                   const void* B, const void* C, const float* D,
                   const float* dt_bias, void* y, float* state, int b, int S,
                   int H, cudaStream_t stream) {
  constexpr int smem = smem_floats<P, N>() * (int)sizeof(float);
  auto kern = ssd_chunk_walk<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, b), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt_raw), A_log,
      static_cast<const T*>(B), static_cast<const T*>(C), D, dt_bias,
      static_cast<T*>(y), state, S, H);
  return cudaGetLastError();
}

// the (P, N) pairs built: mamba2-130m's (64, 128) and its smoke config's
// (32, 16); the wrapper's SHAPES lists the same
template <typename T>
cudaError_t launch_pn(int P, int N, const void* x, const void* dt_raw,
                      const float* A_log, const void* B, const void* C,
                      const float* D, const float* dt_bias, void* y,
                      float* state, int b, int S, int H, cudaStream_t stream) {
  if (P == 32 && N == 16)
    return launch<T, 32, 16>(x, dt_raw, A_log, B, C, D, dt_bias, y, state, b, S, H, stream);
  if (P == 64 && N == 128)
    return launch<T, 64, 128>(x, dt_raw, A_log, B, C, D, dt_bias, y, state, b, S, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (b, S, H, P), dt_raw (b, S, H), B and C (b, S, N), all contiguous in one
// dtype (0 = float32, 1 = bfloat16); A_log, D, dt_bias (H,) float32; outputs
// y (b, S, H, P) in that dtype and state (b, H, P, N) float32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt_raw,
                              const void* A_log, const void* B, const void* C,
                              const void* D, const void* dt_bias, void* y,
                              void* state, int b, int S, int H, int P, int N,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(A_log);
  const float* dv = static_cast<const float*>(D);
  const float* db = static_cast<const float*>(dt_bias);
  float* st = static_cast<float*>(state);
  if (dtype == 0)
    return (int)launch_pn<float>(P, N, x, dt_raw, al, B, C, dv, db, y, st, b, S, H, s);
  if (dtype == 1)
    return (int)launch_pn<__nv_bfloat16>(P, N, x, dt_raw, al, B, C, dv, db, y, st, b, S, H, s);
  return (int)cudaErrorInvalidValue;
}

// rows per chunk of the walk
extern "C" int repro_ssd_scan_chunk() { return L; }
