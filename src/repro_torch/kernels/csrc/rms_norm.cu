// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale, one
// block per row, its sum of squares in an order set by the row width alone.
//
// Replaces: no Pallas kernel.  The JAX package's
// src/repro/models/common.py::rms_norm is left to XLA; the port's plain
// version (kernels/rms_norm/ref.py) is PyTorch's float32 mean, whose CUDA
// reduction sizes its thread block by the number of rows -- one row alone
// is spread over more threads than the same row among eight, so the two
// sum in other orders and can differ in the last bit.  In a decode step
// that was enough to flip greedy tokens of the batchers against
// per-request decoding (chip_smoke.py's batch probe found Mamba2's gated
// norm first).  Here a row's bits depend on the row alone.
//
// What bounds it on an H100: bytes.  A row is read twice (the sum, then the
// output; the second read comes from L1/L2) and written once, ~3 flops an
// element: at llama3.2-3b's prefill (4,096 rows of 3,072 bf16) 50 MB in and
// out, ~15 us at 3.35 TB/s.  In a decode step (8 rows) it is one launch
// where the plain version issues seven, which is what the host-bound
// decode pays for.
//
// Design: NT = 256 threads a row.  Thread t takes the 16-byte chunks t,
// t + NT, t + 2 NT, ... (8 bf16 or 4 float32 values each) in that order
// and sums their squares in float32; the 32 lanes of a warp are summed by a
// butterfly of shuffles and the 8 warps' sums by thread 0 in warp order.
// So the order is fixed by d, never by the rows beside it or the grid.
// rstd = rsqrt(sum / d + eps) is kept in float32 (and written out for the
// backward), and each output is (x * rstd) * scale in float32, rounded
// once to x's dtype, as the plain version rounds.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;
using repro::warp_sum;

constexpr int NT = 256;

template <typename T, typename S>
__global__ void __launch_bounds__(NT)
rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                float* __restrict__ rstd, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float part[NT / 32];
  __shared__ float r_s;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const int chunks = d / VEC;

  float acc = 0.f;
  for (int c = threadIdx.x; c < chunks; c += NT) {
    const uint4 raw = xr[c];
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f(v[e]);
      acc += f * f;
    }
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += part[w];
    r_s = rsqrtf(s / d + eps);
    if (rstd) rstd[row] = r_s;
  }
  __syncthreads();
  const float r = r_s;
  for (int c = threadIdx.x; c < chunks; c += NT) {
    const uint4 raw = xr[c];
    const T* v = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o[e] = from_f<T>((to_f(v[e]) * r) * to_f(scale[c * VEC + e]));
    yr[c] = out;
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* y, float* rstd, long long rows,
                   int d, float eps, cudaStream_t stream) {
  if (d % (16 / (int)sizeof(T)) || rows <= 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  rms_norm_kernel<T, S><<<(unsigned)rows, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), rstd, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_s(int scale_dtype, const void* x, const void* scale, void* y, float* rstd,
                     long long rows, int d, float eps, cudaStream_t stream) {
  if (scale_dtype == 0) return launch<T, float>(x, scale, y, rstd, rows, d, eps, stream);
  if (scale_dtype == 1) return launch<T, __nv_bfloat16>(x, scale, y, rstd, rows, d, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y (rows, d) contiguous, 16-byte aligned, of one dtype (0 float32, 1
// bfloat16); scale (d,) of scale_dtype; rstd (rows,) float32 or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rms_norm(const void* x, const void* scale, void* y, void* rstd,
                              long long rows, int d, int dtype, int scale_dtype, float eps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0) return (int)launch_s<float>(scale_dtype, x, scale, y, r, rows, d, eps, s);
  if (dtype == 1) return (int)launch_s<__nv_bfloat16>(scale_dtype, x, scale, y, r, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
