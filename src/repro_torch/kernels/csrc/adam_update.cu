// Fused mixed-precision Adam for Hopper (sm_90a): one pass over a leaf.
//
// Replaces: src/repro/kernels/adam_update/adam_update.py::adam_update_fused
// (the Pallas TPU kernel `_kernel`, a 1-D grid over 128-lane tiles with the
// seven scalars in SMEM, on a copy padded to a whole number of tiles).
//
// What bounds it on an H100: nothing but bytes.  Per parameter it reads g,
// m, v and master (16 B, fp32) and writes m, v, master (12 B) and the
// parameter (2 B in bf16): 30 B for ~15 flops, so at 3.35 TB/s the 353.5 M
// parameters of gpt2-350m take >= 3.2 ms and the arithmetic is free.
//
// Design: a grid-stride loop, each thread taking four parameters at a time
// with 16-byte loads and stores of the fp32 streams (and one 8-byte store of
// four bf16 parameters), so every warp moves whole 128-byte lines; the last
// n % 4 elements are done one by one by the first threads of block 0 (no
// padded copy).  m, v and master are updated in place and the parameter is
// written into the model's own storage.  The scalars arrive as kernel
// arguments, so nothing is read from device memory beyond the five streams:
// lr, c1 and c2 change every step.  The arithmetic is the JAX oracle's
// (src/repro/kernels/adam_update/ref.py), in float32, in the same order.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;

constexpr int NT = 256;

struct Scalars {
  float lr, beta1, omb1, beta2, omb2, eps, wd, c1, c2;
};

__device__ __forceinline__ void step(float g, float& m, float& v, float& mp,
                                     const Scalars& s) {
  m = s.beta1 * m + s.omb1 * g;
  v = s.beta2 * v + s.omb2 * (g * g);
  const float upd = (m / s.c1) / (sqrtf(v / s.c2) + s.eps) + s.wd * mp;
  mp = mp - s.lr * upd;
}

template <typename P>
__device__ __forceinline__ void store4(P* p, size_t i, float4 x);

template <>
__device__ __forceinline__ void store4<float>(float* p, size_t i, float4 x) {
  reinterpret_cast<float4*>(p)[i] = x;
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      size_t i, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = packed;
}

template <typename P>
__global__ void __launch_bounds__(NT)
adam_update_kernel(const float* __restrict__ g, float* __restrict__ m,
                   float* __restrict__ v, float* __restrict__ master,
                   P* __restrict__ param, size_t n, Scalars s) {
  const size_t n4 = n / 4;
  const size_t stride = (size_t)gridDim.x * NT;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  float4* p4 = reinterpret_cast<float4*>(master);
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n4; i += stride) {
    const float4 gg = g4[i];
    float4 mm = m4[i], vv = v4[i], pp = p4[i];
    step(gg.x, mm.x, vv.x, pp.x, s);
    step(gg.y, mm.y, vv.y, pp.y, s);
    step(gg.z, mm.z, vv.z, pp.z, s);
    step(gg.w, mm.w, vv.w, pp.w, s);
    m4[i] = mm;
    v4[i] = vv;
    p4[i] = pp;
    store4<P>(param, i, pp);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4) {  // the ragged tail
    const size_t i = n4 * 4 + threadIdx.x;
    float mm = m[i], vv = v[i], pp = master[i];
    step(g[i], mm, vv, pp, s);
    m[i] = mm;
    v[i] = vv;
    master[i] = pp;
    param[i] = from_f<P>(pp);
  }
}

}  // namespace

// g, m, v, master: n contiguous float32, 16-byte aligned; param: n
// contiguous elements of float32 (pdtype 0) or bfloat16 (pdtype 1), aligned
// to four elements.  m, v and master are updated in place; param receives
// master' rounded to its type.  omb1 = 1 - beta1 and omb2 = 1 - beta2 as the
// caller rounds them.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_adam_update(const void* g, void* m, void* v, void* master,
                                 void* param, int pdtype, long long n,
                                 float lr, float beta1, float omb1, float beta2,
                                 float omb2, float eps, float wd, float c1,
                                 float c2, int n_sm, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Scalars s{lr, beta1, omb1, beta2, omb2, eps, wd, c1, c2};
  const size_t n4 = (size_t)n / 4;
  // enough blocks to fill every SM several times over, no more: the loop
  // strides over the rest
  size_t blocks = (n4 + NT - 1) / NT;
  const size_t cap = (size_t)n_sm * 8;
  if (blocks > cap) blocks = cap;
  if (blocks == 0) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pdtype == 0)
    adam_update_kernel<float><<<(unsigned)blocks, NT, 0, st>>>(
        static_cast<const float*>(g), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<float*>(master),
        static_cast<float*>(param), (size_t)n, s);
  else if (pdtype == 1)
    adam_update_kernel<__nv_bfloat16><<<(unsigned)blocks, NT, 0, st>>>(
        static_cast<const float*>(g), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<float*>(master),
        static_cast<__nv_bfloat16*>(param), (size_t)n, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
