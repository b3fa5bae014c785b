// Split-KV flash decode for Hopper (sm_90a): one new token per row against a
// (ring) KV cache with an explicit (b, S) validity mask, GQA.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py::flash_decode_gqa
// (the Pallas TPU kernel `_gqa_kernel`, which emits per-block (acc, m, l)
// partials, and its jnp merge `_combine`).
//
// What bounds it on an H100: one decode call reads the valid rows of the K
// and V caches once (b=8, S=544, K=8, D=128, bf16, all rows valid: ~17.8 MB,
// ~5.3 us at 3.35 TB/s) and does
// ~4 FLOPs per cached element per query head -- G=3 heads share each KV
// element, so ~6 FLOPs per byte, far below the ~295 at which the tensor
// cores would bind.  It is bound by memory traffic.
//
// Design: the cache length is the axis with parallelism, so the grid is
// (cache block of 256 rows, KV head, batch) and no state carries between
// blocks.  Each block stages the G query rows of its KV head in shared
// memory; its warps walk the block's cache rows, one row per warp, the 32
// lanes reading the row's D elements together and reducing the G dot
// products with shuffles.  Invalid rows and rows past S are skipped, not
// padded -- neither their K nor their V is read -- so no decode step copies
// the cache, and a non-finite value in a masked slot cannot reach the output.  A warp per query head then
// turns the block's scores into the partial (m, l) and p (p rounded to v's
// dtype, as in the TPU kernel; masked rows give p = 0, so a fully masked
// block yields acc = 0, l = 0, m = NEG_INF and drops out of the merge),
// and the threads accumulate p.V over the block with consecutive threads
// on consecutive columns so the V reads coalesce.  A second, small kernel
// merges the partials with exp(m_blk - m_glob) and writes the output in
// v's dtype; a row with no valid entry comes out as 0, as the TPU kernel's
// merge gives (0 / max(0, 1e-30)).
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::NEG_INF;
using repro::round_to;
using repro::to_f;
using repro::warp_max;
using repro::warp_sum;

constexpr int BS = 256;   // cache rows per block (the TPU kernel's block_s)
constexpr int NT = 256;   // threads per block
constexpr int GCH = 4;    // query heads accumulated together in p.V

// q (b, H, D) as rows kh*G .. kh*G+G-1; partials indexed (b, ns, K, G[, D]).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_partials(const T* __restrict__ q, const T* __restrict__ kc,
                const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                float* __restrict__ acc_out, float* __restrict__ m_out,
                float* __restrict__ l_out, int S, int H, int K, float scale) {
  constexpr int EPL = D / 32;          // elements of a cache row per lane
  constexpr int NCH = NT / D;          // row chunks in p.V
  constexpr int RPC = BS / NCH;        // cache rows per p.V chunk
  extern __shared__ float smem[];
  const int G = H / K;
  float* qs = smem;                    // (G, D)
  float* ps = qs + G * D;              // (G, BS): scores, then p
  float* red = ps + G * BS;            // (NCH, G, D): p.V per chunk
  __shared__ uint8_t live[BS];         // row valid and inside the cache

  const int js = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int ns = gridDim.x;
  const int s0 = js * BS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < G * D; e += NT)
    qs[e] = to_f(q[((size_t)b * H + (size_t)kh * G) * D + e]);
  __syncthreads();

  const uint8_t* vrow = valid + (size_t)b * S;
  for (int rl = warp; rl < BS; rl += NT / 32) {
    const int s = s0 + rl;
    const bool ok = s < S && vrow[s];
    if (lane == 0) live[rl] = ok;
    if (!ok) {                         // warp-uniform branch
      for (int gg = lane; gg < G; gg += 32) ps[gg * BS + rl] = NEG_INF;
      continue;
    }
    const T* krow = kc + (((size_t)b * S + s) * K + kh) * D;
    float kr[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) kr[i] = to_f(krow[lane + 32 * i]);
    for (int gg = 0; gg < G; ++gg) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) dot = fmaf(qs[gg * D + lane + 32 * i], kr[i], dot);
      dot = warp_sum(dot);
      if (lane == 0) ps[gg * BS + rl] = dot * scale;
    }
  }
  __syncthreads();

  for (int gg = warp; gg < G; gg += NT / 32) {
    float* prow = ps + gg * BS;
    float mx = NEG_INF;
    for (int i = lane; i < BS; i += 32) mx = fmaxf(mx, prow[i]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int i = lane; i < BS; i += 32) {
      const float sv = prow[i];
      const float p = sv == NEG_INF ? 0.f : expf(sv - mx);
      l += p;
      prow[i] = round_to<T>(p);
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t idx = (((size_t)b * ns + js) * K + kh) * G + gg;
      m_out[idx] = mx;
      l_out[idx] = l;
    }
  }
  __syncthreads();

  const int d = tid % D, ch = tid / D;
  const int r_lo = ch * RPC;
  const int r_hi = min(r_lo + RPC, S - s0);
  for (int g0 = 0; g0 < G; g0 += GCH) {
    float a[GCH];
#pragma unroll
    for (int j = 0; j < GCH; ++j) a[j] = 0.f;
#pragma unroll 4
    for (int rl = r_lo; rl < r_hi; ++rl) {
      // a masked row has p = 0 and its V is not read: a predicated load,
      // not a branch, so the unrolled loads stay in flight together
      const float vv =
          live[rl] ? to_f(vc[(((size_t)b * S + s0 + rl) * K + kh) * D + d]) : 0.f;
#pragma unroll
      for (int j = 0; j < GCH; ++j)
        if (g0 + j < G) a[j] = fmaf(ps[(g0 + j) * BS + rl], vv, a[j]);
    }
#pragma unroll
    for (int j = 0; j < GCH; ++j)
      if (g0 + j < G) red[(ch * G + g0 + j) * D + d] = a[j];
  }
  __syncthreads();

  float* acc_blk = acc_out + (((size_t)b * ns + js) * K + kh) * G * D;
  for (int e = tid; e < G * D; e += NT) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) sum += red[c * G * D + e];
    acc_blk[e] = sum;
  }
}

// Merge the ns partials of each (b, h): grid (H, b), D threads.  The partial
// of block js for head h sits at (b*ns + js)*H + h, since h = kh*G + g.
template <typename T>
__global__ void decode_combine(const float* __restrict__ acc,
                               const float* __restrict__ m,
                               const float* __restrict__ l, T* __restrict__ out,
                               int ns, int H, int D) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  float m_g = NEG_INF;
  for (int js = 0; js < ns; ++js) m_g = fmaxf(m_g, m[((size_t)b * ns + js) * H + h]);
  float l_g = 0.f, o = 0.f;
  for (int js = 0; js < ns; ++js) {
    const size_t idx = ((size_t)b * ns + js) * H + h;
    const float alpha = expf(m[idx] - m_g);
    l_g += l[idx] * alpha;
    o += acc[idx * D + d] * alpha;
  }
  out[((size_t)b * H + h) * D + d] = from_f<T>(o / fmaxf(l_g, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, float* acc, float* m, float* l,
                   void* out, int b, int S, int H, int K, float scale,
                   cudaStream_t stream) {
  const int G = H / K;
  const int ns = (S + BS - 1) / BS;
  const int smem = (G * D + G * BS + (NT / D) * G * D) * (int)sizeof(float);
  auto kern = decode_partials<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(ns, K, b), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, acc, m, l, S, H, K, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<dim3(H, b), D, 0, stream>>>(acc, m, l, static_cast<T*>(out),
                                                  ns, H, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const uint8_t* valid, float* acc, float* m, float* l,
                     void* out, int b, int S, int H, int K, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, valid, acc, m, l, out, b, S, H, K, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, acc, m, l, out, b, S, H, K, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, acc, m, l, out, b, S, H, K, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, 1, H, D); k/v caches (b, S, K, D); valid (b, S) of 0/1 bytes;
// scratch acc (b, ns, K, G, D), m and l (b, ns, K, G) float32 with
// ns = ceil(S / 256); out (b, 1, H, D).  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int repro_flash_decode_gqa(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* acc, void* m, void* l, void* out,
                                      int b, int S, int H, int K, int D,
                                      int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, vm, a, mm, ll, out, b, S, H, K, scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, vm, a, mm, ll, out, b, S, H, K, scale, s);
  return (int)cudaErrorInvalidValue;
}

// rows of scratch a call needs: ns = ceil(S / block)
extern "C" int repro_flash_decode_block_s() { return BS; }
