// Flash attention forward for Hopper (sm_90a): causal / sliding-window GQA.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (the Pallas TPU kernel `_kernel`, which walks KV blocks sequentially per
// (batch, q-head, q-block) and carries the online-softmax state in VMEM).
//
// What bounds it on an H100: at the serving prefill shape (b=8, s=512, H=24,
// K=8, D=128, bf16) one call moves ~67 MB (q, k, v, o once each, ~20 us at
// 3.35 TB/s) and does ~1.3e10 causal FLOPs (~13 us at 989 TFLOP/s bf16), so
// the card's floor is the memory traffic.  This first version does its
// arithmetic in float32 on the CUDA cores, not on the tensor cores, and is
// bound by shared-memory loads feeding those FMAs (about one 4-byte shared
// load per FMA), i.e. well above the floor.
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, batch);
// the KV head is h / G.  The block loops over 32-row K/V tiles staged in
// shared memory (as float32, rows padded by one word so the column reads do
// not collide in a bank), visiting only tiles inside the causal / window
// band -- the same `live` test as the TPU kernel -- and stopping at the
// first tile past the diagonal.  Four threads share a query row: each
// computes 8 of the 32 scores, the row max and sum are combined with two
// warp shuffles, and each thread owns D/4 output columns of the fp32
// accumulator in registers.  m, l and acc stay fp32; p is rounded to v's
// dtype before PV, as in the TPU kernel; keys past sk are masked in-kernel
// (no padded copy).  Tiles are visited in reverse q order so the longest
// causal rows start first.  Tensor-core MMA (wgmma), TMA staging and warp
// specialisation are left for the PR that makes this fast.
//
// Head dims 32, 64 and 128 serve the GQA models; 48 and 192 are the MLA
// prefill's qk width dn + dr (deepseek-v2's smoke and full widths), whose v
// arrives zero-padded to that width.  At D = 192 a block's shared memory is
// 107,136 bytes, so two blocks (the launch bound) still fit an SM's 228 KB;
// at deepseek-v2's prefill (b=8, s=512, H=K=128, bf16) a call moves ~805 MB
// (~240 us at 3.35 TB/s), the bound, against ~1.0e11 causal FLOPs.
//
// For training it also writes each row's log-sum-exp, lse = m + log(l) in
// float32 (b, H, sq) and in the scaled units of the scores, from which the
// backward (flash_attention_bwd.cu) recomputes P; a row the mask leaves
// with no key gets NEG_INF.  The serving path passes a null pointer.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::NEG_INF;
using repro::round_to;
using repro::to_f;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per K/V tile
constexpr int NT = 256;       // threads: 4 per query row
constexpr int CPT = BK / 4;   // score columns per thread

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int H, int K,
                       int causal, int window, float scale) {
  constexpr int LD = D + 1;   // padded row stride of the q and k tiles
  constexpr int DPT = D / 4;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // (BQ, LD)
  float* ks = qs + BQ * LD;    // (BK, LD)
  float* vs = ks + BK * LD;    // (BK, D)
  float* ps = vs + BK * D;     // (BQ, BK + 1): p rounded to T

  const int tid = threadIdx.x;
  const int r = tid >> 2;      // query row within the tile
  const int g = tid & 3;       // which quarter of the row this thread holds
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int qrow = q0 + r;

  for (int e = tid; e < BQ * D; e += NT) {
    const int rr = e / D, d = e % D;
    const int qi = q0 + rr;
    qs[rr * LD + d] =
        qi < sq ? to_f(q[(((size_t)b * sq + qi) * H + h) * D + d]) : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    // the TPU kernel's `live` test for the (q tile, k tile) pair
    if (causal && k0 > q0 + BQ - 1) break;            // past the diagonal
    if (window && k0 + BK - 1 <= q0 - window) continue;  // before the band
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int rr = e / D, d = e % D;
      const int kj = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (kj < sk) {
        const size_t off = (((size_t)b * sk + kj) * K + kh) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[rr * LD + d] = kv;
      vs[rr * D + d] = vv;
    }
    __syncthreads();

    float s[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[j] = fmaf(qv, ks[(g + 4 * j) * LD + d], s[j]);
    }

    float mx = NEG_INF;
    unsigned ok = 0u;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kp = k0 + g + 4 * j;
      const bool live = kp < sk && (!causal || kp <= qrow) &&
                        (!window || kp > qrow - window);
      s[j] = live ? s[j] * scale : NEG_INF;
      ok |= (unsigned)live << j;
      mx = fmaxf(mx, s[j]);
    }
    // the four threads of a row are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = ((ok >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      rs += p;
      ps[r * (BK + 1) + g + 4 * j] = round_to<T>(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_i = l_i * alpha + rs;
    m_i = m_new;
    __syncwarp();  // row r's p values come from lanes of this warp only

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = ps[r * (BK + 1) + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[c * D + g + 4 * i], acc[i]);
    }
  }

  if (qrow < sq) {
    const float den = fmaxf(l_i, 1e-30f);
    T* orow = o + (((size_t)b * sq + qrow) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[g + 4 * i] = from_f<T>(acc[i] / den);
    if (lse != nullptr && g == 0)
      lse[((size_t)b * H + h) * sq + qrow] = l_i > 0.f ? m_i + logf(l_i) : NEG_INF;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int H, int K, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, H, b);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q),
                                   static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(o),
                                   lse, sq, sk, H, K, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int b, int sq, int sk, int H, int K,
                     int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, b, sq, sk, H, K, causal, window, scale, stream);
    case 48: return launch<T, 48>(q, k, v, o, lse, b, sq, sk, H, K, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, sq, sk, H, K, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, sq, sk, H, K, causal, window, scale, stream);
    case 192: return launch<T, 192>(q, k, v, o, lse, b, sq, sk, H, K, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, sq, H, D), k/v (b, sk, K, D), o (b, sq, H, D), all contiguous and of
// one dtype; lse (b, H, sq) float32, or null where it is not wanted.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int b,
                                     int sq, int sk, int H, int K, int D,
                                     int dtype, int causal, int window,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, o, l, b, sq, sk, H, K, causal, window, scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, o, l, b, sq, sk, H, K, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
