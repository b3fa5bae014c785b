// Split-KV absorbed MLA decode for Hopper (sm_90a): one new token per row
// against the compressed cache of DeepSeek-V2's multi-head latent attention,
// with an explicit (b, S) validity mask.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py::flash_decode_mla
// (the Pallas TPU kernel `_mla_kernel`, which emits per-block (acc, m, l)
// partials over all H heads of one (batch, cache block), and its jnp merge
// `_combine`).  It computes, per row b and head h,
//   s_j = (q_lat[h] . c_kv[j] + q_rope[h] . k_rope[j]) / denom,
//   p_j = softmax over the valid j, o_lat[h] = sum_j p_j c_kv[j],
// with p rounded to c_kv's dtype before the PV product, as the TPU kernel.
//
// What bounds it on an H100: at deepseek-v2's widths (H=128, r=512, dr=64)
// and b=8, S=544, bf16, one call reads c_kv, k_rope, q_lat, q_rope and
// writes o_lat, ~7.2 MB (~2.2 us at 3.35 TB/s), and does ~1.2 GFLOP
// (2(r+dr) + 2r per head and cache row): ~1.2 us on the tensor cores, but
// ~18 us on the CUDA cores at 67 TFLOP/s float32.  Every head reads the same
// latent row, so the arithmetic intensity is H times the GQA decode's; this
// first version does its products on the CUDA cores and is bound by them.
// Tensor cores (mma.sync, then wgmma fed by TMA) are the next step.
//
// Design: the TPU program holds all H heads of a (batch, cache block); its
// float32 accumulator (H=128 x r=512, 256 KB) fits neither a block's shared
// memory nor its registers, so the heads are split across blocks.  The grid
// is (cache block of 256 rows, group of 16 heads, batch); no state carries
// between blocks.  A block stages its group's [q_lat | q_rope] rows in
// shared memory once, then walks its cache block in tiles of 32 rows: each
// tile's [c_kv | k_rope] rows are staged in shared memory as float32 with
// 16-byte loads, several in flight per thread (the other head groups
// re-read them, mostly from L2), the 16 x 32 scores are computed with
// 4 x 4 register tiles whose dot products 8 lanes split and reduce with
// shuffles, one warp per two heads turns them into p with an online-softmax
// update of the block's running (m, l), and each thread accumulates p . c_kv
// for 2 latent columns of all 16 heads in registers.  Invalid rows and rows
// past S are skipped, not padded: their cache rows are never read (zeros are
// staged), they get p = 0, and a tile with no valid row is skipped whole,
// so no decode step copies the cache and a non-finite value in a dead slot
// cannot reach the output.  A fully masked block yields acc = 0, l = 0,
// m = NEG_INF and drops out of the merge.  A second, small kernel merges
// the partials with exp(m_blk - m_glob) and writes o_lat in c_kv's dtype; a
// row with no valid entry comes out as 0 (0 / max(0, 1e-30)), as the TPU
// kernel's merge gives.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::NEG_INF;
using repro::round_to;
using repro::warp_max;
using repro::warp_sum;

constexpr int BS = 256;   // cache rows per block (the TPU kernel's block_s)
constexpr int TS = 32;    // cache rows per shared-memory tile (one per lane)
constexpr int HG = 16;    // query heads per block
constexpr int NT = 256;   // threads per block: 8 warps

__device__ __forceinline__ void widen(uint4 u, float* out, float) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  *reinterpret_cast<float4*>(out) = f;
}

__device__ __forceinline__ void widen(uint4 u, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float4 lo, hi;
  float2 f;
  f = __bfloat1622float2(h[0]); lo.x = f.x; lo.y = f.y;
  f = __bfloat1622float2(h[1]); lo.z = f.x; lo.w = f.y;
  f = __bfloat1622float2(h[2]); hi.x = f.x; hi.y = f.y;
  f = __bfloat1622float2(h[3]); hi.z = f.x; hi.w = f.y;
  reinterpret_cast<float4*>(out)[0] = lo;
  reinterpret_cast<float4*>(out)[1] = hi;
}

// Stage ROWS rows of [a | d] (a: R elements a row, d: DR) into dst as float32
// rows of R + DR, with 16-byte loads: a block's loads are all issued before
// any is converted, up to 8 per thread, so many are in flight at once.  Row
// j is read only if j < n_ok and (live is null or live[j]); otherwise it is
// staged as zeros.  a, d and every row start are 16-byte aligned (the
// wrapper checks the bases; R and DR are multiples of 16 bytes' elements).
template <typename T, int R, int DR, int ROWS>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ a,
                                           const T* __restrict__ d, int n_ok,
                                           const uint8_t* live) {
  constexpr int VE = 16 / (int)sizeof(T);  // elements per 16-byte load
  constexpr int VR = R / VE, VW = (R + DR) / VE;
  constexpr int NV = ROWS * VW;
  constexpr int ITERS = (NV + NT - 1) / NT;
  constexpr int CH = ITERS < 8 ? ITERS : 8;
  static_assert(R % VE == 0 && DR % VE == 0, "rows are read 16 bytes at a time");
  for (int i0 = 0; i0 < ITERS; i0 += CH) {
    uint4 buf[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int v = threadIdx.x + (i0 + i) * NT;
      const int j = v / VW, u = v % VW;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      if (v < NV && j < n_ok && (live == nullptr || live[j]))
        buf[i] = u < VR
            ? __ldg(reinterpret_cast<const uint4*>(a + (size_t)j * R + u * VE))
            : __ldg(reinterpret_cast<const uint4*>(d + (size_t)j * DR + (u - VR) * VE));
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int v = threadIdx.x + (i0 + i) * NT;
      if (v < NV) widen(buf[i], dst + (v / VW) * (R + DR) + (v % VW) * VE, T());
    }
  }
}

// q_lat (b, H, R), q_rope (b, H, DR), c_kv (b, S, R), k_rope (b, S, DR);
// partials indexed (b, ns, H[, R]).
template <typename T, int R, int DR>
__global__ void __launch_bounds__(NT, 2)
mla_partials(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
             const T* __restrict__ c_kv, const T* __restrict__ k_rope,
             const uint8_t* __restrict__ valid, float* __restrict__ acc_out,
             float* __restrict__ m_out, float* __restrict__ l_out, int S,
             int H, float denom) {
  constexpr int KD = R + DR;             // length of a score's dot product
  constexpr int KD4 = KD / 4;
  constexpr int CPT = (R + NT - 1) / NT; // latent columns per thread in p.V
  static_assert(KD % 4 == 0, "rows are read as float4");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // (HG, KD): [q_lat | q_rope] of the group
  float* cs = qs + HG * KD;      // (TS, KD): [c_kv | k_rope] rows of a tile
  float* ss = cs + TS * KD;      // (HG, TS): scaled, masked scores
  float* ps = ss + HG * TS;      // (TS, HG): p rounded to T
  float* ms = ps + TS * HG;      // (HG): running max of the block
  float* ls = ms + HG;           // (HG): running sum of p
  float* as = ls + HG;           // (HG): this tile's rescale of acc
  __shared__ uint8_t live[TS];   // row valid and inside the block

  const int js = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
  const int ns = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s_lo = js * BS, s_hi = min(s_lo + BS, S);

  // heads past H are staged as zeros and never written out
  stage_rows<T, R, DR, HG>(qs, q_lat + ((size_t)b * H + h0) * R,
                           q_rope + ((size_t)b * H + h0) * DR, H - h0, nullptr);
  if (tid < HG) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }

  float acc[HG][CPT];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[hh][i] = 0.f;

  // scores: warp w owns tile rows 4w..4w+3, the 8-lane group lane>>3 owns
  // heads 4(lane>>3)..+3, and lane&7 takes every 8th float4 of the dot
  // products (each quarter-warp then reads 128 contiguous bytes of one row)
  const int tj = warp, th = lane >> 3, kg = lane & 7;
  const uint8_t* vrow = valid + (size_t)b * S;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const float4* c4 = reinterpret_cast<const float4*>(cs);
  const float4* p4 = reinterpret_cast<const float4*>(ps);

  for (int t0 = s_lo; t0 < s_hi; t0 += TS) {
    __syncthreads();  // the previous tile's readers are done
    bool ok = false;
    if (tid < TS) {
      ok = t0 + tid < s_hi && vrow[t0 + tid];
      live[tid] = ok;
    }
    if (!__syncthreads_or(ok)) continue;  // a fully masked tile adds nothing
    stage_rows<T, R, DR, TS>(cs, c_kv + ((size_t)b * S + t0) * R,
                             k_rope + ((size_t)b * S + t0) * DR, TS, live);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int hi = 0; hi < 4; ++hi)
#pragma unroll
      for (int ji = 0; ji < 4; ++ji) sc[hi][ji] = 0.f;
    for (int kk = kg; kk < KD4; kk += 8) {
      float4 qv[4], cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q4[(4 * th + i) * KD4 + kk];
        cv[i] = c4[(4 * tj + i) * KD4 + kk];
      }
#pragma unroll
      for (int hi = 0; hi < 4; ++hi)
#pragma unroll
        for (int ji = 0; ji < 4; ++ji) {
          float a = sc[hi][ji];
          a = fmaf(qv[hi].x, cv[ji].x, a);
          a = fmaf(qv[hi].y, cv[ji].y, a);
          a = fmaf(qv[hi].z, cv[ji].z, a);
          a = fmaf(qv[hi].w, cv[ji].w, a);
          sc[hi][ji] = a;
        }
    }
#pragma unroll
    for (int hi = 0; hi < 4; ++hi)
#pragma unroll
      for (int ji = 0; ji < 4; ++ji) {
        float a = sc[hi][ji];
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        a += __shfl_xor_sync(0xffffffffu, a, 4);
        // every lane of the 8 holds the sum; lane kg stores two of the 16
        if (((hi * 4 + ji) >> 1) == kg) {
          const int j = 4 * tj + ji;
          ss[(4 * th + hi) * TS + j] = live[j] ? a / denom : NEG_INF;
        }
      }
    __syncthreads();

    // online softmax: warp w updates heads 2w and 2w+1, lane = tile row
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int hh = 2 * warp + u;
      const float sv = ss[hh * TS + lane];
      const float m_old = ms[hh];
      const float m_new = fmaxf(m_old, warp_max(sv));  // finite: a row is live
      const float p = live[lane] ? expf(sv - m_new) : 0.f;
      const float psum = warp_sum(p);
      ps[lane * HG + hh] = round_to<T>(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[hh] = alpha;
        ls[hh] = ls[hh] * alpha + psum;
        ms[hh] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float a = as[hh];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[hh][i] *= a;
    }
    for (int j = 0; j < TS; ++j) {
      float p[HG];
#pragma unroll
      for (int q = 0; q < HG / 4; ++q) {
        const float4 v = p4[j * (HG / 4) + q];  // a broadcast to the warp
        p[4 * q] = v.x;
        p[4 * q + 1] = v.y;
        p[4 * q + 2] = v.z;
        p[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + NT * i;
        if (c < R) {
          const float cv = cs[j * KD + c];
#pragma unroll
          for (int hh = 0; hh < HG; ++hh) acc[hh][i] = fmaf(p[hh], cv, acc[hh][i]);
        }
      }
    }
  }

  const size_t base = ((size_t)b * ns + js) * H;
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (h0 + hh >= H) break;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + NT * i;
      if (c < R) acc_out[(base + h0 + hh) * R + c] = acc[hh][i];
    }
  }
  __syncthreads();  // ms, ls were last written by other warps
  if (tid < HG && h0 + tid < H) {
    m_out[base + h0 + tid] = ms[tid];
    l_out[base + h0 + tid] = ls[tid];
  }
}

// Merge the ns partials of each (b, h): grid (H, b), R threads.
template <typename T>
__global__ void mla_combine(const float* __restrict__ acc,
                            const float* __restrict__ m,
                            const float* __restrict__ l, T* __restrict__ out,
                            int ns, int H, int R) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  float m_g = NEG_INF;
  for (int js = 0; js < ns; ++js) m_g = fmaxf(m_g, m[((size_t)b * ns + js) * H + h]);
  float l_g = 0.f, o = 0.f;
  for (int js = 0; js < ns; ++js) {
    const size_t idx = ((size_t)b * ns + js) * H + h;
    const float alpha = expf(m[idx] - m_g);
    l_g += l[idx] * alpha;
    o += acc[idx * R + d] * alpha;
  }
  out[((size_t)b * H + h) * R + d] = from_f<T>(o / fmaxf(l_g, 1e-30f));
}

template <typename T, int R, int DR>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* c_kv,
                   const void* k_rope, const uint8_t* valid, float* acc,
                   float* m, float* l, void* out, int b, int S, int H,
                   float denom, cudaStream_t stream) {
  const int ns = (S + BS - 1) / BS;
  const int smem =
      (HG * (R + DR) + TS * (R + DR) + 2 * HG * TS + 3 * HG) * (int)sizeof(float);
  auto kern = mla_partials<T, R, DR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(ns, (H + HG - 1) / HG, b), NT, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(c_kv), static_cast<const T*>(k_rope), valid, acc,
      m, l, S, H, denom);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_combine<T><<<dim3(H, b), R, 0, stream>>>(acc, m, l, static_cast<T*>(out),
                                               ns, H, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rd(int R, int DR, const void* q_lat, const void* q_rope,
                      const void* c_kv, const void* k_rope,
                      const uint8_t* valid, float* acc, float* m, float* l,
                      void* out, int b, int S, int H, float denom,
                      cudaStream_t stream) {
  if (R == 32 && DR == 16)
    return launch<T, 32, 16>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out, b, S, H, denom, stream);
  if (R == 32 && DR == 64)
    return launch<T, 32, 64>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out, b, S, H, denom, stream);
  if (R == 512 && DR == 16)
    return launch<T, 512, 16>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out, b, S, H, denom, stream);
  if (R == 512 && DR == 64)
    return launch<T, 512, 64>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out, b, S, H, denom, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_lat (b, H, R), q_rope (b, H, DR), c_kv (b, S, R), k_rope (b, S, DR),
// valid (b, S) of 0/1 bytes, all contiguous; scratch acc (b, ns, H, R), m and
// l (b, ns, H) float32 with ns = ceil(S / 256); out (b, H, R).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int repro_flash_decode_mla(const void* q_lat, const void* q_rope,
                                      const void* c_kv, const void* k_rope,
                                      const void* valid, void* acc, void* m,
                                      void* l, void* out, int b, int S, int H,
                                      int R, int DR, int dtype, float denom,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (dtype == 0)
    return (int)launch_rd<float>(R, DR, q_lat, q_rope, c_kv, k_rope, vm, a, mm, ll, out, b, S, H, denom, s);
  if (dtype == 1)
    return (int)launch_rd<__nv_bfloat16>(R, DR, q_lat, q_rope, c_kv, k_rope, vm, a, mm, ll, out, b, S, H, denom, s);
  return (int)cudaErrorInvalidValue;
}

// rows of scratch a call needs: ns = ceil(S / block)
extern "C" int repro_flash_decode_mla_block_s() { return BS; }
