// Split-KV flash decode for Hopper (sm_90a): one new token per row against a
// (ring) KV cache with an explicit (b, S) validity mask, GQA.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py::flash_decode_gqa
// (the Pallas TPU kernel `_gqa_kernel`, which emits per-block (acc, m, l)
// partials, and its jnp merge `_combine`).
//
// What bounds it on an H100: one decode call reads the valid rows of the K
// and V caches once (b=8, S=544, K=8, D=128, bf16, all rows valid: ~17.8 MB,
// ~5.3 us at 3.35 TB/s) and does ~4 FLOPs per cached element per query head
// -- G=3 heads share each KV element, so ~6 FLOPs per byte, far below the
// ~295 at which the tensor cores would bind.  It is bound by memory traffic,
// so the design is about keeping enough bytes in flight (Little's law: ~15-20
// KB per SM at 3.35 TB/s), not about the products.
//
// Design:
//  * Splits.  The grid is (split, KV head, batch); a split is `bs` cache rows,
//    a multiple of TR = 64 rows chosen on the host (kernels/meta.py's
//    gqa_block_s) from S alone, never from b: one tile up to 64 splits a
//    row (4,096 slots), longer splits (up to 512 rows) past that, so the
//    merge stays short and the partials a few percent of the cache's
//    bytes.  One-tile splits hold the least shared memory, so the most
//    blocks share an SM: on the H100 they ran fastest at every measured
//    shape, a batch of 8 or one row.  A row's partials and their merge
//    order follow the cache alone: a row decoded alone and in a batch
//    gives the same bits.
//  * Loads.  A split's K tiles, then its V tiles, stream through a ring of up
//    to four 64-row tiles in shared memory by 16-byte cp.async, each thread
//    keeping 8 (bf16, D=128) of them in flight per tile, and the V tiles are
//    in flight while the scores are computed: a block with one K and one V
//    tile issues both before it waits (32 KB in flight a block, several
//    blocks an SM).  A masked row, or a row past S, is zero-filled by the
//    copy without a read of K or V, so a non-finite value in a masked slot
//    never reaches the output.
//  * Scores.  A row of D values is CPR 16-byte chunks (16 for bf16 D=128), so
//    CPR lanes take one row each and reduce its G dot products with log2(CPR)
//    shuffles (4 at bf16 D=128); a warp covers 32/CPR rows a step.  Tensor
//    cores are not used: the bound is bytes, and G = 3 query rows would fill
//    3 of an mma's 16.  A row whose chunk count is not a power of two (D =
//    160: 20 chunks in bf16, 40 in float32) is taken by LPR lanes, the
//    largest power of two that divides CPR (4 and 8), each reading CH =
//    CPR / LPR chunks (5), so every lane works and the G dot products
//    reduce with log2(LPR) shuffles; CH = 1 is the power-of-two mapping.
//  * Softmax and p.V.  The split's scores stay in shared memory (G x bs
//    floats); one warp per query head takes their max m and l = sum exp(s -
//    m), and rounds p to v's dtype, as the TPU kernel does (a masked row gives
//    p = 0; a fully masked split gives acc = 0, l = 0, m = NEG_INF and drops
//    out of the merge).  Then each thread accumulates p.V over its rows for
//    one 16-byte column chunk, 4 heads at a time in registers, and the lanes
//    of a warp that share a chunk are summed with shuffles at the end of each
//    tile into the warp's own slice of shared memory.  At a CPR that is not
//    a power of two the lanes sharing a chunk are not XOR partners: NT /
//    CPR row groups (6 in bf16 at D = 160, 3 in float32; the 8 threads
//    past them idle in p.V) each keep their own slice of sums in shared
//    memory instead, which the end of the block adds in a fixed order.  At
//    stablelm-12b's decode (b=8, S=544, H=32, K=8, so G=4) a call reads
//    ~22 MB of cache when every row is valid (~6.7 us at 3.35 TB/s).
//  * Merge.  A second small kernel merges the partials of each (b, h) with
//    exp(m_blk - m_glob), in a fixed order, and writes the output in v's
//    dtype; a row with no valid entry comes out as 0, as the TPU kernel's
//    merge gives (0 / max(0, 1e-30)).  Asked for the log-sum-exp (one rank
//    of a sharded decode, whose partial results are merged across ranks),
//    it writes the output in float32, so that merge rounds once, and
//    lse = m_glob + log(l_glob) per (b, h): -inf exactly on a row with no
//    valid entry, whose output stays 0.  The partials kernel and the launch
//    plan are the same either way.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::from_f;
using repro::NEG_INF;
using repro::round_to;
using repro::to_f;
using repro::warp_max;
using repro::warp_sum;

constexpr int TR = 64;         // cache rows per tile
constexpr int NW = 4;          // warps per block
constexpr int NT = 32 * NW;    // threads per block
constexpr int NST = 4;         // most tiles in the ring
constexpr int MAX_TILES = 8;   // most tiles per split (bs <= 512)
constexpr int GCH = 4;         // query heads accumulated together in p.V

// wait until at most n of this thread's committed cp.async groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0) repro::cp_async_wait<0>();
  else if (n == 1) repro::cp_async_wait<1>();
  else repro::cp_async_wait<2>();
}

// the EPC values of a 16-byte chunk of T, widened to float
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  // a bf16 is the high half of the float with the same bits
  f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
  f[4] = __uint_as_float(v.z << 16); f[5] = __uint_as_float(v.z & 0xffff0000u);
  f[6] = __uint_as_float(v.w << 16); f[7] = __uint_as_float(v.w & 0xffff0000u);
}

// how the lanes map onto a row of D values of T
template <typename T, int D>
struct RowMap {
  static constexpr int EPC = 16 / (int)sizeof(T);  // values per 16-byte chunk
  static constexpr int CPR = D / EPC;              // chunks per row
  static constexpr bool POW2 = (CPR & (CPR - 1)) == 0;
  // lanes per row in the scores: the largest power of two dividing CPR
  static constexpr int LPR = (CPR & -CPR) < 32 ? (CPR & -CPR) : 32;
  static constexpr int CH = CPR / LPR;             // chunks a lane reads
  // slices of p.V sums: one a warp, or one a row group
  static constexpr int NRED = POW2 ? NW : NT / CPR;
};

// shared memory of one block: the tile ring, then float32 q (G x D), the
// p.V sums (NRED x G x D), the scores (G x bs), then bs live flags
template <typename T, int D>
__host__ __device__ constexpr int ring_bytes(int nst) { return nst * TR * D * (int)sizeof(T); }

// q (b, H, D) as rows kh*G .. kh*G+G-1; partials indexed (b, ns, K, G[, D]).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_partials(const T* __restrict__ q, const T* __restrict__ kc,
                const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                float* __restrict__ acc_out, float* __restrict__ m_out,
                float* __restrict__ l_out, int S, int H, int K, int bs, int nst,
                float scale) {
  using M = RowMap<T, D>;
  constexpr int EPC = M::EPC;          // values per 16-byte chunk
  constexpr int CPR = M::CPR;          // chunks per cache row
  constexpr int LPR = M::LPR, CH = M::CH, NRED = M::NRED;
  static_assert(CPR >= 4 && CPR <= 64 && LPR >= 4 && (TR * CPR) % NT == 0,
                "a row is 4-64 chunks, taken by at least 4 lanes");
  static_assert(M::POW2 ? CH == 1 : CPR <= NT, "one chunk a thread in p.V");
  constexpr int RPW = 32 / LPR;        // rows a warp covers per step
  constexpr int RG = NT / CPR;         // row groups in p.V
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / K;
  const int nt = bs / TR;              // tiles per split
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + ring_bytes<T, D>(min(nst, 2 * nt)));
  float* red = qs + G * D;             // (NRED, G, D)
  float* sc = red + NRED * G * D;      // (G, bs): scores, then p
  uint8_t* live = reinterpret_cast<uint8_t*>(sc + G * bs);

  const int js = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int ns = gridDim.x;
  const int s0 = js * bs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < G * D; e += NT) {
    qs[e] = to_f(q[((size_t)b * H + (size_t)kh * G) * D + e]);
    for (int w = 0; w < NRED; ++w) red[w * G * D + e] = 0.f;
  }
  for (int r = tid; r < bs; r += NT) {
    const int s = s0 + r;
    live[r] = s < S && valid[(size_t)b * S + s];
  }
  __syncthreads();

  // tile j of the stream: K tile j for j < nt, then V tile j - nt
  auto issue = [&](int j) {
    if (j >= 2 * nt) return;
    const T* src = j < nt ? kc : vc;
    const int t0 = (j < nt ? j : j - nt) * TR;
    T* dst = ring + (j % nst) * TR * D;
#pragma unroll
    for (int i = 0; i < TR * CPR / NT; ++i) {
      const int e = tid + i * NT, r = e / CPR, c = e % CPR;
      const bool ok = live[t0 + r];
      const T* g = src + (((size_t)b * S + (ok ? s0 + t0 + r : 0)) * K + kh) * D + c * EPC;
      cp_async16(dst + r * D + c * EPC, g, ok);
    }
  };

  for (int j = 0; j < nst - 1; ++j) {
    issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < 2 * nt; ++j) {
    cp_wait(nst - 2);
    __syncthreads();
    issue(j + nst - 1);
    cp_async_commit();
    const T* tile = ring + (j % nst) * TR * D;
    if (j < nt) {                      // scores of K tile j
      const int c = lane % LPR, rs = lane / LPR;
      for (int r = warp * RPW + rs; r < TR; r += NW * RPW) {
        float kf[CH][EPC];
#pragma unroll
        for (int i = 0; i < CH; ++i) load_chunk(tile + r * D + (c + LPR * i) * EPC, kf[i]);
        const bool ok = live[j * TR + r];
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < CH; ++i)
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              dot = fmaf(qs[g * D + (c + LPR * i) * EPC + e], kf[i][e], dot);
#pragma unroll
          for (int o = LPR / 2; o; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (c == 0) sc[g * bs + j * TR + r] = ok ? dot * scale : NEG_INF;
        }
      }
      continue;
    }
    if (j == nt) {                     // all scores are in: softmax per head
      for (int g = warp; g < G; g += NW) {
        float* row = sc + g * bs;
        float mx = NEG_INF;
        for (int i = lane; i < bs; i += 32) mx = fmaxf(mx, row[i]);
        mx = warp_max(mx);
        float l = 0.f;
        for (int i = lane; i < bs; i += 32) {
          const float p = live[i] ? expf(row[i] - mx) : 0.f;
          l += p;
          row[i] = round_to<T>(p);
        }
        l = warp_sum(l);
        if (lane == 0) {
          const size_t idx = (((size_t)b * ns + js) * K + kh) * G + g;
          m_out[idx] = mx;
          l_out[idx] = l;
        }
      }
      __syncthreads();
    }
    {                                  // p.V over V tile j - nt
      const int tv = j - nt;
      const int cc = tid % CPR, rg = tid / CPR;
      for (int g0 = 0; g0 < G && rg < RG; g0 += GCH) {
        float a[GCH][EPC];
#pragma unroll
        for (int u = 0; u < GCH; ++u)
#pragma unroll
          for (int e = 0; e < EPC; ++e) a[u][e] = 0.f;
        for (int r = rg; r < TR; r += RG) {
          float vf[EPC];
          load_chunk(tile + r * D + cc * EPC, vf);
#pragma unroll
          for (int u = 0; u < GCH; ++u) {
            if (g0 + u >= G) break;
            const float p = sc[(g0 + u) * bs + tv * TR + r];
#pragma unroll
            for (int e = 0; e < EPC; ++e) a[u][e] = fmaf(p, vf[e], a[u][e]);
          }
        }
        if constexpr (!M::POW2) {
          // each row group's own slice: no two threads share a slot
#pragma unroll
          for (int u = 0; u < GCH; ++u) {
            if (g0 + u >= G) break;
            float* dst = red + (rg * G + g0 + u) * D + cc * EPC;
#pragma unroll
            for (int e = 0; e < EPC; ++e) dst[e] += a[u][e];
          }
          continue;
        }
        // lanes lane, lane + CPR, ... of a warp share the column chunk
#pragma unroll
        for (int u = 0; u < GCH; ++u) {
          if (g0 + u >= G) break;
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
#pragma unroll
            for (int o = 16; o >= CPR; o >>= 1)
              a[u][e] += __shfl_xor_sync(0xffffffffu, a[u][e], o);
          }
          if (lane < CPR) {
            float* dst = red + (warp * G + g0 + u) * D + cc * EPC;
#pragma unroll
            for (int e = 0; e < EPC; ++e) dst[e] += a[u][e];
          }
        }
      }
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  float* acc_blk = acc_out + (((size_t)b * ns + js) * K + kh) * G * D;
  for (int e = tid; e < G * D; e += NT) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NRED; ++w) sum += red[w * G * D + e];
    acc_blk[e] = sum;
  }
}

// Merge the ns partials of each (b, h): grid (H, b), D threads.  The partial
// of block js for head h sits at (b*ns + js)*H + h, since h = kh*G + g.
// With lse (b, H) given, thread 0 also writes each (b, h)'s log-sum-exp.
template <typename T>
__global__ void decode_combine(const float* __restrict__ acc,
                               const float* __restrict__ m,
                               const float* __restrict__ l, T* __restrict__ out,
                               float* __restrict__ lse, int ns, int H, int D) {
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
  if (lse != nullptr && d == 0)
    lse[(size_t)b * H + h] = l_g > 0.f ? m_g + logf(l_g) : __int_as_float(0xff800000);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, float* acc, float* m, float* l,
                   void* out, float* lse, int b, int S, int H, int K, int bs,
                   float scale, cudaStream_t stream) {
  if (bs <= 0 || bs % TR || bs > TR * MAX_TILES) return cudaErrorInvalidValue;
  const int G = H / K;
  const int ns = (S + bs - 1) / bs;
  const int nt = bs / TR;
  // one more ring slot than tiles (up to NST): every tile is issued before
  // the first wait when the split has one K and one V tile
  const int nst = 2 * nt + 1 < NST ? 2 * nt + 1 : NST;
  const int smem = ring_bytes<T, D>(nst < 2 * nt ? nst : 2 * nt) +
                   (G * D + RowMap<T, D>::NRED * G * D + G * bs) * (int)sizeof(float) + bs;
  auto kern = decode_partials<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(ns, K, b), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, acc, m, l, S, H, K, bs, nst, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (lse != nullptr)   // float32 output beside the log-sum-exp
    decode_combine<float><<<dim3(H, b), D, 0, stream>>>(
        acc, m, l, static_cast<float*>(out), lse, ns, H, D);
  else
    decode_combine<T><<<dim3(H, b), D, 0, stream>>>(
        acc, m, l, static_cast<T*>(out), nullptr, ns, H, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const uint8_t* valid, float* acc, float* m, float* l,
                     void* out, float* lse, int b, int S, int H, int K, int bs,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, valid, acc, m, l, out, lse, b, S, H, K, bs, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, acc, m, l, out, lse, b, S, H, K, bs, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, acc, m, l, out, lse, b, S, H, K, bs, scale, stream);
    case 160: return launch<T, 160>(q, k, v, valid, acc, m, l, out, lse, b, S, H, K, bs, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, 1, H, D); k/v caches (b, S, K, D); valid (b, S) of 0/1 bytes;
// scratch acc (b, ns, K, G, D), m and l (b, ns, K, G) float32 with
// ns = ceil(S / bs), bs a multiple of 64 up to 512 (the wrapper's plan,
// kernels/meta.py's gqa_block_s, from S alone); out
// (b, 1, H, D) in the caches' dtype, or float32 when lse (b, H) float32 is
// not null.  Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_flash_decode_gqa(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* acc, void* m, void* l, void* out,
                                      void* lse, int b, int S, int H, int K,
                                      int D, int bs, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, vm, a, mm, ll, out, ls, b, S, H, K, bs, scale,
                                s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, vm, a, mm, ll, out, ls, b, S, H, K,
                                        bs, scale, s);
  return (int)cudaErrorInvalidValue;
}
