// Flash attention forward for Hopper (sm_90a): causal / sliding-window GQA.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (the Pallas TPU kernel `_kernel`, which walks KV blocks sequentially per
// (batch, q-head, q-block) and carries the online-softmax state in VMEM).
//
// What bounds it on an H100: at the serving prefill shape (b=8, s=512, H=24,
// K=8, D=128, bf16) one call moves ~67 MB (q, k, v, o once each, ~20 us at
// 3.35 TB/s) and does ~1.3e10 causal FLOPs (~13 us at 989 TFLOP/s bf16), so
// the card's floor is the memory traffic; at deepseek-v2's MLA prefill
// (b=8, s=512, H=K=128, D=192) ~805 MB (~240 us) against ~1.0e11 FLOPs
// (~100 us).  Both products have to run on the tensor cores to come near
// that floor: on the CUDA cores the FLOPs alone take 5-15x the byte bound.
//
// bfloat16 design (FlashAttention-2 on mma.sync): one block per (q tile,
// q head, batch), the KV head h / G, tiles in reverse q order so the
// longest causal rows start first.  A warp owns 16 query rows; the q tile
// is 64 rows (4 warps), or 128 (8 warps) at D = 192, where a 64-row tile
// would leave a block's 120 KB of K/V ring to only 4 warps of an SM.  Q is
// staged once and 64-key K and V tiles stream through a two-stage cp.async
// ring, 16 bytes a thread, into XOR-swizzled tiles (mma.cuh), so ldmatrix
// reads them without bank conflicts; the next tile's copy is in flight
// while the tensor cores work on this one.  S = Q K^T runs as
// mma.m16n8k16 (bf16 in, fp32 out) fed by ldmatrix; the online softmax
// runs in registers on the fp32 accumulator fragments (row max and sum over
// the four lanes of a row with two shuffles, exp2 with the scale folded in
// log2 units); P is rounded to bf16 in registers -- the TPU kernel's
// p.astype(v.dtype) -- and is the A fragment of O += P V (V through
// ldmatrix.trans), with no trip through shared memory.  Only the band's
// tiles are visited -- the TPU kernel's `live` test -- and the mask is
// evaluated only on tiles that cross the diagonal, the window's edge or
// sk; keys past sk are zero-filled by the copy, not padded in memory.  O
// leaves through the warp's own rows of the Q tile as 16-byte stores;
// rows past sq are never stored.  Shared memory a block: 20 KB (D=32) to
// 80 KB (D=128) and 144 KB (D=192); registers up to 255 a thread at D =
// 128 and 192 (no spills), so 2 blocks (D = 128) or 1 (D = 192) an SM.
// Two 16-row bands a warp, which halve the ldmatrix reads per mma, ran
// slower on an H100 (0.096 against 0.085 ms at the prefill shape): shared
// memory is not what holds this design back.  It runs at
// FlashAttention-2's speed (PyTorch's flash backend) and behind cuDNN's
// kernels (PyTorch's default); Hopper's own path -- wgmma fed by TMA
// from a producer warp -- is the next step.
//
// float32 keeps the first version's body on the CUDA cores, chosen by the
// template type (TF32 cannot hold the 2e-5 the float32 callers are held
// to): one block of 256 threads per (64-row q tile, head, batch), four
// threads a query row, 32-key K/V tiles staged as float32 with rows padded
// by one word, each thread D/4 output columns in registers.  No main path
// runs it on the card.
//
// Head dims 32, 64 and 128 serve the GQA models; 48 and 192 are the MLA
// prefill's qk width dn + dr (deepseek-v2's smoke and full widths), whose v
// arrives zero-padded to that width.
//
// For training it also writes each row's log-sum-exp, lse = m + log(l) in
// float32 (b, H, sq) and in the scaled units of the scores, from which the
// backward (flash_attention_bwd.cu) recomputes P; a row the mask leaves
// with no key gets NEG_INF.  The serving path passes a null pointer.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::from_f;
using repro::NEG_INF;
using repro::round_to;
using repro::to_f;

// the float32 body's tiles
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per K/V tile
constexpr int NT = 256;       // threads: 4 per query row
constexpr int CPT = BK / 4;   // score columns per thread

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

// ------------------------------------------------- float32, CUDA cores --

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

// ---------------------------------------------------------------- bf16 --

using repro::bf16;
using repro::Tile;

constexpr int MMA_KEYS = 64;  // keys per K/V tile of the bf16 body
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// warps of the bf16 body's block, 16 query rows each: 8 at D = 192, so
// that a block's 144 KB of Q tile and K/V ring feed 8 warps of an SM
template <int D>
struct MmaWarps {
  static constexpr int value = D > 128 ? 8 : 4;
};

template <int D>
constexpr int mma_smem_bytes() {
  return (Tile<D>::elems(16 * MmaWarps<D>::value) + 4 * Tile<D>::elems(MMA_KEYS)) *
         (int)sizeof(bf16);
}

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int sq, int sk, int H, int K,
                    int causal, int window, float scale) {
  constexpr int THREADS = NW * 32, ROWS = 16 * NW, KEYS = MMA_KEYS;
  constexpr int QE = Tile<D>::elems(ROWS), KE = Tile<D>::elems(KEYS);
  extern __shared__ uint4 smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // (ROWS, D)
  bf16* Ks = Qs + QE;                             // 2 stages of (KEYS, D)
  bf16* Vs = Ks + 2 * KE;                         // 2 stages of (KEYS, D)

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * ROWS;
  const int q_last = min(q0 + ROWS, sq) - 1;  // the tile's last real row
  // the band of k tiles: the TPU kernel's `live` test, as a range
  const int n_kt = (sk + KEYS - 1) / KEYS;
  const int kt_end = causal ? min(n_kt, q_last / KEYS + 1) : n_kt;
  const int kt_begin = (window && q0 - window + 1 > 0) ? (q0 - window + 1) / KEYS : 0;

  const long long qstride = (long long)H * D, kstride = (long long)K * D;
  const bf16* qb = q + ((size_t)b * sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * sk * K + kh) * D;
  const bf16* vb = v + ((size_t)b * sk * K + kh) * D;

  // prologue: Q and the first k tile in one group, the second in the next
  repro::load_tile<D, ROWS, THREADS>(Qs, qb, qstride, q0, sq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kt_begin + i < kt_end) {
      repro::load_tile<D, KEYS, THREADS>(Ks + i * KE, kb, kstride, (kt_begin + i) * KEYS, sk);
      repro::load_tile<D, KEYS, THREADS>(Vs + i * KE, vb, kstride, (kt_begin + i) * KEYS, sk);
    }
    repro::cp_async_commit();
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's rows, q0 + 16w + g and that + 8: running max (log2
  // units of the scaled scores) and this thread's share of the row sum
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + 16 * w + g;
  const float sl2 = scale * LOG2E;
  const float ninf = __int_as_float(0xff800000u);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    repro::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * KE;
    const bf16* Vt = Vs + st * KE;

    float s[KEYS / 8][4];
#pragma unroll
    for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    repro::mma_abt<D, KEYS / 8>(s, Qs, 16 * w, Kt, lane);

    const int k0 = kt * KEYS;
    const bool edge = k0 + KEYS > sk || (causal && k0 + KEYS - 1 > q0) ||
                      (window && k0 <= q_last - window);
    float mx[2] = {ninf, ninf};
#pragma unroll
    for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const int qr = row0 + 8 * (e >> 1);
          const bool live = kp < sk && (!causal || kp <= qr) && (!window || kp > qr - window);
          x = live ? x : ninf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four lanes of a row are neighbours in the warp
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);  // finite: m_r starts at NEG_INF
      alpha[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < KEYS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_r[e >> 1]);  // 0 where masked
        l_r[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    uint32_t pa[KEYS / 16][4];
    repro::c_to_a<KEYS / 8>(pa, s);
    repro::mma_ab<D, KEYS / 16>(acc, pa, Vt, lane);

    __syncthreads();  // every warp is done with this stage
    if (kt + 2 < kt_end) {
      repro::load_tile<D, KEYS, THREADS>(Ks + st * KE, kb, kstride, (kt + 2) * KEYS, sk);
      repro::load_tile<D, KEYS, THREADS>(Vs + st * KE, vb, kstride, (kt + 2) * KEYS, sk);
    }
    repro::cp_async_commit();
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
  repro::cp_async_wait<0>();  // with no k tile, Q may still be arriving
  __syncthreads();
  // O through the warp's own rows of the Q tile, which no other warp reads
  repro::store_rows<D>(acc, inv[0], inv[1], Qs, 16 * w, o + ((size_t)b * sq * H + h) * D,
                       qstride, q0 + 16 * w, sq, lane);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + 8 * i;
      if (qi < sq)
        lse[((size_t)b * H + h) * sq + qi] =
            l_r[i] > 0.f ? m_r[i] * LN2 + logf(l_r[i]) : NEG_INF;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int H, int K, int causal,
                   int window, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
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
  } else {
    constexpr int NW = MmaWarps<D>::value;
    constexpr int smem = mma_smem_bytes<D>();
    auto kern = flash_attention_mma<D, NW>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + 16 * NW - 1) / (16 * NW), H, b);
    kern<<<grid, NW * 32, smem, stream>>>(static_cast<const bf16*>(q),
                                          static_cast<const bf16*>(k),
                                          static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                          lse, sq, sk, H, K, causal, window, scale);
  }
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

// q (b, sq, H, D), k/v (b, sk, K, D), o (b, sq, H, D), all contiguous,
// 16-byte aligned and of one dtype; lse (b, H, sq) float32, or null where it is not wanted.
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
