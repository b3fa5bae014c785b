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
// with the scores in float32 from the inputs' products, p = 0 on a masked
// row, p rounded to c_kv's dtype before the product with c_kv, float32
// partials merged with exp(m_blk - m_glob), and 0 for a row with no valid
// entry, as the TPU kernel.
//
// What bounds it on an H100: at deepseek-v2's widths (H=128, r=512, dr=64)
// and b=8, S=544 with 4,105 of 4,352 rows valid, bf16, one call must read
// the valid c_kv and k_rope rows, the queries and the mask and write o_lat,
// ~7.0 MB: 2.08 us at 3.35 TB/s.  It does H (4r + 2dr) = 278,528 flops per
// valid row, 1.143 GFLOP: 1.16 us on the tensor cores at 989 TFLOP/s, ~17 us
// on the CUDA cores at 67 TFLOP/s float32.  Every head reads the same latent
// row, so the products belong on the tensor cores with the heads as the
// mma's rows.
//
// bf16 body (mla_partials_mma<R, DR>), one block per (split, 64 heads,
// batch), 8 warps:
//  * Tensor cores.  mma.sync.m16n8k16 (bf16 in, float32 accumulate; helpers
//    in mma.cuh).  The query heads are the M dimension, 16 a warp; cache rows
//    are N; [r | dr] is K (36 k-steps at 576).  Warp w takes heads 16(w%4)..
//    of the block's 64 and, for the scores, the tile rows 32(w/4)..+31; for
//    p.c_kv, the latent columns (r/2)(w/4).. (16 heads x 256 columns of
//    float32 accumulator, 128 registers a thread at r=512).  So a head's
//    scores, max and p are computed once, and a cache tile is read from L2
//    by H/64 = 2 blocks, where the first version's 16-head blocks read it 8
//    times.
//  * One bf16 copy of each cache tile for both products.  [c_kv | k_rope]
//    rows are staged by 16-byte cp.async into swizzled bf16 tiles (64 rows,
//    73,728 B at 576 wide; the first version widened 32 rows to float32 in
//    the same room) and read by ldmatrix as B of the scores and, c_kv again
//    transposed, as B of p.c_kv.  A masked row or a row past the split is
//    zero-filled by the copy without a read, and its score is NEG_INF and
//    its p 0, so a non-finite value in a masked slot never reaches the
//    output; a tile with no valid row is skipped.  Every warp turns the
//    tile's 64 valid flags into a bit mask with two ballots, so no copy
//    waits on a flag load of its own.  Where a split has more than one
//    tile, the next tile is in flight while the current one is computed (a
//    ring of two).  The queries (64 heads, 73,728 B) stay in shared memory
//    for the block: 230,416 B a block at r=512, one block an SM.
//  * p through shared memory once.  The two warps that share a head group
//    exchange their row maxima through shared memory (one barrier), each
//    rounds its p to bf16 into a 64 x 64 tile (8 KB), and after a second
//    barrier both read all 64 rows of it as A of p.c_kv; the online-softmax
//    rescale of the accumulator stays in registers, since a warp's heads are
//    the same in both products.  l sums the unrounded p, per lane, and is
//    reduced once at the end.  Four barriers a 64-row tile, where the first
//    version had five a 32-row tile.
//  * Splits from the cache length alone (chosen by the wrapper,
//    kernels/meta.py's mla_plan, and passed in), so a row's output does not
//    depend on the batch around it: at most 6 splits of at least one tile
//    (64 rows) and at most 1024 rows, a multiple of 16.  Six is the most
//    splits whose clusters the H100 holds in one wave at deepseek-v2's
//    serving batch (b=8, 2 head tiles: 16 clusters; it holds 17 of 6 and
//    15 of 7, chip_smoke.py --mla-splits).  At the decode shape (S=544):
//    96-row splits (a 64-row and a 32-row tile), grid (6 splits, 2 head
//    tiles, 8) = 96 blocks, one wave; the first version's third split of
//    32 rows is gone.  Past S = 6,144 the splits stay at 1024 rows and
//    grow in number, so past 8 of them (S > 8,192) the float32 partials a
//    merge kernel reads are 22% of the cache's bytes at H=128, r=512.
//  * Merge in a cluster.  The splits of one (head tile, batch) are one
//    thread-block cluster (up to 8 splits, cluster dims (ns, 1, 1)).  After
//    its walk a block leaves its (m, l) of each head and its float32 partial
//    (64 x 512, 133,120 B with padded rows) in its own shared memory; after
//    a cluster barrier, split k reads every split's partial through
//    distributed shared memory for its k-th share of the 64 x 512 outputs,
//    merges them in split order with exp(m_blk - m_glob), scales by the
//    merged 1 / l and writes o_lat in bf16 -- or, given an lse buffer (a
//    sharded decode's merge across ranks), in float32, split 0 writing each
//    head's m + log(l) (-inf on a row with no valid slot), as the merge
//    kernel does on the other path.  So a call at the decode shape is
//    one kernel that writes no partials to device memory.  With the
//    partials in device memory and a merge kernel (9 64-row splits at the
//    decode shape), the merge kernel takes about a third of the pair
//    (chip_smoke.py --mla-splits), over the quarter at which the merge was
//    to move into the cluster.  More than 8 splits (a cache over 8,192
//    rows) and the float32 body keep that path: the
//    partials in device memory and a second, small kernel that merges them
//    in the same order.  A row with no valid entry comes out as 0 (0 /
//    max(0, 1e-30)), as the TPU kernel's merge gives; a fully masked split
//    gives acc = 0, l = 0, m = NEG_INF and drops out.
//  * Next: the queries are read from L2 by every split of a cluster (73,728
//    B a block); TMA multicast across the cluster would read them once,
//    and wgmma would take the products off the ldmatrix path.
//
// float32 body (mla_partials_f32<R, DR>): the first version's CUDA-core walk,
// kept as the correctness path (16 heads a block, 32-row tiles staged in
// shared memory, 4 x 4 register tiles of scores), at the same splits.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::bf16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::from_f;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;
using repro::NEG_INF;
using repro::pack_bf16;
using repro::Tile;
using repro::warp_max;
using repro::warp_sum;

// ------------------------------------------------------------ bf16 body --

constexpr int HT = 64;         // query heads per block (4 warps of 16 mma rows)
constexpr int TR = 64;         // cache rows per tile
constexpr int MW = 8;          // warps per block
constexpr int MT = 32 * MW;    // threads per block

// shared memory of one block, in bf16 elements, then bytes
template <int R, int DR>
struct MmaSmem {
  static constexpr int QL = Tile<R>::elems(HT);        // q_lat of the block's heads
  static constexpr int QR = Tile<DR>::elems(HT);       // q_rope
  static constexpr int CK = Tile<R>::elems(TR);        // c_kv rows of a tile
  static constexpr int SLOT = CK + Tile<DR>::elems(TR);  // + k_rope rows
  static constexpr int P = Tile<TR>::elems(HT);        // p, heads x tile rows
  // + row maxima and sums of the two row halves (2 x 2 x HT floats), and
  // the live rows of the two ring slots (2 x 64 bits)
  static constexpr int BYTES = 2 * (QL + QR + 2 * SLOT + P) + 16 * HT + 16;
};

constexpr int MAX_CLUSTER = 8;  // splits merged in a cluster (portable size)

// The merge in a cluster: a split's float32 partial, HT rows of R + 8 floats
// (padded against bank conflicts), goes to its ring and p tile; the splits'
// weights and 1 / l go where the queries were.
template <int R, int DR>
struct MergeFits {
  using L = MmaSmem<R, DR>;
  static constexpr int RP = R + 8;
  static_assert(HT * RP * 4 <= 2 * (2 * L::SLOT + L::P) &&
                    (MAX_CLUSTER + 1) * HT * 4 <= 2 * L::QL,
                "the merge reuses the ring, the p tile and the queries' room");
};

// q_lat (b, H, R), q_rope (b, H, DR), c_kv (b, S, R), k_rope (b, S, DR),
// out (b, H, R); a split is bs rows.  FUSED: the splits of one (head tile,
// batch) are one cluster and merge there into out -- or, with lse (b, H)
// given, into the float32 out_f beside each head's log-sum-exp --;
// otherwise each writes its float32 partial, indexed (b, ns, H[, R]), for
// mla_combine.
template <int R, int DR, bool FUSED>
__global__ void __launch_bounds__(MT, 1)
mla_partials_mma(const bf16* __restrict__ q_lat, const bf16* __restrict__ q_rope,
                 const bf16* __restrict__ c_kv, const bf16* __restrict__ k_rope,
                 const uint8_t* __restrict__ valid, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 bf16* __restrict__ out, float* __restrict__ out_f, float* __restrict__ lse,
                 int S, int H, int bs, float denom) {
  using L = MmaSmem<R, DR>;
  constexpr int CR = R / 8, CW = (R + DR) / 8;   // 16-byte chunks of a c_kv, a whole row
  constexpr int NP = R / 16;                     // 8-column n tiles of a warp's R/2 columns
  constexpr int KS = (R + DR) / 16;              // k-steps of a score
  extern __shared__ __align__(128) unsigned char smem_mma[];
  bf16* ql = reinterpret_cast<bf16*>(smem_mma);
  bf16* qr = ql + L::QL;
  bf16* ring = qr + L::QR;                       // two slots of [c_kv | k_rope] tiles
  bf16* ps = ring + 2 * L::SLOT;
  float* red_m = reinterpret_cast<float*>(ps + L::P);  // (2 row halves, HT)
  float* red_l = red_m + 2 * HT;                        // (2 row halves, HT)
  uint64_t* live = reinterpret_cast<uint64_t*>(red_l + 2 * HT);  // (2 slots): row r valid at bit r

  const int js = blockIdx.x, h0 = blockIdx.y * HT, b = blockIdx.z;
  const int ns = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = warp & 3;       // head group: heads 16 hg .. 16 hg + 15
  const int half = warp >> 2;    // tile rows 32 half.. (scores), columns (R/2) half.. (p.c_kv)
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row and chunk offsets for A and B fragments
  const int a_r = repro::a_row(lane), a_c = repro::a_chunk(lane);
  const int b_r = repro::b_row(lane), b_c = repro::b_chunk(lane);
  const float inv_denom = 1.f / denom;
  const int s_lo = js * bs, s_hi = min(s_lo + bs, S);
  const int nt = (s_hi - s_lo + TR - 1) / TR;
  const uint8_t* vrow = valid + (size_t)b * S;

  // tile j of the split into ring slot j % 2; rows masked or past the split
  // are zero-filled and not read.  Every warp reads the tile's 64 flags
  // (two bytes a lane) into a mask, so no copy waits on a flag of its own.
  auto issue = [&](int j) {
    const int t0 = s_lo + j * TR;
    const bool v0 = t0 + lane < s_hi && vrow[t0 + lane];
    const bool v1 = t0 + 32 + lane < s_hi && vrow[t0 + 32 + lane];
    const uint64_t mask = __ballot_sync(0xffffffffu, v0) |
                          (uint64_t)__ballot_sync(0xffffffffu, v1) << 32;
    bf16* ck = ring + (j & 1) * L::SLOT;
    bf16* kr = ck + L::CK;
#pragma unroll
    for (int i = 0; i < (TR * CW + MT - 1) / MT; ++i) {
      const int e = tid + i * MT;
      if ((TR * CW) % MT != 0 && e >= TR * CW) break;
      const int r = e / CW, c = e % CW;
      const bool ok = (mask >> r) & 1;
      const size_t row = (size_t)b * S + (ok ? t0 + r : 0);
      if (c < CR)
        cp_async16(ck + Tile<R>::at(r, c), c_kv + row * R + c * 8, ok);
      else
        cp_async16(kr + Tile<DR>::at(r, c - CR), k_rope + row * DR + (c - CR) * 8, ok);
    }
    if (tid == 0) live[j & 1] = mask;
  };

  // heads past H are zero queries, never written out
  repro::load_tile<R, HT, MT>(ql, q_lat + ((size_t)b * H + h0) * R, R, 0, H - h0);
  repro::load_tile<DR, HT, MT>(qr, q_rope + ((size_t)b * H + h0) * DR, DR, 0, H - h0);
  issue(0);
  cp_async_commit();             // group 0: the queries and tile 0
  if (nt > 1) issue(1);
  cp_async_commit();             // group 1: tile 1 (or nothing)

  float acc[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max and this lane's share of the sum of p, heads g and g + 8
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < nt; ++j) {
    repro::cp_async_wait<1>();   // every group but the newest: tile j is in
    __syncthreads();
    const int slot = j & 1;
    const bf16* ck = ring + slot * L::SLOT;
    const bf16* kr = ck + L::CK;
    const uint64_t lv = live[slot];
    const int rows = min(TR, s_hi - (s_lo + j * TR));
    if (lv) {                    // a tile with no valid row adds nothing
      // scores of the warp's 16 heads x tile rows r0 .. r0 + 31
      const int r0 = 32 * half;
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      // a warp whose rows all lie past the tile's end skips its products;
      // the fragments of k-step kk + 1 load while k-step kk multiplies
      if (r0 < rows) {
        uint32_t a[2][4], b0[2][4], b1[2][4];
        auto frags = [&](int kk, uint32_t (&fa)[4], uint32_t (&fb0)[4], uint32_t (&fb1)[4]) {
          if (kk < R / 16) {
            ldsm_x4(fa, ql + Tile<R>::at(16 * hg + a_r, 2 * kk + a_c));
            ldsm_x4(fb0, ck + Tile<R>::at(r0 + b_r, 2 * kk + b_c));
            ldsm_x4(fb1, ck + Tile<R>::at(r0 + 16 + b_r, 2 * kk + b_c));
          } else {
            const int k2 = kk - R / 16;
            ldsm_x4(fa, qr + Tile<DR>::at(16 * hg + a_r, 2 * k2 + a_c));
            ldsm_x4(fb0, kr + Tile<DR>::at(r0 + b_r, 2 * k2 + b_c));
            ldsm_x4(fb1, kr + Tile<DR>::at(r0 + 16 + b_r, 2 * k2 + b_c));
          }
        };
        frags(0, a[0], b0[0], b1[0]);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int cur = kk & 1;
          if (kk + 1 < KS) frags(kk + 1, a[cur ^ 1], b0[cur ^ 1], b1[cur ^ 1]);
          mma_bf16(sc[0], a[cur], b0[cur][0], b0[cur][1]);
          mma_bf16(sc[1], a[cur], b0[cur][2], b0[cur][3]);
          mma_bf16(sc[2], a[cur], b1[cur][0], b1[cur][1]);
          mma_bf16(sc[3], a[cur], b1[cur][2], b1[cur][3]);
        }
      }
      // scale and mask; c[n][e] is head g + 8 (e / 2), row r0 + 8n + 2t + e % 2
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (lv >> (r0 + 8 * n + 2 * t + (e & 1))) & 1;
          const float s = ok ? sc[n][e] * inv_denom : NEG_INF;
          sc[n][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        if (t == 0) red_m[half * HT + 16 * hg + g + 8 * i] = mx[i];
      }
      __syncthreads();
      // the tile's max over both row halves; finite, since a row is live
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int h = 16 * hg + g + 8 * i;
        const float m_new = fmaxf(m_run[i], fmaxf(red_m[h], red_m[HT + h]));
        alpha[i] = __expf(m_run[i] - m_new);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (lv >> (r0 + 8 * n + 2 * t + (e & 1))) & 1;
          const float p = ok ? __expf(sc[n][e] - m_run[e >> 1]) : 0.f;
          sc[n][e] = p;
          l_run[e >> 1] += p;
        }
        // p rounded to bf16, heads x rows, for both warps of the head group
        *reinterpret_cast<uint32_t*>(ps + Tile<TR>::at(16 * hg + g, 4 * half + n) + 2 * t) =
            pack_bf16(sc[n][0], sc[n][1]);
        *reinterpret_cast<uint32_t*>(ps + Tile<TR>::at(16 * hg + g + 8, 4 * half + n) + 2 * t) =
            pack_bf16(sc[n][2], sc[n][3]);
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      __syncthreads();
      // acc (16 heads x the warp's R/2 columns) += p c_kv over the tile's
      // rows; the c_kv fragments of column pair dp + 2 load while dp
      // multiplies
      const int nk = (rows + 15) / 16;
#pragma unroll
      for (int kc = 0; kc < TR / 16; ++kc) {
        if (kc >= nk) break;
        uint32_t a[4], bb[3][4];
        auto frag = [&](int dp, uint32_t (&fb)[4]) {
          ldsm_x4_t(fb, ck + Tile<R>::at(16 * kc + a_r, (R / 16) * half + 2 * dp + a_c));
        };
        ldsm_x4(a, ps + Tile<TR>::at(16 * hg + a_r, 2 * kc + a_c));
        frag(0, bb[0]);
        if (NP / 2 > 1) frag(1, bb[1]);
#pragma unroll
        for (int dp = 0; dp < NP / 2; ++dp) {
          if (dp + 2 < NP / 2) frag(dp + 2, bb[(dp + 2) % 3]);
          mma_bf16(acc[2 * dp], a, bb[dp % 3][0], bb[dp % 3][1]);
          mma_bf16(acc[2 * dp + 1], a, bb[dp % 3][2], bb[dp % 3][3]);
        }
      }
    }
    __syncthreads();             // slot, p and the maxima are free again
    if (j + 2 < nt) issue(j + 2);
    cp_async_commit();
  }
  repro::cp_async_wait<0>();

  // l: over the lanes of a head, then over the two row halves
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    if (t == 0) red_l[half * HT + 16 * hg + g + 8 * i] = l_run[i];
  }
  __syncthreads();
  if constexpr (FUSED) {
    // the cluster's splits merge here: each leaves its (m, l) of every head
    // and its partial in its own shared memory (the ring, the p tile and
    // the queries' room are free after the loop's last barrier) ...
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    constexpr int RP = MergeFits<R, DR>::RP;
    float* mb = red_m;                       // (HT): the split's max
    float* lb = red_m + HT;                  // (HT): its sum of p
    float* part = reinterpret_cast<float*>(ring);  // (HT, RP)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = 16 * hg + g + 8 * i;
      float* dst = part + h * RP + (R / 2) * half + 2 * t;
#pragma unroll
      for (int n = 0; n < NP; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      if (half == 0 && t == 0) {
        mb[h] = m_run[i];
        lb[h] = red_l[h] + red_l[HT + h];
      }
    }
    cl.sync();
    // ... each head's weight exp(m_split - m_glob) of every split and the
    // inverse of its merged sum, over the splits in order (all of a head's
    // remote loads in flight at once) ...
    const int nsc = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    float* wts = reinterpret_cast<float*>(ql);     // (MAX_CLUSTER, HT)
    float* inv_l = wts + MAX_CLUSTER * HT;         // (HT)
    if (tid < HT) {
      float mk[MAX_CLUSTER], lk[MAX_CLUSTER];
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k) {
        mk[k] = k < nsc ? cl.map_shared_rank(mb, k)[tid] : NEG_INF;
        lk[k] = k < nsc ? cl.map_shared_rank(lb, k)[tid] : 0.f;
      }
      float m_g = NEG_INF;
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k) m_g = fmaxf(m_g, mk[k]);
      float l_g = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k) {
        const float a = k < nsc ? __expf(mk[k] - m_g) : 0.f;
        wts[k * HT + tid] = a;
        l_g += lk[k] * a;
      }
      inv_l[tid] = 1.f / fmaxf(l_g, 1e-30f);
      if (lse != nullptr && rank == 0 && h0 + tid < H)
        lse[(size_t)b * H + h0 + tid] = l_g > 0.f ? m_g + logf(l_g) : __int_as_float(0xff800000);
    }
    __syncthreads();
    // ... and split k of the cluster writes the k-th share of o_lat, 4
    // columns a thread, reading every split's partial from its block (all
    // of a step's remote loads in flight at once)
    constexpr int U = HT * R / 4;
    for (int u = rank * U / nsc + tid; u < (rank + 1) * U / nsc; u += MT) {
      const int h = u / (R / 4), c = (u % (R / 4)) * 4;
      float4 v[MAX_CLUSTER];
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k)
        if (k < nsc)
          v[k] = *reinterpret_cast<const float4*>(cl.map_shared_rank(part, k) + h * RP + c);
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k) {
        if (k >= nsc) break;
        const float a = wts[k * HT + h];
        o.x += v[k].x * a;
        o.y += v[k].y * a;
        o.z += v[k].z * a;
        o.w += v[k].w * a;
      }
      const float il = inv_l[h];
      if (h0 + h >= H) continue;
      const size_t at = ((size_t)b * H + h0 + h) * R + c;
      if (lse != nullptr)
        *reinterpret_cast<float4*>(out_f + at) = make_float4(o.x * il, o.y * il, o.z * il, o.w * il);
      else
        *reinterpret_cast<uint2*>(out + at) =
            make_uint2(pack_bf16(o.x * il, o.y * il), pack_bf16(o.z * il, o.w * il));
    }
    cl.sync();                   // the other splits may still read this block
  } else {
    const size_t base = ((size_t)b * ns + js) * H + h0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = 16 * hg + g + 8 * i;
      if (h0 + h >= H) continue;
      float* dst = acc_out + (base + h) * R + (R / 2) * half + 2 * t;
#pragma unroll
      for (int n = 0; n < NP; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      if (half == 0 && t == 0) {
        m_out[base + h] = m_run[i];
        l_out[base + h] = red_l[h] + red_l[HT + h];
      }
    }
  }
}

// ----------------------------------------------------------- float32 body --

constexpr int TS = 32;    // cache rows per shared-memory tile (one per lane)
constexpr int HG = 16;    // query heads per block
constexpr int NT = 256;   // threads per block: 8 warps

// Stage ROWS rows of [a | d] (a: R floats a row, d: DR) into dst as rows of
// R + DR, with 16-byte loads: a block's loads are all issued before any is
// stored, up to 8 per thread, so many are in flight at once.  Row j is read
// only if j < n_ok and (live is null or live[j]); otherwise it is staged as
// zeros.  a, d and every row start are 16-byte aligned (the wrapper checks
// the bases).
template <int R, int DR, int ROWS>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ a,
                                           const float* __restrict__ d, int n_ok,
                                           const uint8_t* live) {
  constexpr int VR = R / 4, VW = (R + DR) / 4;
  constexpr int NV = ROWS * VW;
  constexpr int ITERS = (NV + NT - 1) / NT;
  constexpr int CH = ITERS < 8 ? ITERS : 8;
  for (int i0 = 0; i0 < ITERS; i0 += CH) {
    float4 buf[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int v = threadIdx.x + (i0 + i) * NT;
      const int j = v / VW, u = v % VW;
      buf[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < NV && j < n_ok && (live == nullptr || live[j]))
        buf[i] = u < VR ? __ldg(reinterpret_cast<const float4*>(a + (size_t)j * R + u * 4))
                        : __ldg(reinterpret_cast<const float4*>(d + (size_t)j * DR + (u - VR) * 4));
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int v = threadIdx.x + (i0 + i) * NT;
      if (v < NV) *reinterpret_cast<float4*>(dst + (v / VW) * (R + DR) + (v % VW) * 4) = buf[i];
    }
  }
}

template <int R, int DR>
constexpr int f32_smem_bytes() {
  return (HG * (R + DR) + TS * (R + DR) + 2 * HG * TS + 3 * HG) * (int)sizeof(float);
}

// as mla_partials_mma, float32, 16 heads a block
template <int R, int DR>
__global__ void __launch_bounds__(NT, 2)
mla_partials_f32(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                 const float* __restrict__ c_kv, const float* __restrict__ k_rope,
                 const uint8_t* __restrict__ valid, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int S,
                 int H, int bs, float denom) {
  constexpr int KD = R + DR;             // length of a score's dot product
  constexpr int KD4 = KD / 4;
  constexpr int CPT = (R + NT - 1) / NT; // latent columns per thread in p.V
  static_assert(KD % 4 == 0, "rows are read as float4");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // (HG, KD): [q_lat | q_rope] of the group
  float* cs = qs + HG * KD;      // (TS, KD): [c_kv | k_rope] rows of a tile
  float* ss = cs + TS * KD;      // (HG, TS): scaled, masked scores
  float* ps = ss + HG * TS;      // (TS, HG): p
  float* ms = ps + TS * HG;      // (HG): running max of the block
  float* ls = ms + HG;           // (HG): running sum of p
  float* as = ls + HG;           // (HG): this tile's rescale of acc
  __shared__ uint8_t live[TS];   // row valid and inside the split

  const int js = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
  const int ns = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s_lo = js * bs, s_hi = min(s_lo + bs, S);

  // heads past H are staged as zeros and never written out
  stage_rows<R, DR, HG>(qs, q_lat + ((size_t)b * H + h0) * R,
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
    stage_rows<R, DR, TS>(cs, c_kv + ((size_t)b * S + t0) * R,
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
      ps[lane * HG + hh] = p;
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

// ------------------------------------------------------------------ merge --

// Merge the ns partials of each (b, h) in order: grid (H, b), R threads.
// With lse (b, H) given, thread 0 also writes each (b, h)'s log-sum-exp.
template <typename T>
__global__ void mla_combine(const float* __restrict__ acc,
                            const float* __restrict__ m,
                            const float* __restrict__ l, T* __restrict__ out,
                            float* __restrict__ lse, int ns, int H, int R) {
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
  if (lse != nullptr && d == 0)
    lse[(size_t)b * H + h] = l_g > 0.f ? m_g + logf(l_g) : __int_as_float(0xff800000);
}

template <int R, int DR>
cudaError_t launch_merge(const float* q_lat, const float* q_rope, const float* c_kv,
                         const float* k_rope, const uint8_t* valid, float* acc, float* m,
                         float* l, void* out, float* lse, int b, int S, int H, int bs,
                         bool fused, float denom, cudaStream_t stream) {
  if (fused) return cudaErrorInvalidValue;  // the float32 body merges in a second kernel
  const int ns = (S + bs - 1) / bs;
  constexpr int smem = f32_smem_bytes<R, DR>();
  cudaError_t err = cudaFuncSetAttribute(mla_partials_f32<R, DR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mla_partials_f32<R, DR><<<dim3(ns, (H + HG - 1) / HG, b), NT, smem, stream>>>(
      q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, S, H, bs, denom);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_combine<float><<<dim3(H, b), R, 0, stream>>>(acc, m, l, static_cast<float*>(out), lse,
                                                   ns, H, R);
  return cudaGetLastError();
}

// out: bf16, or float32 beside the log-sum-exp when lse is given
template <int R, int DR>
cudaError_t launch_merge(const bf16* q_lat, const bf16* q_rope, const bf16* c_kv,
                         const bf16* k_rope, const uint8_t* valid, float* acc, float* m,
                         float* l, void* out, float* lse, int b, int S, int H, int bs,
                         bool fused, float denom, cudaStream_t stream) {
  bf16* out_b = lse == nullptr ? static_cast<bf16*>(out) : nullptr;
  float* out_f = lse == nullptr ? nullptr : static_cast<float*>(out);
  const int ns = (S + bs - 1) / bs;
  constexpr int smem = MmaSmem<R, DR>::BYTES;
  const dim3 grid(ns, (H + HT - 1) / HT, b);
  if (fused && ns > MAX_CLUSTER) return cudaErrorInvalidValue;
  if (fused) {                   // one cluster of splits a (head tile, batch)
    auto kern = mla_partials_mma<R, DR, true>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(MT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ns;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kern, q_lat, q_rope, c_kv, k_rope, valid, acc, m, l,
                              out_b, out_f, lse, S, H, bs, denom);
  }
  auto kern = mla_partials_mma<R, DR, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, MT, smem, stream>>>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out_b,
                                   out_f, lse, S, H, bs, denom);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (lse != nullptr)   // float32 output beside the log-sum-exp
    mla_combine<float><<<dim3(H, b), R, 0, stream>>>(acc, m, l, out_f, lse, ns, H, R);
  else
    mla_combine<bf16><<<dim3(H, b), R, 0, stream>>>(acc, m, l, out_b, nullptr, ns, H, R);
  return cudaGetLastError();
}

template <typename T, int R, int DR>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* c_kv,
                   const void* k_rope, const uint8_t* valid, float* acc,
                   float* m, float* l, void* out, float* lse, int b, int S, int H, int bs,
                   bool fused, float denom, cudaStream_t stream) {
  if (bs <= 0 || bs % 16) return cudaErrorInvalidValue;
  return launch_merge<R, DR>(static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
                             static_cast<const T*>(c_kv), static_cast<const T*>(k_rope),
                             valid, acc, m, l, out, lse, b, S, H, bs, fused, denom, stream);
}

template <typename T>
cudaError_t launch_rd(int R, int DR, const void* q_lat, const void* q_rope,
                      const void* c_kv, const void* k_rope,
                      const uint8_t* valid, float* acc, float* m, float* l,
                      void* out, float* lse, int b, int S, int H, int bs, bool fused,
                      float denom, cudaStream_t stream) {
  if (R == 32 && DR == 16)
    return launch<T, 32, 16>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out, lse, b, S, H, bs, fused, denom, stream);
  if (R == 32 && DR == 64)
    return launch<T, 32, 64>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out, lse, b, S, H, bs, fused, denom, stream);
  if (R == 512 && DR == 16)
    return launch<T, 512, 16>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out, lse, b, S, H, bs, fused, denom, stream);
  if (R == 512 && DR == 64)
    return launch<T, 512, 64>(q_lat, q_rope, c_kv, k_rope, valid, acc, m, l, out, lse, b, S, H, bs, fused, denom, stream);
  return cudaErrorInvalidValue;
}

template <int R, int DR>
int max_clusters(int ns) {
  auto kern = mla_partials_mma<R, DR, true>;
  constexpr int smem = MmaSmem<R, DR>::BYTES;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, 1, 1);
  cfg.blockDim = dim3(MT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace

// q_lat (b, H, R), q_rope (b, H, DR), c_kv (b, S, R), k_rope (b, S, DR),
// valid (b, S) of 0/1 bytes, all contiguous; bs cache rows a split (a
// multiple of 16) and fused (the ns = ceil(S / bs) splits of a (head tile,
// batch) merge in one cluster: bf16 only, ns <= 8), both from the wrapper's
// plan (kernels/meta.py's mla_plan); scratch acc (b, ns, H, R), m and l
// (b, ns, H) float32, unused (may be null) where fused; out (b, H, R) in
// the caches' dtype, or float32 when lse (b, H) float32 is not null: each
// (b, h)'s log-sum-exp of its scores, -inf on a row with no valid entry.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_flash_decode_mla(const void* q_lat, const void* q_rope,
                                      const void* c_kv, const void* k_rope,
                                      const void* valid, void* acc, void* m,
                                      void* l, void* out, void* lse, int b, int S,
                                      int H, int R, int DR, int bs, int fused,
                                      int dtype, float denom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)launch_rd<float>(R, DR, q_lat, q_rope, c_kv, k_rope, vm, a, mm, ll, out, ls, b, S, H, bs, fused, denom, s);
  if (dtype == 1)
    return (int)launch_rd<bf16>(R, DR, q_lat, q_rope, c_kv, k_rope, vm, a, mm, ll, out, ls, b, S, H, bs, fused, denom, s);
  return (int)cudaErrorInvalidValue;
}

// clusters of ns blocks of the bf16 body at widths (R, DR) that the current
// device holds at once (cudaOccupancyMaxActiveClusters), or -1
extern "C" int repro_flash_decode_mla_clusters(int R, int DR, int ns) {
  if (ns < 1 || ns > MAX_CLUSTER) return -1;
  if (R == 32 && DR == 16) return max_clusters<32, 16>(ns);
  if (R == 32 && DR == 64) return max_clusters<32, 64>(ns);
  if (R == 512 && DR == 16) return max_clusters<512, 16>(ns);
  if (R == 512 && DR == 64) return max_clusters<512, 64>(ns);
  return -1;
}
