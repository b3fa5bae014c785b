// Tensor-core building blocks of the attention kernels' bfloat16 bodies
// (flash_attention.cu, flash_attention_bwd.cu), in raw PTX: cp.async
// copies into shared memory, ldmatrix loads of 8x8 bf16 matrices into mma
// fragments, mma.sync.m16n8k16 (bf16 in, float32 accumulate), and the XOR
// swizzle of the bf16 tiles they stage.
//
// Fragments of mma.m16n8k16 for lane l of a warp, g = l / 4, t = l % 4:
//   A (16x16, row-major), 4 registers of 2 bf16: a0 = (g, 2t..2t+1),
//     a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..);
//   B (16x8, k x n), 2 registers: b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C (16x8 float32), 4 registers: c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..).
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 in
// pairs, are the A fragment of the next product over those 16 columns: P
// and dS never leave the registers.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace repro {

using bf16 = __nv_bfloat16;

// A tile of rows of D bf16 values (D a multiple of 16) in shared memory, in
// 16-byte chunks of 8 values.  A row takes RC chunk slots: D/8 rounded up
// to a whole 128-byte line of the 32 banks (8 chunks), or 4 for D = 32.
// Chunk c of row r sits at slot c ^ (r % 8) of its 8-chunk group (for D =
// 32, two rows share a line and the slot is c ^ (r/2 % 4)), so the eight
// rows an ldmatrix phase reads at one chunk column fall in eight different
// 16-byte bank groups: no bank conflicts, and no padding.
template <int D>
struct Tile {
  static_assert(D % 16 == 0, "mma.m16n8k16 needs a head dim that is a multiple of 16");
  static constexpr int C = D / 8;
  static constexpr int RC = C <= 4 ? 4 : (C + 7) / 8 * 8;
  // element offset of chunk c of row r
  static __device__ __forceinline__ int at(int r, int c) {
    if (RC == 4) return (r * 4 + (c ^ ((r >> 1) & 3))) * 8;
    return (r * RC + ((c & ~7) | ((c ^ r) & 7))) * 8;
  }
  __host__ __device__ static constexpr int elems(int rows) { return rows * RC * 8; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory; zeros where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0+ROWS-1 of a row-major bf16 array (row stride `stride`
// elements, `base` at row 0) into a swizzled Tile<D>, by the block's NT
// threads, 16 bytes each; rows at or past `rows` are zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ base,
                                          long long stride, int r0, int rows) {
  constexpr int C = Tile<D>::C;
#pragma unroll
  for (int i = 0; i < (ROWS * C + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if ((ROWS * C) % NT != 0 && e >= ROWS * C) break;
    const int r = e / C, c = e % C;
    const bool ok = r0 + r < rows;
    cp_async16(dst + Tile<D>::at(r, c), base + (ok ? (r0 + r) * stride + c * 8 : 0), ok);
  }
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments (16 x 16 columns each) of a 16 x 8N float32 C tile, in bf16
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[N / 2][4], const float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// ldmatrix row and chunk offsets of lane l for the three operand shapes
// read from a Tile (row-major rows x D):
//  A, rows r0.. x chunks 2kk..2kk+1:   row r0 + (l & 15), chunk 2kk + l / 16
//  B, rows n0..n0+15 as n (two 8-wide n tiles), chunks 2kk.. as k:
//      row n0 + (l & 7) + (l / 16) * 8, chunk 2kk + (l / 8) % 2
//  B transposed (.trans), rows k0..k0+15 as k, chunks 2dp..2dp+1 as n:
//      the A offsets.
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_chunk(int lane) { return lane >> 4; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_chunk(int lane) { return (lane >> 3) & 1; }

// acc (16 x 8N) += A B^T over the D columns of two Tiles: A is rows
// ra..ra+15 of As, B is rows 0..8N-1 of Bs (S = Q K^T, dP = dO V^T).
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], const bf16* As, int ra,
                                        const bf16* Bs, int lane) {
  static_assert(N % 2 == 0, "n tiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, As + Tile<D>::at(ra + a_row(lane), 2 * kk + a_chunk(lane)));
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Bs + Tile<D>::at(16 * np + b_row(lane), 2 * kk + b_chunk(lane)));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += A B: A (16 x 16KC) as bf16 A fragments in registers, B
// rows 0..16KC-1 of the Tile Bs, read transposed (O += P V, dQ += dS K).
template <int D, int KC>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KC][4],
                                       const bf16* Bs, int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Bs + Tile<D>::at(16 * kc + a_row(lane), 2 * dp + a_chunk(lane)));
      mma_bf16(acc[2 * dp], a[kc], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kc], b[2], b[3]);
    }
  }
}

// A 16-row band of float32 C fragments (16 x D), scaled by mul, rounded to
// bf16 and stored through the warp's own rows r0..r0+15 of the Tile `stage`
// as 16-byte chunks, rows at or past `rows` skipped: out + (r0 + r) *
// stride is output row r.  The caller syncs so that no thread still reads
// those rows of the tile.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul0, float mul1,
                                           bf16* stage, int r0, bf16* __restrict__ out,
                                           long long stride, int row_base, int rows,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + Tile<D>::at(r0 + g, n) + 2 * t) =
        pack_bf16(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(stage + Tile<D>::at(r0 + g + 8, n) + 2 * t) =
        pack_bf16(acc[n][2] * mul1, acc[n][3] * mul1);
  }
  __syncwarp();
  constexpr int C = Tile<D>::C;
#pragma unroll
  for (int e = lane; e < 16 * C; e += 32) {
    const int r = e / C, c = e % C;
    if (row_base + r < rows)
      *reinterpret_cast<uint4*>(out + (row_base + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + Tile<D>::at(r0 + r, c));
  }
}

}  // namespace repro
