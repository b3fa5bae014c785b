// RMSNorm for Hopper (sm_90a): y = u * rsqrt(mean(u^2) + eps) * scale with
// u = x, or u = x * bf16(silu(f32(z))) for Mamba2's gated norm; and its
// gradient (dx, dz, dscale) from the row scales the forward writes.  A row's
// sums run in an order set by the row width alone.
//
// Replaces: no Pallas kernel.  The JAX package's
// src/repro/models/common.py::rms_norm and ::gated_rms_norm are left to XLA,
// which fuses the norm, its gate and their gradient.  The port's plain
// version (kernels/rms_norm/ref.py) is PyTorch's float32 mean, whose CUDA
// reduction sizes its thread block by the number of rows -- one row alone
// is spread over more threads than the same row among eight, so the two
// sum in other orders and can differ in the last bit.  In a decode step
// that was enough to flip greedy tokens of the batchers against
// per-request decoding (chip_smoke.py's batch probe found Mamba2's gated
// norm first).  Here a row's bits depend on the row alone.
//
// What bounds it on an H100: bytes, ~3-10 flops an element.  The forward
// reads x (and z) once and writes y: at llama3.2-3b's prefill (4,096 rows
// of 3,072 bf16) 50 MB, ~15 us at 3.35 TB/s.  The backward reads g, x (and
// z) once and writes dx (and dz), plus one float32 (blocks, d) scratch of
// dscale's partial sums written and read back: at a training microbatch
// (1,024 rows of 3,072) ~19 MB + 1.6 MB.  The gradient it replaces was 13
// eager kernels moving ~340 MB through float32 temporaries.
//
// Design.
// - A row is split into 16-byte chunks (8 bf16 or 4 float32 values).  W =
//   ceil(d / 2,048) warps take a row (one warp up to 2,048 values, 8 at
//   jamba's 16,384, the widest taken), thread t the chunks t, t + 32 W, ...
//   -- at most 64 values (8 bf16 or 16 float32 chunks), loaded once into
//   registers: the row is read once.  W comes from kernels/meta.py's
//   rms_norm_plan, from d alone.
// - A block holds R = 8 / W rows (one when W >= 8), so narrow rows still
//   fill 256-thread blocks and several blocks share each SM at the main
//   paths' row counts; the forward takes fewer when the rows would not
//   give each SM a block (a decode step's few rows).  R never touches a
//   row's sums.
// - A row's sum: each thread sums its chunks' squares in chunk order in
//   float32, a warp's lanes by a butterfly of shuffles (every lane ends with
//   the same bits), the W warps' sums through shared memory, read by every
//   thread in warp order -- no serial pass by one thread, one barrier.
//   The order is fixed by d, never by the rows beside it or the grid.
// - rstd = rsqrt(sum / d + eps) in float32 (written for the backward), each
//   output (u * rstd) * scale in float32, rounded once to x's dtype, as the
//   plain version rounds.  The gate is rounded to x's dtype and the product
//   x * gate too, as gated_rms_norm rounds them.
// - x and z may be strided rows (the last axis contiguous, rows a fixed
//   number of elements apart, 16-byte aligned): MLA's kv[..., :r_kv] is
//   normed in place of a copy.  y, dx and dz are contiguous.
// - Backward: a block walks a contiguous range of rows, R at a time, each
//   row by the same W warps and chunks as the forward: c = mean(g s x_hat)
//   in the forward's order, dx = rstd (g s - x_hat c) (for the gated form
//   then through the product and silu, rounded where autograd rounds).
//   Each of the R row groups adds g x_hat of its rows into its own float32
//   row of shared memory; at the end the block writes their sum, in group
//   order, as its row of a (blocks, d) float32 scratch, and a second launch
//   sums the blocks' rows into dscale (32 columns a block, its 8 warps each
//   over every 8th row, then in warp order).  No atomics: a rerun gives the
//   same bits, and the number of blocks follows (rows, d) alone
//   (kernels/meta.py's rms_norm_bwd_blocks).
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::round_to;
using repro::to_f;
using repro::warp_sum;

constexpr int MAXV = 64;           // values a thread holds, at most
constexpr int MAX_THREADS = 256;   // W * 32 * R, at most
constexpr int SMEM_DEFAULT = 48 * 1024;  // static + dynamic, without opting in
constexpr int BWD_STATIC_SMEM = 2 * 32 * (int)sizeof(float);  // rms_norm_bwd's part

struct NormArgs {
  const void* g;
  const void* x;
  const void* z;
  const void* scale;
  const float* rstd_in;
  void* y;
  float* rstd;
  void* dx;
  void* dz;
  float* partial;
  void* dscale;
  long long rows, x_stride, z_stride;
  int d, warps, rows_a_block, blocks;
  float eps;
  cudaStream_t stream;
};

// silu(z) = z / (1 + exp(-z)), as PyTorch's CUDA silu computes it
__device__ __forceinline__ float silu_f(float z) { return z / (1.f + expf(-z)); }

// the gate of the gated norm: silu in float32, rounded to T
template <typename T>
__device__ __forceinline__ float gate_of(float z) { return round_to<T>(silu_f(z)); }

// the VEC scale values of chunk c, widened to float
template <typename S, int VEC>
__device__ __forceinline__ void load_scale(const S* __restrict__ scale, int c, float (&s)[VEC]) {
  constexpr int BYTES = VEC * (int)sizeof(S);
  constexpr int PER16 = 16 / (int)sizeof(S);
  if constexpr (BYTES % 16 == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(scale + (size_t)c * VEC);
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 raw = p[k];
      const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
      for (int j = 0; j < PER16; ++j) s[k * PER16 + j] = to_f(e[j]);
    }
  } else {  // four bf16 values: 8 bytes
    const uint2 raw = *reinterpret_cast<const uint2*>(scale + (size_t)c * VEC);
    const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = to_f(e[j]);
  }
}

// The forward: one row per group of blockDim.x = 32 W threads, blockDim.y
// = R rows a block (R does not touch a row's sums).
template <typename T, typename S, bool GATED>
__global__ void __launch_bounds__(MAX_THREADS)
rms_norm_fwd(const T* __restrict__ x, const T* __restrict__ z, const S* __restrict__ scale,
             T* __restrict__ y, float* __restrict__ rstd, long long rows, int d,
             long long x_stride, long long z_stride, float eps) {
  constexpr int VEC = 16 / sizeof(T), MAXC = MAXV / VEC;
  __shared__ float part[32];
  const int tx = threadIdx.x, nt = blockDim.x, W = nt >> 5, lane = tx & 31, warp = tx >> 5;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  const int chunks = d / VEC;

  uint4 xv[MAXC];
  float acc = 0.f;
  if (live) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_stride);
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = tx + i * nt;
      if (c < chunks) xv[i] = xr[c];
    }
    if constexpr (GATED) {
      const uint4* zr = reinterpret_cast<const uint4*>(z + row * z_stride);
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = tx + i * nt;
        if (c < chunks) {
          const uint4 raw = zr[c];
          const T* zz = reinterpret_cast<const T*>(&raw);
          T* v = reinterpret_cast<T*>(&xv[i]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = from_f<T>(to_f(v[e]) * gate_of<T>(to_f(zz[e])));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      if (tx + i * nt < chunks) {
        const T* v = reinterpret_cast<const T*>(&xv[i]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f(v[e]);
          acc += f * f;
        }
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) part[threadIdx.y * W + warp] = acc;
  __syncthreads();
  if (!live) return;
  float ss = 0.f;
  for (int w = 0; w < W; ++w) ss += part[threadIdx.y * W + w];
  const float r = rsqrtf(ss / d + eps);
  if (rstd && tx == 0) rstd[row] = r;
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = tx + i * nt;
    if (c < chunks) {
      float s[VEC];
      load_scale<S, VEC>(scale, c, s);
      const T* v = reinterpret_cast<const T*>(&xv[i]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = from_f<T>((to_f(v[e]) * r) * s[e]);
      yr[c] = out;
    }
  }
}

// The backward: a block takes rows [blockIdx.x * per_block, ...), R at a
// time; acc (dynamic shared memory, R x d float32) holds each row group's
// sum of g x_hat; the block's sum goes to partial[blockIdx.x].
template <typename T, typename S, bool GATED>
__global__ void __launch_bounds__(MAX_THREADS)
rms_norm_bwd(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ z,
             const S* __restrict__ scale, const float* __restrict__ rstd, T* __restrict__ dx,
             T* __restrict__ dz, float* __restrict__ partial, long long rows, int d,
             long long x_stride, long long z_stride, long long per_block) {
  constexpr int VEC = 16 / sizeof(T), MAXC = MAXV / VEC;
  extern __shared__ float4 acc_s[];
  __shared__ float part[2][32];
  static_assert(sizeof(part) == BWD_STATIC_SMEM, "rms_norm_bwd's static shared memory");
  const int tx = threadIdx.x, nt = blockDim.x, W = nt >> 5, lane = tx & 31, warp = tx >> 5;
  const int R = blockDim.y, chunks = d / VEC;
  float4* acc = acc_s + (size_t)threadIdx.y * (d / 4);
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = tx + i * nt;
    if (c < chunks) {
#pragma unroll
      for (int k = 0; k < VEC / 4; ++k) acc[c * (VEC / 4) + k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const long long r0 = (long long)blockIdx.x * per_block;
  const long long r1 = r0 + per_block < rows ? r0 + per_block : rows;
  const long long iters = r1 > r0 ? (r1 - r0 + R - 1) / R : 0;

  for (long long it = 0; it < iters; ++it) {
    const long long row = r0 + it * R + threadIdx.y;
    const bool live = row < r1;
    uint4 xv[MAXC], gv[MAXC], zv[GATED ? MAXC : 1];
    float p = 0.f, r = 0.f;
    if (live) {
      r = rstd[row];
      const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_stride);
      const uint4* gr = reinterpret_cast<const uint4*>(g + row * (long long)d);
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = tx + i * nt;
        if (c < chunks) {
          xv[i] = xr[c];
          gv[i] = gr[c];
        }
      }
      if constexpr (GATED) {
        const uint4* zr = reinterpret_cast<const uint4*>(z + row * z_stride);
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int c = tx + i * nt;
          if (c < chunks) zv[i] = zr[c];
        }
      }
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = tx + i * nt;
        if (c < chunks) {
          float s[VEC];
          load_scale<S, VEC>(scale, c, s);
          const T* xx = reinterpret_cast<const T*>(&xv[i]);
          const T* gg = reinterpret_cast<const T*>(&gv[i]);
          float gx[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float u = to_f(xx[e]);
            if constexpr (GATED) {
              const T* zz = reinterpret_cast<const T*>(&zv[i]);
              u = round_to<T>(u * gate_of<T>(to_f(zz[e])));
            }
            const float xh = u * r, gf = to_f(gg[e]);
            p += (gf * s[e]) * xh;
            gx[e] = gf * xh;
          }
#pragma unroll
          for (int k = 0; k < VEC / 4; ++k) {
            float4 a = acc[c * (VEC / 4) + k];
            a.x += gx[4 * k];
            a.y += gx[4 * k + 1];
            a.z += gx[4 * k + 2];
            a.w += gx[4 * k + 3];
            acc[c * (VEC / 4) + k] = a;
          }
        }
      }
    }
    p = warp_sum(p);
    float* pp = part[it & 1];   // two buffers: a row's reads end before the next but one writes
    if (lane == 0) pp[threadIdx.y * W + warp] = p;
    __syncthreads();
    if (!live) continue;
    float sp = 0.f;
    for (int w = 0; w < W; ++w) sp += pp[threadIdx.y * W + w];
    const float mean = sp / d;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * (long long)d);
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = tx + i * nt;
      if (c < chunks) {
        float s[VEC];
        load_scale<S, VEC>(scale, c, s);
        const T* xx = reinterpret_cast<const T*>(&xv[i]);
        const T* gg = reinterpret_cast<const T*>(&gv[i]);
        uint4 out, outz;
        T* o = reinterpret_cast<T*>(&out);
        T* oz = reinterpret_cast<T*>(&outz);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = to_f(xx[e]);
          if constexpr (GATED) {
            const T* zz = reinterpret_cast<const T*>(&zv[i]);
            const float zf = to_f(zz[e]);
            const float ez = 1.f + expf(-zf);
            const float gate = round_to<T>(zf / ez);   // gate_of<T>(zf)
            const float u = round_to<T>(xf * gate), xh = u * r;
            // du in x's dtype, then the product's two gradients in it, then
            // silu's in float32: autograd's roundings
            const float du = round_to<T>(r * (to_f(gg[e]) * s[e] - xh * mean));
            o[e] = from_f<T>(du * gate);
            const float dgate = round_to<T>(du * xf);
            const float sg = 1.f / ez;
            oz[e] = from_f<T>(dgate * sg * (1.f + zf * (1.f - sg)));
          } else {
            const float xh = xf * r;
            o[e] = from_f<T>(r * (to_f(gg[e]) * s[e] - xh * mean));
          }
        }
        dxr[c] = out;
        if constexpr (GATED) reinterpret_cast<uint4*>(dz + row * (long long)d)[c] = outz;
      }
    }
  }
  __syncthreads();
  // the block's sum of g x_hat: its row groups' sums in group order
  const int tid = threadIdx.y * nt + tx, all = nt * R;
  const float* accf = reinterpret_cast<const float*>(acc_s);
  for (int col = tid; col < d; col += all) {
    float s = 0.f;
    for (int j = 0; j < R; ++j) s += accf[(size_t)j * d + col];
    partial[(size_t)blockIdx.x * d + col] = s;
  }
}

// dscale = the blocks' partial sums in an order set by the number of blocks
// alone: a block of 8 warps takes 32 columns, a lane a column; warp w adds
// the partial rows w, w + 8, ... in row order, then the warps' sums are
// added in warp order.
template <typename S>
__global__ void __launch_bounds__(256)
rms_norm_dscale(const float* __restrict__ partial, S* __restrict__ dscale, int blocks, int d) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += 8) s += partial[(size_t)b * d + col];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += sums[w][lane];
    dscale[col] = from_f<S>(t);
  }
}

template <typename T>
bool plan_ok(const NormArgs& a) {
  const int vec = 16 / (int)sizeof(T);
  return a.d > 0 && a.d % vec == 0 && a.rows > 0 && a.warps >= 1 && a.rows_a_block >= 1 &&
         32 * a.warps * a.rows_a_block <= MAX_THREADS && a.d <= 32 * a.warps * MAXV;
}

struct Fwd {
  template <typename T, typename S, bool G>
  static cudaError_t run(const NormArgs& a) {
    if (!plan_ok<T>(a)) return cudaErrorInvalidValue;
    const long long grid = (a.rows + a.rows_a_block - 1) / a.rows_a_block;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    rms_norm_fwd<T, S, G><<<(unsigned)grid, dim3(32 * a.warps, a.rows_a_block), 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.z), static_cast<const S*>(a.scale),
        static_cast<T*>(a.y), a.rstd, a.rows, a.d, a.x_stride, a.z_stride, a.eps);
    return cudaGetLastError();
  }
};

struct Bwd {
  template <typename T, typename S, bool G>
  static cudaError_t run(const NormArgs& a) {
    if (!plan_ok<T>(a) || a.blocks < 1 || a.blocks > a.rows) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (size_t)a.rows_a_block * a.d;
    if (smem + BWD_STATIC_SMEM > SMEM_DEFAULT) {
      cudaError_t err = cudaFuncSetAttribute(rms_norm_bwd<T, S, G>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) return err;
    }
    const long long per_block = (a.rows + a.blocks - 1) / a.blocks;
    rms_norm_bwd<T, S, G><<<(unsigned)a.blocks, dim3(32 * a.warps, a.rows_a_block), smem,
                            a.stream>>>(
        static_cast<const T*>(a.g), static_cast<const T*>(a.x), static_cast<const T*>(a.z),
        static_cast<const S*>(a.scale), a.rstd_in, static_cast<T*>(a.dx), static_cast<T*>(a.dz),
        a.partial, a.rows, a.d, a.x_stride, a.z_stride, per_block);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rms_norm_dscale<S><<<(unsigned)((a.d + 31) / 32), 256, 0, a.stream>>>(
        a.partial, static_cast<S*>(a.dscale), a.blocks, a.d);
    return cudaGetLastError();
  }
};

template <class K, typename T, typename S>
cudaError_t by_gate(bool gated, const NormArgs& a) {
  return gated ? K::template run<T, S, true>(a) : K::template run<T, S, false>(a);
}

template <class K, typename T>
cudaError_t by_scale(int scale_dtype, bool gated, const NormArgs& a) {
  if (scale_dtype == 0) return by_gate<K, T, float>(gated, a);
  if (scale_dtype == 1) return by_gate<K, T, __nv_bfloat16>(gated, a);
  return cudaErrorInvalidValue;
}

template <class K>
int dispatch(int dtype, int scale_dtype, const NormArgs& a) {
  const bool gated = a.z != nullptr;
  if (dtype == 0) return (int)by_scale<K, float>(scale_dtype, gated, a);
  if (dtype == 1) return (int)by_scale<K, __nv_bfloat16>(scale_dtype, gated, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (rows, d) of dtype (0 float32, 1 bfloat16), row i at x + i * x_stride
// elements, 16-byte aligned; z null (plain) or as x (gated); scale (d,) of
// scale_dtype; y (rows, d) contiguous; rstd (rows,) float32 or null.  The
// plan (warps a row, rows a block) is kernels/meta.py's rms_norm_fwd_plan.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rms_norm(const void* x, const void* z, const void* scale, void* y,
                              void* rstd, long long rows, int d, long long x_stride,
                              long long z_stride, int warps, int rows_a_block, int dtype,
                              int scale_dtype, float eps, void* stream) {
  NormArgs a{};
  a.x = x;
  a.z = z;
  a.scale = scale;
  a.y = y;
  a.rstd = static_cast<float*>(rstd);
  a.rows = rows;
  a.d = d;
  a.x_stride = x_stride;
  a.z_stride = z_stride;
  a.warps = warps;
  a.rows_a_block = rows_a_block;
  a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Fwd>(dtype, scale_dtype, a);
}

// The gradient: g (rows, d) contiguous in x's dtype, x and z as the
// forward's, scale, rstd (rows,) float32 from the forward; writes dx (and
// dz) (rows, d) contiguous, partial (blocks, d) float32 scratch, dscale (d,)
// of scale_dtype.  blocks: kernels/meta.py's rms_norm_bwd_blocks(rows, d).
// Two launches (the rows, then dscale's sum over the blocks).
extern "C" int repro_rms_norm_bwd(const void* g, const void* x, const void* z,
                                  const void* scale, const void* rstd, void* dx, void* dz,
                                  void* partial, void* dscale, long long rows, int d,
                                  long long x_stride, long long z_stride, int warps,
                                  int rows_a_block, int blocks, int dtype, int scale_dtype,
                                  void* stream) {
  NormArgs a{};
  a.g = g;
  a.x = x;
  a.z = z;
  a.scale = scale;
  a.rstd_in = static_cast<const float*>(rstd);
  a.dx = dx;
  a.dz = dz;
  a.partial = static_cast<float*>(partial);
  a.dscale = dscale;
  a.rows = rows;
  a.d = d;
  a.x_stride = x_stride;
  a.z_stride = z_stride;
  a.warps = warps;
  a.rows_a_block = rows_a_block;
  a.blocks = blocks;
  a.stream = static_cast<cudaStream_t>(stream);
  if (z != nullptr && dz == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<Bwd>(dtype, scale_dtype, a);
}
