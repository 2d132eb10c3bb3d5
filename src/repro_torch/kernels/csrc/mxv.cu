// Crossbar MxV kernels for Hopper (sm_90a): the CM core's analog
// matrix-vector unit, with int8 "conductances" and per-row scales.
//
// Replaces the two Pallas kernels of the JAX package's kernels/mxv.py:
//   crossbar_mxv      <- _mxv_kernel      (y = (x @ wq^T) * scale, f32 sum)
//   crossbar_mxv_int8 <- _mxv_int8_kernel (acc = xq @ wq^T in int32, then
//                                          y = (acc * xs[b]) * ws[m])
//
// What bounds them on this card: the simulator hands the plane one small
// (B, N) activation block per core firing (N <= 256, M <= 256, B from 1 to
// a few hundred).  A call moves a few kilobytes to a few hundred kilobytes
// and does at most 2*B*N*M ~ 10^7 operations, so by bytes or by operations
// the work is over in well under a microsecond: both kernels are bound by
// their own latency, from the launch through one round of loads to the
// last store.  What the design does about it:
//   - the grid covers the card: the host's plan (mxv.py:mxv_plan) gives at
//     least 132 blocks wherever B x M has that many warp tiles, growing a
//     block's rows, then trading warps along k for rows, only while the
//     grid stays that large;
//   - one round of loads: a block stages its slice of the crossbar (weight-
//     stationary, as the Pallas kernel keeps it in VMEM) and its x rows in
//     shared memory by cp.async, all in flight at once, behind one barrier:
//     16 bytes a copy where every row is 16-byte aligned, else, where one
//     chunk takes all of k, the block's rows as one contiguous region of
//     16-byte units (the main path's 252-byte crossbar rows), 4 bytes a
//     copy for 4-byte aligned rows otherwise.  Staging the crossbar was
//     most of the first design's time (PERF.md): 16-byte copies by
//     cp.async.ca, which lets the second block on an SM find the slice in
//     L1, took the main path's kernel from 3.4 to 2.5 us;
//   - padded rows are an odd number of 16-byte units apart, so the 8 lanes
//     of each phase of a 16-byte shared load hit 8 different bank groups;
//     a region is read where it lands when its rows are 4-byte aligned (N
//     / 4 words a row, conflict-free 4-byte loads where N / 4 is odd) and
//     unpacked into padded rows behind a second barrier when they are not
//     (N = 9 on the DAC path, a crossbar one byte off);
//   - short chains: in the float kernel each thread keeps 4 accumulators
//     and the block splits k over up to 4 warps;
//   - exactly one launch a call, no workspace, no atomics.
//
// Float kernel (f32 on the CUDA cores: a TF32 product would miss the 1e-5
// bound, and at 3.6 MFLOP on the main path the arithmetic bounds nothing).
// A warp covers MT columns (4, 8, 16 or 32: the power of two >= min(M, 32))
// and 32 / MT batch rows, so no lane idles at M = 4 or 8; a block has RG
// such row groups times KS parts of k, each part KC columns of a chunk.
// Thread (row b, column m, part p) sums its part of k in ascending order
// into 4 accumulators, k mod 4 picking one, from one 16-byte (or four
// 4-byte) weight loads and four x loads per 16 columns; then (a0 + a1) +
// (a2 + a3); then the KS parts in ascending part order through shared
// memory; then one multiply by scale[m].  The order is fixed, so results
// are bit-equal from run to run.  A crossbar slice that does not fit the
// plan's shared memory is staged CHUNK columns at a time (the accumulators
// carry on across chunks).
//
// Int8 kernel (DAC) on the int8 tensor cores: mma.sync m16n8k32 s8 x s8 ->
// s32.  A block of 4 warps stages 16, 32 or 64 batch rows and 8 crossbar
// rows; each of its first 1, 2 or 4 warps owns 16 of the batch rows (A,
// row-major) times the 8 crossbar rows (B's columns, col-major: a crossbar
// row is a column), and walks k 32 at a time; zero padding in shared
// memory brings B to 16, M to 8 and N to 32.  A and B fragments are 32-bit
// shared loads (4 consecutive int8 of one row), conflict-free at a row
// stride of 16 mod 32 bytes.  The int32 sums are exact, so the result is
// bit-equal to the plain version; the epilogue applies (acc * xs[b]) *
// ws[m] in that order.  wgmma's 64-row warpgroup tiles would be mostly
// padding at M <= 28.
//
// Edges in B, M and N are masked; B == 0 or M == 0 is the caller's to skip
// (a zero-sized grid is a launch error).  Rows past B or M are not staged:
// their lanes compute values that are never stored.
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::i8x4_to_f32;
using repro_torch::load4;
using repro_torch::smem_addr;
using repro_torch::store;

constexpr int F32_THREADS = 256;   // the float kernel's most threads a block
constexpr int MMA_THREADS = 128;   // the int8 kernel's threads a block
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int BATCH = 4;          // byte loads in flight a thread

// The host's launch plan (mxv.py:MxvPlan.args), field for field.
struct Plan {
  int mt;         // crossbar rows (output columns) a block
  int rows;       // batch rows a block
  int ks;         // warps along k (a power of two)
  int kc;         // k columns a part takes of a chunk
  int chunk;      // k columns staged at a time (ks * kc)
  int wstride;    // bytes a crossbar row in shared memory
  int xstride;    // bytes an x row in shared memory
  int smem;       // dynamic shared memory bytes
  int col_tiles;  // ceil(M / mt)
  int blocks;     // ceil(B / rows) * col_tiles
  int threads;
  int wraw, xraw; // offsets of the areas for one region (0: none)
};

inline Plan read_plan(const int* p) {
  return Plan{p[0], p[1], p[2], p[3], p[4], p[5], p[6],
              p[7], p[8], p[9], p[10], p[11], p[12]};
}

// Stage `rows` rows of a row-major byte matrix (row_bytes a row, from src)
// in shared memory (stride bytes a row, at dst): bytes [c0, c0 + cb) of
// each row, zero where a byte lies past row_bytes.  cb is a multiple of 16,
// c0 of 16.  Copies of 16 bytes by cp.async where src and every row are
// 16-byte aligned, of 4 where 4-byte aligned; the (row, unit) of a thread's
// next copy is stepped, not divided out.  Otherwise byte loads, BATCH in
// flight a thread before their stores: rows the plan gave no region for
// (k in several chunks, or 16-byte rows of a crossbar off its alignment).
__device__ __forceinline__ void stage(uint8_t* dst, int stride,
                                      const uint8_t* src, size_t row_bytes,
                                      int rows, size_t c0, int cb) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | row_bytes;
  const int nt = blockDim.x, tid = threadIdx.x;
  if ((align & 3) == 0) {
    const int sh = (align & 15) == 0 ? 4 : 2;
    const int per = cb >> sh, total = rows * per;
    const int dr = nt / per, dc = nt - dr * per;
    int r = tid / per, c = tid - r * per;
    for (int i = tid; i < total; i += nt) {
      const size_t off = c0 + (static_cast<size_t>(c) << sh);
      const bool ok = off < row_bytes;
      const uint32_t d = smem_addr(dst + r * stride + (c << sh));
      const uint8_t* s = ok ? src + r * row_bytes + off : src;
      if (sh == 4) {
        cp_async16(d, s, ok);
      } else {
        cp_async4(d, s, ok);
      }
      c += dc;
      r += dr;
      if (c >= per) {
        c -= per;
        ++r;
      }
    }
    return;
  }
  const int total = rows * cb;
  for (int i0 = tid; i0 < total; i0 += BATCH * nt) {
    uint8_t v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * nt, r = i / cb;
      const size_t off = c0 + (i - r * cb);
      v[j] = i < total && off < row_bytes ? src[r * row_bytes + off] : 0;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * nt, r = i / cb;
      if (i < total) dst[r * stride + (i - r * cb)] = v[j];
    }
  }
}

// nbytes from src, one contiguous region (the block's rows, all of k), to
// raw as the 16-byte-aligned units of global memory that hold it: raw +
// (src & 15) is then its first byte.  Up to 15 bytes on either side of the
// region come with it, from the aligned units that hold its first and last
// bytes, so never from another page.  cp.async.ca: the blocks on one SM
// read the same crossbar, and L1 serves the second.
__device__ __forceinline__ void copy_region(uint8_t* raw, const uint8_t* src,
                                            size_t nbytes) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) & ~uintptr_t{15};
  const int units = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src) + nbytes + 15 - lo) >> 4);
  for (int i = threadIdx.x; i < units; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(raw + 16 * i)),
                 "l"(reinterpret_cast<const void*>(lo + 16 * i)));
}

// The rows copy_region left in raw, into dst's rows (stride bytes a row),
// zero from row_bytes to cb.
__device__ __forceinline__ void unpack(uint8_t* dst, int stride,
                                       const uint8_t* raw,
                                       const uint8_t* src, int row_bytes,
                                       int rows, int cb) {
  const uint8_t* from = raw + (reinterpret_cast<uintptr_t>(src) & 15);
  for (int i = threadIdx.x; i < rows * cb; i += blockDim.x) {
    const int r = i / cb, c = i - r * cb;
    dst[r * stride + c] = c < row_bytes ? from[r * row_bytes + c] : 0;
  }
}

__device__ __forceinline__ void fma4(float4 x, float4 w, float& a0,
                                     float& a1, float& a2, float& a3) {
  a0 = fmaf(x.x, w.x, a0);
  a1 = fmaf(x.y, w.y, a1);
  a2 = fmaf(x.z, w.z, a2);
  a3 = fmaf(x.w, w.w, a3);
}

template <typename T>
__global__ void __launch_bounds__(F32_THREADS)
crossbar_mxv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ scale, T* __restrict__ y,
                    int B, int N, int M, Plan P) {
  extern __shared__ uint4 smem[];
  uint8_t* wsm = reinterpret_cast<uint8_t*>(smem);      // [mt][wstride]
  uint8_t* xsm = wsm + P.mt * P.wstride;                 // [rows][xstride]
  float* red = reinterpret_cast<float*>(xsm + P.rows * P.xstride);
  const int lmt = __ffs(P.mt) - 1, lks = __ffs(P.ks) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = warp & (P.ks - 1), grp = warp >> lks;
  const int col = lane & (P.mt - 1);
  const int row = (grp << (5 - lmt)) + (lane >> lmt);
  const int m0 = (blockIdx.x % P.col_tiles) * P.mt;
  const int b0 = (blockIdx.x / P.col_tiles) * P.rows;
  const int m = m0 + col, b = b0 + row;
  const float sc = m < M ? scale[m] : 0.f;
  const int wrows = min(P.mt, M - m0), xrows = min(P.rows, B - b0);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  const uint8_t* wsrc =
      reinterpret_cast<const uint8_t*>(wq) + static_cast<size_t>(m0) * N;
  const uint8_t* xsrc = reinterpret_cast<const uint8_t*>(
      x + static_cast<size_t>(b0) * N);
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  // one chunk and rows not 16-byte aligned: the crossbar slice goes as one
  // region, read where it lands if its rows are 4-byte aligned (compact,
  // N / 4 words a row: conflict-free 4-byte loads where N / 4 is odd, as at
  // N = 252), else unpacked into padded rows; the same for x's rows that
  // are not 4-byte aligned
  const bool wregion = P.wraw != 0;
  const bool compact =
      wregion && ((reinterpret_cast<uintptr_t>(wsrc) | N) & 3) == 0;
  const bool xregion = P.xraw != 0;
  const uint8_t* wc = base + P.wraw +
      (reinterpret_cast<uintptr_t>(wsrc) & 15) + col * N;
  for (int k0 = 0; k0 < N; k0 += P.chunk) {
    const int kn = min(P.chunk, N - k0), kn16 = (kn + 15) & ~15;
    if (wregion) {
      copy_region(base + P.wraw, wsrc, static_cast<size_t>(wrows) * N);
    } else {
      stage(wsm, P.wstride, wsrc, N, wrows, k0, kn16);
    }
    if (xregion) {
      copy_region(base + P.xraw, xsrc, sizeof(T) * N * xrows);
    } else {
      stage(xsm, P.xstride, xsrc, sizeof(T) * N, xrows, sizeof(T) * k0,
            sizeof(T) * kn16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if ((wregion && !compact) || xregion) {
      if (wregion && !compact)
        unpack(wsm, P.wstride, base + P.wraw, wsrc, N, wrows, kn16);
      if (xregion)
        unpack(xsm, P.xstride, base + P.xraw, xsrc, sizeof(T) * N, xrows,
               sizeof(T) * kn16);
      __syncthreads();
    }
    const T* xr = reinterpret_cast<const T*>(xsm + row * P.xstride);
    const int ke = min((part + 1) * P.kc, kn16);
    if (compact) {
      // columns past N read the next row's bytes (finite int8) against
      // x's zero padding
#pragma unroll 2
      for (int k = part * P.kc; k < ke; k += 16) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(wc + k);
        fma4(load4(xr + k), i8x4_to_f32(w[0]), a0, a1, a2, a3);
        fma4(load4(xr + k + 4), i8x4_to_f32(w[1]), a0, a1, a2, a3);
        fma4(load4(xr + k + 8), i8x4_to_f32(w[2]), a0, a1, a2, a3);
        fma4(load4(xr + k + 12), i8x4_to_f32(w[3]), a0, a1, a2, a3);
      }
    } else {
      const uint8_t* wr = wsm + col * P.wstride;
#pragma unroll 2
      for (int k = part * P.kc; k < ke; k += 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(wr + k);
        fma4(load4(xr + k), i8x4_to_f32(w.x), a0, a1, a2, a3);
        fma4(load4(xr + k + 4), i8x4_to_f32(w.y), a0, a1, a2, a3);
        fma4(load4(xr + k + 8), i8x4_to_f32(w.z), a0, a1, a2, a3);
        fma4(load4(xr + k + 12), i8x4_to_f32(w.w), a0, a1, a2, a3);
      }
    }
    if (k0 + P.chunk < N) __syncthreads();   // the next chunk overwrites
  }
  float s = (a0 + a1) + (a2 + a3);
  if (P.ks > 1) {
    red[threadIdx.x] = s;
    __syncthreads();
    if (part != 0) return;
    for (int q = 1; q < P.ks; ++q) s += red[threadIdx.x + 32 * q];
  }
  if (b < B && m < M) store(y + static_cast<size_t>(b) * M + m, s * sc);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(MMA_THREADS)
crossbar_mxv_int8_kernel(const int8_t* __restrict__ xq,
                         const float* __restrict__ xscale,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ wscale,
                         float* __restrict__ y, int B, int N, int M, Plan P) {
  extern __shared__ uint4 smem[];
  uint8_t* xsm = reinterpret_cast<uint8_t*>(smem);      // [rows][xstride]
  uint8_t* wsm = xsm + P.rows * P.xstride;               // [8][wstride]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;                 // mma's group, thread
  // the block stages with all its threads; warps past rows / 16 only that
  const bool mma_warp = warp * 16 < P.rows;
  const int m0 = (blockIdx.x % P.col_tiles) * P.mt;
  const int b0 = (blockIdx.x / P.col_tiles) * P.rows;
  // the fragment's outputs: rows bA, bA + 8; columns mA, mA + 1
  const int bA = b0 + warp * 16 + g, mA = m0 + 2 * t;
  const float xs0 = bA < B ? xscale[bA] : 0.f;
  const float xs1 = bA + 8 < B ? xscale[bA + 8] : 0.f;
  const float ws0 = mA < M ? wscale[mA] : 0.f;
  const float ws1 = mA + 1 < M ? wscale[mA + 1] : 0.f;
  const int wrows = min(P.mt, M - m0), xrows = min(P.rows, B - b0);
  const int sx = P.xstride >> 2, sw = P.wstride >> 2;   // in words
  const uint32_t* xa =
      reinterpret_cast<const uint32_t*>(xsm) + (warp * 16 + g) * sx + t;
  const uint32_t* wb = reinterpret_cast<const uint32_t*>(wsm) + g * sw + t;
  const uint8_t* xsrc =
      reinterpret_cast<const uint8_t*>(xq) + static_cast<size_t>(b0) * N;
  const uint8_t* wsrc =
      reinterpret_cast<const uint8_t*>(wq) + static_cast<size_t>(m0) * N;
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  // one chunk and rows not 4-byte aligned (N = 9): both operands go as one
  // region each and are unpacked into padded rows
  const bool region = P.xraw != 0;
  int acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < N; k0 += P.chunk) {
    const int kn32 = (min(P.chunk, N - k0) + 31) & ~31;
    if (region) {
      copy_region(base + P.xraw, xsrc, static_cast<size_t>(xrows) * N);
      copy_region(base + P.wraw, wsrc, static_cast<size_t>(wrows) * N);
    } else {
      stage(xsm, P.xstride, xsrc, N, xrows, k0, kn32);
      stage(wsm, P.wstride, wsrc, N, wrows, k0, kn32);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (region) {
      unpack(xsm, P.xstride, base + P.xraw, xsrc, N, xrows, kn32);
      unpack(wsm, P.wstride, base + P.wraw, wsrc, N, wrows, kn32);
      __syncthreads();
    }
    for (int kw = 0; mma_warp && kw < kn32 >> 2; kw += 8) {
      mma_s8(acc, xa[kw], xa[8 * sx + kw], xa[kw + 4], xa[8 * sx + kw + 4],
             wb[kw], wb[kw + 4]);
    }
    if (k0 + P.chunk < N) __syncthreads();   // the next chunk overwrites
  }
  if (!mma_warp) return;
  if (bA < B) {
    float* yr = y + static_cast<size_t>(bA) * M;
    if (mA < M) yr[mA] = (static_cast<float>(acc[0]) * xs0) * ws0;
    if (mA + 1 < M) yr[mA + 1] = (static_cast<float>(acc[1]) * xs0) * ws1;
  }
  if (bA + 8 < B) {
    float* yr = y + static_cast<size_t>(bA + 8) * M;
    if (mA < M) yr[mA] = (static_cast<float>(acc[2]) * xs1) * ws0;
    if (mA + 1 < M) yr[mA + 1] = (static_cast<float>(acc[3]) * xs1) * ws1;
  }
}

// Above the default 48 KB a kernel takes dynamic shared memory only after
// its limit is raised (only plans for N in the thousands ask for that).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_float(const void* x, const void* wq, const void* scale, void* y,
                 int B, int N, int M, const int* plan, void* stream) {
  const Plan P = read_plan(plan);
  const cudaError_t err = allow_smem(crossbar_mxv_kernel<T>, P.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crossbar_mxv_kernel<T><<<P.blocks, P.threads, P.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<T*>(y), B, N, M, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crossbar_mxv_f32(const void* x, const void* wq, const void* scale,
                     void* y, int B, int N, int M, const int* plan,
                     void* stream) {
  return launch_float<float>(x, wq, scale, y, B, N, M, plan, stream);
}

int crossbar_mxv_bf16(const void* x, const void* wq, const void* scale,
                      void* y, int B, int N, int M, const int* plan,
                      void* stream) {
  return launch_float<__nv_bfloat16>(x, wq, scale, y, B, N, M, plan, stream);
}

int crossbar_mxv_int8(const void* xq, const void* xs, const void* wq,
                      const void* ws, void* y, int B, int N, int M,
                      const int* plan, void* stream) {
  const Plan P = read_plan(plan);
  const cudaError_t err = allow_smem(crossbar_mxv_int8_kernel, P.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crossbar_mxv_int8_kernel<<<P.blocks, P.threads, P.smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<float*>(y), B, N, M, P);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_torch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
