// Blockwise-int8 round trip with error feedback over a whole gradient tree
// for Hopper (sm_90a), in one pass.
//
// Replaces no Pallas kernel: the JAX package's compressor
// (distributed/compression.py: quantize_blockwise, dequantize_blockwise,
// compress_with_feedback) is plain jnp, which XLA fuses under the
// accumulated train step's jax.jit (distributed/overlap.py
// make_accum_train_step).  In plain PyTorch the round trip is some twelve
// passes a tensor.  Here, for every tensor i of the tree and its flat view
// cut into blocks of `block` elements (the last block of a tensor padded
// with zeros; a block never crosses tensors):
//   t  = g + e                     (g alone where no residual is given)
//   s  = absmax_block(t) > 0 ? absmax / 127 : 1
//   c  = clip(rint(t / s), -127, 127) * s      written over g
//   e' = t - c                     written over e, where a residual is given
// in f32.  Each operation is one rounding by intrinsic (__fadd_rn,
// __fdiv_rn, rintf: half to even, as jnp.round, __fmul_rn, __fsub_rn), so
// that nvcc contracts nothing into an FMA; the block's max is exact in any
// order.  The quantized value is taken back to +0 where rint gave -0 (the
// reference's int8 codes have no sign of zero).  So the result is bit-equal
// to the plain version (kernels/compress.py), the composition of the
// reference's functions.  Non-finite values: the max keeps a NaN (as
// jnp.max does), so a block holding one has scale 1, as the reference's;
// the NaN comes out NaN (the reference casts it to int8, which is
// undefined); a block holding an Inf has scale Inf and comes out NaN (0 *
// Inf), as the reference's.
//
// What bounds it on this card: bytes.  It reads g (and e) once and writes
// them once: 8 bytes an element, 16 with a residual.  llama3.2-3b's tree
// holds 3,212,749,824 elements: 25.70 GB, 7.67 ms at 3.35 TB/s.  The
// arithmetic is a handful of operations an element.
//
// The design.  A table of the tensors (pointers, numel, first block) is
// written on the device by compress_fill_kernel from kernel arguments, FILL
// entries a launch, so a capture records it with no host copy.  Then
// compress_int8_kernel<VEC, PER>: one wave of resident blocks; each warp
// takes a contiguous run of the tree's quantization blocks, one block an
// iteration, and finds its first block's tensor by a binary search of the
// table's first blocks, then steps to the next tensor as its run crosses
// one.  Each lane loads its PER pieces of VEC elements of the block into
// registers (16-byte loads for VEC = 4: every pointer 16-byte aligned and
// `block` a multiple of 4, which the wrapper checks; PER = block / (32
// VEC) rounded up, so that registers hold only the block's pieces and the
// SM as many warps as it can), the block's absmax is reduced by
// __shfl_xor_sync, and each lane writes its pieces back from the
// registers: g and e are read once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCK = 1024;        // the largest quantization block
constexpr int FILL = 100;              // table entries a fill launch (3,200
                                       // bytes of kernel parameters)
constexpr unsigned FULL = 0xffffffffu;

struct Entry {
  float* g;                            // the values, compressed in place
  float* e;                            // the residual, or nullptr
  long long numel;
  long long block0;                    // the tensor's first block
};

struct Fill {
  Entry e[FILL];
};

__global__ void compress_fill_kernel(Fill f, Entry* table, int offset,
                                     int count) {
  const int i = threadIdx.x;
  if (i < count) table[offset + i] = f.e[i];
}

// the entry of block b: the last whose first block is <= b
__device__ __forceinline__ int find(const Entry* table, int n, long long b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].block0 <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// max(a, b) that keeps a NaN of either, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  return (b != b || b > a) ? b : a;
}

// one element: c (returned) and, with a residual, e' = t - c
__device__ __forceinline__ float round_trip(float t, float s) {
  float q = rintf(__fdiv_rn(t, s));
  q = q > 127.f ? 127.f : (q < -127.f ? -127.f : q);   // a NaN stays
  q = __fadd_rn(q, 0.f);                               // -0 -> +0
  return __fmul_rn(q, s);
}

// VEC elements a piece: 4 (16-byte accesses) or 1; PER pieces a lane: a
// block holds at most 32 PER VEC elements
template <int VEC, int PER>
__global__ void __launch_bounds__(THREADS)
compress_int8_kernel(const Entry* __restrict__ table, int n,
                     long long blocks, int block) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * WARPS;
  const long long run = (blocks + warps - 1) / warps;
  long long b = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * run;
  const long long end = b + run < blocks ? b + run : blocks;
  if (b >= end) return;                         // the whole warp
  int ei = find(table, n, b);
  Entry en = table[ei];
  long long next0 = ei + 1 < n ? table[ei + 1].block0 : blocks;
  for (; b < end; ++b) {
    while (b >= next0) {                        // the run enters a tensor
      en = table[++ei];
      next0 = ei + 1 < n ? table[ei + 1].block0 : blocks;
    }
    const long long start = (b - en.block0) * block;
    const long long rem = en.numel - start;
    const int count = rem < block ? (int)rem : block;
    float* g = en.g + start;
    float* e = en.e ? en.e + start : nullptr;
    float t[PER][VEC];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = (j * 32 + lane) * VEC;
      bool whole = false;
      if constexpr (VEC == 4) {
        whole = i + VEC <= count;
        if (whole) {
          const float4 x = *reinterpret_cast<const float4*>(g + i);
          t[j][0] = x.x; t[j][1] = x.y; t[j][2] = x.z; t[j][3] = x.w;
          if (e) {
            const float4 r = *reinterpret_cast<const float4*>(e + i);
            t[j][0] = __fadd_rn(t[j][0], r.x);
            t[j][1] = __fadd_rn(t[j][1], r.y);
            t[j][2] = __fadd_rn(t[j][2], r.z);
            t[j][3] = __fadd_rn(t[j][3], r.w);
          }
        }
      }
      if (!whole) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          float x = 0.f;                              // the block's padding
          if (i + k < count) {
            x = g[i + k];
            if (e) x = __fadd_rn(x, e[i + k]);
          }
          t[j][k] = x;
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) m = nan_max(m, fabsf(t[j][k]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = nan_max(m, __shfl_xor_sync(FULL, m, o));
    const float s = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = (j * 32 + lane) * VEC;
      bool whole = false;
      if constexpr (VEC == 4) {
        whole = i + VEC <= count;
        if (whole) {
          float c[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) c[k] = round_trip(t[j][k], s);
          *reinterpret_cast<float4*>(g + i) = make_float4(c[0], c[1], c[2],
                                                          c[3]);
          if (e)
            *reinterpret_cast<float4*>(e + i) = make_float4(
                __fsub_rn(t[j][0], c[0]), __fsub_rn(t[j][1], c[1]),
                __fsub_rn(t[j][2], c[2]), __fsub_rn(t[j][3], c[3]));
        }
      }
      if (!whole) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (i + k < count) {
            const float c = round_trip(t[j][k], s);
            g[i + k] = c;
            if (e) e[i + k] = __fsub_rn(t[j][k], c);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// the workspace bytes of a tree of n tensors: the table
int compress_workspace_bytes(int n) {
  return (int)((size_t)n * sizeof(Entry));
}

// entries: n rows of (g, e, numel) as the wrapper's int64 array (e 0: no
// residual); block: the quantization block (16-1024); vec: 4 (every pointer
// 16-byte aligned, block a multiple of 4) or 1; workspace: the table;
// sms: the card's SMs (the grid's size)
int compress_int8(const long long* entries, int n, int block, int vec,
                  void* workspace, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || block < 16 || block > MAX_BLOCK || (vec != 1 && vec != 4) ||
      (vec == 4 && block % 4 != 0))
    return cudaErrorInvalidValue;
  Entry* table = static_cast<Entry*>(workspace);
  long long blocks = 0;
  Fill f;
  for (int i0 = 0; i0 < n; i0 += FILL) {
    const int cnt = n - i0 < FILL ? n - i0 : FILL;
    for (int j = 0; j < cnt; ++j) {
      const long long* r = entries + 3 * (i0 + j);
      f.e[j] = Entry{reinterpret_cast<float*>(r[0]),
                     reinterpret_cast<float*>(r[1]), r[2], blocks};
      blocks += (r[2] + block - 1) / block;
    }
    compress_fill_kernel<<<1, FILL, 0, s>>>(f, table, i0, cnt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (blocks == 0) return cudaErrorInvalidValue;
  // pieces a lane: the smallest instantiated count that holds the block
  const int need = (block + 32 * vec - 1) / (32 * vec);
  int per = 1;
  while (per < need) per *= 2;
  void (*kernel)(const Entry*, int, long long, int) = nullptr;
  if (vec == 4) {
    kernel = per == 1 ? compress_int8_kernel<4, 1>
           : per == 2 ? compress_int8_kernel<4, 2>
           : per == 4 ? compress_int8_kernel<4, 4>
                      : compress_int8_kernel<4, 8>;
  } else {
    kernel = per == 1 ? compress_int8_kernel<1, 1>
           : per == 2 ? compress_int8_kernel<1, 2>
           : per == 4 ? compress_int8_kernel<1, 4>
           : per == 8 ? compress_int8_kernel<1, 8>
           : per == 16 ? compress_int8_kernel<1, 16>
                       : compress_int8_kernel<1, 32>;
  }
  // one wave: as many blocks as are resident (asked once an instantiation,
  // on the first call, which is eager), no more than there is work
  static int resident_of[2][6] = {};
  int log_per = 0;
  while ((1 << log_per) < per) ++log_per;
  int& resident = resident_of[vec == 4][log_per];
  if (resident == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  long long grid = (blocks + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * (resident > 0 ? resident : 1);
  if (grid > cap) grid = cap;
  kernel<<<(unsigned)grid, THREADS, 0, s>>>(table, n, blocks, block);
  return cudaGetLastError();
}

}  // extern "C"
