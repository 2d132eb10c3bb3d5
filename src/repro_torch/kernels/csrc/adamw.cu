// AdamW over a model's whole parameter tree for Hopper (sm_90a), in one
// pass a parameter.
//
// Replaces no Pallas kernel: the JAX package's optimizer
// (optim/adamw.py adamw_update) is plain jnp, which XLA fuses under the
// train step's jax.jit into a few loop fusions.  The port's step runs it
// here, eagerly or inside the step's CUDA graph.  For every tensor i of the
// tree, with a global gradient norm over every gradient:
//   gnorm = sqrt(sum_i sum g_i^2),  scale = min(1, clip / max(gnorm, 1e-9))
//   g32 = g scale
//   m'  = b1 m + (1 - b1) g32,  v' = b2 v + (1 - b2) g32 g32
//   p'  = p - lr (m' / bc1 / (sqrt(v' / bc2) + eps) + wd_i p)
// in f32, each result rounded once to its tensor's type and written in
// place.  lr, bc1 and bc2 come from a device buffer (`hyper`), written
// before each step or graph replay; scale from the norm's own output
// (`stats`: gnorm, scale), so no host float is baked into a capture.  A
// tensor without a gradient (the loss does not reach it) reads as a zero
// gradient.  A gradient is of its parameter's type or f32 (the accumulated
// step's f32 sum beside bf16 parameters, distributed/overlap.py): the
// reference casts every gradient to f32 first, so the arithmetic is the
// same.  Each operation is written with a round-to-nearest intrinsic,
// in the reference's order, so that nvcc contracts nothing into an FMA and
// the plain version's separate operations (kernels/adamw.py) give the same
// bits.
//
// What bounds it on this card: bytes.  The update reads g, p, m, v and
// writes p, m, v: 22 bytes a parameter for bf16 parameters and f32
// moments, 70.7 GB over llama3.2-3b's 3,212,749,824 parameters, 21.1 ms at
// 3.35 TB/s; the norm reads g once more (2 bytes, 1.9 ms).  With f32
// gradients: 24 bytes (23.0 ms) and 4 (3.8 ms).  The arithmetic
// is some 15 operations an element, far below the card's f32 rate.
//
// The design.  The tree is cut into chunks of CHUNK elements of one tensor
// (a tensor's last chunk ragged).  A table of the tensors (pointers, numel,
// first chunk, flags: decay and the tensor's types) is written on the
// device by adamw_fill_kernel from kernel arguments, FILL entries a launch,
// so a capture records it with no host copy; gradient addresses may change
// from step to step.  A tree may mix types (falcon-mamba keeps A_log and D
// in f32 beside bf16 weights): each chunk's body is picked by its tensor's
// (parameter, gradient, moment) types, f32 or bf16 each, one branch a
// block.  Then:
//   1. adamw_norm_kernel: NORM_BLOCKS blocks walk the chunks, block b the
//      chunks b, b + NORM_BLOCKS, ...; each thread sums its squares in f64
//      (the sum of 3.2 G squares keeps f32's rounding out of the norm), the
//      block sums its threads by shuffles and the warps in order, and
//      writes its partial to slot b.  No atomics: the order is fixed, so
//      the norm is bit-equal from run to run.
//   2. adamw_finalize_kernel: one block sums the partials in a fixed
//      order, writes gnorm and scale.
//   3. adamw_update_kernel: a block a chunk, 256 threads, 8 elements a
//      thread a step in 16-byte loads and stores (two for f32), the tensor
//      found by a binary search of the table's first chunks.
// Across ranks (a tree split over a mesh, ZeRO-1) the host entry points
// split after 1: the wrapper sums the NORM_BLOCKS f64 partials over the
// mesh in f64, then 2 and 3 run on the sum; a tensor whose elements
// another rank also updates (replicated over "model", say) is flagged
// NO_NORM on all but one rank, so each element's square counts once.
// Every pointer is 16-byte aligned (the wrapper checks, and copies a
// gradient that is not) and chunks start at multiples of 8 elements, so
// every vector access is aligned; a chunk's last count % 8 elements go one
// at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                 // elements a thread a step
constexpr long long CHUNK = 8192;      // elements a chunk (a multiple of VEC)
constexpr int NORM_BLOCKS = 1024;      // the norm's blocks and partials
constexpr int FILL = 80;               // table entries a fill launch (3,840
                                       // bytes of kernel parameters)

// flags of an entry
constexpr int DECAY = 1;               // weight decay applies
constexpr int P_BF16 = 2;              // the parameter (and, without G_F32,
                                       // the gradient) is bf16
constexpr int M_BF16 = 4;              // the moments are bf16
constexpr int G_F32 = 8;               // the gradient is f32 beside a bf16
                                       // parameter
constexpr int NO_NORM = 16;            // the tensor is updated here but its
                                       // squares count on another rank

struct Entry {
  const void* g;                       // nullptr: a zero gradient
  void* p;
  void* m;
  void* v;
  long long numel;
  int chunk0;                          // the tensor's first chunk
  int flags;                           // DECAY | P_BF16 | M_BF16 | G_F32
};

struct Fill {
  Entry e[FILL];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC consecutive elements of p (16-byte aligned) as f32, in 16-byte loads
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&x)[VEC]) {
  constexpr int W = VEC * sizeof(T) / 16;
  uint4 raw[W];
#pragma unroll
  for (int i = 0; i < W; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
  const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = to_f32(t[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&x)[VEC]) {
  constexpr int W = VEC * sizeof(T) / 16;
  uint4 raw[W];
  T* t = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) t[i] = from_f32<T>(x[i]);
#pragma unroll
  for (int i = 0; i < W; ++i) reinterpret_cast<uint4*>(p)[i] = raw[i];
}

__global__ void adamw_fill_kernel(Fill f, Entry* table, int offset,
                                  int count) {
  const int i = threadIdx.x;
  if (i < count) table[offset + i] = f.e[i];
}

// the entry of chunk c: the last whose first chunk is <= c
__device__ __forceinline__ int find(const Entry* table, int n, long long c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].chunk0 <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// the block's sum of one double a thread: shuffles within each warp, then
// the warps' sums in warp order, in thread 0
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sums[w] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += warp_sums[i];
  }
  return s;
}

// this thread's share of the squares of one chunk of g, added to acc
template <typename P>
__device__ __forceinline__ double chunk_squares(const P* g, int count,
                                                double acc) {
  const int full = count - count % VEC;
  for (int i = threadIdx.x * VEC; i < full; i += THREADS * VEC) {
    float x[VEC];
    load8(g + i, x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc = fma((double)x[k], (double)x[k], acc);
  }
  for (int i = full + threadIdx.x; i < count; i += THREADS) {
    const double x = to_f32(g[i]);
    acc = fma(x, x, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
adamw_norm_kernel(const Entry* __restrict__ table, int n, long long chunks,
                  double* __restrict__ partials) {
  __shared__ int entry;
  __shared__ double warp_sums[THREADS / 32];
  double acc = 0.0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    __syncthreads();
    if (threadIdx.x == 0) entry = find(table, n, c);
    __syncthreads();
    const Entry& e = table[entry];
    if (e.g == nullptr || (e.flags & NO_NORM)) continue;
    const long long start = (c - e.chunk0) * CHUNK;
    const long long rem = e.numel - start;
    const int count = (int)(rem < CHUNK ? rem : CHUNK);
    if ((e.flags & (P_BF16 | G_F32)) == P_BF16)
      acc = chunk_squares(static_cast<const __nv_bfloat16*>(e.g) + start,
                          count, acc);
    else
      acc = chunk_squares(static_cast<const float*>(e.g) + start, count, acc);
  }
  const double s = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// one block of NORM_BLOCKS threads: gnorm and scale into stats
__global__ void adamw_finalize_kernel(const double* __restrict__ partials,
                                      float* __restrict__ stats, float clip) {
  __shared__ double warp_sums[NORM_BLOCKS / 32];
  const double s = block_sum(partials[threadIdx.x], warp_sums);
  if (threadIdx.x == 0) {
    const float gnorm = (float)sqrt(s);
    // min(1, clip / max(gnorm, 1e-9)), a NaN kept as the reference keeps it
    const float lo = gnorm < 1e-9f ? 1e-9f : gnorm;
    const float r = __fdiv_rn(clip, lo);
    stats[0] = gnorm;
    stats[1] = r > 1.f ? 1.f : r;
  }
}

struct Hyper {
  float scale, lr, bc1, bc2;
};

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

// one element: p, m, v updated in place in f32 (the reference's order)
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h, const Consts& k,
                                       bool decay) {
  const float g32 = __fmul_rn(g, h.scale);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(g32, k.omb1));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(g32, g32), k.omb2));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), k.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(p, k.wd));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

// one chunk of one tensor: count elements from start, in place
template <typename P, typename G, typename M>
__device__ __forceinline__ void update_chunk(const Entry& e, long long start,
                                             int count, const Hyper& h,
                                             const Consts& k) {
  const G* g = e.g ? static_cast<const G*>(e.g) + start : nullptr;
  P* p = static_cast<P*>(e.p) + start;
  M* m = static_cast<M*>(e.m) + start;
  M* v = static_cast<M*>(e.v) + start;
  const bool decay = (e.flags & DECAY) != 0;
  const int full = count - count % VEC;
  for (int i = threadIdx.x * VEC; i < full; i += THREADS * VEC) {
    float pp[VEC], gg[VEC], mm[VEC], vv[VEC];
    if (g) {
      load8(g + i, gg);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) gg[j] = 0.f;
    }
    load8(p + i, pp);
    load8(m + i, mm);
    load8(v + i, vv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) update(pp[j], gg[j], mm[j], vv[j], h, k, decay);
    store8(p + i, pp);
    store8(m + i, mm);
    store8(v + i, vv);
  }
  for (int i = full + threadIdx.x; i < count; i += THREADS) {
    float pp = to_f32(p[i]), mm = to_f32(m[i]), vv = to_f32(v[i]);
    update(pp, g ? to_f32(g[i]) : 0.f, mm, vv, h, k, decay);
    p[i] = from_f32<P>(pp);
    m[i] = from_f32<M>(mm);
    v[i] = from_f32<M>(vv);
  }
}

// a block a chunk; the chunk's tensor's types pick the body (one branch a
// block, so no divergence): the gradient is the parameter's type, or f32
__global__ void __launch_bounds__(THREADS)
adamw_update_kernel(const Entry* __restrict__ table, int n,
                    const float* __restrict__ stats,
                    const float* __restrict__ hyper, Consts k) {
  __shared__ int entry;
  if (threadIdx.x == 0) entry = find(table, n, blockIdx.x);
  __syncthreads();
  const Entry& e = table[entry];
  const Hyper h{stats[1], hyper[0], hyper[1], hyper[2]};
  const long long start = ((long long)blockIdx.x - e.chunk0) * CHUNK;
  const long long rem = e.numel - start;
  const int count = (int)(rem < CHUNK ? rem : CHUNK);
  using bf16 = __nv_bfloat16;
  switch (e.flags & (P_BF16 | M_BF16 | G_F32)) {
    case 0:
      update_chunk<float, float, float>(e, start, count, h, k);
      break;
    case M_BF16:
      update_chunk<float, float, bf16>(e, start, count, h, k);
      break;
    case P_BF16:
      update_chunk<bf16, bf16, float>(e, start, count, h, k);
      break;
    case P_BF16 | M_BF16:
      update_chunk<bf16, bf16, bf16>(e, start, count, h, k);
      break;
    case P_BF16 | G_F32:
      update_chunk<bf16, float, float>(e, start, count, h, k);
      break;
    default:                           // P_BF16 | M_BF16 | G_F32
      update_chunk<bf16, float, bf16>(e, start, count, h, k);
  }
}

}  // namespace

// the table's rows from the wrapper's int64 array, written by fill
// launches; returns the chunks' count (0 with an error in *err)
static long long fill_table(const long long* entries, int n, Entry* table,
                     cudaStream_t s, cudaError_t* err) {
  long long chunks = 0;
  Fill f;
  *err = cudaSuccess;
  for (int i0 = 0; i0 < n; i0 += FILL) {
    const int cnt = n - i0 < FILL ? n - i0 : FILL;
    for (int j = 0; j < cnt; ++j) {
      const long long* r = entries + 6 * (i0 + j);
      f.e[j] = Entry{reinterpret_cast<const void*>(r[0]),
                     reinterpret_cast<void*>(r[1]),
                     reinterpret_cast<void*>(r[2]),
                     reinterpret_cast<void*>(r[3]), r[4], (int)chunks,
                     (int)r[5]};
      chunks += (r[4] + CHUNK - 1) / CHUNK;
      if (chunks > 0x7fffffffLL) {
        *err = cudaErrorInvalidValue;
        return 0;
      }
    }
    adamw_fill_kernel<<<1, FILL, 0, s>>>(f, table, i0, cnt);
    *err = cudaGetLastError();
    if (*err != cudaSuccess) return 0;
  }
  return chunks;
}

static long long count_chunks(const long long* entries, int n) {
  long long chunks = 0;
  for (int i = 0; i < n; ++i) chunks += (entries[6 * i + 4] + CHUNK - 1) / CHUNK;
  return chunks;
}

static size_t table_bytes(int n) { return ((size_t)n * sizeof(Entry) + 15) & ~15; }

extern "C" {

// the workspace bytes of a tree of n tensors: the table, then the partials
int adamw_workspace_bytes(int n) {
  return (int)(table_bytes(n) + NORM_BLOCKS * sizeof(double));
}

// The step in two calls, so that the norm's partials can be summed over
// ranks between them (the wrapper: a tree split over a mesh).  On one rank
// the two calls launch what one did: the fills, the norm, the finalize,
// the update.
//
// adamw_norm: entries: n rows of (g, p, m, v, numel, flags) as the
// wrapper's int64 array (flags: DECAY | P_BF16 | M_BF16 | G_F32 |
// NO_NORM); workspace: the table (n Entry), then NORM_BLOCKS doubles, the
// partials of the sum of squares written here (zeros for n == 0: a rank
// that updates nothing still takes part in the sum).
int adamw_norm(const long long* entries, int n, void* workspace,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0) return cudaErrorInvalidValue;
  Entry* table = static_cast<Entry*>(workspace);
  double* partials = reinterpret_cast<double*>(
      static_cast<char*>(workspace) + table_bytes(n));
  if (n == 0)
    return cudaMemsetAsync(partials, 0, NORM_BLOCKS * sizeof(double), s);
  cudaError_t err;
  const long long chunks = fill_table(entries, n, table, s, &err);
  if (err != cudaSuccess) return err;
  if (chunks == 0) return cudaErrorInvalidValue;
  adamw_norm_kernel<<<NORM_BLOCKS, THREADS, 0, s>>>(table, n, chunks,
                                                    partials);
  return cudaGetLastError();
}

// adamw_finish: the same entries and workspace after adamw_norm (the
// partials possibly summed over ranks since); stats: gnorm, scale (out);
// hyper: lr, bc1, bc2.  The finalize, then the update (none for n == 0).
int adamw_finish(const long long* entries, int n, void* workspace,
                 void* stats, const void* hyper, float b1, float omb1,
                 float b2, float omb2, float eps, float wd, float clip,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0) return cudaErrorInvalidValue;
  Entry* table = static_cast<Entry*>(workspace);
  double* partials = reinterpret_cast<double*>(
      static_cast<char*>(workspace) + table_bytes(n));
  adamw_finalize_kernel<<<1, NORM_BLOCKS, 0, s>>>(
      partials, static_cast<float*>(stats), clip);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return err;
  const long long chunks = count_chunks(entries, n);
  adamw_update_kernel<<<(unsigned)chunks, THREADS, 0, s>>>(
      table, n, static_cast<const float*>(stats),
      static_cast<const float*>(hyper), Consts{b1, omb1, b2, omb2, eps, wd});
  return cudaGetLastError();
}

}  // extern "C"
