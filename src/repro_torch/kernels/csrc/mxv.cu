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
// the work is over in about a microsecond, and the launch itself (several
// microseconds) is what a call costs.  The design therefore keeps every call
// to exactly one launch with no scratch, no second pass and no atomics, and
// stays simple: no tensor cores, TMA or split-N yet.
//
// Layout: grid (ceil(M/TM), ceil(B/TB)); a block of TM x TB threads owns a
// TM-row slice of the crossbar and TB batch rows.  The block stages its x
// rows in shared memory, KT columns at a time (converted to f32, or kept as
// int8 bytes for the int8 kernel), and every thread computes one output:
// it walks its weight row in ascending k, four bytes per load where the row
// is 4-byte aligned, with scalar head and tail elements around the aligned
// words.  The float kernel dequantizes in registers and accumulates in f32
// in a fixed k order, so results are deterministic run to run; the scale is
// applied once at the end, as _mxv_kernel does.  The int8 kernel
// accumulates exactly in int32 with __dp4a.  Edges in B, M and N are masked;
// B == 0 or M == 0 is the caller's to skip (a zero-sized grid is a launch
// error).
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;   // crossbar rows per block: one warp along M
constexpr int TB = 8;    // batch rows per block
constexpr int KT = 256;  // columns of x staged per pass (a full crossbar row)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Number of leading bytes before p reaches a 4-byte boundary, at most n.
__device__ __forceinline__ int head_bytes(const int8_t* p, int n) {
  int h = (4 - static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3)) & 3;
  return h < n ? h : n;
}

template <typename T>
__global__ void __launch_bounds__(TM * TB)
crossbar_mxv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ scale, T* __restrict__ y,
                    int B, int N, int M) {
  __shared__ float xs[TB][KT];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TM + tx;
  const int m = blockIdx.x * TM + tx;
  const int b0 = blockIdx.y * TB;
  const int b = b0 + ty;
  // threads past the last row read row M-1 (in bounds) and store nothing
  const int8_t* wrow = wq + static_cast<size_t>(m < M ? m : M - 1) * N;
  float acc = 0.f;
  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kn = N - k0 < KT ? N - k0 : KT;
    for (int i = tid; i < TB * KT; i += TM * TB) {
      const int r = i / KT, c = i % KT;
      const int bb = b0 + r;
      xs[r][c] = (bb < B && c < kn)
                     ? to_f32(x[static_cast<size_t>(bb) * N + k0 + c])
                     : 0.f;
    }
    __syncthreads();
    const int8_t* p = wrow + k0;
    const float* xr = xs[ty];
    const int h = head_bytes(p, kn);
    int k = 0;
    for (; k < h; ++k) acc = fmaf(xr[k], static_cast<float>(p[k]), acc);
    for (; k + 4 <= kn; k += 4) {
      const char4 w = *reinterpret_cast<const char4*>(p + k);
      acc = fmaf(xr[k], static_cast<float>(w.x), acc);
      acc = fmaf(xr[k + 1], static_cast<float>(w.y), acc);
      acc = fmaf(xr[k + 2], static_cast<float>(w.z), acc);
      acc = fmaf(xr[k + 3], static_cast<float>(w.w), acc);
    }
    for (; k < kn; ++k) acc = fmaf(xr[k], static_cast<float>(p[k]), acc);
    __syncthreads();
  }
  if (m < M && b < B) store(y + static_cast<size_t>(b) * M + m, acc * scale[m]);
}

__global__ void __launch_bounds__(TM * TB)
crossbar_mxv_int8_kernel(const int8_t* __restrict__ xq,
                         const float* __restrict__ xscale,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ wscale,
                         float* __restrict__ y, int B, int N, int M) {
  // one spare word per row: an unaligned 4-byte read of x near the end of
  // the tile spans two words
  __shared__ int32_t xw[TB][KT / 4 + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TM + tx;
  const int m = blockIdx.x * TM + tx;
  const int b0 = blockIdx.y * TB;
  const int b = b0 + ty;
  const int8_t* wrow = wq + static_cast<size_t>(m < M ? m : M - 1) * N;
  int32_t acc = 0;
  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kn = N - k0 < KT ? N - k0 : KT;
    int8_t* xbytes = reinterpret_cast<int8_t*>(&xw[0][0]);
    for (int i = tid; i < TB * (KT + 4); i += TM * TB) {
      const int r = i / (KT + 4), c = i % (KT + 4);
      const int bb = b0 + r;
      xbytes[r * (KT + 4) + c] =
          (bb < B && c < kn) ? xq[static_cast<size_t>(bb) * N + k0 + c] : 0;
    }
    __syncthreads();
    const int8_t* p = wrow + k0;
    const int8_t* xr = xbytes + ty * (KT + 4);
    const int32_t* xwr = xw[ty];
    const int h = head_bytes(p, kn);
    int k = 0;
    for (; k < h; ++k) acc += static_cast<int32_t>(xr[k]) * p[k];
    for (; k + 4 <= kn; k += 4) {
      const int32_t w = *reinterpret_cast<const int32_t*>(p + k);
      // x bytes k..k+3 from the two words that hold them (k may be
      // unaligned: the weight row, not x, fixes the alignment)
      const int j = k >> 2, sh = (k & 3) * 8;
      const int32_t xv = static_cast<int32_t>(__funnelshift_r(
          static_cast<uint32_t>(xwr[j]), static_cast<uint32_t>(xwr[j + 1]),
          sh));
      acc = __dp4a(w, xv, acc);
    }
    for (; k < kn; ++k) acc += static_cast<int32_t>(xr[k]) * p[k];
    __syncthreads();
  }
  if (m < M && b < B)
    y[static_cast<size_t>(b) * M + m] =
        (static_cast<float>(acc) * xscale[b]) * wscale[m];
}

inline dim3 grid_for(int B, int M) {
  return dim3((M + TM - 1) / TM, (B + TB - 1) / TB);
}

}  // namespace

extern "C" {

int crossbar_mxv_f32(const void* x, const void* wq, const void* scale,
                     void* y, int B, int N, int M, void* stream) {
  crossbar_mxv_kernel<float><<<grid_for(B, M), dim3(TM, TB), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(y), B, N, M);
  return static_cast<int>(cudaGetLastError());
}

int crossbar_mxv_bf16(const void* x, const void* wq, const void* scale,
                      void* y, int B, int N, int M, void* stream) {
  crossbar_mxv_kernel<__nv_bfloat16><<<grid_for(B, M), dim3(TM, TB), 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), B, N,
      M);
  return static_cast<int>(cudaGetLastError());
}

int crossbar_mxv_int8(const void* xq, const void* xs, const void* wq,
                      const void* ws, void* y, int B, int N, int M,
                      void* stream) {
  crossbar_mxv_int8_kernel<<<grid_for(B, M), dim3(TM, TB), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<float*>(y), B, N, M);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_torch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
