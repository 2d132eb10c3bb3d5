// Listing-1 convolution for Hopper (sm_90a): one CM core's conv, each output
// pixel an MxV of its input window against the resident crossbar.
//
// Replaces the Pallas kernel of the JAX package's kernels/conv2d.py:
//   crossbar_conv2d <- _conv_row_kernel
//     y[f, i, j] = scale[f] * sum_k patch(i, j)[k] * wq[f, k]
//     k over (c, fh, fw) in that order; the patch is taken from the
//     zero-padded input at (i * stride, j * stride);
//     OH = (H + 2 pad - FH) / stride + 1, OW likewise (floor division).
//
// What bounds it on this card: the CM zoo's convs are small (the main path's
// is 28 channels of 16 x 16 and 28 filters: 64.5 KB in and out, 3.6 MFLOP),
// so by bytes or by f32 operations the work could be over in well under a
// microsecond.  This first kernel is bound by its own latency instead: at
// the main path's shape it runs 32 blocks, and each thread walks two
// 252-term FMA chains, reading its weights byte by byte through L1 (about
// 29 us of device time on an H100, PERF.md).  The design keeps one launch
// per call with no scratch and no host-side padded copy, and stays simple:
// an implicit GEMM on the CUDA cores, no tensor cores, weights not staged.
//
// Layout: grid (OH, ceil(OW / TJ), ceil(FL / TF)); a block owns one output
// row, up to TJ of its columns and up to TF filters.  Per chunk of CC
// channels it stages the FH input rows that output row needs, over the
// columns its output columns read, in shared memory as f32; the zero padding
// is done by masked loads (rows and columns outside the image read 0).  CC
// is chosen on the host so a chunk fits SMEM_BYTES, so any C fits.  Each
// thread owns up to PAIRS (filter, column) outputs; it walks its filter's
// crossbar row in ascending k, dequantizing int8 (or reading f32) in
// registers, with one f32 FMA per term, and multiplies by the filter's scale
// once at the end, as _conv_row_kernel does.  The result is written straight
// into (FL, OH, OW).  The Pallas kernel's whole image in VMEM, its per-row
// grid and its (OH, OW, FL) layout plus transpose are TPU choices and are
// not carried over.
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape whose one channel does not fit the shared-memory budget (the wrapper
// checks that first).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TF = 16;                   // filters per block
constexpr int TJ = 32;                   // output columns per block
constexpr int THREADS = 128;
constexpr int PAIRS = TF * TJ / THREADS; // (filter, column) outputs a thread
constexpr int SMEM_BYTES = 48 * 1024;    // the default dynamic limit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename W>
__global__ void __launch_bounds__(THREADS)
crossbar_conv2d_kernel(const float* __restrict__ x, const W* __restrict__ wq,
                       const float* __restrict__ scale, float* __restrict__ y,
                       int C, int H, int Wd, int FL, int FH, int FW,
                       int stride, int pad, int OH, int OW, int CC) {
  extern __shared__ float slab[];        // [CC][FH][WS]
  const int i = blockIdx.x;
  const int j0 = blockIdx.y * TJ;
  const int f0 = blockIdx.z * TF;
  const int nj = min(TJ, OW - j0);
  const int nf = min(TF, FL - f0);
  const int WS = (nj - 1) * stride + FW; // staged input columns
  const int row0 = i * stride - pad;     // input row under fh = 0
  const int col0 = j0 * stride - pad;    // input column under staged col 0
  const int taps = FH * FW;
  const int K = C * taps;
  const int npairs = nf * nj;

  float acc[PAIRS];
  const W* wrow[PAIRS];
  int xoff[PAIRS];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = threadIdx.x + q * THREADS;
    const int fl = p < npairs ? p / nj : 0;
    const int j = p < npairs ? p % nj : 0;
    acc[q] = 0.f;
    wrow[q] = wq + static_cast<size_t>(f0 + fl) * K;
    xoff[q] = j * stride;
  }

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);
    const int n = nc * FH * WS;
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const int cc = e / (FH * WS);
      const int r = e - cc * (FH * WS);
      const int fh = r / WS;
      const int col = r - fh * WS;
      const int hi = row0 + fh, wi = col0 + col;
      slab[e] = (hi >= 0 && hi < H && wi >= 0 && wi < Wd)
                    ? x[(static_cast<size_t>(c0 + cc) * H + hi) * Wd + wi]
                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      if (threadIdx.x + q * THREADS < npairs) {
        const W* w = wrow[q] + static_cast<size_t>(c0) * taps;
        float a = acc[q];
        for (int cc = 0; cc < nc; ++cc) {
          for (int fh = 0; fh < FH; ++fh) {
            const float* s = slab + (cc * FH + fh) * WS + xoff[q];
            for (int fw = 0; fw < FW; ++fw) a = fmaf(s[fw], to_f32(*w++), a);
          }
        }
        acc[q] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = threadIdx.x + q * THREADS;
    if (p < npairs) {
      const int f = f0 + p / nj, j = j0 + p % nj;
      y[(static_cast<size_t>(f) * OH + i) * OW + j] = acc[q] * scale[f];
    }
  }
}

template <typename W>
int launch(const void* x, const void* wq, const void* scale, void* y, int C,
           int H, int Wd, int FL, int FH, int FW, int stride, int pad, int OH,
           int OW, void* stream) {
  const long long ws = static_cast<long long>((OW < TJ ? OW : TJ) - 1) *
                           stride + FW;
  const long long per_channel = 4LL * FH * ws;
  if (per_channel > SMEM_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  const long long fit = SMEM_BYTES / per_channel;
  const int cc = static_cast<int>(C < fit ? C : fit);
  const dim3 grid(OH, (OW + TJ - 1) / TJ, (FL + TF - 1) / TF);
  crossbar_conv2d_kernel<W><<<grid, THREADS,
                              static_cast<size_t>(cc * per_channel),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const W*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(y), C, H, Wd, FL,
      FH, FW, stride, pad, OH, OW, cc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crossbar_conv2d_i8(const void* x, const void* wq, const void* scale,
                       void* y, int C, int H, int W, int FL, int FH, int FW,
                       int stride, int pad, int OH, int OW, void* stream) {
  return launch<int8_t>(x, wq, scale, y, C, H, W, FL, FH, FW, stride, pad, OH,
                        OW, stream);
}

int crossbar_conv2d_f32(const void* x, const void* wq, const void* scale,
                        void* y, int C, int H, int W, int FL, int FH, int FW,
                        int stride, int pad, int OH, int OW, void* stream) {
  return launch<float>(x, wq, scale, y, C, H, W, FL, FH, FW, stride, pad, OH,
                       OW, stream);
}

}  // extern "C"
