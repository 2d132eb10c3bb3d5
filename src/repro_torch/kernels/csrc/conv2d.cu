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
// microsecond: the kernel is bound by its own latency, from the launch and
// the staging of its operands to the last store: the chains of dependent
// loads and FMAs a thread walks, and how many of them the card runs at
// once.  What the design does about it:
//   - no global load in the FMA loop: per chunk of channels the block
//     stages its filters' slice of wq in shared memory as f32, dequantized
//     once, next to the input rows it reads, in one pass with BATCH loads a
//     thread in flight and its index arithmetic in multiply-highs, not
//     integer divisions;
//   - independent chains: each thread owns TF = 4 filters of one output
//     column, 4 accumulators fed by one input value and one 16-byte weight
//     load a term, and the block splits K over its threads by channel
//     (KS = 256 / TJ parts, channel c to part c mod KS), the parts added in
//     shared memory at the end in ascending part order;
//   - a grid that covers the card: the host's plan (conv2d.py:conv_plan)
//     halves the column tile TJ, doubling the K split, while the grid has
//     fewer blocks than the card's 132 SMs and the split stays below twice
//     the channels.  At the main path's shape: TJ = 8, KS = 32, a grid of
//     (16, 2, 7) = 224 blocks of 8 warps, at least 132 blocks.
// On an H100 at that shape: 4.1-4.3 us of device time, against 5.2 us for
// cuDNN's F.conv2d in the same run (PERF.md).
// f32 on the CUDA cores: a TF32 tensor-core product would break the 1e-4
// bound against the plain version and Listing 1, and at 3.6 MFLOP the
// arithmetic is not what bounds the kernel.  The scale is applied once per
// output, at the end, as _conv_row_kernel does.
//
// Layout: grid (OH, ceil(OW / TJ), ceil(FL / TF)); a block owns one output
// row i, up to TJ of its columns and up to TF filters; thread t computes
// column t % TJ over K part t / TJ.  Per chunk of CC channels (CC from the
// host's plan, so a chunk fits SMEM_BYTES with the reduction buffer; any C
// takes as many chunks as it needs) it stages:
//   wts  [CC][FH * FW][TF]  the block's filters' weights as f32, a term's
//                      TF weights in one float4;
//   slab [CC][FH][WS]  after them, the FH input rows output row i reads,
//                      over the WS = (TJ - 1) * stride + FW columns its
//                      output columns read, zero outside the image (masked
//                      loads: no padded copy of x).
// The result is written straight into (FL, OH, OW).  The Pallas kernel's
// whole image in VMEM, its per-row grid and its (OH, OW, FL) layout plus
// transpose are TPU choices and are not carried over.
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// plan the kernel does not take (the wrapper's plan never gives one).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TF = 4;                    // filters per block and per thread
constexpr int SMEM_BYTES = 48 * 1024;    // the default dynamic limit
constexpr int BATCH = 4;                 // staging loads in flight a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// q = n / d for 0 <= n, d < 2^16 (n d < 2^32 makes the rounding exact):
// one multiply-high where an integer division takes a dozen instructions
__device__ __forceinline__ unsigned div_magic(int d) {
  return d == 1 ? 0u : 0xffffffffu / static_cast<unsigned>(d) + 1u;
}
__device__ __forceinline__ int fast_div(int n, int d, unsigned magic) {
  return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n),
                                                 magic));
}

// dst[e] = load(e) for e < n, over the block's threads, with BATCH loads a
// thread in flight before the first store
template <typename Load>
__device__ __forceinline__ void stage(float* dst, int n, Load load) {
  for (int e0 = threadIdx.x; e0 < n; e0 += THREADS * BATCH) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * THREADS;
      v[u] = e < n ? load(e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (e0 + u * THREADS < n) dst[e0 + u * THREADS] = v[u];
  }
}

template <typename W>
__global__ void __launch_bounds__(THREADS)
crossbar_conv2d_kernel(const float* __restrict__ x, const W* __restrict__ wq,
                       const float* __restrict__ scale, float* __restrict__ y,
                       int C, int H, int Wd, int FL, int FH, int FW,
                       int stride, int pad, int OH, int OW, int TJ, int CC) {
  extern __shared__ float4 smem4[];
  const int taps = FH * FW;
  const int WS = (TJ - 1) * stride + FW;  // staged input columns
  float* red = reinterpret_cast<float*>(smem4);  // [KS][TF][TJ]
  float* wts = red + THREADS * TF;  // [nc][taps][TF], then slab [nc][FH][WS]
  const int KS = THREADS / TJ;
  const int i = blockIdx.x;
  const int j0 = blockIdx.y * TJ;
  const int f0 = blockIdx.z * TF;
  const int jj = threadIdx.x % TJ;
  const int part = threadIdx.x / TJ;
  const int row0 = i * stride - pad;      // input row under fh = 0
  const int col0 = j0 * stride - pad;     // input column under staged col 0
  const int K = C * taps;  // the wrapper holds every index to int32
  const unsigned ws_magic = div_magic(WS), fh_magic = div_magic(FH);

  float acc[TF];
#pragma unroll
  for (int r = 0; r < TF; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);
    // one pass stages the chunk's weights (element e of wts is term e / TF
    // of filter f0 + e % TF) and its input rows (the slab after them)
    const int n_w = TF * nc * taps;
    const W* wc = wq + c0 * taps;
    const float* xc = x + c0 * H * Wd;
    stage(wts, n_w + nc * FH * WS, [&](int e) {
      if (e < n_w) {
        const int r = e % TF;
        return f0 + r < FL ? to_f32(wc[(f0 + r) * K + e / TF]) : 0.f;
      }
      e -= n_w;
      const int row = fast_div(e, WS, ws_magic);
      const int cc = fast_div(row, FH, fh_magic);
      const int hi = row0 + row - cc * FH;
      const int wi = col0 + e - row * WS;
      return hi >= 0 && hi < H && wi >= 0 && wi < Wd
                 ? xc[(cc * H + hi) * Wd + wi]
                 : 0.f;
    });
    __syncthreads();
    const float* slab = wts + n_w;
    for (int cc = part; cc < nc; cc += KS) {
      const float* s = slab + cc * FH * WS + jj * stride;
      const float4* w = reinterpret_cast<const float4*>(wts) + cc * taps;
      for (int fh = 0; fh < FH; ++fh) {
        for (int fw = 0; fw < FW; ++fw) {
          const float xv = s[fh * WS + fw];
          const float4 wv = w[fh * FW + fw];
          acc[0] = fmaf(xv, wv.x, acc[0]);
          acc[1] = fmaf(xv, wv.y, acc[1]);
          acc[2] = fmaf(xv, wv.z, acc[2]);
          acc[3] = fmaf(xv, wv.w, acc[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TF; ++r) red[(part * TF + r) * TJ + jj] = acc[r];
  __syncthreads();
  if (threadIdx.x < TF * TJ) {
    const int r = threadIdx.x / TJ, j = threadIdx.x % TJ;
    float a = 0.f;
    for (int p = 0; p < KS; ++p) a += red[(p * TF + r) * TJ + j];
    const int f = f0 + r, jo = j0 + j;
    if (f < FL && jo < OW)
      y[(static_cast<size_t>(f) * OH + i) * OW + jo] = a * scale[f];
  }
}

template <typename W>
int launch(const void* x, const void* wq, const void* scale, void* y, int C,
           int H, int Wd, int FL, int FH, int FW, int stride, int pad, int OH,
           int OW, int TJ, int CC, void* stream) {
  const long long ws = static_cast<long long>(TJ - 1) * stride + FW;
  const long long smem =
      4LL * (THREADS * TF + static_cast<long long>(CC) * FH * (ws + FW * TF));
  if (TJ < 1 || TJ > 32 || THREADS % TJ != 0 || CC < 1 ||
      smem > SMEM_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(OH, (OW + TJ - 1) / TJ, (FL + TF - 1) / TF);
  crossbar_conv2d_kernel<W><<<grid, THREADS, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const W*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(y), C, H, Wd, FL,
      FH, FW, stride, pad, OH, OW, TJ, CC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// TJ (output columns a block owns) and CC (channels a chunk stages) come
// from the wrapper's plan, conv2d.py:conv_plan
int crossbar_conv2d_i8(const void* x, const void* wq, const void* scale,
                       void* y, int C, int H, int W, int FL, int FH, int FW,
                       int stride, int pad, int OH, int OW, int TJ, int CC,
                       void* stream) {
  return launch<int8_t>(x, wq, scale, y, C, H, W, FL, FH, FW, stride, pad, OH,
                        OW, TJ, CC, stream);
}

int crossbar_conv2d_f32(const void* x, const void* wq, const void* scale,
                        void* y, int C, int H, int W, int FL, int FH, int FW,
                        int stride, int pad, int OH, int OW, int TJ, int CC,
                        void* stream) {
  return launch<float>(x, wq, scale, y, C, H, W, FL, FH, FW, stride, pad, OH,
                       OW, TJ, CC, stream);
}

}  // extern "C"
