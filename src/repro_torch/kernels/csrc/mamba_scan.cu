// Selective scan (Mamba-1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package:
//   selective_scan <- kernels/mamba_scan.py _scan_kernel
// For each sequence b and channel d, with a diagonal A and a state of N <= 16:
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t      (N values)
//   y_t = sum_N(h_t * C_t) + D[d] * u_t
// u/dt (B, L, Din) and B/C (B, L, N) in f32 or bf16, A (Din, N) and D (Din,)
// in f32.  Outputs y (B, L, Din) in f32, with the skip term added in f32 (the
// model adds D * u in f32 before it rounds), and the final state hT
// (B, Din, N) in f32, which prefill hands to decode.
//
// What bounds it on this card.  Bytes: u and dt are read once and y written
// once, 2 + 2 + 4 bytes per (b, t, d) in bf16; at the falcon-mamba-7b
// prefill shape (B, L, Din, N) = (8, 512, 8192, 16) that is 272 MB, 81 us at
// 3.35 TB/s, above the 2.7 GFLOP of f32 multiplies and FMAs (40 us at
// 67 TFLOP/s).  The N exponentials per (b, t, d) run on the special-function
// units, 16 per clock per SM: an estimated 0.13 ms at that shape, which is
// what a simple kernel meets first.
//
// What the design does about it.  The Pallas kernel walks time on the TPU's
// sequential grid and carries the (bd, N) state in VMEM across time chunks;
// blocks on Hopper run in no order, so here the whole time loop runs inside
// one thread: one thread per (b, channel) keeps its N state values in
// registers for all L steps, and nothing is carried between blocks.
// Neighbouring threads take neighbouring channels, so each step's u, dt and
// y accesses of a warp are coalesced; each thread loads the u and dt of a
// chunk of CHUNK steps into registers before it computes them, so many loads
// are in flight.  B_t and C_t are the same for every channel of a sequence:
// the block stages a chunk of them in shared memory (read through any
// strides: the model passes column slices of one projection) and every
// thread reads them as broadcasts.  Blocks of 64 channels, so that a
// single-sequence prefill (the batcher's) at Din = 8192 still gives 128
// blocks for the 132 SMs.  Not yet done: a parallel scan across time (more
// blocks at B = 1, shorter chains), and wider loads.
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int THREADS = 64;  // channels per block
constexpr int CHUNK = 32;    // time steps staged per round

struct ScanStrides {
  long long ub, ul;        // u (B, L, Din), last stride 1
  long long db, dl;        // dt (B, L, Din), last stride 1
  long long bb, bl, bn;    // B (B, L, N)
  long long cb, cl, cn;    // C (B, L, N)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ a, const T* __restrict__ bmat,
            const T* __restrict__ cmat, const float* __restrict__ dskip,
            float* __restrict__ y, float* __restrict__ hT, int L, int D,
            int N, ScanStrides st) {
  __shared__ float sb[CHUNK][NMAX];
  __shared__ float sc[CHUNK][NMAX];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  const bool active = ch < D;

  float av[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    av[n] = (active && n < N) ? a[static_cast<long long>(ch) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dsk = active ? dskip[ch] : 0.f;
  const T* ub = u + b * st.ub + ch;
  const T* dtb = dt + b * st.db + ch;
  const T* bb = bmat + b * st.bb;
  const T* cb = cmat + b * st.cb;
  float* yb = y + static_cast<long long>(b) * L * D + ch;

  for (int t0 = 0; t0 < L; t0 += CHUNK) {
    const int tn = min(CHUNK, L - t0);
    __syncthreads();                 // the last chunk's B/C reads are done
    for (int i = threadIdx.x; i < tn * N; i += THREADS) {
      const int t = i / N, n = i % N;
      sb[t][n] = to_f32(bb[(t0 + t) * st.bl + n * st.bn]);
      sc[t][n] = to_f32(cb[(t0 + t) * st.cl + n * st.cn]);
    }
    float uv[CHUNK], dv[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const bool ok = active && t < tn;
      uv[t] = ok ? to_f32(ub[(t0 + t) * st.ul]) : 0.f;
      dv[t] = ok ? to_f32(dtb[(t0 + t) * st.dl]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      if (t >= tn) break;            // the same for every thread of the block
      const float dtu = dv[t] * uv[t];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          h[n] = fmaf(h[n], expf(dv[t] * av[n]), dtu * sb[t][n]);
          acc = fmaf(h[n], sc[t][n], acc);
        }
      }
      if (active)
        yb[static_cast<long long>(t0 + t) * D] = fmaf(dsk, uv[t], acc);
    }
  }
  if (active) {
    float* hb = hT + (static_cast<long long>(b) * D + ch) * N;
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hb[n] = h[n];
  }
}

template <typename T, int NMAX>
int launch(const void* u, const void* dt, const void* a, const void* bm,
           const void* cm, const void* dskip, void* y, void* hT, int B, int L,
           int D, int N, const ScanStrides& st, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  scan_kernel<T, NMAX><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(dskip),
      static_cast<float*>(y), static_cast<float*>(hT), L, D, N, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* u, const void* dt, const void* a, const void* bm,
             const void* cm, const void* dskip, void* y, void* hT, int B,
             int L, int D, int N, const long long* s, void* stream) {
  const ScanStrides st{s[0], s[1], s[2], s[3], s[4],
                       s[5], s[6], s[7], s[8], s[9]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (N < 1 || B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 4) return launch<T, 4>(u, dt, a, bm, cm, dskip, y, hT, B, L, D, N, st, cs);
  if (N <= 8) return launch<T, 8>(u, dt, a, bm, cm, dskip, y, hT, B, L, D, N, st, cs);
  if (N <= 16) return launch<T, 16>(u, dt, a, bm, cm, dskip, y, hT, B, L, D, N, st, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// strides: 10 element strides: u (b, l), dt (b, l), B (b, l, n), C (b, l, n)
int selective_scan_f32(const void* u, const void* dt, const void* a,
                       const void* bm, const void* cm, const void* dskip,
                       void* y, void* hT, int B, int L, int D, int N,
                       const long long* strides, void* stream) {
  return dispatch<float>(u, dt, a, bm, cm, dskip, y, hT, B, L, D, N, strides,
                         stream);
}

int selective_scan_bf16(const void* u, const void* dt, const void* a,
                        const void* bm, const void* cm, const void* dskip,
                        void* y, void* hT, int B, int L, int D, int N,
                        const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(u, dt, a, bm, cm, dskip, y, hT, B, L, D, N,
                                 strides, stream);
}

}  // extern "C"
