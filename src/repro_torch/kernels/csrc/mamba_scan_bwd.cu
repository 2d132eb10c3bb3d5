// Selective scan (Mamba-1) backward for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its plain
// chunked scan (models/layers.py _ssm_scan_chunked, under
// jax.value_and_grad), and the port's forward is a kernel (mamba_scan.cu),
// so training through it needs this backward.  With a_t = exp(dt_t A), the
// states h_t of the forward (h_{-1} = 0) and dy (B, L, Din), the gradient
// of the forward's f32 y:
//   g_t   = dy_t C_t + a_{t+1} g_{t+1},   g_L = 0      (per b, d, n; reverse)
//   du_t  = dt_t sum_n g_t B_t + D dy_t
//   ddt_t = sum_n g_t (u_t B_t + A a_t h_{t-1})
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1}               (Din, N)
//   dB_t  = sum_d g_t dt_t u_t,   dC_t = sum_d dy_t h_t   (B, L, N)
//   dD    = sum_{b,t} dy_t u_t                           (Din,)
// u/dt (B, L, Din) and B/C (B, L, N) in f32 or bf16 (B and C read through
// any strides, as the forward reads them), A (Din, N), D (Din,) and dy in
// f32.  du, ddt, dB, dC are stored in the inputs' type, dA and dD in f32,
// each summed in f32 and rounded once at its store.
//
// What bounds it on this card.  Bytes: u, dt and dy read and du and ddt
// written, 12 bytes a (b, t, d) in bf16: 403 MB at falcon-mamba-7b's
// training shape (B, L, Din, N) = (8, 512, 8192, 16), 120 us at 3.35 TB/s.
// The exponentials: a_t for each (b, t, d, n), 537 M at that shape, 128 us
// on the special-function units (16 per clock per SM) each time they are
// taken; this design takes them three times (the forward walk that stores
// the chunks' starting states, the chunk's recomputed states, the reverse
// walk), 0.38 ms.
//
// The design, simple first.  The reverse walk needs h_{t-1}, which the
// forward kernel does not keep (all states are 2.1 GB a layer at the
// training shape), and the forward kernel stays as serving launches it.
// So three kernels, each a block of 128 threads over 32 channels of one
// sequence, a channel's 16-column state group over 4 lanes of 4 columns
// (N < 16: the missing columns read as 0 and stay 0; N > 16: groups one
// after another, as in the forward):
//   1. scan_bwd_bounds_kernel walks forward and stores the state at the
//      start of each chunk of TC = 16 steps after the first, (B, ceil(L /
//      TC) - 1, Din, N) f32 (134 MB at the training shape);
//   2. scan_bwd_kernel walks the chunks in reverse.  For each chunk it
//      stores u, dt, dy, B and C in shared memory in f32 (loaded into
//      registers, with the chunk's starting state, while the chunk after
//      it computed: the loads' latency hides behind that compute; the
//      bounds walk does the same), recomputes the chunk's states from
//      the stored start into shared memory, then walks the chunk back
//      carrying g and a_{t+1} in registers (across chunks too):
//      a lane's shares of du and ddt are summed over the channel's 4 lanes
//      by shuffles in a fixed order, dA is summed in registers over the
//      sequence, and dB's terms g dt u go to shared memory, where the block
//      sums them, and dC from dy and the states, over its 32 channels in
//      order.  Its partial sums go to a workspace: dB and dC per block
//      (B, Din / 32, L, N), dA and dD per sequence.  N > 16 sums du and ddt
//      over the groups in f32 in a workspace, in group order, and rounds at
//      the last group;
//   3. scan_bwd_reduce_kernel adds the partial sums in a fixed order: dB
//      and dC over the blocks, dA and dD over the sequences.
// No atomics: two launches are bit-equal.  Shared memory of kernel 2:
// 76 KB (the chunk's states and dB's terms, 32 KB each), two blocks an
// SM.  Registers: no spills (ptxas, printed and held by chip_smoke.py
// phase 1).
//
// Plain-C entry point (loaded with ctypes): launches the three kernels on
// the given stream and returns the first cudaError_t.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;       // threads a block
constexpr int G = 4;               // lanes a channel
constexpr int S = 4;               // state columns a lane
constexpr int GW = G * S;          // state columns a group
constexpr int CH = THREADS / G;    // channels a block
constexpr int TC = 16;             // steps a chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* u;
  const void* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* dskip;
  const float* dy;         // (B, L, Din) f32, contiguous
  void* du;                // (B, L, Din), u's type, contiguous
  void* ddt;
  float* da;               // (Din, N)
  void* db;                // (B, L, N), u's type, contiguous
  void* dc;
  float* dd;               // (Din,)
  float* bounds;           // (B, chunks - 1, Din, N): chunk k + 1's start
  float* acc;              // (2, B, L, Din): du, ddt over the groups so far
  float* pbc;              // (2, B, blocks, L, N): dB, dC per block
  float* pa;               // (B, Din, N)
  float* pd;               // (B, Din)
  int B, L, D, N;
  int groups, chunks, blocks;
  long long ub, ul;        // u (B, L, Din), last stride 1
  long long dtb, dtl;      // dt (B, L, Din), last stride 1
  long long bb, bl, bn;    // B (B, L, N)
  long long cb, cl, cn;    // C (B, L, N)
};

// Kernel 2's shared memory: a chunk of operands in f32, its states, dB's
// terms, and the channels' du and ddt
struct Tiles {
  alignas(16) float2 dtu[TC * CH];      // {dt, u}
  alignas(16) float dy[TC * CH];
  alignas(16) float b[TC * GW];         // B, this group's columns
  alignas(16) float c[TC * GW];         // C
  alignas(16) float hist[TC * CH * GW]; // h_t, [t][channel][column]
  alignas(16) float red[TC * CH * GW];  // g_t dt_t u_t, the same layout
  alignas(16) float du[TC * CH];
  alignas(16) float ddt[TC * CH];
};

// 2^x as one MUFU.EX2 (x <= 0 here; a result below 2^-126 flushes to 0),
// as the forward takes it
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void lds4(const float* p, float (&o)[S]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void sts4(float* p, const float (&v)[S]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A chunk's operands as loaded from global memory, in their own types:
// the loads of chunk k - 1 are issued before chunk k is computed and used
// only after it, so their latency hides behind the compute.  Element j of
// a thread is (step, channel) i = threadIdx.x + j THREADS of the chunk's
// TC x CH, and (step, column) i of its TC x GW.  WITH_C: also dy, C and
// the lane's starting state (kernel 2).
template <typename T, bool WITH_C>
struct Chunk {
  static constexpr int NU = TC * CH / THREADS;
  static constexpr int NB = TC * GW / THREADS;
  static_assert(NU * THREADS == TC * CH && NB * THREADS == TC * GW);
  T u[NU], dt[NU], b[NB], c[WITH_C ? NB : 1];
  float dy[WITH_C ? NU : 1], h0[WITH_C ? S : 1];
};

// chunk k's starting state of the lane's columns: zero for chunk 0
__device__ __forceinline__ float* bound_at(const Params& p, int k, int ch) {
  return p.bounds +
         ((static_cast<long long>(blockIdx.y) * (p.chunks - 1) + k - 1) *
              p.D + ch) * p.N;
}

// issue the loads of chunk k (steps [k TC, k TC + tn)) of the block's
// channels and of columns [col0, col0 + GW): zeros past tn, Din and N
template <typename T, bool WITH_C>
__device__ __forceinline__ void load_chunk(const Params& p,
                                           Chunk<T, WITH_C>& r, int k,
                                           int tn, int col0) {
  using C = Chunk<T, WITH_C>;
  const int b = blockIdx.y, ch0 = blockIdx.x * CH, t0 = k * TC;
  const T* u = static_cast<const T*>(p.u);
  const T* dt = static_cast<const T*>(p.dt);
#pragma unroll
  for (int j = 0; j < C::NU; ++j) {
    const int i = threadIdx.x + j * THREADS, t = i / CH, ch = ch0 + i % CH;
    const bool ok = t < tn && ch < p.D;
    const long long tt = t0 + t;
    r.u[j] = ok ? u[b * p.ub + tt * p.ul + ch] : T(0.f);
    r.dt[j] = ok ? dt[b * p.dtb + tt * p.dtl + ch] : T(0.f);
    if constexpr (WITH_C)
      r.dy[j] = ok ? p.dy[(b * static_cast<long long>(p.L) + tt) * p.D + ch]
                   : 0.f;
  }
  const T* bm = static_cast<const T*>(p.bm);
  const T* cm = static_cast<const T*>(p.cm);
#pragma unroll
  for (int j = 0; j < C::NB; ++j) {
    const int i = threadIdx.x + j * THREADS, t = i / GW, col = col0 + i % GW;
    const bool ok = t < tn && col < p.N;
    const long long tt = t0 + t;
    r.b[j] = ok ? bm[b * p.bb + tt * p.bl + col * p.bn] : T(0.f);
    if constexpr (WITH_C)
      r.c[j] = ok ? cm[b * p.cb + tt * p.cl + col * p.cn] : T(0.f);
  }
  if constexpr (WITH_C) {
    const int ch = ch0 + threadIdx.x / G, lc = col0 + threadIdx.x % G * S;
    const float* src = k > 0 && ch < p.D ? bound_at(p, k, ch) : nullptr;
#pragma unroll
    for (int s = 0; s < S; ++s)
      r.h0[s] = src != nullptr && lc + s < p.N ? src[lc + s] : 0.f;
  }
}

// a loaded chunk into shared memory, in f32: {dt, u} pairs, dy, B and C
template <typename T, bool WITH_C>
__device__ __forceinline__ void store_chunk(const Chunk<T, WITH_C>& r,
                                            float2* sdtu, float* sdy,
                                            float* sb, float* sc) {
  using C = Chunk<T, WITH_C>;
#pragma unroll
  for (int j = 0; j < C::NU; ++j) {
    const int i = threadIdx.x + j * THREADS;
    sdtu[i] = make_float2(to_f(r.dt[j]), to_f(r.u[j]));
    if constexpr (WITH_C) sdy[i] = r.dy[j];
  }
#pragma unroll
  for (int j = 0; j < C::NB; ++j) {
    const int i = threadIdx.x + j * THREADS;
    sb[i] = to_f(r.b[j]);
    if constexpr (WITH_C) sc[i] = to_f(r.c[j]);
  }
}

// the lane's A and A * log2 e for its columns (0 past column N or channel
// Din)
__device__ __forceinline__ void load_a(const Params& p, int ch, int col0,
                                       float (&af)[S], float (&a2)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int col = col0 + s;
    af[s] = ch < p.D && col < p.N
        ? p.a[static_cast<long long>(ch) * p.N + col] : 0.f;
    a2[s] = af[s] * LOG2E;
  }
}

// 1. The forward walk: the state at the start of every chunk after the
// first.  The last chunk's end is not needed.
template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_bwd_bounds_kernel(const Params p) {
  __shared__ float2 sdtu[TC * CH];
  __shared__ float sb[TC * GW];
  const int cl = threadIdx.x / G, g = threadIdx.x % G;
  const int ch = blockIdx.x * CH + cl;
  for (int grp = 0; grp < p.groups; ++grp) {
    const int col0 = grp * GW + g * S;
    float af[S], a2[S], h[S];
    load_a(p, ch, col0, af, a2);
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = 0.f;
    Chunk<T, false> r;
    load_chunk(p, r, 0, TC, grp * GW);
    for (int k = 0; k + 1 < p.chunks; ++k) {
      __syncthreads();               // the last chunk's operands are read
      store_chunk(r, sdtu, nullptr, sb, nullptr);
      __syncthreads();
      if (k + 2 < p.chunks) load_chunk(p, r, k + 1, TC, grp * GW);
      for (int t = 0; t < TC; ++t) {
        const float2 v = sdtu[t * CH + cl];
        const float dtu = v.x * v.y;
        float bv[S];
        lds4(&sb[t * GW + g * S], bv);
#pragma unroll
        for (int s = 0; s < S; ++s)
          h[s] = fmaf(h[s], ex2(v.x * a2[s]), dtu * bv[s]);
      }
      if (ch < p.D) {
        float* o = bound_at(p, k + 1, ch);
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (col0 + s < p.N) o[col0 + s] = h[s];
      }
    }
  }
}

// Kernel 2, after a chunk's reverse walk: the block's sums of dB's and
// dC's terms over its CH channels, in channel order, per (step, column)
__device__ __forceinline__ void block_partials(const Params& p,
                                               const Tiles& tl, int t0,
                                               int tn, int grp) {
  const long long half = static_cast<long long>(p.B) * p.blocks * p.L * p.N;
  const long long base =
      (static_cast<long long>(blockIdx.y) * p.blocks + blockIdx.x) * p.L;
  for (int i = threadIdx.x; i < tn * GW; i += THREADS) {
    const int t = i / GW, j = i % GW, col = grp * GW + j;
    if (col >= p.N) continue;
    float sb = 0.f, sc = 0.f;
    for (int c = 0; c < CH; ++c) {
      const int r = (t * CH + c) * GW + j;
      sb += tl.red[r];
      sc = fmaf(tl.dy[t * CH + c], tl.hist[r], sc);
    }
    const long long o = (base + t0 + t) * p.N + col;
    p.pbc[o] = sb;
    p.pbc[half + o] = sc;
  }
}

// Kernel 2, after a chunk's reverse walk: the channels' du and ddt of this
// group, added to the groups' before (in f32, in group order) and stored
// in T at the last group
template <typename T>
__device__ __forceinline__ void store_du(const Params& p, const Tiles& tl,
                                         int t0, int tn, int grp) {
  const int ch0 = blockIdx.x * CH;
  const bool first = grp == 0, last = grp == p.groups - 1;
  const long long half = static_cast<long long>(p.B) * p.L * p.D;
  for (int i = threadIdx.x; i < tn * CH; i += THREADS) {
    const int t = i / CH, ch = ch0 + i % CH;
    if (ch >= p.D) continue;
    const long long o =
        (static_cast<long long>(blockIdx.y) * p.L + t0 + t) * p.D + ch;
    float vu = tl.du[i], vt = tl.ddt[i];
    if (!first) {
      vu += p.acc[o];
      vt += p.acc[half + o];
    }
    if (last) {
      repro_torch::store(static_cast<T*>(p.du) + o, vu);
      repro_torch::store(static_cast<T*>(p.ddt) + o, vt);
    } else {
      p.acc[o] = vu;
      p.acc[half + o] = vt;
    }
  }
}

// 2. The reverse walk, chunk by chunk, each chunk's states recomputed from
// its start
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
scan_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles& tl = *reinterpret_cast<Tiles*>(smem);
  const int cl = threadIdx.x / G, g = threadIdx.x % G;
  const int ch = blockIdx.x * CH + cl;
  const bool live = ch < p.D;
  const float dsk = live ? p.dskip[ch] : 0.f;
  float dd = 0.f;                       // dD's sum (lane 0, group 0)
  for (int grp = 0; grp < p.groups; ++grp) {
    const int col0 = grp * GW + g * S;
    float af[S], a2[S], gs[S], an[S], da[S];
    load_a(p, ch, col0, af, a2);
#pragma unroll
    for (int s = 0; s < S; ++s) gs[s] = an[s] = da[s] = 0.f;
    Chunk<T, true> r;
    load_chunk(p, r, p.chunks - 1, p.L - (p.chunks - 1) * TC, grp * GW);
    for (int k = p.chunks - 1; k >= 0; --k) {
      const int t0 = k * TC, tn = min(TC, p.L - t0);
      __syncthreads();               // the last chunk's tiles are read
      store_chunk(r, tl.dtu, tl.dy, tl.b, tl.c);
      float h0[S];
#pragma unroll
      for (int s = 0; s < S; ++s) h0[s] = r.h0[s];
      __syncthreads();
      if (k > 0) load_chunk(p, r, k - 1, TC, grp * GW);
      // the chunk's states, each lane its own columns
      float h[S];
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = h0[s];
      for (int t = 0; t < tn; ++t) {
        const float2 v = tl.dtu[t * CH + cl];
        const float dtu = v.x * v.y;
        float bv[S];
        lds4(&tl.b[t * GW + g * S], bv);
#pragma unroll
        for (int s = 0; s < S; ++s)
          h[s] = fmaf(h[s], ex2(v.x * a2[s]), dtu * bv[s]);
        sts4(&tl.hist[(t * CH + cl) * GW + g * S], h);
      }
      // back through the chunk
      for (int t = tn - 1; t >= 0; --t) {
        const float2 v = tl.dtu[t * CH + cl];       // {dt, u}
        const float dyv = tl.dy[t * CH + cl];
        float bv[S], cv[S], hp[S], red[S];
        lds4(&tl.b[t * GW + g * S], bv);
        lds4(&tl.c[t * GW + g * S], cv);
        if (t > 0) {
          lds4(&tl.hist[((t - 1) * CH + cl) * GW + g * S], hp);
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) hp[s] = h0[s];
        }
        const float dtu = v.x * v.y;
        float sdu = 0.f, sdt = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float at = ex2(v.x * a2[s]);
          const float gn = fmaf(an[s], gs[s], dyv * cv[s]);
          const float ah = at * hp[s];
          gs[s] = gn;
          an[s] = at;
          sdu = fmaf(gn, bv[s], sdu);
          sdt = fmaf(gn, fmaf(v.y, bv[s], af[s] * ah), sdt);
          da[s] = fmaf(gn * v.x, ah, da[s]);
          red[s] = gn * dtu;
        }
        sts4(&tl.red[(t * CH + cl) * GW + g * S], red);
        // the channel's G lanes: a butterfly, the same sum in every lane
#pragma unroll
        for (int o = 1; o < G; o *= 2) {
          sdu += __shfl_xor_sync(FULL, sdu, o);
          sdt += __shfl_xor_sync(FULL, sdt, o);
        }
        if (g == 0) {
          tl.du[t * CH + cl] = fmaf(v.x, sdu, grp == 0 ? dsk * dyv : 0.f);
          tl.ddt[t * CH + cl] = sdt;
          if (grp == 0) dd = fmaf(dyv, v.y, dd);
        }
      }
      __syncthreads();
      block_partials(p, tl, t0, tn, grp);
      store_du<T>(p, tl, t0, tn, grp);
    }
    if (live) {
      float* o = p.pa + (static_cast<long long>(blockIdx.y) * p.D + ch) * p.N;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (col0 + s < p.N) o[col0 + s] = da[s];
    }
  }
  if (g == 0 && live) p.pd[static_cast<long long>(blockIdx.y) * p.D + ch] = dd;
}

// 3. The partial sums added in a fixed order: dB and dC over the blocks,
// dA and dD over the sequences
template <typename T>
__global__ void __launch_bounds__(256) scan_bwd_reduce_kernel(const Params p) {
  const long long ln = static_cast<long long>(p.L) * p.N;
  const long long nbc = p.B * ln, nda = static_cast<long long>(p.D) * p.N;
  const long long half = p.B * p.blocks * ln;
  const long long total = nbc + nda + p.D;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < nbc) {
      const long long b = i / ln, r = i % ln;
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < p.blocks; ++k) {
        const long long o = (b * p.blocks + k) * ln + r;
        sb += p.pbc[o];
        sc += p.pbc[half + o];
      }
      repro_torch::store(static_cast<T*>(p.db) + i, sb);
      repro_torch::store(static_cast<T*>(p.dc) + i, sc);
    } else if (i < nbc + nda) {
      const long long j = i - nbc;
      float s = 0.f;
      for (int b = 0; b < p.B; ++b) s += p.pa[b * nda + j];
      p.da[j] = s;
    } else {
      const long long j = i - nbc - nda;
      float s = 0.f;
      for (int b = 0; b < p.B; ++b) s += p.pd[static_cast<long long>(b) * p.D + j];
      p.dd[j] = s;
    }
  }
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  if (p.B < 1 || p.B > 65535 || p.L < 1 || p.D < 1 || p.N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  p.groups = (p.N + GW - 1) / GW;
  p.chunks = (p.L + TC - 1) / TC;
  p.blocks = (p.D + CH - 1) / CH;
  const dim3 grid(p.blocks, p.B);
  if (p.chunks > 1) {
    scan_bwd_bounds_kernel<T><<<grid, THREADS, 0, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int smem = static_cast<int>(sizeof(Tiles));
  cudaError_t e = cudaFuncSetAttribute(
      scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = p.B * static_cast<long long>(p.L) * p.N +
                          static_cast<long long>(p.D) * p.N + p.D;
  const int blocks = static_cast<int>(
      total / 256 + 1 < 132 * 8 ? total / 256 + 1 : 132 * 8);
  scan_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* u, const void* dt, const void* a, const void* bm,
             const void* cm, const void* dskip, const void* dy, void* du,
             void* ddt, void* da, void* db, void* dc, void* dd, void* bounds,
             void* acc, void* pbc, void* pa, void* pd, int B, int L, int D,
             int N, const long long* s, void* stream) {
  Params p{u, dt, static_cast<const float*>(a), bm, cm,
           static_cast<const float*>(dskip), static_cast<const float*>(dy),
           du, ddt, static_cast<float*>(da), db, dc, static_cast<float*>(dd),
           static_cast<float*>(bounds), static_cast<float*>(acc),
           static_cast<float*>(pbc), static_cast<float*>(pa),
           static_cast<float*>(pd), B, L, D, N, 0, 0, 0,
           s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]};
  return launch<T>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// strides: 10 element strides: u (b, l), dt (b, l), B (b, l, n), C (b, l,
// n); dy, du, ddt, dB, dC contiguous; the workspaces as mamba_scan.py's
// selective_scan_bwd allocates them
int selective_scan_bwd_f32(const void* u, const void* dt, const void* a,
                           const void* bm, const void* cm, const void* dskip,
                           const void* dy, void* du, void* ddt, void* da,
                           void* db, void* dc, void* dd, void* bounds,
                           void* acc, void* pbc, void* pa, void* pd, int B,
                           int L, int D, int N, const long long* strides,
                           void* stream) {
  return dispatch<float>(u, dt, a, bm, cm, dskip, dy, du, ddt, da, db, dc, dd,
                         bounds, acc, pbc, pa, pd, B, L, D, N, strides,
                         stream);
}

int selective_scan_bwd_bf16(const void* u, const void* dt, const void* a,
                            const void* bm, const void* cm, const void* dskip,
                            const void* dy, void* du, void* ddt, void* da,
                            void* db, void* dc, void* dd, void* bounds,
                            void* acc, void* pbc, void* pa, void* pd, int B,
                            int L, int D, int N, const long long* strides,
                            void* stream) {
  return dispatch<__nv_bfloat16>(u, dt, a, bm, cm, dskip, dy, du, ddt, da, db,
                                 dc, dd, bounds, acc, pbc, pa, pd, B, L, D, N,
                                 strides, stream);
}

}  // extern "C"
