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
// taken.  What the reverse walk meets first is instruction issue: some 30
// warp-instructions for a warp's 64 (b, t, d, n) a step, at 4 a clock per
// SM (the FMAs and multiplies of the recompute and the reverse step, the
// shuffles, selects and adds of the sums, the shared loads).
//
// The design.  The reverse walk needs h_{t-1}, which the forward kernel
// does not keep (all states are 2.1 GB a layer at the training shape), and
// the forward kernel stays as serving launches it.  So three kernels; a
// state of N > 16 runs as groups of 16 columns one after another (N < 16:
// the missing columns read as 0 and stay 0):
//   1. scan_bwd_bounds_kernel walks forward and stores the state at the
//      start of each chunk of TC = 16 steps after the first, (B, ceil(L /
//      TC) - 1, Din, N) f32 (134 MB at the training shape): 128 threads
//      over 32 channels, a channel's group over 4 lanes of 4 columns, the
//      next chunk's operands loaded into registers while this one walks.
//   2. scan_bwd_kernel walks the chunks in reverse: 256 threads (8 warps)
//      over the same 32 channels of one sequence, a channel's group over 8
//      lanes of 2 columns (4 channels a warp), two blocks an SM: 16 warps.
//      A lane walks a chunk back a part of HT = 4 steps at a time from the
//      last: a first walk from the chunk's stored start keeps the state at
//      each part's start, then each part recomputes its states and a_t
//      into registers (the t-loops unrolled), so the reverse step reads
//      h_{t-1}, h_t and a_t from registers, with no exponential and no
//      state in shared memory.  g and a_{t+1} carry across chunks in
//      registers.  The sums run by reduce-scatters of shuffles in a fixed
//      order, as the forward sums y: du's and ddt's shares over the
//      channel's 8 lanes, four steps at a time (7 shuffles for 8 sums;
//      lane 0 adds D dy); dB's and dC's terms over the warp's 4 channels,
//      two steps at a time (6 shuffles; each lane keeps one step's dB or
//      dC of its 2 columns).  The warps' dB and dC sums and the channels'
//      du and ddt go to double-buffered shared tiles and out during the
//      next chunk (four values a thread): the 8 warps' sums added in warp
//      order, per block (B, Din / 32, L, N) to a workspace (pbc, 134 MB
//      at the training shape).  dA and dD are summed in registers over the
//      sequence.  The operands (u, dt, dy, B, C, the chunk's start) of
//      chunk k - 1 are copied by cp.async (u and dt four elements at a
//      time, the others 16 bytes) while chunk k walks; the thread that
//      copied a slot turns it into f32 tiles ({dt, u, dy} of a channel and
//      {B, B, C, C} of a lane's columns: a reverse step's operands in two
//      16-byte shared loads), rows padded so that neither the conversion
//      nor the walk meets a bank conflict; so a chunk takes one barrier.
//      Where pointers or strides do not allow cp.async (B and C column
//      slices off 16 bytes or of another column stride, u/dt rows off four
//      elements, Din or N not a multiple of 4) those operands are loaded
//      plainly.  A ragged last chunk walks padded: dt = u = dy = B = C = 0
//      leaves h as it is and g at 0, and its steps are not stored.  N > 16
//      sums du and ddt over the groups in f32 in a workspace, in group
//      order, and rounds at the last group.
//   3. scan_bwd_reduce_kernel adds the partial sums in a fixed order: dB
//      and dC over the blocks, dA and dD over the sequences.
// A (b, t, d, n) costs 2.75 exponentials (the bounds walk once, kernel 2's
// recompute 1.75 times; the design before took three: the reverse step
// took its own), 3.1 shared-memory instructions in kernel 2, every load a
// broadcast of a step's operands (before: five f32 accesses of its own,
// the states and dB's terms stored and read back, and a serial 32-channel
// loop with bank conflicts for dB and dC), and 2.4 shuffles.  No atomics:
// two launches are bit-equal.  Registers: 128 (two blocks an SM), no
// spills (ptxas, printed and held by chip_smoke.py phase 1, with kernel
// 2's resident warps an SM from selective_scan_bwd_occupancy).
//
// Plain-C entry points (loaded with ctypes): the launch of the three
// kernels on the given stream, returning the first cudaError_t, and kernel
// 2's occupancy.

#include "common.cuh"

namespace {

constexpr int CH = 32;             // channels a block (kernels 1 and 2)
constexpr int GW = 16;             // state columns a group
constexpr int TC = 16;             // steps a chunk
// kernel 1: 128 threads, a channel's group over G lanes of S columns
constexpr int THREADS = 128;
constexpr int G = 4;
constexpr int S = 4;
// kernel 2: RT threads, a channel's group over RG lanes of RS columns;
// du and ddt reduced QT steps at a time, dB and dC QY steps at a time; a
// chunk walked back in parts of HT steps, each with its states and a_t in
// registers
constexpr int RT = 256;
constexpr int RG = 8;
constexpr int RS = 2;
constexpr int RW = RT / 32;        // warps a block
constexpr int WCH = 32 / RG;       // channels a warp
constexpr int QT = 4;
constexpr int QY = 2;
constexpr int HT = 4;
static_assert(THREADS / G == CH && G * S == GW);
static_assert(RT / RG == CH && RG * RS == GW && TC % HT == 0 && HT % QT == 0);
// du and ddt of QT steps: one sum a lane; dB and dC (2 x RS columns) of QY
// steps: one step's dB or dC sums a lane
static_assert(2 * QT == RG && QT % QY == 0 && 2 * QY == WCH && RS == 2);
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
  int vec;                 // kernel 2's asynchronous copies: bit 0 u and
                           // dt, bit 1 B and C, bit 2 dy, bit 3 the bounds
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

// chunk k's starting state of channel ch: zero for chunk 0
__device__ __forceinline__ float* bound_at(const Params& p, int k, int ch) {
  return p.bounds +
         ((static_cast<long long>(blockIdx.y) * (p.chunks - 1) + k - 1) *
              p.D + ch) * p.N;
}

// the lane's A and A * log2 e for its R columns (0 past column N or
// channel Din)
template <int R>
__device__ __forceinline__ void load_a(const Params& p, int ch, int col0,
                                       float (&af)[R], float (&a2)[R]) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int col = col0 + s;
    af[s] = ch < p.D && col < p.N
        ? p.a[static_cast<long long>(ch) * p.N + col] : 0.f;
    a2[s] = af[s] * LOG2E;
  }
}

// ------------------------------------------------ 1. the bounds walk

// Kernel 1's chunk of operands as loaded from global memory, in their own
// types: the loads of chunk k + 1 are issued before chunk k is walked and
// used only after it, so their latency hides behind the walk.  Element j
// of a thread is (step, channel) i = threadIdx.x + j THREADS of the
// chunk's TC x CH, and (step, column) i of its TC x GW.
template <typename T>
struct Chunk {
  static constexpr int NU = TC * CH / THREADS;
  static constexpr int NB = TC * GW / THREADS;
  static_assert(NU * THREADS == TC * CH && NB * THREADS == TC * GW);
  T u[NU], dt[NU], b[NB];
};

// issue the loads of chunk k (steps [k TC, k TC + tn)) of the block's
// channels and of columns [col0, col0 + GW): zeros past tn, Din and N
template <typename T>
__device__ __forceinline__ void load_chunk(const Params& p, Chunk<T>& r,
                                           int k, int tn, int col0) {
  const int b = blockIdx.y, ch0 = blockIdx.x * CH, t0 = k * TC;
  const T* u = static_cast<const T*>(p.u);
  const T* dt = static_cast<const T*>(p.dt);
#pragma unroll
  for (int j = 0; j < Chunk<T>::NU; ++j) {
    const int i = threadIdx.x + j * THREADS, t = i / CH, ch = ch0 + i % CH;
    const bool ok = t < tn && ch < p.D;
    const long long tt = t0 + t;
    r.u[j] = ok ? u[b * p.ub + tt * p.ul + ch] : T(0.f);
    r.dt[j] = ok ? dt[b * p.dtb + tt * p.dtl + ch] : T(0.f);
  }
  const T* bm = static_cast<const T*>(p.bm);
#pragma unroll
  for (int j = 0; j < Chunk<T>::NB; ++j) {
    const int i = threadIdx.x + j * THREADS, t = i / GW, col = col0 + i % GW;
    const bool ok = t < tn && col < p.N;
    const long long tt = t0 + t;
    r.b[j] = ok ? bm[b * p.bb + tt * p.bl + col * p.bn] : T(0.f);
  }
}

// a loaded chunk into shared memory, in f32: {dt, u} pairs and B
template <typename T>
__device__ __forceinline__ void store_chunk(const Chunk<T>& r, float2* sdtu,
                                            float* sb) {
#pragma unroll
  for (int j = 0; j < Chunk<T>::NU; ++j)
    sdtu[threadIdx.x + j * THREADS] = make_float2(to_f(r.dt[j]),
                                                  to_f(r.u[j]));
#pragma unroll
  for (int j = 0; j < Chunk<T>::NB; ++j)
    sb[threadIdx.x + j * THREADS] = to_f(r.b[j]);
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
    load_a<S>(p, ch, col0, af, a2);
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = 0.f;
    Chunk<T> r;
    load_chunk(p, r, 0, TC, grp * GW);
    for (int k = 0; k + 1 < p.chunks; ++k) {
      __syncthreads();               // the last chunk's operands are read
      store_chunk(r, sdtu, sb);
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

// ------------------------------------------------ 2. the reverse walk

// row strides of kernel 2's tiles, each row padded so that the
// conversion's loads and stores (a lane a row) and the walk's loads (a row
// a step) fall in distinct banks
constexpr int OP_ROW = CH + 1;     // float4 {dt, u, dy, 0} a channel
constexpr int BC_ROW = RG + 1;     // float4 {B, B, C, C} a lane's columns
constexpr int H0_ROW = GW + 4;     // float
constexpr int DU_ROW = CH + 4;     // float
constexpr int RU_ROW = CH + 4;     // raw u, dt (T) and dy (f32)

// one chunk as copied: u, dt, dy [step][channel], B and C [step][column],
// the chunk's start [channel][column] (this group's columns)
template <typename T>
struct Raw {
  static constexpr int RB_ROW = GW + 16 / sizeof(T);
  alignas(16) T u[TC * RU_ROW];
  alignas(16) T dt[TC * RU_ROW];
  alignas(16) float dy[TC * RU_ROW];
  alignas(16) T b[TC * RB_ROW];
  alignas(16) T c[TC * RB_ROW];
  alignas(16) float h0[CH * H0_ROW];
};

// one chunk in f32, as the walk reads it: a step's operands of a channel
// in one 16-byte load, those of a lane's 2 columns in another
struct Ops {
  alignas(16) float4 op[TC * OP_ROW];    // {dt, u, dy, 0} [step][channel]
  alignas(16) float4 bc[TC * BC_ROW];    // [step][lane of the group]
  alignas(16) float h0[CH * H0_ROW];     // [channel][column]
};

// Kernel 2's shared memory: the copies in flight, two chunks of f32
// operands (the walked one and the next), and two chunks of sums (the
// walked one's and the one being stored): dB and dC per warp, [step][dB,
// dC][column]; du and ddt [step][du, ddt][channel]
template <typename T>
struct RevTiles {
  Raw<T> raw;
  Ops op[2];
  alignas(16) float part[2][RW][TC][2][GW];
  alignas(16) float duo[2][TC * 2 * DU_ROW];
};

// 16 (or 8) bytes global -> shared, asynchronously: the first `bytes`
// read, the rest zero (src stays a valid address where bytes is 0)
__device__ __forceinline__ void cp_async16n(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   repro_torch::smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async8n(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   repro_torch::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// four elements' copy: 16 bytes of f32, 8 of bf16
__device__ __forceinline__ void cp_async4e(float* dst, const float* src,
                                           int n) {
  cp_async16n(dst, src, 4 * n);
}
__device__ __forceinline__ void cp_async4e(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int n) {
  cp_async8n(dst, src, 2 * n);
}

// a bf16 as f32: its upper half
__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// four elements of shared memory (16 bytes of f32, 8 of bf16) as f32
__device__ __forceinline__ void lds4e(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void lds4e(const __nv_bfloat16* p, float* o) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = bf_lo(w.x); o[1] = bf_hi(w.x); o[2] = bf_lo(w.y); o[3] = bf_hi(w.y);
}
// 16 bytes of shared memory (4 f32 or 8 bf16) as f32
__device__ __forceinline__ void lds_vec(const float* p, float* o) {
  lds4e(p, o);
}
__device__ __forceinline__ void lds_vec(const __nv_bfloat16* p, float* o) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = bf_lo(ws[i]);
    o[2 * i + 1] = bf_hi(ws[i]);
  }
}

// A chunk's copies are cut into slots: u, dt and dy of 4 channels of a
// step (threads 0 to NU - 1), the start of 4 columns of a channel, and B
// and C of VEC columns of a step (both from thread NU on, in turn).  A
// slot's row is its index mod TC (mod CH for the start), so that the lanes
// of a warp convert into rows one after another.  The thread that copies
// a slot converts it.
template <typename T>
struct Slots {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int NU = TC * CH / 4;
  static constexpr int NH = CH * GW / 4;
  static constexpr int NB = TC * GW / VEC;
  static_assert(NU + NH <= RT && NU + NB <= RT);
};

// Start copying chunk k of group grp into the raw tiles: each thread its
// slots, rows past L, channels past Din and columns past N zero-filled;
// the operands whose pointers or strides do not allow it are left to
// convert_chunk's plain loads.
template <typename T>
__device__ __forceinline__ void issue_chunk(const Params& p, Raw<T>& r,
                                            int k, int grp) {
  using SL = Slots<T>;
  constexpr int VEC = SL::VEC, RB = Raw<T>::RB_ROW;
  const int b = blockIdx.y, ch0 = blockIdx.x * CH, t0 = k * TC;
  const int tn = min(TC, p.L - t0), tid = threadIdx.x;
  if (tid < SL::NU) {
    const int t = tid % TC, c = tid / TC * 4, ch = ch0 + c;
    const long long tt = t0 + t;
    const int n = t < tn && ch < p.D ? min(4, p.D - ch) : 0;
    if (p.vec & 1) {
      const T* u = static_cast<const T*>(p.u) + b * p.ub;
      const T* dt = static_cast<const T*>(p.dt) + b * p.dtb;
      cp_async4e(&r.u[t * RU_ROW + c], n ? u + tt * p.ul + ch : u, n);
      cp_async4e(&r.dt[t * RU_ROW + c], n ? dt + tt * p.dtl + ch : dt, n);
    }
    if (p.vec & 4)
      cp_async4e(&r.dy[t * RU_ROW + c],
                 n ? p.dy + (static_cast<long long>(b) * p.L + tt) * p.D + ch
                   : p.dy, n);
  } else {
    const int i = tid - SL::NU;
    if ((p.vec & 8) && k > 0 && i < SL::NH) {
      const int c = i % CH, q = i / CH * 4, ch = ch0 + c;
      const int col = grp * GW + q;
      const int bytes = ch < p.D && col < p.N ? min(4, p.N - col) * 4 : 0;
      cp_async16n(&r.h0[c * H0_ROW + q],
                  bytes ? bound_at(p, k, ch) + col : p.bounds, bytes);
    }
    if ((p.vec & 2) && i < SL::NB) {
      const int t = i % TC, c = i / TC * VEC, col = grp * GW + c;
      const long long tt = t0 + t;
      const int bytes =
          t < tn && col < p.N ? min(VEC, p.N - col) * int(sizeof(T)) : 0;
      const T* bm = static_cast<const T*>(p.bm) + b * p.bb;
      const T* cm = static_cast<const T*>(p.cm) + b * p.cb;
      cp_async16n(&r.b[t * RB + c], bytes ? bm + tt * p.bl + col : bm,
                  bytes);
      cp_async16n(&r.c[t * RB + c], bytes ? cm + tt * p.cl + col : cm,
                  bytes);
    }
  }
}

// Chunk k of group grp into f32 tiles: each thread its own slots, from its
// copies (landed: the caller waited for them) or, for the operands not
// copied, by plain loads; zeros past L, Din and N
template <typename T>
__device__ __forceinline__ void convert_chunk(const Params& p,
                                              const Raw<T>& r, Ops& o, int k,
                                              int grp) {
  using SL = Slots<T>;
  constexpr int VEC = SL::VEC, RB = Raw<T>::RB_ROW;
  const int b = blockIdx.y, ch0 = blockIdx.x * CH, t0 = k * TC;
  const int tn = min(TC, p.L - t0), tid = threadIdx.x;
  if (tid < SL::NU) {
    const int t = tid % TC, c = tid / TC * 4, ch = ch0 + c;
    const long long tt = t0 + t;
    float uf[4], df[4], yf[4];
    if (p.vec & 1) {
      lds4e(&r.u[t * RU_ROW + c], uf);
      lds4e(&r.dt[t * RU_ROW + c], df);
    } else {
      const T* u = static_cast<const T*>(p.u) + b * p.ub + tt * p.ul;
      const T* dt = static_cast<const T*>(p.dt) + b * p.dtb + tt * p.dtl;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = t < tn && ch + e < p.D;
        uf[e] = ok ? to_f(u[ch + e]) : 0.f;
        df[e] = ok ? to_f(dt[ch + e]) : 0.f;
      }
    }
    if (p.vec & 4) {
      lds4e(&r.dy[t * RU_ROW + c], yf);
    } else {
      const float* dy = p.dy + (static_cast<long long>(b) * p.L + tt) * p.D;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        yf[e] = t < tn && ch + e < p.D ? dy[ch + e] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o.op[t * OP_ROW + c + e] = make_float4(df[e], uf[e], yf[e], 0.f);
    return;
  }
  const int i = tid - SL::NU;
  if (i < SL::NH) {
    const int c = i % CH, q = i / CH * 4, ch = ch0 + c;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (k > 0 && (p.vec & 8)) {
      lds4e(&r.h0[c * H0_ROW + q], v);
    } else if (k > 0 && ch < p.D) {
      const float* src = bound_at(p, k, ch);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = grp * GW + q + e;
        v[e] = col < p.N ? src[col] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(&o.h0[c * H0_ROW + q]) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  if (i < SL::NB) {
    const int t = i % TC, c = i / TC * VEC;
    float bf[VEC], cf[VEC];
    if (p.vec & 2) {
      lds_vec(&r.b[t * RB + c], bf);
      lds_vec(&r.c[t * RB + c], cf);
    } else {
      const T* bm = static_cast<const T*>(p.bm) + b * p.bb + (t0 + t) * p.bl;
      const T* cm = static_cast<const T*>(p.cm) + b * p.cb + (t0 + t) * p.cl;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = grp * GW + c + e;
        const bool ok = t < tn && col < p.N;
        bf[e] = ok ? to_f(bm[col * p.bn]) : 0.f;
        cf[e] = ok ? to_f(cm[col * p.cn]) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; e += RS)
      o.bc[t * BC_ROW + (c + e) / RS] =
          make_float4(bf[e], bf[e + 1], cf[e], cf[e + 1]);
  }
}

// The lane's reverse walk through steps [t0, t0 + HT) of the chunk (its
// channel cl, columns g RS onwards of the group), from the state h0 before
// t0: the states recomputed into registers with each step's a_t, then g
// walked back: du's and ddt's shares reduced QT steps at a time, dB's and
// dC's terms QY steps at a time, into the chunk's sums (duo, part[warp]).
// gs, an (g and a_{t+1}), da and dd carry over.  dsk is D on lane 0 of
// group 0, else 0.
__device__ __forceinline__ void walk_part(
    int t0, const Ops& o, float (&part)[TC][2][GW], float* duo, int cl,
    int g, int cw, const float (&af)[RS], const float (&a2)[RS], float dsk,
    const float (&h0)[RS], float (&gs)[RS], float (&an)[RS],
    float (&da)[RS], float& dd) {
  float h[HT + 1][RS], av[HT][RS];
#pragma unroll
  for (int s = 0; s < RS; ++s) h[0][s] = h0[s];
#pragma unroll
  for (int i = 0; i < HT; ++i) {
    const int t = t0 + i;
    const float2 v = *reinterpret_cast<const float2*>(     // {dt, u}
        &o.op[t * OP_ROW + cl]);
    const float2 bv = *reinterpret_cast<const float2*>(&o.bc[t * BC_ROW + g]);
    const float dtu = v.x * v.y;
    const float bs[RS] = {bv.x, bv.y};
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      av[i][s] = ex2(v.x * a2[s]);
      h[i + 1][s] = fmaf(h[i][s], av[i][s], dtu * bs[s]);
    }
  }
#pragma unroll
  for (int q = HT / QT - 1; q >= 0; --q) {
    float x[2 * QT];        // du's and ddt's shares of the QT steps
#pragma unroll
    for (int r = QT / QY - 1; r >= 0; --r) {
      float y[4 * QY];      // dB's and dC's terms: [step][dB, dC][column]
#pragma unroll
      for (int jy = QY - 1; jy >= 0; --jy) {
        const int j = r * QY + jy, i = q * QT + j, t = t0 + i;
        const float4 v = o.op[t * OP_ROW + cl];         // {dt, u, dy}
        const float4 bc = o.bc[t * BC_ROW + g];         // {B, B, C, C}
        const float bs[RS] = {bc.x, bc.y}, cs[RS] = {bc.z, bc.w};
        const float dtu = v.x * v.y, dyv = v.z;
        float sdu = 0.f, sq = 0.f;
#pragma unroll
        for (int s = 0; s < RS; ++s) {
          const float gn = fmaf(an[s], gs[s], dyv * cs[s]);
          const float qv = gn * (av[i][s] * h[i][s]);     // g a_t h_{t-1}
          sdu = fmaf(gn, bs[s], sdu);
          sq = fmaf(af[s], qv, sq);
          da[s] = fmaf(v.x, qv, da[s]);
          y[jy * 4 + s] = gn * dtu;
          y[jy * 4 + RS + s] = dyv * h[i + 1][s];
          gs[s] = gn;
          an[s] = av[i][s];
        }
        x[j] = fmaf(v.x, sdu, dsk * dyv);
        x[QT + j] = fmaf(v.y, sdu, sq);
        dd = fmaf(dyv, v.y, dd);
      }
      // dB and dC over the warp's WCH channels (lanes RG apart): channel
      // cw of the warp keeps step cw / 2's dB (cw even) or dC sums
#pragma unroll
      for (int w = WCH / 2; w >= 1; w /= 2) {
        const bool up = cw & w;
#pragma unroll
        for (int e = 0; e < 2 * w; ++e) {
          const float send = up ? y[e] : y[e + 2 * w];
          y[e] = (up ? y[e + 2 * w] : y[e]) +
                 __shfl_xor_sync(FULL, send, w * RG);
        }
      }
      *reinterpret_cast<float2*>(
          &part[t0 + q * QT + r * QY + cw / 2][cw % 2][g * RS]) =
          make_float2(y[0], y[1]);
    }
    // du and ddt over the channel's RG lanes: lane g keeps sum g, ddt's
    // from g = QT on, step g mod QT
#pragma unroll
    for (int w = RG / 2; w >= 1; w /= 2) {
      const bool up = g & w;
#pragma unroll
      for (int e = 0; e < w; ++e) {
        const float send = up ? x[e] : x[e + w];
        x[e] = (up ? x[e + w] : x[e]) + __shfl_xor_sync(FULL, send, w);
      }
    }
    duo[((t0 + q * QT + g % QT) * 2 + g / QT) * DU_ROW + cl] = x[0];
  }
}

// The lane's reverse walk through one chunk, a part of HT steps at a
// time from the last: a first walk from the chunk's start keeps the state
// at each part's start, then each part recomputes its states and a_t into
// registers and walks back (the steps before the last part are walked
// twice).
__device__ __forceinline__ void walk_chunk(
    const Ops& o, float (&part)[TC][2][GW], float* duo, int cl, int g,
    int cw, const float (&af)[RS], const float (&a2)[RS], float dsk,
    float (&gs)[RS], float (&an)[RS], float (&da)[RS], float& dd) {
  constexpr int PARTS = TC / HT;
  float hp[PARTS][RS];                   // the state at each part's start
  {
    const float2 v = *reinterpret_cast<const float2*>(&o.h0[cl * H0_ROW +
                                                             g * RS]);
    hp[0][0] = v.x;
    hp[0][1] = v.y;
  }
#pragma unroll
  for (int m = 1; m < PARTS; ++m) {
    float h[RS] = {hp[m - 1][0], hp[m - 1][1]};
#pragma unroll
    for (int t = (m - 1) * HT; t < m * HT; ++t) {
      const float2 v = *reinterpret_cast<const float2*>(
          &o.op[t * OP_ROW + cl]);
      const float2 bv = *reinterpret_cast<const float2*>(
          &o.bc[t * BC_ROW + g]);
      const float dtu = v.x * v.y;
      h[0] = fmaf(h[0], ex2(v.x * a2[0]), dtu * bv.x);
      h[1] = fmaf(h[1], ex2(v.x * a2[1]), dtu * bv.y);
    }
    hp[m][0] = h[0];
    hp[m][1] = h[1];
  }
#pragma unroll
  for (int m = PARTS - 1; m >= 0; --m)
    walk_part(m * HT, o, part, duo, cl, g, cw, af, a2, dsk, hp[m], gs, an,
              da, dd);
}

// four values stored in T at once (p aligned to four elements)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned*>(&a);
  w.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// Chunk k's sums out, a thread 4 of them: dB and dC of the block (the
// warps' sums added in warp order) to pbc, from threads 0 to TC GW / 2 - 1;
// du and ddt of the channels, added to the groups' before (in f32, in
// group order) and stored in T at the last group, from the others
template <typename T>
__device__ __forceinline__ void flush_chunk(const Params& p,
                                            const RevTiles<T>& tl, int k,
                                            int grp) {
  constexpr int NP = TC * 2 * GW / 4;       // float4s of a warp's sums
  static_assert(NP + TC * CH / 4 == RT);
  const int buf = k & 1, t0 = k * TC, tn = min(TC, p.L - t0);
  const int tid = threadIdx.x;
  if (tid < NP) {
    const float4* part = reinterpret_cast<const float4*>(tl.part[buf]);
    float4 s = part[tid];
#pragma unroll
    for (int w = 1; w < RW; ++w) {
      const float4 v = part[w * NP + tid];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    const int f = tid * 4, t = f / (2 * GW), kind = f / GW % 2;
    const int col = grp * GW + f % GW;
    if (t >= tn) return;
    const long long half =
        static_cast<long long>(p.B) * p.blocks * p.L * p.N;
    float* dst = p.pbc + kind * half +
                 ((static_cast<long long>(blockIdx.y) * p.blocks +
                   blockIdx.x) * p.L + t0 + t) * p.N + col;
    if (p.N % 4 == 0 && col < p.N) {
      *reinterpret_cast<float4*>(dst) = s;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < p.N) dst[e] = v[e];
    }
    return;
  }
  const int i = tid - NP, t = i / (CH / 4), c = i % (CH / 4) * 4;
  const int ch = blockIdx.x * CH + c;
  if (t >= tn || ch >= p.D) return;
  const float* duo = tl.duo[buf];
  const float4 u4 = *reinterpret_cast<const float4*>(&duo[t * 2 * DU_ROW + c]);
  const float4 t4 =
      *reinterpret_cast<const float4*>(&duo[(t * 2 + 1) * DU_ROW + c]);
  float vu[4] = {u4.x, u4.y, u4.z, u4.w}, vt[4] = {t4.x, t4.y, t4.z, t4.w};
  const bool first = grp == 0, last = grp == p.groups - 1;
  const long long dhalf = static_cast<long long>(p.B) * p.L * p.D;
  const long long o =
      (static_cast<long long>(blockIdx.y) * p.L + t0 + t) * p.D + ch;
  if (first && last && p.D % 4 == 0) {    // one group: 4 stores at once
    store4(static_cast<T*>(p.du) + o, vu);
    store4(static_cast<T*>(p.ddt) + o, vt);
    return;
  }
  const int n = min(4, p.D - ch);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e >= n) break;
    if (!first) {
      vu[e] += p.acc[o + e];
      vt[e] += p.acc[dhalf + o + e];
    }
    if (last) {
      repro_torch::store(static_cast<T*>(p.du) + o + e, vu[e]);
      repro_torch::store(static_cast<T*>(p.ddt) + o + e, vt[e]);
    } else {
      p.acc[o + e] = vu[e];
      p.acc[dhalf + o + e] = vt[e];
    }
  }
}

// 2. The reverse walk, chunk by chunk, each chunk's states recomputed from
// its start; one barrier a chunk
template <typename T>
__global__ void __launch_bounds__(RT, 2) scan_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  RevTiles<T>& tl = *reinterpret_cast<RevTiles<T>*>(smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane % RG, cw = lane / RG, cl = warp * WCH + cw;
  const int ch = blockIdx.x * CH + cl;
  const bool live = ch < p.D;
  for (int grp = 0; grp < p.groups; ++grp) {
    const int col0 = grp * GW + g * RS;
    // D dy on lane 0 of group 0
    const float dsk = live && g == 0 && grp == 0 ? p.dskip[ch] : 0.f;
    float af[RS], a2[RS], gs[RS], an[RS], da[RS], dd = 0.f;
    load_a<RS>(p, ch, col0, af, a2);
#pragma unroll
    for (int s = 0; s < RS; ++s) gs[s] = an[s] = da[s] = 0.f;
    const int last = p.chunks - 1;
    issue_chunk(p, tl.raw, last, grp);
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<0>();
    convert_chunk(p, tl.raw, tl.op[last & 1], last, grp);
    for (int k = last; k >= 0; --k) {
      // chunk k's operands and chunk k + 1's sums are complete, and
      // every thread is done with chunk k + 1's operands
      __syncthreads();
      if (k < last) flush_chunk(p, tl, k + 1, grp);
      if (k > 0) {
        issue_chunk(p, tl.raw, k - 1, grp);
        repro_torch::cp_async_commit();
      }
      walk_chunk(tl.op[k & 1], tl.part[k & 1][warp], tl.duo[k & 1], cl, g,
                 cw, af, a2, dsk, gs, an, da, dd);
      if (k > 0) {
        repro_torch::cp_async_wait<0>();
        convert_chunk(p, tl.raw, tl.op[(k - 1) & 1], k - 1, grp);
      }
    }
    __syncthreads();
    flush_chunk(p, tl, 0, grp);
    if (live) {
      const long long row = static_cast<long long>(blockIdx.y) * p.D + ch;
#pragma unroll
      for (int s = 0; s < RS; ++s)
        if (col0 + s < p.N) p.pa[row * p.N + col0 + s] = da[s];
      if (g == 0 && grp == 0) p.pd[row] = dd;     // dD's sum
    }
  }
}

// ------------------------------------------------ 3. the reduction

// The partial sums added in a fixed order: dB and dC over the blocks, dA
// and dD over the sequences
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

// kernel 2's asynchronous copies that the pointers and strides allow
// (Params' vec)
template <typename T>
int copy_flags(const Params& p) {
  constexpr long long VEC = 16 / sizeof(T);
  auto al = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  int f = 0;
  auto al4 = [](const void* q) {             // four elements
    return reinterpret_cast<uintptr_t>(q) % (4 * sizeof(T)) == 0;
  };
  if (al4(p.u) && al4(p.dt) && p.ub % 4 == 0 && p.ul % 4 == 0 &&
      p.dtb % 4 == 0 && p.dtl % 4 == 0)
    f |= 1;
  if (p.bn == 1 && p.cn == 1 && al(p.bm) && al(p.cm) && p.bb % VEC == 0 &&
      p.bl % VEC == 0 && p.cb % VEC == 0 && p.cl % VEC == 0)
    f |= 2;
  if (al(p.dy) && p.D % 4 == 0) f |= 4;
  if (al(p.bounds) && p.N % 4 == 0) f |= 8;
  return f;
}

template <typename T>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(RevTiles<T>))));
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  if (p.B < 1 || p.B > 65535 || p.L < 1 || p.D < 1 || p.N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  p.groups = (p.N + GW - 1) / GW;
  p.chunks = (p.L + TC - 1) / TC;
  p.blocks = (p.D + CH - 1) / CH;
  p.vec = copy_flags<T>(p);
  const dim3 grid(p.blocks, p.B);
  if (p.chunks > 1) {
    scan_bwd_bounds_kernel<T><<<grid, THREADS, 0, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int e = set_smem<T>();
  if (e != 0) return e;
  scan_bwd_kernel<T><<<grid, RT, sizeof(RevTiles<T>), stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const long long total = p.B * static_cast<long long>(p.L) * p.N +
                          static_cast<long long>(p.D) * p.N + p.D;
  const int blocks = static_cast<int>(
      total / 256 + 1 < 132 * 8 ? total / 256 + 1 : 132 * 8);
  scan_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// kernel 2's residency: out = {blocks an SM, warps an SM, shared bytes a
// block}
template <typename T>
int occupancy(int* out) {
  int e = set_smem<T>();
  if (e != 0) return e;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], scan_bwd_kernel<T>, RT, sizeof(RevTiles<T>)));
  out[1] = out[0] * RT / 32;
  out[2] = static_cast<int>(sizeof(RevTiles<T>));
  return e;
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
           s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], 0};
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

// the reverse walk's (scan_bwd_kernel's) residency for u's type (bf16 !=
// 0): out[0] blocks an SM, out[1] warps an SM, out[2] shared bytes a block
int selective_scan_bwd_occupancy(int bf16, int* out) {
  return bf16 ? occupancy<__nv_bfloat16>(out) : occupancy<float>(out);
}

}  // extern "C"
