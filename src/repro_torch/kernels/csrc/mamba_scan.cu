// Selective scan (Mamba-1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package:
//   selective_scan <- kernels/mamba_scan.py _scan_kernel
// For each sequence b and channel d, with a diagonal A and a state of N:
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
// 67 TFLOP/s).  The B*L*Din*N exponentials run on the special-function
// units, 16 per clock per SM: 0.13 ms at that shape, the floor this kernel
// meets first.  So each (b, t, d, n) costs one MUFU.EX2 (ex2 of dt * A *
// log2 e, with A * log2 e formed once per state) and four f32 operations
// (dt A, dt u B, the state's FMA, the output's FMA), nothing more.
//
// The design.  The recurrence is diagonal in n: each of a channel's N
// states is an independent scan.  A channel's states are spread over G
// lanes of one warp, S states each, G S = 16 columns a group (a state of
// N < 16 runs with its missing columns zero: A, B and C read as 0, so
// those states stay 0; a state of N > 16 runs as ceil(N / 16) groups one
// after another in the same block: y is the groups' outputs added in
// order, the first adding D * u, hT their states side by side).  Fewer
// states a lane means fewer registers and more warps, at more shuffles a
// state; so the launch plan (mamba_scan.py scan_plan) starts at S = 8 and
// halves S, doubling G, until B * Din * G lanes fill the card (132 SMs x
// 8 warps), down to S = 2, and only while the wider grid stays resident
// at the 4 blocks an SM its launch bound allows.  At B = 8 x 8192 that is
// S = 8, G = 2 (4,096 warps, all resident at the 8 blocks per SM the
// launch bound demands); at the batcher's B = 1 it is S = 2, G = 8 (2,048
// warps, under 4 blocks an SM) at every L, each (b, t, d, n) taking one
// exponential as at B = 8.  Time is never split: every block walks all L
// steps of its channels, so no exponential is spent twice and no state is
// carried between blocks.  (S, G) are template arguments: every
// shared-memory offset and the lanes' sum are compile-time.  The G lanes
// of a channel sum their shares of y_t for G steps at once by a
// reduce-scatter (G - 1 shuffles for G steps; lane g ends with step g's
// sum), in a fixed order.
//
// A block walks L a round of TT steps at a time (TT x channels =
// 1,024 in bf16, 512 in f32).  The next round's u, dt, B and C are copied
// into shared memory by 16-byte cp.async (zero-filled past Din and N;
// plain loads where pointers or strides do not allow it: B and C are read
// through any strides, since the model passes column slices of one
// projection) while this round computes; then the block converts the
// round to f32, u and dt as {dt, u} pairs (one 8-byte shared load a step),
// rows past L as zeros (a step with dt = 0 and B = C = 0
// changes nothing).  A lane reads its S columns of B_t and C_t with
// 16-byte shared loads (8-byte at S = 2).  The round's y goes to shared
// memory and out with 16-byte stores, D * u added.  Loaded in turn with
// the compute, behind the round's barriers, the operands took a third of
// the time at B = 1 (PERF.md).  Registers (ptxas, printed by chip_smoke.py
// phase 1): the launch bound keeps them at 64 (G = 2) or 128 (G >= 4),
// with no spills (PERF.md).  Deterministic: no atomics, every sum in a
// fixed order.
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int THREADS = 128;    // threads per block
// Blocks per SM the registers must allow (64 registers a thread at 8,
// 128 at 4).  The plan widens a channel to G >= 4 lanes only where the
// wider grid has at most 132 x 4 blocks: 4 a SM hold it at once, and the
// registers go to the G steps that the lanes' sum takes at a time.
template <int G>
constexpr int min_blocks() { return G >= 4 ? 4 : 8; }
constexpr int GW = 16;          // state columns a group: one walk's
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* u;
  const void* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* dskip;
  float* y;
  float* hT;
  int B, L, D, N;
  int groups;              // ceil(N / GW)
  int vec;                 // bit 0: u and dt rows take 16-byte copies;
                           // bit 1: B and C rows (unit column stride)
  long long ub, ul;        // u (B, L, Din), last stride 1
  long long db, dl;        // dt (B, L, Din), last stride 1
  long long bb, bl, bn;    // B (B, L, N)
  long long cb, cl, cn;    // C (B, L, N)
};

// The shapes of one instantiation: S states a lane, G lanes a channel
// (G S = GW), CH channels a block, TT steps a round.
template <typename T, int S, int G>
struct Shape {
  static constexpr int CH = THREADS / G;
  static constexpr int TT = (sizeof(T) == 2 ? 8 : 4) * G;
  static constexpr int VEC = 16 / sizeof(T);   // elements a 16-byte copy
  static_assert(G * S == GW && THREADS % G == 0 && 32 % G == 0);
  static_assert(CH % VEC == 0 && GW % VEC == 0);
};

// A block's shared memory: a round of operands in f32, and two stages of
// raw (T) operands, the next round's in flight while this one computes.
template <typename T, int S, int G>
struct Tiles {
  using Sh = Shape<T, S, G>;
  alignas(16) float2 sud[Sh::TT * Sh::CH];   // {dt, u}
  alignas(16) float sy[Sh::TT * Sh::CH];     // the round's sums over N
  alignas(16) float sb[Sh::TT * GW];         // B, this group's columns
  alignas(16) float sc[Sh::TT * GW];         // C
  alignas(16) T ru[2][Sh::TT * Sh::CH];
  alignas(16) T rd[2][Sh::TT * Sh::CH];
  alignas(16) T rb[2][Sh::TT * GW];
  alignas(16) T rc[2][Sh::TT * GW];
};

// 2^x as one MUFU.EX2 (x <= 0 here; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// S consecutive f32 of shared memory (S = 2, 4 or 8), aligned to min(S, 4)
// floats
template <int S>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (S >= 4) {
#pragma unroll
    for (int i = 0; i < S; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
}

// The block's sequence and first channel, read afresh where they are used:
// the compiler cannot hoist a volatile read out of the round loop, so the
// round's global addresses are formed each round from the kernel's
// parameters instead of held in registers across the steps (which spilled)
__device__ __forceinline__ int block_b() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int block_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}

// 16 bytes global -> shared, asynchronously, through L2: the first
// `bytes` read, the rest zero (src stays a valid address where bytes is 0)
__device__ __forceinline__ void cp_async16n(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   repro_torch::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// Start copying u and dt of steps [t0, t0 + tn), channels [ch0, ch0 + CH),
// and columns [col0, col0 + GW) of B and C into raw stage st: 16-byte
// cp.async where the flags allow (zero past Din and N), else plain loads.
// THREADS is a multiple of CH / VEC, so each thread keeps one column of
// VEC channels.
template <typename T, int S, int G>
__device__ __forceinline__ void issue_round(const Params& p,
                                            Tiles<T, S, G>& tl, int st,
                                            int col0, int t0, int tn) {
  using Sh = Shape<T, S, G>;
  constexpr int CH = Sh::CH, VEC = Sh::VEC, NV = CH / VEC;
  const int b = block_b(), ch0 = block_x() * CH;
  const T* pu = static_cast<const T*>(p.u) + b * p.ub + t0 * p.ul;
  const T* pd = static_cast<const T*>(p.dt) + b * p.db + t0 * p.dl;
  const int c = (threadIdx.x % NV) * VEC, ch = ch0 + c;
  if (p.vec & 1) {
    const int bytes = ch >= p.D ? 0 : min(VEC, p.D - ch) * int(sizeof(T));
    for (int t = threadIdx.x / NV; t < tn; t += THREADS / NV) {
      cp_async16n(&tl.ru[st][t * CH + c], bytes ? pu + t * p.ul + ch : pu,
                  bytes);
      cp_async16n(&tl.rd[st][t * CH + c], bytes ? pd + t * p.dl + ch : pd,
                  bytes);
    }
  } else {
    for (int t = threadIdx.x / NV; t < tn; t += THREADS / NV)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool ok = ch + j < p.D;
        tl.ru[st][t * CH + c + j] = ok ? pu[t * p.ul + ch + j] : T(0.f);
        tl.rd[st][t * CH + c + j] = ok ? pd[t * p.dl + ch + j] : T(0.f);
      }
  }
  const T* pb = static_cast<const T*>(p.bm) + b * p.bb + t0 * p.bl;
  const T* pc = static_cast<const T*>(p.cm) + b * p.cb + t0 * p.cl;
  if (p.vec & 2) {                 // bn = cn = 1
    constexpr int PR = GW / VEC;
    for (int i = threadIdx.x; i < tn * PR; i += THREADS) {
      const int t = i / PR, j = (i % PR) * VEC, col = col0 + j;
      const int bytes =
          col >= p.N ? 0 : min(VEC, p.N - col) * int(sizeof(T));
      cp_async16n(&tl.rb[st][t * GW + j], bytes ? pb + t * p.bl + col : pb,
                  bytes);
      cp_async16n(&tl.rc[st][t * GW + j], bytes ? pc + t * p.cl + col : pc,
                  bytes);
    }
    return;
  }
  for (int i = threadIdx.x; i < tn * GW; i += THREADS) {
    const int t = i / GW, col = col0 + i % GW;
    const bool ok = col < p.N;
    tl.rb[st][i] = ok ? pb[t * p.bl + col * p.bn] : T(0.f);
    tl.rc[st][i] = ok ? pc[t * p.cl + col * p.cn] : T(0.f);
  }
}

// Raw stage st of a round of tn steps to f32: {dt, u} pairs, B and C.
// Rows tn .. TT-1 become zeros: a step with dt = u = 0 and B = C = 0
// leaves the state as it is (2^0 = 1) and adds 0 to y.
template <typename T, int S, int G>
__device__ __forceinline__ void convert_round(Tiles<T, S, G>& tl, int st,
                                              int tn) {
  using Sh = Shape<T, S, G>;
  constexpr int CH = Sh::CH, TT = Sh::TT;
  for (int i = threadIdx.x * 4; i < TT * CH; i += THREADS * 4) {
    float4 u4 = make_float4(0.f, 0.f, 0.f, 0.f), d4 = u4;
    if (i < tn * CH) {
      u4 = repro_torch::load4(&tl.ru[st][i]);
      d4 = repro_torch::load4(&tl.rd[st][i]);
    }
    float4* dst = reinterpret_cast<float4*>(&tl.sud[i]);
    dst[0] = make_float4(d4.x, u4.x, d4.y, u4.y);
    dst[1] = make_float4(d4.z, u4.z, d4.w, u4.w);
  }
  for (int i = threadIdx.x * 4; i < TT * GW; i += THREADS * 4) {
    const bool live = i < tn * GW;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&tl.sb[i]) =
        live ? repro_torch::load4(&tl.rb[st][i]) : z;
    *reinterpret_cast<float4*>(&tl.sc[i]) =
        live ? repro_torch::load4(&tl.rc[st][i]) : z;
  }
}

// y of steps [t0, t0 + tn) and channels [ch0, ch0 + CH) from sy: group 0
// adds D * u to its sum and stores; a later group adds its sum to y
template <typename T, int S, int G>
__device__ __forceinline__ void store_y(const Params& p,
                                        const Tiles<T, S, G>& tl, int grp,
                                        int t0, int tn) {
  constexpr int CH = Shape<T, S, G>::CH, NV = CH / 4;
  const int b = block_b(), ch0 = block_x() * CH;
  const int c = (threadIdx.x % NV) * 4, ch = ch0 + c;
  const bool vec = p.D % 4 == 0 && ch + 4 <= p.D;
  float dsk[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    dsk[j] = ch + j < p.D ? p.dskip[ch + j] : 0.f;
  float* yb = p.y + (static_cast<long long>(b) * p.L + t0) * p.D + ch;
  for (int t = threadIdx.x / NV; t < tn; t += THREADS / NV) {
    float* py = yb + static_cast<long long>(t) * p.D;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t * CH + c + j;
      v[j] = grp == 0 ? fmaf(dsk[j], tl.sud[i].y, tl.sy[i]) : tl.sy[i];
    }
    if (vec) {
      float4 o = make_float4(v[0], v[1], v[2], v[3]);
      if (grp) {
        const float4 old = *reinterpret_cast<const float4*>(py);
        o = make_float4(old.x + o.x, old.y + o.y, old.z + o.z, old.w + o.w);
      }
      *reinterpret_cast<float4*>(py) = o;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ch + j < p.D) py[j] = grp ? py[j] + v[j] : v[j];
    }
  }
}

// One step of the lane's S states; returns their share of y_t.
template <int S>
__device__ __forceinline__ float step(float2 v, const float* bp,
                                      const float* cp, const float (&a2)[S],
                                      float (&h)[S]) {
  const float dtu = v.x * v.y;                 // v = {dt, u}
  float bv[S], cv[S];
  lds<S>(bp, bv);
  lds<S>(cp, cv);
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    h[s] = fmaf(h[s], ex2(v.x * a2[s]), dtu * bv[s]);
    acc = fmaf(h[s], cv[s], acc);
  }
  return acc;
}

// One state group of one block: the lane's S states h walk all L steps, a
// round of TT steps at a time, the next round's operands copied while
// this one computes.  G steps at a time, the channel's G lanes sum their
// shares of y_t by a reduce-scatter (lane g ends with step g's sum: G - 1
// shuffles for G steps) and store it.
template <typename T, int S, int G>
__device__ __forceinline__ void walk(const Params& p, Tiles<T, S, G>& tl,
                                     int grp, const float (&a2)[S],
                                     float (&h)[S]) {
  using Sh = Shape<T, S, G>;
  constexpr int CH = Sh::CH, TT = Sh::TT;
  const int cl = threadIdx.x / G, g = threadIdx.x % G, col0 = grp * GW;
  issue_round(p, tl, 0, col0, 0, min(TT, p.L));
  repro_torch::cp_async_commit();
  int st = 0;
  for (int t0 = 0; t0 < p.L; t0 += TT, st ^= 1) {
    const int tn = min(TT, p.L - t0);
    if (t0 + TT < p.L)
      issue_round(p, tl, st ^ 1, col0, t0 + TT, min(TT, p.L - t0 - TT));
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<1>();   // this round's copies have landed
    __syncthreads();                   // everyone's, and the last round is read
    convert_round(tl, st, tn);
    __syncthreads();
    for (int t = 0; t < tn; t += G) {
      float acc[G];
#pragma unroll
      for (int j = 0; j < G; ++j)
        acc[j] = step<S>(tl.sud[(t + j) * CH + cl],
                         &tl.sb[(t + j) * GW + g * S],
                         &tl.sc[(t + j) * GW + g * S], a2, h);
#pragma unroll
      for (int o = G / 2; o >= 1; o /= 2) {
        const bool up = g & o;       // keeps the upper half of acc[0, 2o)
#pragma unroll
        for (int i = 0; i < o; ++i) {
          const float send = up ? acc[i] : acc[i + o];
          acc[i] = (up ? acc[i + o] : acc[i]) +
                   __shfl_xor_sync(FULL, send, o);
        }
      }
      if (t + g < tn) tl.sy[(t + g) * CH + cl] = acc[0];
    }
    __syncthreads();
    store_y(p, tl, grp, t0, tn);
  }
}

// the lane's A * log2 e for its columns (0 past column N or channel Din)
template <int S>
__device__ __forceinline__ void load_a2(const Params& p, int ch, int col0,
                                        float (&a2)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int col = col0 + s;
    a2[s] = ch < p.D && col < p.N
        ? p.a[static_cast<long long>(ch) * p.N + col] * LOG2E : 0.f;
  }
}

// Each block: CH channels of sequence blockIdx.y, every state group in
// turn; y, and hT at the end of each group's walk.
template <typename T, int S, int G>
__global__ void __launch_bounds__(THREADS, min_blocks<G>())
scan_lanes_kernel(const Params p) {
  __shared__ Tiles<T, S, G> tl;
  const int cl = threadIdx.x / G, g = threadIdx.x % G;
  const int ch = blockIdx.x * (THREADS / G) + cl;
  for (int grp = 0; grp < p.groups; ++grp) {
    const int col0 = grp * GW + g * S;
    float a2[S], h[S];
    load_a2<S>(p, ch, col0, a2);
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = 0.f;
    walk<T, S, G>(p, tl, grp, a2, h);
    if (ch < p.D) {
      float* hb = p.hT + (static_cast<long long>(blockIdx.y) * p.D + ch) *
                             p.N;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (col0 + s < p.N) hb[col0 + s] = h[s];
    }
  }
}

template <typename T, int S, int G>
int launch(Params p, int tile, cudaStream_t stream) {
  using Sh = Shape<T, S, G>;
  if (tile != Sh::TT) return static_cast<int>(cudaErrorInvalidValue);
  p.groups = (p.N + GW - 1) / GW;
  const unsigned gx = (p.D + Sh::CH - 1) / Sh::CH;
  scan_lanes_kernel<T, S, G><<<dim3(gx, p.B), THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the (S, G) pairs scan_plan chooses: S from 8 down to 2, G S = GW
template <typename T>
int dispatch(const void* u, const void* dt, const void* a, const void* bm,
             const void* cm, const void* dskip, void* y, void* hT, int B,
             int L, int D, int N, int S, int G, int tile, int vec,
             const long long* s, void* stream) {
  const Params p{u, dt, static_cast<const float*>(a), bm, cm,
                 static_cast<const float*>(dskip), static_cast<float*>(y),
                 static_cast<float*>(hT), B, L, D, N, 0, vec,
                 s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]};
  if (B < 1 || B > 65535 || L < 1 || D < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (S * 100 + G) {
    case 802: return launch<T, 8, 2>(p, tile, cs);
    case 404: return launch<T, 4, 4>(p, tile, cs);
    case 208: return launch<T, 2, 8>(p, tile, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// plan: S states a lane, G lanes a channel, tile steps a round (checked
// against the instantiation's), vec (bit 0: u and dt rows take 16-byte
// copies, bit 1: B and C rows).  strides: 10 element strides: u (b, l),
// dt (b, l), B (b, l, n), C (b, l, n)
int selective_scan_f32(const void* u, const void* dt, const void* a,
                       const void* bm, const void* cm, const void* dskip,
                       void* y, void* hT, int B, int L, int D, int N, int S,
                       int G, int tile, int vec, const long long* strides,
                       void* stream) {
  return dispatch<float>(u, dt, a, bm, cm, dskip, y, hT, B, L, D, N, S, G,
                         tile, vec, strides, stream);
}

int selective_scan_bf16(const void* u, const void* dt, const void* a,
                        const void* bm, const void* cm, const void* dskip,
                        void* y, void* hT, int B, int L, int D, int N, int S,
                        int G, int tile, int vec, const long long* strides,
                        void* stream) {
  return dispatch<__nv_bfloat16>(u, dt, a, bm, cm, dskip, y, hT, B, L, D, N,
                                 S, G, tile, vec, strides, stream);
}

}  // extern "C"
