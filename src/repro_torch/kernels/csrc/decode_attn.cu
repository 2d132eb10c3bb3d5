// Flash decode over a float or an int8 KV cache, for Hopper (sm_90a): a
// split-KV kernel and a merge kernel; and the decode over a slice of the
// head dimension (decode_scores_kernel, decode_apply_kernel), below.
//
// Replaces two Pallas kernels of the JAX package:
//   flash_decode       <- kernels/decode_attn.py      _decode_kernel
//   flash_decode_int8  <- kernels/decode_attn_int8.py _decode_int8_kernel
// One query token per sequence attends over its cache: q (B, Hq, D),
// k/v (B, Hkv, S, D), the G = Hq / Hkv query heads of a KV head together;
// positions >= length[b] are masked.  The int8 variant reads int8 k/v with
// one f32 scale per (position, head), (B, Hkv, S, 1), and applies each
// position's scale after the load.  The running max, sum and accumulator
// are f32, with a 1e-30 floor on the sum; the output is in q's dtype.
//
// length[b] <= 0 masks every position.  The Pallas kernel masks with the
// finite -1e30, so its softmax is then uniform and it returns the mean of V
// over all S positions; so does this kernel (the row takes one equal score,
// 0, at each of its S positions).  length[b] > S reads all S positions.
//
// What bounds it on this card: bytes.  Each cached position is read once
// and used for G dot products and G axpys of length D, about three
// operations per byte, far below the ~295 at which the H100's operations
// would bound it; so f32 on the CUDA cores, no tensor cores.  The least
// time is the cache rows below length[b] over 3.35 TB/s.  What the design
// does about it:
//   - enough blocks to fill the card: the positions of a row are split
//     into chunks of CHUNK = 64, one block per (chunk, KV head, row, group
//     of up to 8 query heads); a block whose chunk starts at or past the
//     row's length exits at once.  The chunk is the grid's slowest
//     dimension, so the blocks of the first chunks, the ones that work,
//     are scheduled first and the exiting ones last.  At llama3.2-3b's decode (B 8, Hkv 8,
//     lengths 529) 9 x 8 x 8 = 576 blocks work, where one block per
//     (KV head, row) gave 64 on 132 SMs.  The grid depends on S, never on
//     the lengths, which stay on the device (no host read, so the step can
//     be captured in a CUDA graph);
//   - every byte of the chunk in flight at once, coalesced: a block copies
//     its 64 K and V rows into shared memory with 16-byte cp.async (a bf16
//     row at D = 128 is 256 contiguous bytes, 16 lanes per row) in three
//     commit groups, K rows 0-31, K rows 32-63, V rows, so the scores of
//     the first K rows are computed while the rest arrive;
//   - scores from shared memory without shuffles: lane l owns position l of
//     a 32-row sub-tile and the four warps split D (16-byte chunk c to warp
//     c % 4), so each K element is loaded and converted once; K rows are
//     padded by 16 bytes, so a quarter-warp's 16-byte loads hit 32 distinct
//     banks; q is staged as f32 and read by broadcast.  The four partial
//     dots are added, scaled, masked and exponentiated by one warp per head.
//     Loops over the block's heads are unrolled to 8 and stop at its G
//     (with the absent heads predicated off, their instructions were issued
//     all the same: G = 3 paid for 8);
//   - P.V with each thread owning four columns of every head over a
//     share of the positions (D / 4 column slices x 128 / (D / 4)
//     position groups: all 128 threads busy at any G), one shared-memory
//     load and conversion of V per position for all heads; the groups'
//     sums are added in group order through shared memory (over the K
//     rows, which are no longer read);
//   - int8 bytes converted with a byte permute and an add (i8x4_to_f32),
//     and each position's K scale applied to its dot product and its V
//     scale to its P: the dequantization of the reference, per position;
//   - the partials merged by a second kernel: each (row, query head,
//     chunk) writes (acc[D], m, l) to an f32 workspace the wrapper
//     allocates, and decode_merge_kernel combines a row's ceil(L / 64)
//     partials with the exact log-sum-exp rule (m = max m_i, l = sum l_i
//     exp(m_i - m), out = sum acc_i exp(m_i - m) / max(l, 1e-30)), reading
//     length on the device; its lanes read the partials' m and l side by
//     side and 16 partials' accumulators at once (one load after another
//     cost a round trip to L2 per partial), and the sums run in a fixed
//     order: the same result run after run, no atomics.
// Not done yet: at llama's decode every working block is resident at once,
// so all of them load, then all compute, and the compute (scores, softmax,
// P.V) does not overlap the loads; blocks that pipeline several chunks,
// the merge within the split kernel, and TMA loads are next.
//
// Layout: split grid (Hkv, B * ceil(G / 8), ceil(S / 64)), 128 threads;
// merge grid ceil(B * Hq / 4), 128 threads, one warp per (row, query head).
// Workspace (B, Hq, ceil(S / 64), D + 4) f32: acc in [0, D), m at D, l at
// D + 1 (rows of D + 4 floats keep the float4 stores aligned).  cp.async of
// 16 bytes needs the data pointer and the b, h, s strides of k and v to be
// multiples of 16 bytes (4 elements in f32, 8 in bf16, 16 in int8): the
// wrapper checks them and copies a tensor that breaks this; the model's
// (B, S, Hkv, D) cache views meet it.
//
// Partial mode (a rank's window of a cache split over positions): k/v hold
// the window [w0, w0 + S) of the whole cache, the lengths are the whole
// rows'.  The merge then writes o in f32 and each row's lse = m + log l; a
// window wholly past the row's length takes no chunk and gives o = 0 and
// lse = -inf, and a row with length <= 0 takes every position of every
// window (equal scores), so the windows' merge is the mean of V over the
// whole cache.  The windows' (o, lse) pairs are merged by the same merge
// kernel, which reads them where the all-gather put them
// (decode_merge_parts).
//
// Plain-C entry points (loaded with ctypes): each launches its kernels on
// the given stream and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a head dim the kernels are not built for.

#include "common.cuh"

namespace {

using repro_torch::NEG;
using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::smem_addr;

constexpr int CHUNK = 64;      // cache positions per split block
constexpr int SUB = 32;        // positions per K sub-tile: one per lane
constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;
constexpr int MAXG = 8;        // query heads per split block
constexpr int PP = CHUNK + 1;  // row of scores, padded against bank conflicts

struct DecodeStrides {
  long long qb, qh;        // q (B, Hq, D)
  long long kb, kh, ks;    // k (B, Hkv, S, D)
  long long vb, vh, vs;    // v
  long long ob, oh;        // out (B, Hq, D)
  long long sb, sh, ss;    // scales (B, Hkv, S, 1), shared by k and v
};

// Shared memory of a split block, in bytes, for GN = min(G, 8) query heads:
//   K    [CHUNK][KP]     the chunk's K rows as loaded, each padded by 16 B
//   V    [CHUNK][ROW]    its V rows as loaded
//   q    [GN][D]         f32
//   sc   [2][CHUNK]      f32 K and V scales (read by the int8 kernel only)
//   part [NW][GN][PP]    f32 partial dot products of each warp; row 0 of
//                        each head then holds P
template <typename TKV, int D>
struct Layout {
  static constexpr int ROW = D * static_cast<int>(sizeof(TKV));
  static constexpr int CPR = ROW / 16;                       // 16 B chunks
  static constexpr int EPC = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int KP = ROW + 16;
  static constexpr int V_OFF = CHUNK * KP;
  static constexpr int Q_OFF = V_OFF + CHUNK * ROW;
  __host__ __device__ static constexpr int sc_off(int gn) {
    return Q_OFF + gn * D * 4;
  }
  __host__ __device__ static constexpr int part_off(int gn) {
    return sc_off(gn) + 2 * CHUNK * 4;
  }
  __host__ __device__ static constexpr int bytes(int gn) {
    return part_off(gn) + NW * gn * PP * 4;
  }
};

// 16 bytes of shared memory as f32: 4 f32, 8 bf16 or 16 int8 elements
__device__ __forceinline__ void unpack16(uint4 w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack16(uint4 w, float (&f)[16]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = repro_torch::i8x4_to_f32(u[i]);
    f[4 * i] = x.x;
    f[4 * i + 1] = x.y;
    f[4 * i + 2] = x.z;
    f[4 * i + 3] = x.w;
  }
}

// One block: positions [64 c, 64 c + cnt) of row b, KV head hk, query
// heads g0 .. g0 + gn - 1; writes their partial (acc, m, l) per head.
template <typename TQ, typename TKV, bool QUANT, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const float* __restrict__ kscale,
                    const TKV* __restrict__ v,
                    const float* __restrict__ vscale, float* __restrict__ ws,
                    const int* __restrict__ length, int S, int Hq, int G,
                    int NC, int w0, float sm_scale, DecodeStrides st) {
  using Lay = Layout<TKV, D>;
  constexpr int CPR = Lay::CPR, EPC = Lay::EPC, KP = Lay::KP,
                ROW = Lay::ROW;
  const int hk = blockIdx.x, c = blockIdx.z;
  const int groups = (G + MAXG - 1) / MAXG;
  const int b = blockIdx.y / groups;
  const int g0 = (blockIdx.y - b * groups) * MAXG;
  const int len = length[b];
  const bool uniform = len <= 0;  // every position masked: equal scores
  // the positions of this window (global w0 onwards) below the length
  const int L = uniform ? S : max(0, min(len - w0, S));
  const int c0 = c * CHUNK;
  if (c0 >= L) return;            // the chunk lies past the row's length
  const int cnt = min(CHUNK, L - c0);
  const int gn = min(MAXG, G - g0), GN = min(MAXG, G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* ksm = smem;
  uint8_t* vsm = smem + Lay::V_OFF;
  float* qs = reinterpret_cast<float*>(smem + Lay::Q_OFF);
  float* sc = reinterpret_cast<float*>(smem + Lay::sc_off(GN));
  float* part = reinterpret_cast<float*>(smem + Lay::part_off(GN));

  // commit groups 0 and 1: K rows [0, 32) (with the scales) and [32, 64);
  // group 2: the V rows.  Rows at or past cnt are zero-filled, not read.
  const TKV* kb = k + b * st.kb + hk * st.kh + c0 * st.ks;
  const TKV* vb = v + b * st.vb + hk * st.vh + c0 * st.vs;
#pragma unroll
  for (int sub = 0; sub < CHUNK / SUB; ++sub) {
    for (int i = tid; i < SUB * CPR; i += NT) {
      const int r = sub * SUB + i / CPR, cc = i % CPR;
      const bool ok = r < cnt;
      cp_async16(smem_addr(ksm + r * KP + cc * 16),
                 kb + (ok ? r * st.ks + cc * EPC : 0), ok);
    }
    if constexpr (QUANT) {
      if (sub == 0 && tid < CHUNK) {
        const bool ok = tid < cnt;
        const long long at = b * st.sb + hk * st.sh +
                             (c0 + (ok ? tid : 0)) * st.ss;
        cp_async4(smem_addr(sc + tid), kscale + at, ok);
        cp_async4(smem_addr(sc + CHUNK + tid), vscale + at, ok);
      }
    }
    cp_async_commit();
  }
  for (int i = tid; i < CHUNK * CPR; i += NT) {
    const int r = i / CPR, cc = i % CPR;
    const bool ok = r < cnt;
    cp_async16(smem_addr(vsm + r * ROW + cc * 16),
               vb + (ok ? r * st.vs + cc * EPC : 0), ok);
  }
  cp_async_commit();

  // q rows of the block's heads as f32, while the copies are in flight
  constexpr int NQ = D / 4;
  for (int i = tid; i < gn * NQ; i += NT) {
    const int g = i / NQ, d = (i % NQ) * 4;
    const TQ* qrow = q + b * st.qb + (hk * G + g0 + g) * st.qh;
    *reinterpret_cast<float4*>(&qs[g * D + d]) = repro_torch::load4(qrow + d);
  }

  // partial scores: lane = position of the sub-tile, warp = D chunks
#pragma unroll
  for (int sub = 0; sub < CHUNK / SUB; ++sub) {
    if (sub == 0) cp_async_wait<2>();
    else cp_async_wait<1>();
    __syncthreads();  // this sub-tile's K rows, the scales and q
    const int r = sub * SUB + lane;
    const uint8_t* krow = ksm + r * KP;
    float dot[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
#pragma unroll
    for (int i = 0; i < (CPR + NW - 1) / NW; ++i) {
      const int cc = warp + i * NW;
      if (cc < CPR) {
        float kf[EPC];
        unpack16(*reinterpret_cast<const uint4*>(krow + cc * 16), kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= gn) break;
#pragma unroll
          for (int e = 0; e < EPC; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&qs[g * D + cc * EPC + e]);
            dot[g] = repro_torch::dot4(
                qv, make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]),
                dot[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= gn) break;
      part[(warp * GN + g) * PP + r] = dot[g];
    }
  }
  __syncthreads();  // every warp's partial dots

  // softmax over the chunk, one warp per head: m, l to the workspace, P
  // (times the V scale of its position) into part's row 0 of the head
  const long long W = D + 4;
  float* wrow = ws + ((static_cast<long long>(b) * Hq + hk * G + g0) * NC + c)
                         * W;                               // head g0's
  for (int g = warp; g < gn; g += NW) {
    float s[CHUNK / 32];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < CHUNK / 32; ++j) {
      const int pos = lane + 32 * j;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) x += part[(w * GN + g) * PP + pos];
      if constexpr (QUANT) x *= sc[pos];
      x = uniform ? 0.f : x * sm_scale;
      s[j] = x;
      if (pos < cnt) mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNK / 32; ++j) {
      const int pos = lane + 32 * j;
      const float p = pos < cnt ? expf(s[j] - mx) : 0.f;
      sum += p;
      part[g * PP + pos] = QUANT ? p * sc[CHUNK + pos] : p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      wrow[g * NC * W + D] = mx;
      wrow[g * NC * W + D + 1] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the V rows and P

  // acc = P.V: thread owns columns [col, col + 4) of every head, over
  // positions pq, pq + PQ, ...; one load and conversion of V a position
  constexpr int NCOL = D / 4;
  constexpr int PQ = NT / NCOL;
  const int col = (tid % NCOL) * 4, pq = tid / NCOL;
  float4 acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int pos = pq; pos < cnt; pos += PQ) {
    const float4 vx = repro_torch::load4(
        reinterpret_cast<const TKV*>(vsm + pos * ROW) + col);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= gn) break;
      repro_torch::axpy4(part[g * PP + pos], vx, acc[g]);
    }
  }
  // the PQ groups' sums added in group order through shared memory, RH
  // heads a round, over the K rows (no longer read)
  constexpr int RH = CHUNK * KP / (NT * 16);
  static_assert(RH >= 1, "a head's partial sums must fit the K rows");
  float4* red = reinterpret_cast<float4*>(ksm);  // [RH][NT]
  for (int h0 = 0; h0 < gn; h0 += RH) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g >= h0 && g < h0 + RH && g < gn) red[(g - h0) * NT + tid] = acc[g];
    __syncthreads();
    for (int i = tid; i < min(RH, gn - h0) * NCOL; i += NT) {
      const int j = i / NCOL, cc = i % NCOL;
      float4 sum = red[j * NT + cc];
#pragma unroll
      for (int r = 1; r < PQ; ++r) {
        const float4 x = red[j * NT + r * NCOL + cc];
        sum = make_float4(sum.x + x.x, sum.y + x.y, sum.z + x.z, sum.w + x.w);
      }
      *reinterpret_cast<float4*>(wrow + (h0 + j) * NC * W + cc * 4) = sum;
    }
    __syncthreads();
  }
}

// One warp per (row, query head): the row's partials, in order, by the
// exact log-sum-exp rule; the output in q's dtype.  PARTS false: ws is the
// split kernel's workspace (B, Hq, NC, D + 4) of (acc, m, l) chunks, those
// that took part counted from the row's length.  PARTS: NC given partials
// of disjoint windows, ws their o (NC, B, Hq, D) and m_in their lse (NC,
// B, Hq), read as (acc, m, l) = (o, lse, 1), every one taking part.
template <typename TQ, bool PARTS>
__global__ void __launch_bounds__(NT)
decode_merge_kernel(const float* __restrict__ ws,
                    const float* __restrict__ m_in, TQ* __restrict__ o,
                    float* __restrict__ lse, const int* __restrict__ length,
                    int B, int Hq, int S, int D, int NC, int w0, long long ob,
                    long long oh) {
  const int row = blockIdx.x * NW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * Hq) return;
  const int b = row / Hq, h = row - b * Hq;
  int nc = NC;  // given partials: every one takes part
  if (!PARTS) {
    const int len = length[b];
    const int L = len <= 0 ? S : max(0, min(len - w0, S));
    nc = (L + CHUNK - 1) / CHUNK;  // the chunks that took part
  }
  const long long BH = static_cast<long long>(B) * Hq;
  const int W = D + 4;
  // partial i's acc at part + i * step; its m and l
  const long long step = PARTS ? BH * D : W;
  const float* part = ws + (PARTS ? row * static_cast<long long>(D)
                                  : row * static_cast<long long>(NC) * W);
  const float* mpart = PARTS ? m_in + row : part + D;
  const long long mstep = PARTS ? BH : W;
  // lane i combines the (m, l) of partials i, i + 32, ...; then the warp
  float m_own = NEG, l_own = 0.f;
  for (int i = lane; i < nc; i += 32) {
    const float mi = mpart[i * mstep];
    const float li = PARTS ? 1.f : part[i * W + D + 1];
    const float mn = fmaxf(m_own, mi);
    l_own = l_own * expf(m_own - mn) + li * expf(mi - mn);
    m_own = mn;
  }
  float mx = m_own;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float l = l_own * expf(m_own - mx);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  const float lv = fmaxf(l, 1e-30f);
  // partial mode: the row's log-sum-exp; -inf where no position took part
  if (lse != nullptr && lane == 0)
    lse[row] = l > 0.f ? mx + logf(l) : -__int_as_float(0x7f800000);
  TQ* orow = o + b * ob + h * oh;
  constexpr int BATCH = 16;  // partials' acc loads in flight at once
  for (int c0 = 0; c0 < D; c0 += 128) {  // every lane: the loop shuffles
    const int col = c0 + lane * 4;
    const bool on = col < D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < nc; i0 += 32) {
      // partial i's weight exp(m_i - m), from lane i % 32 (0 past nc)
      const float f =
          i0 + lane < nc ? expf(mpart[(i0 + lane) * mstep] - mx) : 0.f;
      const int n = min(32, nc - i0);
      for (int i1 = 0; i1 < n; i1 += BATCH) {
        float4 x[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          x[j] = on && i1 + j < n
                     ? *reinterpret_cast<const float4*>(
                           part + (i0 + i1 + j) * step + col)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          repro_torch::axpy4(__shfl_sync(0xffffffffu, f, i1 + j), x[j], acc);
      }
    }
    if (on) {
      repro_torch::store(orow + col, acc.x / lv);
      repro_torch::store(orow + col + 1, acc.y / lv);
      repro_torch::store(orow + col + 2, acc.z / lv);
      repro_torch::store(orow + col + 3, acc.w / lv);
    }
  }
}

template <typename TQ, typename TKV, bool QUANT, int D>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* o, void* lse, const void* length, void* ws,
           int B, int Hq, int Hkv, int S, int w0, float sm_scale,
           const long long* strides, cudaStream_t stream) {
  const DecodeStrides st{strides[0], strides[1], strides[2], strides[3],
                         strides[4], strides[5], strides[6], strides[7],
                         strides[8], strides[9], strides[10], strides[11],
                         strides[12]};
  const int G = Hq / Hkv, GN = G < MAXG ? G : MAXG;
  const int groups = (G + MAXG - 1) / MAXG, NC = (S + CHUNK - 1) / CHUNK;
  const int smem = Layout<TKV, D>::bytes(GN);
  auto split = decode_split_kernel<TQ, TKV, QUANT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  split<<<dim3(Hkv, B * groups, NC), NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const float*>(ks), static_cast<const TKV*>(v),
      static_cast<const float*>(vs), static_cast<float*>(ws),
      static_cast<const int*>(length), S, Hq, G, NC, w0, sm_scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B * Hq + NW - 1) / NW;
  if (lse != nullptr)  // partial mode: o in f32 and the rows' lse
    decode_merge_kernel<float, false><<<grid, NT, 0, stream>>>(
        static_cast<const float*>(ws), nullptr, static_cast<float*>(o),
        static_cast<float*>(lse), static_cast<const int*>(length), B, Hq, S,
        D, NC, w0, st.ob, st.oh);
  else
    decode_merge_kernel<TQ, false><<<grid, NT, 0, stream>>>(
        static_cast<const float*>(ws), nullptr, static_cast<TQ*>(o), nullptr,
        static_cast<const int*>(length), B, Hq, S, D, NC, w0, st.ob, st.oh);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT>
int dispatch(const void* q, const void* k, const void* ks, const void* v,
             const void* vs, void* o, void* lse, const void* length, void* ws,
             int B, int Hq, int Hkv, int S, int D, int w0, float sm_scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<TQ, TKV, QUANT, 32>(q, k, ks, v, vs, o, lse, length, ws, B, Hq, Hkv, S, w0, sm_scale, strides, s);
    case 64: return launch<TQ, TKV, QUANT, 64>(q, k, ks, v, vs, o, lse, length, ws, B, Hq, Hkv, S, w0, sm_scale, strides, s);
    case 128: return launch<TQ, TKV, QUANT, 128>(q, k, ks, v, vs, o, lse, length, ws, B, Hq, Hkv, S, w0, sm_scale, strides, s);
    case 256: return launch<TQ, TKV, QUANT, 256>(q, k, ks, v, vs, o, lse, length, ws, B, Hq, Hkv, S, w0, sm_scale, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Decode over a slice of the head dimension (the cache's head dim split over
// the "model" ranks): two kernels and the merge.
//
// decode_scores_kernel: block (KV head, row, chunk of SCH positions), the
// G query heads of the KV head together.  The chunk's K rows (D' elements
// each: the rank's slice) are copied to shared memory with 16-byte loads,
// once; each thread then takes (position, head) pairs and writes the
// partial dot product over the slice, times sm_scale (and, for an int8
// cache, the whole head's K scale of the position, which every rank holds),
// to scores (B, Hq, W) f32.  Positions at or past the row's length, and
// every position of a row with length <= 0, get 0: the all-reduce over the
// ranks then sums finite numbers only.
//
// decode_apply_kernel: block (KV head, row, chunk of CHUNK positions) over
// the summed scores, as decode_split_kernel's blocks: one warp a head takes
// the chunk's max, its sum of exponentials and P (times the V scale of an
// int8 cache), the chunk's V rows (copied once with 16-byte loads) give
// P.V over the slice, and (acc[D'], m, l) goes to the workspace; then
// decode_merge_kernel combines a row's chunks into o (f32) and lse.  The
// length rule is decode_split_kernel's, window offset included.
//
// What bounds them: the bytes of the K and V slices, each read once.
// Not done yet: the (position, head) products read K from shared memory with
// a stride of a row (bank conflicts), and the scores' round trip through
// global memory is the all-reduce's.
constexpr int SCH = 32;  // positions per scores block

struct SliceStrides {
  long long qb, qh;      // q (B, Hq, D'), or o (B, Hq, D') for the apply
  long long kb, kh, ks;  // the K or V slice (B, Hkv, W, D')
  long long sb, sh, ss;  // the scales (B, Hkv, W, 1)
};

template <typename TKV>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const TKV* src,
                                          int rows, int cpr, long long rs) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(TKV));
  for (int i = threadIdx.x; i < rows * cpr; i += NT) {
    const int r = i / cpr, cc = i - r * cpr;
    *reinterpret_cast<uint4*>(dst + (r * cpr + cc) * 16) =
        *reinterpret_cast<const uint4*>(src + r * rs + cc * EPC);
  }
}

template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(NT)
decode_scores_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const float* __restrict__ kscale,
                     float* __restrict__ scores,
                     const int* __restrict__ length, int W, int Hq, int G,
                     int Dp, int w0, float sm_scale, SliceStrides st) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(TKV));
  const int hk = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * SCH;
  const int len = length[b];
  // valid positions of the window; none are computed in a uniform row
  const int L = len <= 0 ? 0 : max(0, min(len - w0, W));
  const int cnt = max(0, min(SCH, L - c0));
  const int cpr = Dp / EPC, row = Dp * static_cast<int>(sizeof(TKV));
  extern __shared__ float4 smem4[];
  uint8_t* ksm = reinterpret_cast<uint8_t*>(smem4);
  float* qs = reinterpret_cast<float*>(ksm + SCH * row);
  copy_rows(ksm, k + b * st.kb + hk * st.kh + c0 * st.ks, cnt, cpr, st.ks);
  const int nq = Dp / 4;
  for (int i = threadIdx.x; i < G * nq; i += NT) {
    const int g = i / nq, d = (i - g * nq) * 4;
    *reinterpret_cast<float4*>(&qs[g * Dp + d]) =
        repro_torch::load4(q + b * st.qb + (hk * G + g) * st.qh + d);
  }
  __syncthreads();
  float* srow = scores + (static_cast<long long>(b) * Hq + hk * G) * W;
  for (int i = threadIdx.x; i < SCH * G; i += NT) {
    const int g = i / SCH, r = i - g * SCH, pos = c0 + r;
    if (pos >= W) continue;
    float x = 0.f;
    if (r < cnt) {
      const uint8_t* krow = ksm + r * row;
      const float* qg = qs + g * Dp;
      float dot = 0.f;
      for (int cc = 0; cc < cpr; ++cc) {
        float kf[EPC];
        unpack16(*reinterpret_cast<const uint4*>(krow + cc * 16), kf);
#pragma unroll
        for (int e = 0; e < EPC; e += 4)
          dot = repro_torch::dot4(
              *reinterpret_cast<const float4*>(qg + cc * EPC + e),
              make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]), dot);
      }
      if constexpr (QUANT) dot *= kscale[b * st.sb + hk * st.sh + pos * st.ss];
      x = dot * sm_scale;
    }
    srow[static_cast<long long>(g) * W + pos] = x;
  }
}

template <typename TKV, bool QUANT>
__global__ void __launch_bounds__(NT)
decode_apply_kernel(const float* __restrict__ scores,
                    const TKV* __restrict__ v,
                    const float* __restrict__ vscale, float* __restrict__ ws,
                    const int* __restrict__ length, int W, int Hq, int G,
                    int Dp, int NC, int w0, SliceStrides st) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(TKV));
  const int hk = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int c0 = c * CHUNK;
  const int len = length[b];
  const bool uniform = len <= 0;
  const int L = uniform ? W : max(0, min(len - w0, W));
  if (c0 >= L) return;
  const int cnt = min(CHUNK, L - c0);
  const int cpr = Dp / EPC, row = Dp * static_cast<int>(sizeof(TKV));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ float4 smem4[];
  uint8_t* vsm = reinterpret_cast<uint8_t*>(smem4);
  float* psm = reinterpret_cast<float*>(vsm + CHUNK * row);  // [G][CHUNK]
  copy_rows(vsm, v + b * st.kb + hk * st.kh + c0 * st.ks, cnt, cpr, st.ks);
  const long long Wr = Dp + 4;
  for (int g = warp; g < G; g += NW) {
    const int h = hk * G + g;
    const float* srow = scores + (static_cast<long long>(b) * Hq + h) * W + c0;
    float s[CHUNK / 32];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < CHUNK / 32; ++j) {
      const int pos = lane + 32 * j;
      s[j] = pos < cnt ? (uniform ? 0.f : srow[pos]) : NEG;
      if (pos < cnt) mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNK / 32; ++j) {
      const int pos = lane + 32 * j;
      float p = 0.f;
      if (pos < cnt) {
        p = expf(s[j] - mx);
        sum += p;
        if constexpr (QUANT)
          p *= vscale[b * st.sb + hk * st.sh + (c0 + pos) * st.ss];
      }
      psm[g * CHUNK + pos] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      float* wrow = ws + ((static_cast<long long>(b) * Hq + h) * NC + c) * Wr;
      wrow[Dp] = mx;
      wrow[Dp + 1] = sum;
    }
  }
  __syncthreads();
  const int ncol = Dp / 4;
  for (int i = tid; i < G * ncol; i += NT) {
    const int g = i / ncol, col = (i - g * ncol) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int pos = 0; pos < cnt; ++pos)
      repro_torch::axpy4(psm[g * CHUNK + pos],
                         repro_torch::load4(
                             reinterpret_cast<const TKV*>(vsm + pos * row) + col),
                         acc);
    float* wrow =
        ws + ((static_cast<long long>(b) * Hq + hk * G + g) * NC + c) * Wr;
    *reinterpret_cast<float4*>(wrow + col) = acc;
  }
}

SliceStrides slice_strides(const long long* s) {
  return SliceStrides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
}

template <typename TQ, typename TKV, bool QUANT>
int launch_scores(const void* q, const void* k, const void* ks, void* sc,
                  const void* length, int B, int Hq, int Hkv, int W, int Dp,
                  int w0, float sm_scale, const long long* strides,
                  void* stream) {
  if (Dp % (16 / static_cast<int>(sizeof(TKV))) || Dp % 4 || Dp > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const int smem = SCH * Dp * static_cast<int>(sizeof(TKV)) + G * Dp * 4;
  auto fn = decode_scores_kernel<TQ, TKV, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<dim3(Hkv, B, (W + SCH - 1) / SCH), NT, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const float*>(ks), static_cast<float*>(sc),
      static_cast<const int*>(length), W, Hq, G, Dp, w0, sm_scale,
      slice_strides(strides));
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, bool QUANT>
int launch_apply(const void* sc, const void* v, const void* vs, void* o,
                 void* lse, const void* length, void* ws, int B, int Hq,
                 int Hkv, int W, int Dp, int w0, const long long* strides,
                 void* stream) {
  if (Dp % (16 / static_cast<int>(sizeof(TKV))) || Dp % 4 || Dp > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv, NC = (W + CHUNK - 1) / CHUNK;
  const int smem = CHUNK * Dp * static_cast<int>(sizeof(TKV)) + G * CHUNK * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fn = decode_apply_kernel<TKV, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SliceStrides st = slice_strides(strides);
  fn<<<dim3(Hkv, B, NC), NT, smem, s>>>(
      static_cast<const float*>(sc), static_cast<const TKV*>(v),
      static_cast<const float*>(vs), static_cast<float*>(ws),
      static_cast<const int*>(length), W, Hq, G, Dp, NC, w0, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<float, false><<<(B * Hq + NW - 1) / NW, NT, 0, s>>>(
      static_cast<const float*>(ws), nullptr, static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const int*>(length), B, Hq, W,
      Dp, NC, w0, st.qb, st.qh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ws: the f32 workspace (B, Hq, ceil(S / CHUNK), D + 4).  strides: 13
// element strides: q (b, h), k (b, h, s), v (b, h, s), out (b, h), scales
// (b, h, s); the scale strides are ignored by the float kernels.  w0: the
// first position of the window k/v hold, of the whole cache (0 for a whole
// cache).  lse: null, or the partial mode: out is f32 and lse (B, Hq) f32
// gets each row's log-sum-exp (-inf where no position of the window is
// below the row's length).
int flash_decode_f32(const void* q, const void* k, const void* v, void* o,
                     void* lse, const void* length, void* ws, int B, int Hq,
                     int Hkv, int S, int D, int w0, float sm_scale,
                     const long long* strides, void* stream) {
  return dispatch<float, float, false>(q, k, nullptr, v, nullptr, o, lse,
                                       length, ws, B, Hq, Hkv, S, D, w0,
                                       sm_scale, strides, stream);
}

int flash_decode_bf16(const void* q, const void* k, const void* v, void* o,
                      void* lse, const void* length, void* ws, int B, int Hq,
                      int Hkv, int S, int D, int w0, float sm_scale,
                      const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, nullptr, v, nullptr, o, lse, length, ws, B, Hq, Hkv, S, D, w0,
      sm_scale, strides, stream);
}

int flash_decode_int8_f32(const void* q, const void* k8, const void* ks,
                          const void* v8, const void* vs, void* o, void* lse,
                          const void* length, void* ws, int B, int Hq,
                          int Hkv, int S, int D, int w0, float sm_scale,
                          const long long* strides, void* stream) {
  return dispatch<float, int8_t, true>(q, k8, ks, v8, vs, o, lse, length, ws,
                                       B, Hq, Hkv, S, D, w0, sm_scale,
                                       strides, stream);
}

int flash_decode_int8_bf16(const void* q, const void* k8, const void* ks,
                           const void* v8, const void* vs, void* o,
                           void* lse, const void* length, void* ws, int B,
                           int Hq, int Hkv, int S, int D, int w0,
                           float sm_scale, const long long* strides,
                           void* stream) {
  return dispatch<__nv_bfloat16, int8_t, true>(q, k8, ks, v8, vs, o, lse,
                                               length, ws, B, Hq, Hkv, S, D,
                                               w0, sm_scale, strides, stream);
}

// n partials of disjoint windows merged: op (n, B, Hq, D) f32 their o and
// lp (n, B, Hq) f32 their lse, both contiguous; o (B, Hq, D) f32
// contiguous; lse (B, Hq) f32 or null.
int decode_merge_parts(const void* op, const void* lp, void* o, void* lse,
                       int B, int Hq, int n, int D, void* stream) {
  if (D % 4) return static_cast<int>(cudaErrorInvalidValue);
  decode_merge_kernel<float, true><<<(B * Hq + NW - 1) / NW, NT, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(op), static_cast<const float*>(lp),
      static_cast<float*>(o), static_cast<float*>(lse), nullptr, B, Hq, 0, D,
      n, 0, static_cast<long long>(Hq) * D, D);
  return static_cast<int>(cudaGetLastError());
}

// scores (B, Hq, W) f32 contiguous; strides: q (b, h), k (b, h, s), scales
// (b, h, s) (ignored by the float kernels).  D' (Dp): the slice's elements,
// a multiple of 16 bytes and of 4, at most 256.
int decode_scores_f32(const void* q, const void* k, const void* ks, void* sc,
                      const void* length, int B, int Hq, int Hkv, int W,
                      int Dp, int w0, float sm_scale,
                      const long long* strides, void* stream) {
  return launch_scores<float, float, false>(q, k, ks, sc, length, B, Hq, Hkv,
                                            W, Dp, w0, sm_scale, strides,
                                            stream);
}

int decode_scores_bf16(const void* q, const void* k, const void* ks,
                       void* sc, const void* length, int B, int Hq, int Hkv,
                       int W, int Dp, int w0, float sm_scale,
                       const long long* strides, void* stream) {
  return launch_scores<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, ks, sc, length, B, Hq, Hkv, W, Dp, w0, sm_scale, strides, stream);
}

int decode_scores_int8_f32(const void* q, const void* k, const void* ks,
                           void* sc, const void* length, int B, int Hq,
                           int Hkv, int W, int Dp, int w0, float sm_scale,
                           const long long* strides, void* stream) {
  return launch_scores<float, int8_t, true>(q, k, ks, sc, length, B, Hq, Hkv,
                                            W, Dp, w0, sm_scale, strides,
                                            stream);
}

int decode_scores_int8_bf16(const void* q, const void* k, const void* ks,
                            void* sc, const void* length, int B, int Hq,
                            int Hkv, int W, int Dp, int w0, float sm_scale,
                            const long long* strides, void* stream) {
  return launch_scores<__nv_bfloat16, int8_t, true>(
      q, k, ks, sc, length, B, Hq, Hkv, W, Dp, w0, sm_scale, strides, stream);
}

// o (B, Hq, D') f32 and lse (B, Hq) f32; ws (B, Hq, ceil(W / CHUNK), D' + 4)
// f32; strides: o (b, h), v (b, h, s), scales (b, h, s).
int decode_apply_f32(const void* sc, const void* v, const void* vs, void* o,
                     void* lse, const void* length, void* ws, int B, int Hq,
                     int Hkv, int W, int Dp, int w0,
                     const long long* strides, void* stream) {
  return launch_apply<float, false>(sc, v, vs, o, lse, length, ws, B, Hq,
                                    Hkv, W, Dp, w0, strides, stream);
}

int decode_apply_bf16(const void* sc, const void* v, const void* vs, void* o,
                      void* lse, const void* length, void* ws, int B, int Hq,
                      int Hkv, int W, int Dp, int w0,
                      const long long* strides, void* stream) {
  return launch_apply<__nv_bfloat16, false>(sc, v, vs, o, lse, length, ws, B,
                                            Hq, Hkv, W, Dp, w0, strides,
                                            stream);
}

int decode_apply_int8(const void* sc, const void* v, const void* vs, void* o,
                      void* lse, const void* length, void* ws, int B, int Hq,
                      int Hkv, int W, int Dp, int w0,
                      const long long* strides, void* stream) {
  return launch_apply<int8_t, true>(sc, v, vs, o, lse, length, ws, B, Hq, Hkv,
                                    W, Dp, w0, strides, stream);
}

}  // extern "C"
