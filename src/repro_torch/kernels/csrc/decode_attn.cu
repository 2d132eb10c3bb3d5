// Flash decode over a float or an int8 KV cache, for Hopper (sm_90a): a
// split-KV kernel and a merge kernel.
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
// Plain-C entry points (loaded with ctypes): each launches both kernels on
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
                    int NC, float sm_scale, DecodeStrides st) {
  using Lay = Layout<TKV, D>;
  constexpr int CPR = Lay::CPR, EPC = Lay::EPC, KP = Lay::KP,
                ROW = Lay::ROW;
  const int hk = blockIdx.x, c = blockIdx.z;
  const int groups = (G + MAXG - 1) / MAXG;
  const int b = blockIdx.y / groups;
  const int g0 = (blockIdx.y - b * groups) * MAXG;
  const int len = length[b];
  const bool uniform = len <= 0;  // every position masked: equal scores
  const int L = uniform ? S : min(len, S);
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

// One warp per (row, query head): the row's partials, in chunk order, by
// the exact log-sum-exp rule; the output in q's dtype.
template <typename TQ>
__global__ void __launch_bounds__(NT)
decode_merge_kernel(const float* __restrict__ ws, TQ* __restrict__ o,
                    const int* __restrict__ length, int B, int Hq, int S,
                    int D, int NC, long long ob, long long oh) {
  const int row = blockIdx.x * NW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * Hq) return;
  const int b = row / Hq, h = row - b * Hq;
  const int len = length[b];
  const int L = len <= 0 ? S : min(len, S);
  const int nc = (L + CHUNK - 1) / CHUNK;  // the chunks that took part
  const int W = D + 4;
  const float* part = ws + static_cast<long long>(row) * NC * W;
  // lane i combines the (m, l) of partials i, i + 32, ...; then the warp
  float m_own = NEG, l_own = 0.f;
  for (int i = lane; i < nc; i += 32) {
    const float mi = part[i * W + D], li = part[i * W + D + 1];
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
  TQ* orow = o + b * ob + h * oh;
  constexpr int BATCH = 16;  // partials' acc loads in flight at once
  for (int c0 = 0; c0 < D; c0 += 128) {  // every lane: the loop shuffles
    const int col = c0 + lane * 4;
    const bool on = col < D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < nc; i0 += 32) {
      // partial i's weight exp(m_i - m), from lane i % 32 (0 past nc)
      const float f = i0 + lane < nc ? expf(part[(i0 + lane) * W + D] - mx)
                                     : 0.f;
      const int n = min(32, nc - i0);
      for (int i1 = 0; i1 < n; i1 += BATCH) {
        float4 x[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          x[j] = on && i1 + j < n
                     ? *reinterpret_cast<const float4*>(
                           part + (i0 + i1 + j) * W + col)
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
           const void* vs, void* o, const void* length, void* ws, int B,
           int Hq, int Hkv, int S, float sm_scale, const long long* strides,
           cudaStream_t stream) {
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
      static_cast<const int*>(length), S, Hq, G, NC, sm_scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<TQ><<<(B * Hq + NW - 1) / NW, NT, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<TQ*>(o),
      static_cast<const int*>(length), B, Hq, S, D, NC, st.ob, st.oh);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT>
int dispatch(const void* q, const void* k, const void* ks, const void* v,
             const void* vs, void* o, const void* length, void* ws, int B,
             int Hq, int Hkv, int S, int D, float sm_scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<TQ, TKV, QUANT, 32>(q, k, ks, v, vs, o, length, ws, B, Hq, Hkv, S, sm_scale, strides, s);
    case 64: return launch<TQ, TKV, QUANT, 64>(q, k, ks, v, vs, o, length, ws, B, Hq, Hkv, S, sm_scale, strides, s);
    case 128: return launch<TQ, TKV, QUANT, 128>(q, k, ks, v, vs, o, length, ws, B, Hq, Hkv, S, sm_scale, strides, s);
    case 256: return launch<TQ, TKV, QUANT, 256>(q, k, ks, v, vs, o, length, ws, B, Hq, Hkv, S, sm_scale, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// ws: the f32 workspace (B, Hq, ceil(S / CHUNK), D + 4).  strides: 13
// element strides: q (b, h), k (b, h, s), v (b, h, s), out (b, h), scales
// (b, h, s); the scale strides are ignored here
int flash_decode_f32(const void* q, const void* k, const void* v, void* o,
                     const void* length, void* ws, int B, int Hq, int Hkv,
                     int S, int D, float sm_scale, const long long* strides,
                     void* stream) {
  return dispatch<float, float, false>(q, k, nullptr, v, nullptr, o, length,
                                       ws, B, Hq, Hkv, S, D, sm_scale,
                                       strides, stream);
}

int flash_decode_bf16(const void* q, const void* k, const void* v, void* o,
                      const void* length, void* ws, int B, int Hq, int Hkv,
                      int S, int D, float sm_scale, const long long* strides,
                      void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, nullptr, v, nullptr, o, length, ws, B, Hq, Hkv, S, D, sm_scale,
      strides, stream);
}

int flash_decode_int8_f32(const void* q, const void* k8, const void* ks,
                          const void* v8, const void* vs, void* o,
                          const void* length, void* ws, int B, int Hq,
                          int Hkv, int S, int D, float sm_scale,
                          const long long* strides, void* stream) {
  return dispatch<float, int8_t, true>(q, k8, ks, v8, vs, o, length, ws, B,
                                       Hq, Hkv, S, D, sm_scale, strides,
                                       stream);
}

int flash_decode_int8_bf16(const void* q, const void* k8, const void* ks,
                           const void* v8, const void* vs, void* o,
                           const void* length, void* ws, int B, int Hq,
                           int Hkv, int S, int D, float sm_scale,
                           const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16, int8_t, true>(q, k8, ks, v8, vs, o, length,
                                               ws, B, Hq, Hkv, S, D, sm_scale,
                                               strides, stream);
}

}  // extern "C"
