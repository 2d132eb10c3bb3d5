// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's kernels/flash_attn.py
// (flash_attention -> _flash_kernel): online-softmax attention of
// q (B, Hq, Sq, D) over k/v (B, Hkv, Sk, D); query head h reads KV head
// h / G (G = Hq / Hkv); query i sits at absolute position i + Sk - Sq and
// sees keys at positions <= its own when causal.  The running max, sum and
// output accumulator are f32; the output is in q's dtype, in q's strides.
//
// What bounds it on this card: at the LM's prefill shapes (Sq = Sk in the
// hundreds to thousands, D = 128) attention does ~2 * Sq * Sk * D operations
// per head against ~3 * Sk * D elements moved, hundreds of operations per
// byte: it is bound by operations, and the card's rate for them is the bf16
// tensor cores' (989 TFLOP/s).
//
// bf16 inputs: flash_attention_wgmma_kernel, on Hopper's warpgroup tensor
// cores.  One warpgroup (4 warps, 16 query rows each) a block of 64
// queries.  S = Q.K^T runs on wgmma.mma_async m64nBKk16 with Q and K read
// by the tensor cores straight from shared memory, and O += P.V on
// m64nDk16 with P from registers and V from shared memory (transposed by
// the instruction); both accumulate in f32 registers (csrc/wgmma.cuh).
// bf16 x bf16 products are exact in f32, so S is as exact as an f32
// product of the bf16 inputs.  The S accumulators are rescaled and
// exponentiated in registers (exp2f, log2 e folded into the scale; row max
// and sum shared by the four lanes of a row through __shfl_xor_sync 1, 2)
// and are, in wgmma's register layout, the A operand of the P.V product:
// P never goes through shared memory, and it is rounded to bf16 once,
// there (the one rounding the f32 path has not; a TPU's MXU at default
// precision rounds there too).  The row sum l adds the f32 P.  Q, K and V
// arrive by 16-byte cp.async into wgmma's 128-byte-swizzled layout (free
// of bank conflicts), K and V into a ring of two stages, so tile j + 1 is
// in flight while tile j is computed; Q is loaded once per block.  Masks
// are computed only on the causal diagonal tile and the ragged Sk edge;
// tiles past the diagonal are not visited.  The epilogue stages O in
// shared memory and writes it with 16-byte stores through q's strides.
// Not done yet: TMA loads, a producer warp and two consumer warpgroups in
// turns (the FlashAttention-3 shape).
//
// Layout (bf16): grid (Hq, B, ceil(Sq / 64)), query blocks launched longest
// first (block z takes query block ceil(Sq / 64) - 1 - z: under a causal
// mask it has the most keys).  Key tiles of 64 at D <= 128 and of 32 at
// D = 256, which keeps the 128 f32 output accumulators a thread holds at
// D = 256 under 255 registers with no spills; D = 32 is staged and
// multiplied as 64 wide (the swizzle atom), its upper half zero.  cp.async
// of 16 bytes needs the data pointer and the b, h and s strides to be
// multiples of 8 elements: the wrapper checks them and copies a tensor
// that breaks this.
//
// f32 inputs: flash_attention_kernel, on the CUDA cores in f32 (67 TFLOP/s at
// most).  An f32 call exists to hold the f32 checks (logits within 2e-3 at
// depth 4, jamba's reduced config at head_dim 32), which a TF32 or bf16
// tensor-core product would not; no full-width model path runs f32.  Each
// thread owns a 4 x 4 tile of the 64 x 64 score block and a 4-row slice of
// the output, so every shared-memory load feeds 8 (scores) or 5 (P.V)
// FMAs; K/V tiles are staged once per block in shared memory and read by
// all 256 threads; blocks stop at the causal diagonal.  Grid (ceil(Sq / 64),
// Hq, B); 256 threads as 16 x 16.  Thread (tr, tc) owns query rows
// tr + 16 i and keys tc + 16 j (i, j < 4) of each 64 x 64 score tile, and
// output columns in float4 chunks tc + 16 c; the 16 threads of a row group
// are one half-warp, so the row max and sum are shuffle reductions.  Q, K,
// V and P tiles live in dynamic shared memory as f32 (K and Q rows padded
// by 4 floats against bank conflicts).
//
// Both kernels read their inputs through element strides (the last
// dimension contiguous), so the model passes its (B, S, H, D) tensors as
// transposed views; edges in Sq and Sk are masked, so any length works, and
// rows beyond Sq are computed and not stored.
//
// Causal with Sq > Sk: a query row at absolute position < 0 comes before
// every key.  The Pallas kernel masks with the finite -1e30, so such a row
// has a uniform softmax and gets the mean of V over all Sk keys.  Both
// attention kernels see no key for such a row and leave it 0 (its sum is
// 0, floored at 1e-30); prefix_mean_kernel<T>, launched after either only
// when causal and Sq > Sk, writes those rows the mean of V (summed in
// f32, rounded once to T).  The attention kernels are left as they were:
// a test in their tile loops would run in every block, and the f32
// kernel's registers sit at ptxas's 128 with no room.  Rows at positions
// >= 0 compute what they computed before, bit for bit, and a call with
// Sq <= Sk launches the one attention kernel.  No model path sends
// Sq > Sk.
//
// Training (the backward of csrc/flash_attn_bwd.cu): given an lse pointer,
// each attention kernel also stores the f32 natural-log log-sum-exp of every
// row's scaled, masked scores, (B, Hq, Sq) contiguous, from the row max and
// sum it already holds at the epilogue (the bf16 kernel's are in log2
// units and are converted at the store).  Serving passes a null pointer:
// the store is skipped and nothing else changes, bit for bit.  (The f32
// kernel at D = 128 spills 24 bytes at 127 registers with the store and
// without it alike.)
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include <math.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using repro_torch::NEG;
using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::fence_async_smem;
using repro_torch::fence_regs;
using repro_torch::pack_bf16;
using repro_torch::smem_addr;
using repro_torch::smem_desc;
using repro_torch::swizzled;
using repro_torch::wgmma_commit;
using repro_torch::wgmma_fence;
using repro_torch::wgmma_wait_all;

struct Strides3 {
  long long b, h, s;  // element strides; the d stride is 1
};
struct AttnStrides {
  Strides3 q, k, v, o;
};

// ------------------------------------------------ f32: CUDA-core kernel
constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block, 16 x 16

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (D + 4) + static_cast<size_t>(BK) * (D + 4) +
          static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * (BK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Sk, int G,
                       int causal, float sm_scale, AttnStrides st) {
  constexpr int DP = D + 4;            // padded row of Q and K tiles
  constexpr int PP = BK + 4;           // padded row of the P tile
  constexpr int NC = D / 4;            // float4 chunks per row
  constexpr int OC = (NC + 15) / 16;   // output chunks per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int q_offset = Sk - Sq;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* kb = k + b * st.k.b + hk * st.k.h;
  const T* vb = v + b * st.v.b + hk * st.v.h;

  for (int i = tid; i < BQ * NC; i += NT) {
    const int r = i / NC, c = (i % NC) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = repro_torch::load4(qb + (q0 + r) * st.q.s + c);
    *reinterpret_cast<float4*>(&Qs[r * DP + c]) = x;
  }

  float4 acc[4][OC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // keys past the block's last query position are masked for every row
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + q_offset + 1) : Sk;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * NC; i += NT) {
      const int r = i / NC, c = (i % NC) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Sk) {
        kx = repro_torch::load4(kb + (k0 + r) * st.k.s + c);
        vx = repro_torch::load4(vb + (k0 + r) * st.v.s + c);
      }
      *reinterpret_cast<float4*>(&Ks[r * DP + c]) = kx;
      *reinterpret_cast<float4*>(&Vs[r * D + c]) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(tr + 16 * i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tc + 16 * j) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = repro_torch::dot4(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr + 16 * i + q_offset;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tc + 16 * j;
        ok[j] = kk < Sk && (!causal || kk <= qpos);
        s[i][j] *= sm_scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(tr + 16 * i) * PP + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] = repro_torch::scale4(acc[i][c], alpha);
    }
    __syncthreads();

    const int kn = min(BK, kv_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int col = (tc + 16 * c) * 4;
        if (col < D) {
          const float4 vx = *reinterpret_cast<const float4*>(&Vs[kk * D + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) repro_torch::axpy4(p[i], vx, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    const float lv = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tc == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qi] =
          m[i] + logf(lv);
    T* orow = o + b * st.o.b + h * st.o.h + qi * st.o.s;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = (tc + 16 * c) * 4;
      if (col < D) {
        repro_torch::store(orow + col, acc[i][c].x / lv);
        repro_torch::store(orow + col + 1, acc[i][c].y / lv);
        repro_torch::store(orow + col + 2, acc[i][c].z / lv);
        repro_torch::store(orow + col + 3, acc[i][c].w / lv);
      }
    }
  }
}

// Causal with Sq > Sk: the attention kernels see no key for the rows
// before the first key and leave them 0; this kernel, launched after either
// only then, writes them the mean of V over all Sk keys.  One block per
// (query head, row of the batch).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
prefix_mean_kernel(const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                   int G, int D, AttnStrides st) {
  const int h = blockIdx.x, b = blockIdx.y;
  const T* vb = v + b * st.v.b + (h / G) * st.v.h;
  T* ob = o + b * st.o.b + h * st.o.h;
  for (int c = threadIdx.x; c < D; c += NT) {
    float sum = 0.f;
    for (int kk = 0; kk < Sk; ++kk) sum += to_f32(vb[kk * st.v.s + c]);
    const float mean = sum / static_cast<float>(Sk);
    for (int r = 0; r < Sq - Sk; ++r)
      repro_torch::store(ob + r * st.o.s + c, mean);
  }
}

// Launches prefix_mean_kernel<T> where a causal call has Sq > Sk; else
// returns the error state as it is.
template <typename T>
int prefix_mean(const void* v, void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                int causal, int D, const AttnStrides& st, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !causal || Sq <= Sk) return static_cast<int>(err);
  prefix_mean_kernel<T><<<dim3(Hq, B), NT, 0, stream>>>(
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq / Hkv, D, st);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------- bf16: tensor-core kernel
using bf16 = __nv_bfloat16;

constexpr int WG_NT = 128;  // one warpgroup: four warps, 16 query rows each
constexpr int WG_BQ = 64;   // queries per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct WgTile {
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys per tile
  static constexpr int DP = D < 64 ? 64 : D;     // staged row, in elements
  static constexpr int Q_BYTES = WG_BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  // Q, two stages of K and of V, and room to align the tiles to 1024 bytes
  static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * KV_BYTES;
};

// S (64 x BK) (+)= Q.K^T over 16 of D, and O (64 x DP) += P.V over 16 keys
template <int BK>
__device__ __forceinline__ void mma_s(float (&s)[BK / 2], uint64_t q_desc,
                                      uint64_t k_desc, int accumulate) {
  if constexpr (BK == 64) repro_torch::wgmma_ss_n64(s, q_desc, k_desc, accumulate);
  else repro_torch::wgmma_ss_n32(s, q_desc, k_desc, accumulate);
}
template <int DP>
__device__ __forceinline__ void mma_o(float (&o)[DP / 2],
                                      const uint32_t (&p)[4],
                                      uint64_t v_desc) {
  if constexpr (DP == 64) repro_torch::wgmma_rs_n64(o, p, v_desc);
  else if constexpr (DP == 128) repro_torch::wgmma_rs_n128(o, p, v_desc);
  else repro_torch::wgmma_rs_n256(o, p, v_desc);
}

// The accumulators of a 64 x N wgmma: thread (warp w, lane 4 g + t) holds
// element [4 n + e] = row 16 w + g + 8 (e / 2), column 8 n + 2 t + e % 2.
// The A operand from registers has the same rows: a[0], a[1] are row g at
// columns 2t, 2t + 1 and 2t + 8, 2t + 9 of a 16-wide slice, a[2], a[3]
// row g + 8; so S's accumulators of keys 16 kk .. 16 kk + 15 are P's A
// operand once rounded to bf16.
template <int D>
__global__ void __launch_bounds__(WG_NT)
flash_attention_wgmma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int Sq, int Sk, int G,
                             int causal, float scale_log2, AttnStrides st) {
  using Tile = WgTile<D>;
  constexpr int BKT = Tile::BK, DP = Tile::DP;
  constexpr int CH = DP / 8;   // 16-byte chunks of a staged row
  constexpr int DCH = D / 8;   // of them, the ones that hold data
  constexpr int NS = BKT / 8;  // 8-key column blocks of S
  extern __shared__ uint8_t smem_wg[];
  const uint32_t raw = smem_addr(smem_wg);
  uint8_t* Qs = smem_wg + (((raw + 1023) & ~1023u) - raw);
  uint8_t* Ks = Qs + Tile::Q_BYTES;       // [2][KV_BYTES]
  uint8_t* Vs = Ks + 2 * Tile::KV_BYTES;  // [2][KV_BYTES]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WG_BQ;  // longest first
  const int hk = h / G;
  const int q_offset = Sk - Sq;
  const bf16* qg = q + b * st.q.b + h * st.q.h;
  const bf16* kg = k + b * st.k.b + hk * st.k.h;
  const bf16* vg = v + b * st.v.b + hk * st.v.h;

  for (int i = tid; i < WG_BQ * CH; i += WG_NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < Sq && c < DCH;
    cp_async16(smem_addr(Qs + swizzled(r, c, WG_BQ)),
               qg + (ok ? (q0 + r) * st.q.s + c * 8 : 0), ok);
  }
  cp_async_commit();

  // keys past the block's last query position are masked for every row
  const int q_last = min(q0 + WG_BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + q_offset + 1) : Sk;
  const int n_tiles = (kv_end + BKT - 1) / BKT;

  auto load_kv = [&](int tile) {
    const int k0 = tile * BKT;
    uint8_t* ks = Ks + (tile & 1) * Tile::KV_BYTES;
    uint8_t* vs = Vs + (tile & 1) * Tile::KV_BYTES;
    for (int i = tid; i < BKT * CH; i += WG_NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < Sk && c < DCH;
      const long long at = ok ? (k0 + r) * st.k.s + c * 8 : 0;
      const long long av = ok ? (k0 + r) * st.v.s + c * 8 : 0;
      const int off = swizzled(r, c, BKT);
      cp_async16(smem_addr(ks + off), kg + at, ok);
      cp_async16(smem_addr(vs + off), vg + av, ok);
    }
  };
  load_kv(0);
  cp_async_commit();

  const int qpos = q0 + warp * 16 + g + q_offset;  // row g's; g + 8: +8
  const uint32_t q_addr = smem_addr(Qs);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {NEG, NEG};  // running max of rows g, g + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};  // this lane's share of their running sums

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv(j + 1);
    cp_async_commit();   // possibly empty: tile j is then all but one group
    repro_torch::cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int k0 = j * BKT;
    const uint32_t k_addr = smem_addr(Ks + (j & 1) * Tile::KV_BYTES);
    const uint32_t v_addr = smem_addr(Vs + (j & 1) * Tile::KV_BYTES);

    // S = Q.K^T: both K-major; step kk reads 32 bytes of each row, atom
    // kk / 4; 8-row groups 1024 bytes apart
    float s[BKT / 2];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk & 3) * 32;
      mma_s<BKT>(s,
                 smem_desc(q_addr + (kk >> 2) * WG_BQ * 128 + step, 16, 1024),
                 smem_desc(k_addr + (kk >> 2) * BKT * 128 + step, 16, 1024),
                 kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool masked = k0 + BKT > Sk ||
                        (causal && k0 + BKT - 1 > q0 + q_offset);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        if (masked) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          if (key >= Sk || (causal && key > qpos + (e >> 1) * 8))
            x = -INFINITY;
        }
        s[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);  // finite: m_r >= NEG
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BKT / 2; ++i) {
      const float p = exp2f(s[i] - m_r[(i >> 1) & 1]);  // masked: 0
      s[i] = p;
      l_r[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P.V: P from registers, V MN-major (16 keys a step, 2048 bytes;
    // 8-key groups 1024 bytes apart, 64-column atoms BK * 128 bytes apart)
    uint32_t pa[BKT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk)
      mma_o<DP>(acc, pa[kk], smem_desc(v_addr + kk * 2048, BKT * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this stage before refill
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-30f);
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (lse != nullptr && t == 0 && qi < Sq)   // log2 units to natural log
      lse[(static_cast<long long>(b) * gridDim.x + h) * Sq + qi] =
          (m_r[r] + log2f(fmaxf(l_r[r], 1e-30f))) * LN2;
  }
  // O through a row-padded tile over the K/V stages (no one reads them
  // now), then 16-byte stores
  constexpr int LD = D + 8;
  bf16* os = reinterpret_cast<bf16*>(Ks);
  const int r0 = warp * 16;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(os + (r0 + g) * LD + col) =
        __floats2bfloat162_rn(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (r0 + g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[4 * n + 2] * inv[1],
                              acc[4 * n + 3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = o + b * st.o.b + h * st.o.h;
  for (int i = lane; i < 16 * DCH; i += 32) {
    const int r = i / DCH, c = (i % DCH) * 8;
    const int qi = q0 + r0 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(ob + qi * st.o.s + c) =
          *reinterpret_cast<const uint4*>(os + (r0 + r) * LD + c);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
               float sm_scale, const AttnStrides& st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<float, D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk,
      Hq / Hkv, causal, sm_scale, st);
  return prefix_mean<float>(v, o, B, Hq, Hkv, Sq, Sk, causal, D, st, stream);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                float sm_scale, const AttnStrides& st, cudaStream_t stream) {
  constexpr size_t smem = WgTile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, (Sq + WG_BQ - 1) / WG_BQ);
  flash_attention_wgmma_kernel<D><<<grid, WG_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk,
      Hq / Hkv, causal, sm_scale * LOG2E, st);
  return prefix_mean<bf16>(v, o, B, Hq, Hkv, Sq, Sk, causal, D, st, stream);
}

template <int D>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
           float sm_scale, const AttnStrides& st, cudaStream_t stream) {
  return bf16 ? launch_bf16<D>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                               sm_scale, st, stream)
              : launch_f32<D>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal,
                              sm_scale, st, stream);
}

int dispatch(bool bf16, const void* q, const void* k, const void* v, void* o,
             void* lse_ptr, int B, int Hq, int Hkv, int Sq, int Sk, int D,
             int causal, float sm_scale, const long long* strides,
             void* stream) {
  float* lse = static_cast<float*>(lse_ptr);
  const AttnStrides st{{strides[0], strides[1], strides[2]},
                       {strides[3], strides[4], strides[5]},
                       {strides[6], strides[7], strides[8]},
                       {strides[9], strides[10], strides[11]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(bf16, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, sm_scale, st, s);
    case 64: return launch<64>(bf16, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, sm_scale, st, s);
    case 128: return launch<128>(bf16, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, sm_scale, st, s);
    case 256: return launch<256>(bf16, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, causal, sm_scale, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 12 element strides (b, h, s) of q, k, v and o, in that order;
// lse: null, or (B, Hq, Sq) f32 contiguous
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                        int D, int causal, float sm_scale,
                        const long long* strides, void* stream) {
  return dispatch(false, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D, causal,
                  sm_scale, strides, stream);
}

// q, k, v, o bf16; the data pointers and the b, h, s strides are multiples
// of 8 elements (cp.async moves 16 bytes); lse as above
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                         int D, int causal, float sm_scale,
                         const long long* strides, void* stream) {
  return dispatch(true, q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, D, causal,
                  sm_scale, strides, stream);
}

}  // extern "C"
