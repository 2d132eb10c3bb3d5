// Backward of the causal GQA flash attention (csrc/flash_attn.cu) for Hopper
// (sm_90a), for training.
//
// Replaces no Pallas kernel: the JAX package trains through the plain
// _chunked_attention (models/layers.py) and differentiates it with
// jax.value_and_grad; its Pallas flash kernel has no backward.  The port runs
// attention through its forward kernel on every path, so the gradient of that
// kernel is a kernel too.  It computes the FlashAttention-2 backward from the
// forward's inputs, its output O and its row log-sum-exp (lse):
//
//   D_i  = sum_d dO_id O_id                                  (preprocess)
//   P    = exp(S scale - lse),  S = Q K^T, masked as the forward masks
//   dV   = sum_g P^T dO,  dS = P (dO V^T - D)
//   dK   = scale sum_g dS^T Q                                (dK/dV kernel)
//   dQ   = scale dS K                                        (dQ kernel)
//
// where sum_g runs over the G = Hq / Hkv query heads of a KV head.  S and P
// are recomputed from lse in both kernels, never stored.  Query i sits at
// position i q_stride + q_offset, q_offset = Sk - 1 - (Sq - 1) q_stride (the
// last row at Sk - 1; i + Sk - Sq at q_stride 1), as in the forward
// (csrc/flash_attn.cu), and, when causal, sees keys at positions <= its own;
// every row then sees at least one key (the wrapper refuses causal Sq > Sk,
// whose first rows see none and which no training path sends, and a stride
// whose first row would come before the first key).  Ragged Sq and Sk are
// masked: rows past Sq and keys past Sk get P = 0.
//
// Strided queries (q_stride > 1) are context parallelism's striped rows: a
// model rank's rows g, g + mm, ... over the keys up to its last row.  The
// stride enters only the causal masks, each block's range of tiles (the
// first query tile that sees a key tile: t_first, the first row at or after
// the key, ceil((k0 - q_offset) / q_stride); the last key tile a query tile
// sees: kv_end) and the tensor-core kernels' test whether a tile needs its
// mask.  At q_stride 1 every one of them is what it was, and the floating-
// point work is unchanged, bit for bit.  A key tile's query tiles and a
// query tile's key tiles stay monotone in the tile's index at any stride, so
// the launch order below (longest first) holds.
//
// No atomics: each dK/dV tile is written by the one block that owns its keys,
// which loops over the G query heads and every query tile that sees them, and
// each dQ tile by the one block that owns its queries, which loops over the
// key tiles up to the causal diagonal.  The sums run in a fixed order, so a
// backward is bit-equal to itself from run to run (dQ by f32 atomics, as
// FlashAttention-3 does it, would not be; a workspace of dQ partials per key
// tile would write ~400 MB at llama3.2-3b's shape).
//
// What bounds it on this card: at llama3.2-3b's training shape (B 8, Hq 24,
// Hkv 8, S 512, D 128, causal) the five products need ~3.2e10 operations,
// 33 us at the bf16 tensor cores' 989 TFLOP/s, against ~134 MB moved, 40 us
// at 3.35 TB/s: the bound is the bytes, and the time is the products.  The
// recomputation costs the two kernels seven products where the math needs
// five.
//
// bf16 at D <= 128: attn_bwd_dkdv_wgmma_kernel and attn_bwd_dq_wgmma_kernel,
// on Hopper's warpgroup tensor cores (csrc/wgmma.cuh).  One warpgroup (4
// warps, 16 rows each) a block of 64 keys (dK/dV) or 64 queries (dQ); every
// tile is a 64-row bf16 tile in wgmma's 128-byte-swizzled layout, loaded by
// 16-byte cp.async, so one staged tile is both the K-major operand of a
// score product and the MN-major (transposed) B operand of a gradient
// product.  The dK/dV kernel computes S^T = K.Q^T and dP^T = V.dO^T with both
// operands in shared memory, forms P^T = exp2(S^T scale log2 e - lse log2 e)
// and dS^T = P^T (dP^T - D) in the accumulators' registers (lse and D per
// query column from shared memory), and runs dV += P^T.dO and dK += dS^T.Q
// with P^T and dS^T as the register A operand, rounded to bf16 once there,
// as the forward rounds P: neither ever goes to shared memory.  The dV
// product runs while dS^T is formed.  Q, dO, lse and D arrive in a ring of
// two stages, so query tile j + 1 is in flight while tile j is computed; K
// and V are loaded once.  The dQ kernel mirrors it: S = Q.K^T and
// dP = dO.V^T from shared memory, dS in registers, dQ += dS.K with the K
// tile as the MN-major B operand, K and V in a ring of two stages.  dK/dV
// blocks by key tile launch longest first (under a causal mask tile 0 sees
// every query tile), as do the dQ blocks.  D = 32 is staged and multiplied
// as 64 wide (the swizzle atom), its upper half zero.  Both kernels keep
// their f32 accumulators in registers (dK and dV: 2 x D / 2 a thread) and
// take ~98 KB of shared memory at D = 128, so two blocks share an SM.  Not
// done yet: TMA loads, a producer warp, persistent blocks, 128-key blocks
// with two consumer warpgroups.
//
// f32, and bf16 at D = 256: attn_bwd_dkdv_kernel and attn_bwd_dq_kernel, on
// the CUDA cores in f32 (67 TFLOP/s at most).  The f32 kernels hold the f32
// checks a tensor-core product would not.  bf16 at D = 256 (gemma's heads)
// stays there: dK's and dV's accumulators alone would take 256 registers a
// thread in one warpgroup; splitting D over two warpgroups is the next piece
// of this kernel.  64 x 64 tiles (32 x 32 at D = 256) staged in shared memory
// as f32 like the forward's f32 kernel; each of the 256 threads owns a 4 x 4
// (2 x 2) block of a score tile and rows x float4 columns of its
// accumulators, so every shared-memory load feeds several FMAs.
//
// Inputs are read through element strides with a contiguous last dimension
// (loads of 16 bytes: the wrapper aligns the data pointers and the b, h, s
// strides to 4 elements in f32, 8 in bf16), so the model's (B, S, H, D)
// views are read in place; gradients are written through their own strides.
//
// Plain-C entry points (loaded with ctypes): each launches the three kernels
// on the given stream and returns the first launch error.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::fence_async_smem;
using repro_torch::fence_regs;
using repro_torch::pack_bf16;
using repro_torch::smem_addr;
using repro_torch::smem_desc;
using repro_torch::swizzled;
using repro_torch::wgmma_commit;
using repro_torch::wgmma_fence;
using repro_torch::wgmma_wait;

struct Strides3 {
  long long b, h, s;  // element strides; the d stride is 1
};
// q, k, v, o, dO, dq, dk, dv
struct BwdStrides {
  Strides3 q, k, v, o, dout, dq, dk, dv;
};

constexpr int NT = 256;  // threads per block of every kernel, 16 x 16

__device__ __forceinline__ void store4(float* p, float4 x, float s) {
  *reinterpret_cast<float4*>(p) = repro_torch::scale4(x, s);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x, float s) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x * s, x.y * s);
  p2[1] = __floats2bfloat162_rn(x.z * s, x.w * s);
}

// the first query row at or after key k: the least i >= 0 with
// i q_stride + q_offset >= k (k - q_offset at q_stride 1)
__device__ __forceinline__ int first_row(int k, int q_offset, int q_stride) {
  return (max(0, k - q_offset) + q_stride - 1) / q_stride;
}

// D = rowsum(dO o O) in f32, (B, Hq, Sq) contiguous: one warp a row.  Grid
// (ceil(Sq / 8), Hq, B).
template <typename T>
__global__ void __launch_bounds__(NT)
attn_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int Sq, int D,
                           Strides3 so, Strides3 sdo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * (NT / 32) + warp;
  if (i >= Sq) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* orow = o + b * so.b + h * so.h + i * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + i * sdo.s;
  float acc = 0.f;
  for (int c = lane * 4; c < D; c += 128)
    acc = repro_torch::dot4(repro_torch::load4(orow + c),
                            repro_torch::load4(drow + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0)
    delta[(static_cast<long long>(b) * gridDim.y + h) * Sq + i] = acc;
}

// D = rowsum(dO o O) for the launch's other two kernels
template <typename T>
cudaError_t preprocess(const void* o, const void* dout, float* delta, int B,
                       int Hq, int Sq, int D, const BwdStrides& st,
                       cudaStream_t stream) {
  attn_bwd_preprocess_kernel<T><<<dim3((Sq + NT / 32 - 1) / (NT / 32), Hq, B),
                                   NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, Sq, D,
      st.o, st.dout);
  return cudaGetLastError();
}

// --------------------------- f32, and bf16 at D = 256: CUDA-core kernels
// Tiles of BT queries by BT keys; R rows (and columns) of a score tile per
// thread; rows of Q, K, V, dO staged as f32, padded by 4 against bank
// conflicts; OC float4 columns of an accumulator row per thread.
template <int D>
struct Tile {
  static constexpr int BT = D == 256 ? 32 : 64;
  static constexpr int R = BT / 16;
  static constexpr int DP = D + 4;
  static constexpr int PP = BT + 4;
  static constexpr int NC = D / 4;
  static constexpr int OC = (NC + 15) / 16;
};

template <int D>
constexpr size_t dkdv_smem() {
  using Tl = Tile<D>;
  return sizeof(float) * (4 * Tl::BT * Tl::DP + 2 * Tl::BT * Tl::PP + 2 * Tl::BT);
}
template <int D>
constexpr size_t dq_smem() {
  using Tl = Tile<D>;
  return sizeof(float) * (4 * Tl::BT * Tl::DP + Tl::BT * Tl::PP + 2 * Tl::BT);
}

// rows [r0, r0 + BT) of a (·, D) operand into a padded f32 tile, zeros past n
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss,
                                          int r0, int n) {
  using Tl = Tile<D>;
  for (int i = threadIdx.x; i < Tl::BT * Tl::NC; i += NT) {
    const int r = i / Tl::NC, c = (i % Tl::NC) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = repro_torch::load4(src + (r0 + r) * ss + c);
    *reinterpret_cast<float4*>(&dst[r * Tl::DP + c]) = x;
  }
}

// s[i][j] = A[tr + 16 i] . B[tc + 16 j] over D, both padded f32 tiles
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[Tile<D>::R][Tile<D>::R],
                                          const float* A, const float* B,
                                          int tr, int tc) {
  using Tl = Tile<D>;
  constexpr int R = Tl::R;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(tr + 16 * i) * Tl::DP + d]);
#pragma unroll
    for (int j = 0; j < R; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&B[(tc + 16 * j) * Tl::DP + d]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = repro_torch::dot4(a[i], bv[j], s[i][j]);
  }
}

// Grid (Hkv, B, ceil(Sk / BT)): one block a KV tile, over every query head
// of its group and every query tile that sees it.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Hq, int Sq, int Sk, int G,
                     int causal, int q_stride, float scale, BwdStrides st) {
  using Tl = Tile<D>;
  constexpr int BT = Tl::BT, R = Tl::R, DP = Tl::DP, PP = Tl::PP;
  constexpr int OC = Tl::OC;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BT * DP;
  float* Qs = Vs + BT * DP;
  float* dOs = Qs + BT * DP;
  float* Ps = dOs + BT * DP;   // P[query][key]
  float* dSs = Ps + BT * PP;   // dS[query][key]
  float* Ls = dSs + BT * PP;   // the tile's lse
  float* Ds = Ls + BT;         // and D

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BT;
  const int q_offset = Sk - 1 - (Sq - 1) * q_stride;
  load_tile<T, D>(Ks, k + b * st.k.b + hk * st.k.h, st.k.s, k0, Sk);
  load_tile<T, D>(Vs, v + b * st.v.b + hk * st.v.h, st.v.s, k0, Sk);

  float4 dk_acc[R][OC], dv_acc[R][OC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      dk_acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[i][c] = dk_acc[i][c];
    }

  // the first query that sees key k0: ceil((k0 - q_offset) / q_stride)
  const int t_first = causal ? first_row(k0, q_offset, q_stride) / BT : 0;
  const int n_qt = (Sq + BT - 1) / BT;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const long long row0 = (static_cast<long long>(b) * Hq + h) * Sq;
    for (int t = t_first; t < n_qt; ++t) {
      const int q0 = t * BT;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      load_tile<T, D>(Qs, q + b * st.q.b + h * st.q.h, st.q.s, q0, Sq);
      load_tile<T, D>(dOs, dout + b * st.dout.b + h * st.dout.h, st.dout.s,
                      q0, Sq);
      if (tid < BT) {
        const bool in = q0 + tid < Sq;
        Ls[tid] = in ? lse[row0 + q0 + tid] : 0.f;
        Ds[tid] = in ? delta[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[R][R], dp[R][R];
      tile_dots<D>(s, Qs, Ks, tr, tc);
      tile_dots<D>(dp, dOs, Vs, tr, tc);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = tr + 16 * i, qi = q0 + r;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tc + 16 * j, kk = k0 + c;
          const bool ok = qi < Sq && kk < Sk &&
                          (!causal || kk <= qi * q_stride + q_offset);
          const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
          Ps[r * PP + c] = p;
          dSs[r * PP + c] = p * (dp[i][j] - Ds[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's queries
      const int qn = min(BT, Sq - q0);
      for (int qq = 0; qq < qn; ++qq) {
        float p[R], ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = Ps[qq * PP + tr + 16 * i];
          ds[i] = dSs[qq * PP + tr + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const int col = (tc + 16 * c) * 4;
          if (col < D) {
            const float4 d4 = *reinterpret_cast<const float4*>(&dOs[qq * DP + col]);
            const float4 q4 = *reinterpret_cast<const float4*>(&Qs[qq * DP + col]);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              repro_torch::axpy4(p[i], d4, dv_acc[i][c]);
              repro_torch::axpy4(ds[i], q4, dk_acc[i][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kk = k0 + tr + 16 * i;
    if (kk >= Sk) continue;
    T* dkr = dk + b * st.dk.b + hk * st.dk.h + kk * st.dk.s;
    T* dvr = dv + b * st.dv.b + hk * st.dv.h + kk * st.dv.s;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = (tc + 16 * c) * 4;
      if (col < D) {
        store4(dkr + col, dk_acc[i][c], scale);
        store4(dvr + col, dv_acc[i][c], 1.f);
      }
    }
  }
}

// Grid (Hq, B, ceil(Sq / BT)): one block a query tile, over the key tiles up
// to its causal diagonal; query tiles launched longest first.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int Sq, int Sk, int G, int causal, int q_stride,
                   float scale, BwdStrides st) {
  using Tl = Tile<D>;
  constexpr int BT = Tl::BT, R = Tl::R, DP = Tl::DP, PP = Tl::PP;
  constexpr int OC = Tl::OC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BT * DP;
  float* Ks = dOs + BT * DP;
  float* Vs = Ks + BT * DP;
  float* dSs = Vs + BT * DP;
  float* Ls = dSs + BT * PP;
  float* Ds = Ls + BT;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BT;
  const int hk = h / G;
  const int q_offset = Sk - 1 - (Sq - 1) * q_stride;
  const long long row0 = (static_cast<long long>(b) * gridDim.x + h) * Sq;
  load_tile<T, D>(Qs, q + b * st.q.b + h * st.q.h, st.q.s, q0, Sq);
  load_tile<T, D>(dOs, dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0, Sq);
  if (tid < BT) {
    const bool in = q0 + tid < Sq;
    Ls[tid] = in ? lse[row0 + q0 + tid] : 0.f;
    Ds[tid] = in ? delta[row0 + q0 + tid] : 0.f;
  }
  const T* kb = k + b * st.k.b + hk * st.k.h;
  const T* vb = v + b * st.v.b + hk * st.v.h;

  float4 acc[R][OC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int q_last = min(q0 + BT, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last * q_stride + q_offset + 1) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    __syncthreads();  // the previous tile's K and dS are consumed
    load_tile<T, D>(Ks, kb, st.k.s, k0, Sk);
    load_tile<T, D>(Vs, vb, st.v.s, k0, Sk);
    __syncthreads();

    float s[R][R], dp[R][R];
    tile_dots<D>(s, Qs, Ks, tr, tc);
    tile_dots<D>(dp, dOs, Vs, tr, tc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = tr + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tc + 16 * j, kk = k0 + c;
        const bool ok = qi < Sq && kk < Sk &&
                        (!causal || kk <= qi * q_stride + q_offset);
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        dSs[r * PP + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's keys
    const int kn = min(BT, kv_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(tr + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int col = (tc + 16 * c) * 4;
        if (col < D) {
          const float4 k4 = *reinterpret_cast<const float4*>(&Ks[kk * DP + col]);
#pragma unroll
          for (int i = 0; i < R; ++i) repro_torch::axpy4(ds[i], k4, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    T* row = dq + b * st.dq.b + h * st.dq.h + qi * st.dq.s;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = (tc + 16 * c) * 4;
      if (col < D) store4(row + col, acc[i][c], scale);
    }
  }
}

// ------------------------------- bf16 at D <= 128: tensor-core kernels
using bf16 = __nv_bfloat16;

constexpr int WG_NT = 128;  // one warpgroup: four warps, 16 rows each
constexpr int WG_T = 64;    // keys (dK/dV) or queries (dQ) a block, and a tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct WgBwd {
  static constexpr int DP = D < 64 ? 64 : D;  // staged row, in elements
  static constexpr int TILE = WG_T * DP * 2;  // bytes of a 64-row bf16 tile
  // two tiles loaded once, two stages of two tiles, two stages of a query
  // tile's lse and D (f32; the dK/dV kernel's), and room to align the tiles
  // to 1024 bytes
  static constexpr size_t SMEM = 1024 + 6 * TILE + 2 * 2 * WG_T * 4;
};

template <int DP>
__device__ __forceinline__ void mma_rs(float (&d)[DP / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DP == 64) repro_torch::wgmma_rs_n64(d, a, b);
  else repro_torch::wgmma_rs_n128(d, a, b);
}

// acc (64 x 64) = A.B^T over D, A and B 64-row K-major tiles: step kk reads
// 32 bytes of each row, atom kk / 4; 8-row groups 1024 bytes apart
template <int D>
__device__ __forceinline__ void mma_scores(float (&acc)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk >> 2) * WG_T * 128 + (kk & 3) * 32;
    repro_torch::wgmma_ss_n64(acc, smem_desc(a + step, 16, 1024),
                              smem_desc(b + step, 16, 1024), kk > 0);
  }
}

// acc (64 x DP) += A.B over the tile's 64 rows: A (64 x 64) in registers,
// four 16-wide slices; B a 64-row tile read MN-major (16 rows a step, 2048
// bytes; 8-row groups 1024 bytes apart, 64-column atoms 64 * 128 bytes apart)
template <int DP>
__device__ __forceinline__ void mma_grad(float (&acc)[DP / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<DP>(acc, a[kk], smem_desc(b + kk * 2048, WG_T * 128, 1024));
}

// the f32 accumulators of a 64 x 64 tile as wgmma's A operand, bf16: slice
// kk is columns 16 kk .. 16 kk + 15 (accumulator element [4 n + e] is row
// 16 w + g + 8 (e / 2), column 8 n + 2 t + e % 2, and the A operand's
// registers are rows g, g + 8 at columns 2 t, 2 t + 8 of a slice)
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// rows [r0, r0 + 64) of a (., D) bf16 operand into a swizzled tile, zeros
// past n and in the columns past D
template <int D>
__device__ __forceinline__ void load_wg_tile(uint8_t* dst, const bf16* src,
                                             long long ss, int r0, int n) {
  constexpr int CH = WgBwd<D>::DP / 8, DCH = D / 8;
  for (int i = threadIdx.x; i < WG_T * CH; i += WG_NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < n && c < DCH;
    cp_async16(smem_addr(dst + swizzled(r, c, WG_T)),
               src + (ok ? (r0 + r) * ss + c * 8 : 0), ok);
  }
}

// a 64 x DP accumulator tile times s, rounded to bf16, to rows [r0, r0 + 64)
// (those below n) of a (., D) output: through a row-padded tile in shared
// memory, each warp its own 16 rows, then 16-byte stores
template <int D, int N>
__device__ __forceinline__ void store_wg_tile(bf16* stage,
                                              const float (&acc)[N], float s,
                                              bf16* dst, long long ss, int r0,
                                              int n) {
  constexpr int LD = D + 8, DCH = D / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, w0 = warp * 16;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage + (w0 + g) * LD + col) =
        __floats2bfloat162_rn(acc[4 * c] * s, acc[4 * c + 1] * s);
    *reinterpret_cast<__nv_bfloat162*>(stage + (w0 + g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[4 * c + 2] * s, acc[4 * c + 3] * s);
  }
  __syncwarp();
  for (int i = lane; i < 16 * DCH; i += 32) {
    const int r = i / DCH, c = (i % DCH) * 8;
    if (r0 + w0 + r < n)
      *reinterpret_cast<uint4*>(dst + (r0 + w0 + r) * ss + c) =
          *reinterpret_cast<const uint4*>(stage + (w0 + r) * LD + c);
  }
}

// Grid (Hkv, B, ceil(Sk / 64)): one block a tile of 64 keys, over every
// query head of its group and every query tile that sees it.  Block z
// takes key tile z: under a causal mask tile 0 sees the most query tiles,
// and lower z launch first.
template <int D>
__global__ void __launch_bounds__(WG_NT)
attn_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Hq, int Sq, int Sk, int G, int causal,
                           int q_stride, float scale, float scale_log2,
                           BwdStrides st) {
  using W = WgBwd<D>;
  constexpr int DP = W::DP;
  extern __shared__ uint8_t smem_wg[];
  const uint32_t raw = smem_addr(smem_wg);
  uint8_t* Ks = smem_wg + (((raw + 1023) & ~1023u) - raw);
  uint8_t* Vs = Ks + W::TILE;
  uint8_t* Qs = Vs + W::TILE;         // [2][TILE]
  uint8_t* dOs = Qs + 2 * W::TILE;    // [2][TILE]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * W::TILE);  // [2][64]
  float* Ds = Ls + 2 * WG_T;                                // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * WG_T;
  const int q_offset = Sk - 1 - (Sq - 1) * q_stride;
  load_wg_tile<D>(Ks, k + b * st.k.b + hk * st.k.h, st.k.s, k0, Sk);
  load_wg_tile<D>(Vs, v + b * st.v.b + hk * st.v.h, st.v.s, k0, Sk);
  cp_async_commit();

  // the first query that sees key k0: ceil((k0 - q_offset) / q_stride)
  const int t_first = causal ? first_row(k0, q_offset, q_stride) / WG_T : 0;
  const int nt = (Sq + WG_T - 1) / WG_T - t_first;
  const int n_it = G * nt;   // query tiles: head-major, then by position
  auto load_q = [&](int it) {
    const int h = hk * G + it / nt, q0 = (t_first + it % nt) * WG_T;
    const int sg = it & 1;
    load_wg_tile<D>(Qs + sg * W::TILE, q + b * st.q.b + h * st.q.h, st.q.s,
                    q0, Sq);
    load_wg_tile<D>(dOs + sg * W::TILE, dout + b * st.dout.b + h * st.dout.h,
                    st.dout.s, q0, Sq);
    if (tid < WG_T) {
      const bool ok = q0 + tid < Sq;
      const long long at = ok ? (static_cast<long long>(b) * Hq + h) * Sq +
                                    q0 + tid : 0;
      cp_async4(smem_addr(Ls + sg * WG_T + tid), lse + at, ok);
      cp_async4(smem_addr(Ds + sg * WG_T + tid), delta + at, ok);
    }
  };
  load_q(0);
  cp_async_commit();

  const uint32_t k_addr = smem_addr(Ks), v_addr = smem_addr(Vs);
  const int key0 = k0 + warp * 16 + g;   // this thread's key rows: +0, +8
  float dv_acc[DP / 2], dk_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();   // possibly empty: stage it is then all but one group
    repro_torch::cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int sg = it & 1;
    const int q0 = (t_first + it % nt) * WG_T;
    const uint32_t q_addr = smem_addr(Qs + sg * W::TILE);
    const uint32_t do_addr = smem_addr(dOs + sg * W::TILE);
    const float* Lt = Ls + sg * WG_T;
    const float* Dt = Ds + sg * WG_T;

    // S^T = K.Q^T and dP^T = V.dO^T, two groups
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_scores<D>(s, k_addr, q_addr);
    wgmma_commit();
    mma_scores<D>(dp, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T in place of S^T: element [4 n + e] is key key0 + 8 (e / 2),
    // query q0 + 8 n + 2 t + e % 2
    const bool masked = q0 + WG_T > Sq ||
                        (causal && k0 + WG_T - 1 > q0 * q_stride + q_offset);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[4 * n + e], scale_log2,
                             -(e & 1 ? l2.y : l2.x) * LOG2E));
        if (masked) {
          const int qi = q0 + 8 * n + 2 * t + (e & 1);
          const int kk = key0 + 8 * (e >> 1);
          if (qi >= Sq || (causal && kk > qi * q_stride + q_offset)) p = 0.f;
        }
        s[4 * n + e] = p;
      }
    }
    uint32_t pa[4][4];
    to_a(pa, s);
    // dV += P^T.dO, while dS^T is formed
    fence_regs(dv_acc);
    wgmma_fence();
    mma_grad<DP>(dv_acc, pa, do_addr);
    wgmma_commit();
    wgmma_wait<1>();   // dP^T is in
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(Dt + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - (e & 1 ? d2.y : d2.x));
    }
    uint32_t da[4][4];
    to_a(da, dp);
    // dK += dS^T.Q
    fence_regs(dk_acc);
    wgmma_fence();
    mma_grad<DP>(dk_acc, da, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every warp is done with this stage before refill
  }
  repro_torch::cp_async_wait<0>();

  // through row-padded tiles over the Q and dO stages (no one reads them now)
  bf16* stage = reinterpret_cast<bf16*>(Qs);
  store_wg_tile<D>(stage, dv_acc, 1.f, dv + b * st.dv.b + hk * st.dv.h,
                   st.dv.s, k0, Sk);
  store_wg_tile<D>(stage + WG_T * (D + 8), dk_acc, scale,
                   dk + b * st.dk.b + hk * st.dk.h, st.dk.s, k0, Sk);
}

// Grid (Hq, B, ceil(Sq / 64)): one block a tile of 64 queries, over the key
// tiles up to its causal diagonal; query tiles launched longest first.
template <int D>
__global__ void __launch_bounds__(WG_NT)
attn_bwd_dq_wgmma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Sq, int Sk, int G,
                         int causal, int q_stride, float scale,
                         float scale_log2, BwdStrides st) {
  using W = WgBwd<D>;
  constexpr int DP = W::DP;
  extern __shared__ uint8_t smem_wg[];
  const uint32_t raw = smem_addr(smem_wg);
  uint8_t* Qs = smem_wg + (((raw + 1023) & ~1023u) - raw);
  uint8_t* dOs = Qs + W::TILE;
  uint8_t* Ks = dOs + W::TILE;        // [2][TILE]
  uint8_t* Vs = Ks + 2 * W::TILE;     // [2][TILE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WG_T;  // longest first
  const int hk = h / G;
  const int q_offset = Sk - 1 - (Sq - 1) * q_stride;
  load_wg_tile<D>(Qs, q + b * st.q.b + h * st.q.h, st.q.s, q0, Sq);
  load_wg_tile<D>(dOs, dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0,
                  Sq);
  cp_async_commit();
  const bf16* kg = k + b * st.k.b + hk * st.k.h;
  const bf16* vg = v + b * st.v.b + hk * st.v.h;
  const int q_last = min(q0 + WG_T, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last * q_stride + q_offset + 1) : Sk;
  const int n_tiles = (kv_end + WG_T - 1) / WG_T;
  auto load_kv = [&](int j) {
    load_wg_tile<D>(Ks + (j & 1) * W::TILE, kg, st.k.s, j * WG_T, Sk);
    load_wg_tile<D>(Vs + (j & 1) * W::TILE, vg, st.v.s, j * WG_T, Sk);
  };
  load_kv(0);
  cp_async_commit();

  // this thread's query rows, r = 0, 1: row0 + 8 r; their lse (log2 units)
  // and D, read once
  const int row0 = q0 + warp * 16 + g;
  // their positions: row g + 8's is 8 q_stride further
  const int qpos = row0 * q_stride + q_offset, qpos8 = 8 * q_stride;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const long long at = (static_cast<long long>(b) * gridDim.x + h) * Sq + qi;
    l2[r] = qi < Sq ? lse[at] * LOG2E : 0.f;
    dd[r] = qi < Sq ? delta[at] : 0.f;
  }
  const uint32_t q_addr = smem_addr(Qs), do_addr = smem_addr(dOs);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv(j + 1);
    cp_async_commit();
    repro_torch::cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int k0 = j * WG_T;
    const uint32_t k_addr = smem_addr(Ks + (j & 1) * W::TILE);
    const uint32_t v_addr = smem_addr(Vs + (j & 1) * W::TILE);

    // S = Q.K^T and dP = dO.V^T, two groups
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_scores<D>(s, q_addr, k_addr);
    wgmma_commit();
    mma_scores<D>(dp, do_addr, v_addr);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P in place of S: element [4 n + e] is query row0 + 8 (e / 2), key
    // k0 + 8 n + 2 t + e % 2
    const bool masked = k0 + WG_T > Sk ||
                        (causal && k0 + WG_T - 1 > q0 * q_stride + q_offset);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[4 * n + e], scale_log2, -l2[e >> 1]));
        if (masked) {
          const int kk = k0 + 8 * n + 2 * t + (e & 1);
          if (kk >= Sk || (causal && kk > qpos + (e >> 1) * qpos8)) p = 0.f;
        }
        s[4 * n + e] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dd[(i >> 1) & 1]);
    uint32_t da[4][4];
    to_a(da, dp);
    // dQ += dS.K
    fence_regs(acc);
    wgmma_fence();
    mma_grad<DP>(acc, da, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this stage before refill
  }
  repro_torch::cp_async_wait<0>();

  // through a row-padded tile over the K stages (no one reads them now)
  store_wg_tile<D>(reinterpret_cast<bf16*>(Ks), acc, scale,
                   dq + b * st.dq.b + h * st.dq.h, st.dq.s, q0, Sq);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
           int causal, int q_stride, float scale, const BwdStrides& st,
           cudaStream_t stream) {
  using Tl = Tile<D>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  cudaError_t err = preprocess<T>(o, dout, delta, B, Hq, Sq, D, st, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t s_kv = dkdv_smem<D>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<T, D><<<dim3(Hkv, B, (Sk + Tl::BT - 1) / Tl::BT), NT,
                               s_kv, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Sq, Sk, Hq / Hkv, causal, q_stride, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t s_q = dq_smem<D>();
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<T, D><<<dim3(Hq, B, (Sq + Tl::BT - 1) / Tl::BT), NT, s_q,
                             stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Sq, Sk, Hq / Hkv,
      causal, q_stride, scale, st);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                 int causal, int q_stride, float scale, const BwdStrides& st,
                 cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  cudaError_t err = preprocess<bf16>(o, dout, delta, B, Hq, Sq, D, st,
                                     stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem = WgBwd<D>::SMEM;
  const float scale_log2 = scale * LOG2E;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_wgmma_kernel<D><<<dim3(Hkv, B, (Sk + WG_T - 1) / WG_T), WG_NT,
                                  smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Hq, Sq, Sk, Hq / Hkv, causal, q_stride, scale,
      scale_log2, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(attn_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_wgmma_kernel<D><<<dim3(Hq, B, (Sq + WG_T - 1) / WG_T), WG_NT,
                                smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), Sq, Sk, Hq / Hkv,
      causal, q_stride, scale, scale_log2, st);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at D <= 128 on the tensor cores; f32, and bf16 at D = 256, on the
// CUDA cores
template <typename T, int D>
int route(const void* q, const void* k, const void* v, const void* o,
          const void* dout, const float* lse, float* delta, void* dq,
          void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
          int causal, int q_stride, float scale, const BwdStrides& st,
          cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128)
    return launch_wgmma<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                           Hkv, Sq, Sk, causal, q_stride, scale, st, stream);
  else
    return launch<T, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,
                        Sq, Sk, causal, q_stride, scale, st, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
             int D, int causal, int q_stride, float scale,
             const long long* sv, void* stream) {
  BwdStrides st;
  Strides3* parts[] = {&st.q, &st.k, &st.v, &st.o,
                       &st.dout, &st.dq, &st.dk, &st.dv};
  for (int i = 0; i < 8; ++i) *parts[i] = {sv[3 * i], sv[3 * i + 1], sv[3 * i + 2]};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return route<T, 32>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, q_stride, scale, st, s);
    case 64: return route<T, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, q_stride, scale, st, s);
    case 128: return route<T, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, q_stride, scale, st, s);
    case 256: return route<T, 256>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, q_stride, scale, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o, dO in one dtype; lse (B, Hq, Sq) f32 from the forward; delta a
// (B, Hq, Sq) f32 workspace; dq, dk, dv outputs in the inputs' dtype;
// q_stride >= 1 (query row i at position i * q_stride + Sk - 1 - (Sq - 1) *
// q_stride).  strides: 24 element strides (b, h, s) of q, k, v, o, dO, dq,
// dk, dv.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                            int q_stride, float scale,
                            const long long* strides, void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,
                         Sq, Sk, D, causal, q_stride, scale, strides, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int Hq, int Hkv, int Sq, int Sk, int D,
                             int causal, int q_stride, float scale,
                             const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, Sq, Sk, D, causal, q_stride, scale,
                                 strides, stream);
}

}  // extern "C"
