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
//   dK   = scale sum_g dS^T Q                                (dkdv kernel)
//   dQ   = scale dS K                                        (dq kernel)
//
// where sum_g runs over the G = Hq / Hkv query heads of a KV head.  S and P
// are recomputed from lse in both kernels, never stored.  Query i sits at
// position i + Sk - Sq and, when causal, sees keys at positions <= its own;
// every row then sees at least one key (the wrapper refuses causal Sq > Sk,
// whose first rows see none and which no training path sends).  Ragged Sq and
// Sk are masked: rows past Sq and keys past Sk get P = 0.
//
// No atomics: each dK/dV tile is written by the one block that owns its keys,
// which loops over the G query heads and every query tile that sees them, and
// each dQ tile by the one block that owns its queries, which loops over the
// key tiles up to the causal diagonal.  The sums run in a fixed order, so a
// backward is bit-equal to itself from run to run.
//
// What bounds it on this card: at llama3.2-3b's training shape (B 8, Hq 24,
// Hkv 8, S 512, D 128, causal) the five products need ~3.2e10 operations
// against ~134 MB moved, so it is bound by operations.  This first version is
// simple and right: f32 arithmetic on the CUDA cores (67 TFLOP/s at most,
// not the tensor cores' 989 in bf16), 64 x 64 tiles (32 x 32 at D = 256)
// staged in shared memory as f32 like the forward's f32 kernel; each of the
// 256 threads owns a 4 x 4 (2 x 2) block of a score tile and rows x float4
// columns of its accumulators, so every shared-memory load feeds several
// FMAs.  The recomputation costs the two kernels seven products where the
// math needs five.  A wgmma redesign is later work.
//
// Inputs are read through element strides with a contiguous last dimension
// (loads of 4 elements: the wrapper aligns the data pointers and the b, h, s
// strides to 4 elements in f32, 8 in bf16), so the model's (B, S, H, D)
// views are read in place; gradients are written through their own strides.
//
// Plain-C entry points (loaded with ctypes): each launches the three kernels
// on the given stream and returns the first launch error.

#include <math.h>

#include "common.cuh"

namespace {

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
                     int causal, float scale, BwdStrides st) {
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
  const int off = Sk - Sq;
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

  // the first query that sees key k0 sits at k0 - off
  const int t_first = causal ? max(0, k0 - off) / BT : 0;
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
          const bool ok = qi < Sq && kk < Sk && (!causal || kk <= qi + off);
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
                   int Sq, int Sk, int G, int causal, float scale,
                   BwdStrides st) {
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
  const int off = Sk - Sq;
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
  const int kv_end = causal ? min(Sk, q_last + off + 1) : Sk;
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
        const bool ok = qi < Sq && kk < Sk && (!causal || kk <= qi + off);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
           int causal, float scale, const BwdStrides& st,
           cudaStream_t stream) {
  using Tl = Tile<D>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  attn_bwd_preprocess_kernel<T><<<dim3((Sq + NT / 32 - 1) / (NT / 32), Hq, B),
                                   NT, 0, stream>>>(
      static_cast<const T*>(o), dop, delta, Sq, D, st.o, st.dout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t s_kv = dkdv_smem<D>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<T, D><<<dim3(Hkv, B, (Sk + Tl::BT - 1) / Tl::BT), NT,
                               s_kv, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Sq, Sk, Hq / Hkv, causal, scale, st);
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
      causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
             int D, int causal, float scale, const long long* sv,
             void* stream) {
  BwdStrides st;
  Strides3* parts[] = {&st.q, &st.k, &st.v, &st.o,
                       &st.dout, &st.dq, &st.dk, &st.dv};
  for (int i = 0; i < 8; ++i) *parts[i] = {sv[3 * i], sv[3 * i + 1], sv[3 * i + 2]};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, scale, st, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, scale, st, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, scale, st, s);
    case 256: return launch<T, 256>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Hq, Hkv, Sq, Sk, causal, scale, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v, o, dO in one dtype; lse (B, Hq, Sq) f32 from the forward; delta a
// (B, Hq, Sq) f32 workspace; dq, dk, dv outputs in the inputs' dtype.
// strides: 24 element strides (b, h, s) of q, k, v, o, dO, dq, dk, dv.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                            float scale, const long long* strides,
                            void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,
                         Sq, Sk, D, causal, scale, strides, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int Hq, int Hkv, int Sq, int Sk, int D,
                             int causal, float scale,
                             const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, Sq, Sk, D, causal, scale, strides,
                                 stream);
}

}  // extern "C"
