// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's kernels/flash_attn.py
// (flash_attention -> _flash_kernel): online-softmax attention of
// q (B, Hq, Sq, D) over k/v (B, Hkv, Sk, D); query head h reads KV head
// h / G (G = Hq / Hkv); query i sits at absolute position i + Sk - Sq and
// sees keys at positions <= its own when causal.  The running max, sum and
// output accumulator are f32; the output is in q's dtype.
//
// What bounds it on this card: at the LM's prefill shapes (Sq = Sk in the
// hundreds to thousands, D = 128) attention does ~2 * Sq * Sk * D operations
// per head against ~3 * Sk * D elements moved, hundreds of operations per
// byte: it is bound by operations, and the card's rate for them is the
// tensor cores' (989 TFLOP/s in bf16).  This first kernel does not reach
// them: it computes in f32 on the CUDA cores (67 TFLOP/s at most), which
// keeps one code path for f32 and bf16 and the f32 accumulation the
// reference has.  What the design does about the bound within that: each
// thread owns a 4 x 4 tile of the 64 x 64 score block and a 4-row slice of
// the output, so every shared-memory load feeds 8 (scores) or 5 (P.V) FMAs;
// K/V tiles are staged once per block in shared memory and read by all 256
// threads; blocks stop at the causal diagonal, so causal work is about
// half of the full square.  Tensor cores (mma/wgmma) and TMA are later work.
//
// Layout: grid (ceil(Sq / 64), Hq, B); 256 threads as 16 x 16.  Thread
// (tr, tc) owns query rows tr + 16 i and keys tc + 16 j (i, j < 4) of each
// 64 x 64 score tile, and output columns in float4 chunks tc + 16 c.  The
// 16 threads of a row group are one half-warp, so the row max and sum are
// shuffle reductions.  Q, K, V and P tiles live in dynamic shared memory as
// f32 (K and Q rows padded by 4 floats against bank conflicts).  Inputs are
// read through element strides (the last dimension contiguous), so the model
// passes its (B, S, H, D) tensors as transposed views; edges in Sq and Sk
// are masked, so any length works.  Rows beyond Sq are computed and not
// stored.
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include "common.cuh"

namespace {

using repro_torch::NEG;

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block, 16 x 16

struct Strides3 {
  long long b, h, s;  // element strides; the d stride is 1
};
struct AttnStrides {
  Strides3 q, k, v, o;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (D + 4) + static_cast<size_t>(BK) * (D + 4) +
          static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * (BK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int G, int causal, float sm_scale,
                       AttnStrides st) {
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, float sm_scale,
           const long long* strides, cudaStream_t stream) {
  const AttnStrides st{{strides[0], strides[1], strides[2]},
                       {strides[3], strides[4], strides[5]},
                       {strides[6], strides[7], strides[8]},
                       {strides[9], strides[10], strides[11]}};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq / Hkv, causal,
      sm_scale, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Sk, int D, int causal,
             float sm_scale, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, sm_scale, strides, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, sm_scale, strides, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, sm_scale, strides, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, sm_scale, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 12 element strides (b, h, s) of q, k, v and o, in that order
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Sk, int D,
                        int causal, float sm_scale, const long long* strides,
                        void* stream) {
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, sm_scale,
                         strides, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int Sq, int Sk, int D,
                         int causal, float sm_scale, const long long* strides,
                         void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                 sm_scale, strides, stream);
}

}  // extern "C"
