// Flash decode over a float or an int8 KV cache, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of the JAX package:
//   flash_decode       <- kernels/decode_attn.py      _decode_kernel
//   flash_decode_int8  <- kernels/decode_attn_int8.py _decode_int8_kernel
// One query token per sequence attends over its cache: q (B, Hq, D),
// k/v (B, Hkv, S, D), the G = Hq / Hkv query heads of a KV head together;
// positions >= length[b] are masked.  The int8 variant reads int8 k/v with
// one f32 scale per (position, head), (B, Hkv, S, 1), and dequantizes each
// element after the load (k8 * scale, as the reference's oracle does).  The
// running max, sum and accumulator are f32; the output is in q's dtype.
//
// What bounds it on this card: bytes.  Each cached position is read once
// and used for G dot products and G axpys of length D, a few operations per
// byte, far below the ~295 the H100 needs before operations bound.  What the
// design does about it: the block loops only over positions < length[b]
// (masked positions contribute exactly 0 to the reference, so the result is
// the same), reads the cache through strides in the model's own
// (B, S, Hkv, D) layout without a copy, and splits the positions of its
// sequence over 8 warps so that many loads are in flight per SM; the warps'
// partial (max, sum, accumulator) are merged once, in shared memory, at the
// end: no second pass and no atomics.  The int8 cache halves the bytes of a
// bf16 one.  Not yet done: splitting a long sequence over several blocks
// (at B * Hkv = 64 blocks the card's 132 SMs are not all busy), and wider
// loads.
//
// Layout: grid (Hkv, B, ceil(G / 8)); 8 warps.  In each 32-position tile a
// lane owns one position and computes its scores for the block's (up to 8)
// query heads from q rows staged in shared memory; the warp then updates its
// online softmax with shuffle reductions, and accumulates P.V with each lane
// owning float4 chunks lane + 32 c of the head dimension.  length == 0 (or
// less) masks every position and gives an output of zeros (the plain version
// averages V over all S positions instead); the model never passes it.
// length > S reads all S positions.
//
// Plain-C entry points (loaded with ctypes): each launches on the given
// stream and returns cudaGetLastError().

#include "common.cuh"

namespace {

using repro_torch::NEG;

constexpr int NW = 8;    // warps per block
constexpr int MAXG = 8;  // query heads per block

struct DecodeStrides {
  long long qb, qh;        // q (B, Hq, D)
  long long kb, kh, ks;    // k (B, Hkv, S, D)
  long long vb, vh, vs;    // v
  long long ob, oh;        // out (B, Hq, D)
  long long sb, sh, ss;    // scales (B, Hkv, S, 1), shared by k and v
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(MAXG) * D +
                          static_cast<size_t>(NW) * MAXG * (D + 2));
}

template <typename TQ, typename TKV, bool QUANT, int D>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const float* __restrict__ kscale, const TKV* __restrict__ v,
              const float* __restrict__ vscale, TQ* __restrict__ o,
              const int* __restrict__ length, int S, int G, float sm_scale,
              DecodeStrides st) {
  constexpr int NC = D / 4;            // float4 chunks per row
  constexpr int OC = (NC + 31) / 32;   // output chunks per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [MAXG][D]
  float* wm = qs + MAXG * D;                     // [NW][MAXG]
  float* wl = wm + NW * MAXG;                    // [NW][MAXG]
  float* wacc = wl + NW * MAXG;                  // [NW][MAXG][D]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int g0 = blockIdx.z * MAXG;
  const int gn = min(MAXG, G - g0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = max(0, min(length[b], S));

  for (int i = threadIdx.x; i < gn * NC; i += NW * 32) {
    const int g = i / NC, c = (i % NC) * 4;
    const TQ* qrow = q + b * st.qb + (hk * G + g0 + g) * st.qh;
    *reinterpret_cast<float4*>(&qs[g * D + c]) = repro_torch::load4(qrow + c);
  }
  __syncthreads();

  const TKV* kb = k + b * st.kb + hk * st.kh;
  const TKV* vb = v + b * st.vb + hk * st.vh;
  const float* ksb = QUANT ? kscale + b * st.sb + hk * st.sh : nullptr;
  const float* vsb = QUANT ? vscale + b * st.sb + hk * st.sh : nullptr;

  float m[MAXG], l[MAXG];
  float4 acc[MAXG][OC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[g][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t0 = warp * 32; t0 < L; t0 += NW * 32) {
    const int pos = t0 + lane;
    const bool ok = pos < L;
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (ok) {
      const TKV* krow = kb + pos * st.ks;
      const float ksc = QUANT ? ksb[pos * st.ss] : 1.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 kx = repro_torch::load4(krow + d);
        if (QUANT) kx = repro_torch::scale4(kx, ksc);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < gn)
            s[g] = repro_torch::dot4(
                *reinterpret_cast<const float4*>(&qs[g * D + d]), kx, s[g]);
      }
    }
    float p[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= gn) break;
      const float sc = s[g] * sm_scale;
      float mx = ok ? sc : NEG;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      p[g] = ok ? expf(sc - m_new) : 0.f;
      float sum = p[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[g][c] = repro_torch::scale4(acc[g][c], alpha);
    }
    const int tn = min(32, L - t0);
    for (int j = 0; j < tn; ++j) {
      const int pj = t0 + j;
      const float vsc = QUANT ? vsb[pj * st.ss] : 1.f;
      float4 vx[OC];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int col = (lane + 32 * c) * 4;
        vx[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col < D) {
          vx[c] = repro_torch::load4(vb + pj * st.vs + col);
          if (QUANT) vx[c] = repro_torch::scale4(vx[c], vsc);
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= gn) break;
        const float pg = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
        for (int c = 0; c < OC; ++c) repro_torch::axpy4(pg, vx[c], acc[g][c]);
      }
    }
  }

  // merge the warps' partial softmax states
  for (int g = 0; g < gn; ++g) {
    if (lane == 0) {
      wm[warp * MAXG + g] = m[g];
      wl[warp * MAXG + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = (lane + 32 * c) * 4;
      if (col < D)
        *reinterpret_cast<float4*>(&wacc[(warp * MAXG + g) * D + col]) = acc[g][c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float mx = NEG;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * MAXG + g]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w * MAXG + g] - mx);
      lsum = fmaf(wl[w * MAXG + g], f, lsum);
      osum = fmaf(wacc[(w * MAXG + g) * D + d], f, osum);
    }
    repro_torch::store(o + b * st.ob + (hk * G + g0 + g) * st.oh + d,
                       osum / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TKV, bool QUANT, int D>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* o, const void* length, int B, int Hq,
           int Hkv, int S, float sm_scale, const long long* strides,
           cudaStream_t stream) {
  const DecodeStrides st{strides[0], strides[1], strides[2], strides[3],
                         strides[4], strides[5], strides[6], strides[7],
                         strides[8], strides[9], strides[10], strides[11],
                         strides[12]};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV, QUANT, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = Hq / Hkv;
  const dim3 grid(Hkv, B, (G + MAXG - 1) / MAXG);
  decode_kernel<TQ, TKV, QUANT, D><<<grid, NW * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const float*>(ks), static_cast<const TKV*>(v),
      static_cast<const float*>(vs), static_cast<TQ*>(o),
      static_cast<const int*>(length), S, G, sm_scale, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT>
int dispatch(const void* q, const void* k, const void* ks, const void* v,
             const void* vs, void* o, const void* length, int B, int Hq,
             int Hkv, int S, int D, float sm_scale, const long long* strides,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<TQ, TKV, QUANT, 32>(q, k, ks, v, vs, o, length, B, Hq, Hkv, S, sm_scale, strides, s);
    case 64: return launch<TQ, TKV, QUANT, 64>(q, k, ks, v, vs, o, length, B, Hq, Hkv, S, sm_scale, strides, s);
    case 128: return launch<TQ, TKV, QUANT, 128>(q, k, ks, v, vs, o, length, B, Hq, Hkv, S, sm_scale, strides, s);
    case 256: return launch<TQ, TKV, QUANT, 256>(q, k, ks, v, vs, o, length, B, Hq, Hkv, S, sm_scale, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 13 element strides: q (b, h), k (b, h, s), v (b, h, s),
// out (b, h), scales (b, h, s); the scale strides are ignored here
int flash_decode_f32(const void* q, const void* k, const void* v, void* o,
                     const void* length, int B, int Hq, int Hkv, int S, int D,
                     float sm_scale, const long long* strides, void* stream) {
  return dispatch<float, float, false>(q, k, nullptr, v, nullptr, o, length,
                                       B, Hq, Hkv, S, D, sm_scale, strides,
                                       stream);
}

int flash_decode_bf16(const void* q, const void* k, const void* v, void* o,
                      const void* length, int B, int Hq, int Hkv, int S,
                      int D, float sm_scale, const long long* strides,
                      void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, nullptr, v, nullptr, o, length, B, Hq, Hkv, S, D, sm_scale,
      strides, stream);
}

int flash_decode_int8_f32(const void* q, const void* k8, const void* ks,
                          const void* v8, const void* vs, void* o,
                          const void* length, int B, int Hq, int Hkv, int S,
                          int D, float sm_scale, const long long* strides,
                          void* stream) {
  return dispatch<float, int8_t, true>(q, k8, ks, v8, vs, o, length, B, Hq,
                                       Hkv, S, D, sm_scale, strides, stream);
}

int flash_decode_int8_bf16(const void* q, const void* k8, const void* ks,
                           const void* v8, const void* vs, void* o,
                           const void* length, int B, int Hq, int Hkv, int S,
                           int D, float sm_scale, const long long* strides,
                           void* stream) {
  return dispatch<__nv_bfloat16, int8_t, true>(q, k8, ks, v8, vs, o, length,
                                               B, Hq, Hkv, S, D, sm_scale,
                                               strides, stream);
}

}  // extern "C"
