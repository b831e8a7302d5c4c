// Flash attention forward for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   `flash_attention_pallas` (kernel body `_fa_kernel`), the TPU kernel that
//   every attention layer of the model calls when kernels are on.
//
// What it computes (the same function as `_fa_kernel`): online-softmax
// attention, GQA by q-head -> kv-head `h / (Hq / Hkv)`, a causal mask and a
// valid-prefix mask `kpos < kv_len`, scores QK^T in f32 then `* scale`,
// P cast to the value dtype before the PV product, an f32 accumulator, and
// zeros for a row whose every key is masked.
//
// What bounds it on this card: bytes. Decode (one query row per sequence
// over a KV cache) does 2 * D multiply-adds per K/V element it reads, far
// below the ~295 FLOP/byte an H100 needs before the tensor cores, not HBM,
// are the limit. So the design reads each live K/V byte once per CTA and
// nothing else:
//   * q/k/v/out are read in the model layout (b, S, h, d) through strides,
//     so no transposed copy of the KV cache is ever made;
//   * the KV loop stops at min(kv_len, causal frontier): cache slots past
//     kv_len are never read (this replaces the TPU's `pl.when(live)`);
//   * ragged Sq/Skv edges are masked here, so nothing is padded;
//   * K/V tiles come in with 16-byte loads, several in flight per thread;
//   * a decode row tile is 1 (BQ = 1), so no CTA computes padding rows.
// Training and prefill (many query rows, causal over the whole sequence)
// are bounded by operations instead: ~2 * D multiply-adds per score and per
// output element against the bf16 tensor-core peak. There the FMA loops
// below, with one 133 KB CTA per SM, are far from that bound.
// Not done yet (later work): tensor cores (mma/wgmma) with TMA for those
// many-row tiles, grouping the Hq/Hkv q-heads of one kv-head in a CTA
// (decode reads each K/V row Hq/Hkv times, mostly from L2), and split-KV for
// more CTAs at small batch. The backward recomputes through the plain
// version (kernels/flash_attention/ops.py); a backward kernel is later work.
//
// One CTA of 128 threads per (q tile, q-head, batch). The TPU kernel's
// sequential KV grid axis becomes the loop inside the CTA; its (bq, 128)
// lane-broadcast m/l scratch becomes one running max and sum per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadUnroll = 8;  // 16-byte K and V loads in flight per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight bf16 or four f32 values of one 16-byte load, widened to f32.
__device__ __forceinline__ void widen(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Sq, Skv;
  long long q_sb, q_ss, q_sh;  // element strides of (b, S, h); d is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int kv_len, q_offset, causal, bk;
  float scale;
};

// Shared memory in floats: Q (BQ x D), K (bk x D+1, padded against bank
// conflicts in the score loop), V (bk x D), scores/P (BQ x bk), m, l, alpha.
__host__ __device__ constexpr int smem_floats(int bq, int bk, int d) {
  return bq * d + bk * (d + 1) + bk * d + bq * bk + 3 * bq;
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int bk = a.bk;
  float* q_s = smem;
  float* k_s = q_s + BQ * D;
  float* v_s = k_s + bk * (D + 1);
  float* p_s = v_s + bk * D;
  float* m_s = p_s + BQ * bk;
  float* l_s = m_s + BQ;
  float* alpha_s = l_s + BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = q0 + r < a.Sq ? to_f32(q[(q0 + r) * a.q_ss + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // Keys this tile can see: the valid prefix, cut at the causal frontier of
  // its last real row. Nothing at or past kv_end is read.
  int kv_end = min(a.kv_len, a.Skv);
  if (a.causal) kv_end = min(kv_end, a.q_offset + min(q0 + BQ, a.Sq));

  constexpr int kAcc = (BQ * D + kThreads - 1) / kThreads;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  __syncthreads();

  for (int kv0 = 0; kv0 < kv_end; kv0 += bk) {
    const int n = min(bk, kv_end - kv0);  // rows of this tile that exist

    // K/V tile -> shared memory as f32; rows past n are zero.
    for (int base = tid; base < bk * kVecPerRow; base += kThreads * kLoadUnroll) {
      uint4 kr[kLoadUnroll], vr[kLoadUnroll];
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int i = base + u * kThreads;
        const int c = i / kVecPerRow, d = (i % kVecPerRow) * kVec;
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
        if (i < bk * kVecPerRow && c < n) {
          const long long s = kv0 + c;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(k + s * a.k_ss + d));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(v + s * a.v_ss + d));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < bk * kVecPerRow) {
          const int c = i / kVecPerRow, d = (i % kVecPerRow) * kVec;
          float kf[kVec], vf[kVec];
          widen(kr[u], kf, T());
          widen(vr[u], vf, T());
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            k_s[c * (D + 1) + d + e] = kf[e];
            v_s[c * D + d + e] = vf[e];
          }
        }
      }
    }
    __syncthreads();

    // Scores in f32, then * scale; masked entries are exactly kNegInf.
    for (int i = tid; i < BQ * bk; i += kThreads) {
      const int r = i / bk, c = i - r * bk;
      const float* qr = q_s + r * D;
      const float* kc = k_s + c * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kc[d], s);
      const bool live = c < n && (!a.causal || a.q_offset + q0 + r >= kv0 + c);
      p_s[i] = live ? s * a.scale : kNegInf;
    }
    __syncthreads();

    // Online softmax, one warp per row. P is rounded to T (the PV operand
    // type, as the TPU kernel casts p to v.dtype); l sums the f32 values.
    for (int r = warp; r < BQ; r += kWarps) {
      float* pr = p_s + r * bk;
      float mx = kNegInf;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, pr[c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const float s = pr[c];
        const float e = s == kNegInf ? 0.f : expf(s - m_new);
        sum += e;
        pr[c] = to_f32(from_f32<T>(e));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; thread owns elements tid + j * kThreads.
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < BQ * D) {
        const int r = i / D, c = i % D;
        const float* pr = p_s + r * bk;
        float x = acc[j] * alpha_s[r];
        for (int kk = 0; kk < n; ++kk) x = fmaf(pr[kk], v_s[kk * D + c], x);
        acc[j] = x;
      }
    }
    __syncthreads();
  }

  // l == 0 only when every key of the row was masked: write zeros.
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < BQ * D) {
      const int r = i / D, c = i % D;
      if (q0 + r < a.Sq) {
        const float l = l_s[r];
        o[(q0 + r) * a.o_ss + c] = from_f32<T>(l == 0.f ? 0.f : acc[j] / l);
      }
    }
  }
}

constexpr int kMaxBk = 128;

template <typename T, int D, int BQ>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  if (a.bk < 1 || a.bk > kMaxBk) return cudaErrorInvalidValue;
  auto kernel = fa_fwd_kernel<T, D, BQ>;
  // Above 48 KB a block's shared memory must be opted into, once per instance.
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(BQ, kMaxBk, D) * (int)sizeof(float));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, B);
  const size_t smem = smem_floats(BQ, a.bk, D) * sizeof(float);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int BQ>
cudaError_t dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, BQ>(a, B, stream);
    case 32: return launch<T, 32, BQ>(a, B, stream);
    case 64: return launch<T, 64, BQ>(a, B, stream);
    case 80: return launch<T, 80, BQ>(a, B, stream);
    case 128: return launch<T, 128, BQ>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bq(int bq, int D, const Args& a, int B, cudaStream_t stream) {
  if (bq == 1) return dispatch_d<T, 1>(D, a, B, stream);
  if (bq == 64) return dispatch_d<T, 64>(D, a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory, in bytes, of one CTA with row tile bq, KV tile bk
// and head dim d.
extern "C" int fa_smem_bytes(int bq, int bk, int d) {
  return smem_floats(bq, bk, d) * (int)sizeof(float);
}

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o (B, Sq, Hq, D), all of one
// dtype (bf16 != 0: bfloat16, else float32) with d contiguous; `strides`
// holds the element strides of dims (b, S, h) of q, k, v, o in that order.
// K/V rows must be 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int B, int Hq, int Hkv, int Sq, int Skv, int D,
                          const long long* strides, int kv_len, int q_offset,
                          int causal, float scale, int bf16, int bq, int bk,
                          void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, Hq, Hkv, Sq, Skv,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
               kv_len, q_offset, causal, bk, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bq<__nv_bfloat16>(bq, D, a, B, s)
              : dispatch_bq<float>(bq, D, a, B, s);
}
