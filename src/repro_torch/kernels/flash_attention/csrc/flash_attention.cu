// Flash attention forward for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   `flash_attention_pallas` (kernel body `_fa_kernel`), the TPU kernel that
//   every attention layer of the model calls when kernels are on.
//
// What it computes (the same function as `_fa_kernel`): online-softmax
// attention, GQA by q-head -> kv-head `h / (Hq / Hkv)`, a causal mask and a
// valid-prefix mask `kpos < kv_len`, scores QK^T in f32 then `* scale`,
// P cast to the value dtype before the PV product (l sums the f32 values),
// an f32 accumulator, and zeros for a row whose every key is masked.
//
// Common to every instance:
//   * q/k/v/out are read in the model layout (b, S, h, d) through strides,
//     so no transposed copy of the KV cache is ever made;
//   * the KV loop stops at min(kv_len, causal frontier): cache slots past
//     kv_len are never read (this replaces the TPU's `pl.when(live)`);
//   * ragged Sq/Skv edges are masked here, so nothing is padded;
//   * K/V rows come in as 16-byte `cp.async` copies and stay in the input
//     dtype in shared memory.
//
// Three instances, by what bounds each on this card:
//
// 1. Many query rows in bf16 (training, prefill): bounded by operations,
//    ~2 * D multiply-adds per score and per output element against the bf16
//    tensor-core peak. `fa_mma_kernel`, FA2-style: one CTA of 4 warps per
//    (64-row q tile, q-head, batch), 16 rows per warp. Q is loaded once into
//    `mma.sync.m16n8k16` A fragments (ldmatrix); K/V tiles are double
//    buffered in shared memory as bf16, each row padded by 16 bytes so that
//    the 8 rows one ldmatrix reads fall in 8 different bank groups (D = 80:
//    160 -> 176 bytes). S = Q K^T and O += P V run on the tensor cores; the
//    online softmax stays in registers (a row's max and sum reduce over the
//    4 lanes of a quad); P is rounded to bf16 in registers and used as the
//    A fragment of P V, with V through ldmatrix.trans. The element mask runs
//    only on tiles that cross the diagonal or the kv_len edge. D = 192 rows
//    take 400 bytes (25 units) and up to 64 keys a tile, so that Q, O and S
//    stay in registers. `mma.sync` rather than wgmma: a 160-byte row does not fit wgmma's swizzled layouts
//    without splitting D into 64 + 16, and 16 rows per warp keep the softmax
//    free of any exchange across warps.
// 2. Many query rows in f32 (tests, f32 checks): `fa_fwd_kernel`, FMA loops
//    on the CUDA cores; at D = 192 a KV tile of 128 keys would pass the
//    227 KB opt-in, so it takes up to 96. Tensor cores would mean TF32,
//    whose ~1e-3 relative error is outside the 2e-4 f32 tolerance.
// 3. Decode (BQ = 1, both dtypes): bounded by bytes, 2 * D multiply-adds per
//    K/V element read, far below the ~295 FLOP/byte where the tensor cores
//    become the limit. `fa_decode_kernel`: one CTA per (KV split, query
//    position, batch x kv-head) takes all G = Hq / Hkv q-heads of the
//    kv-head (up to kDecodeRows at once), so each live K/V byte is read once.
//    Measured, its time goes to dependent latency rather than to bytes (warm
//    and cold L2 take the same time), so its CTA has 8 warps: two threads
//    per key for the scores, a warp per q-head for the softmax, a warp per
//    eighth of the keys for P V.
//    At D = 192 a lane owns two groups of 4 columns in P V, and a CTA may
//    take all of an SM's registers.
//    The live keys are cut into `n_split` parts (the wrapper's rule: enough
//    that b * Hkv * n_split covers the 132 SMs, never more than KV tiles);
//    each part writes a partial (m, l, acc) in f32 to the wrapper's scratch,
//    and `fa_combine_kernel`, launched next by the same C entry, merges them
//    by log-sum-exp; one part writes the output directly. On request the
//    instance also writes each row's log-sum-exp of its scaled scores, in
//    f32 (the combine where there are parts, else the one part): a caller
//    holding one shard of a cache merges its rows with other shards' by it.
//    A row with no live key gives zeros and a log-sum-exp of -inf.
//
// The backward recomputes through the plain version
// (kernels/flash_attention/ops.py); a backward kernel is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadUnroll = 8;  // 16-byte K and V loads in flight per thread (f32 FMA kernel)
constexpr int kMaxBk = 128;
constexpr int kMaxSmem = 232448;  // the opt-in limit of a block's shared memory
constexpr int kRowTile = 64;    // rows of a many-row CTA
constexpr int kDecodeRows = 8;  // q-heads of one kv-head a decode CTA holds at once
constexpr int kDecodeThreads = 256;  // a decode CTA: latency-bound, so 8 warps
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kMinusInfBits = 0xff800000u;  // the log-sum-exp of a row with no live key
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Eight bf16 or four f32 values of one 16-byte load, widened to f32.
__device__ __forceinline__ void widen(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float* out, bf16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Four consecutive values at p (8-byte aligned for bf16, 16 for f32), as f32.
__device__ __forceinline__ void widen4(const float* p, float (&out)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
}
__device__ __forceinline__ void widen4(const bf16* p, float (&out)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = hi.x;
  out[3] = hi.y;
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

// ---- PTX: cp.async, ldmatrix, mma.sync ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups are still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
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

// ---------------------------------------------------------------------------
// 2. Many rows, f32: FMA loops on the CUDA cores.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// 1. Many rows, bf16: mma.sync on the tensor cores.
// ---------------------------------------------------------------------------

// Shared memory: two stages of K and V tiles, bk rows of D + 8 bf16 each
// (16 bytes of padding per row). Q passes through stage 1 before tile 1.
__host__ __device__ constexpr int mma_smem_bytes(int bk, int d) {
  return 2 * 2 * bk * (d + 8) * 2;
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads) fa_mma_kernel(const Args a) {
  constexpr int LD = D + 8;   // bf16 per shared row: an odd number of 16-byte units
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int KT = D / 16;  // k-steps of Q K^T
  constexpr int NT = BK / 8;  // n8 tiles of S
  constexpr int DT = D / 8;   // n8 tiles of O
  static_assert(D % 16 == 0 && BK % 16 == 0 && 2 * BK >= kRowTile, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* const q_s = sm + 2 * BK * LD;  // stage 1's K and V, until tile 1 is loaded

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowTile;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  bf16* o = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int kv_valid = min(a.kv_len, a.Skv);
  int kv_end = kv_valid;  // nothing at or past kv_end is read
  if (a.causal) kv_end = min(kv_end, a.q_offset + min(q0 + kRowTile, a.Sq));
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  // K/V tile t -> stage s; rows past kv_end are zero (0 * garbage could be NaN).
  auto load_kv = [&](int t, int s) {
    const int kv0 = t * BK, n = min(BK, kv_end - kv0);
    bf16* ks = sm + s * 2 * BK * LD;
    bf16* vs = ks + BK * LD;
    for (int i = tid; i < BK * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      if (r < n) {
        cp_async16(ks + r * LD + c, k + (long long)(kv0 + r) * a.k_ss + c);
        cp_async16(vs + r * LD + c, v + (long long)(kv0 + r) * a.v_ss + c);
      } else {
        *reinterpret_cast<uint4*>(ks + r * LD + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + r * LD + c) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  for (int i = tid; i < kRowTile * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (q0 + r < a.Sq)
      cp_async16(q_s + r * LD + c, q + (long long)(q0 + r) * a.q_ss + c);
    else
      *reinterpret_cast<uint4*>(q_s + r * LD + c) = make_uint4(0, 0, 0, 0);
  }
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix.x4: lane l gives the row address of 8x8 matrix l / 8, row l % 8.
  const int mi = lane >> 3, mr = lane & 7;
  uint32_t qf[KT][4];  // A fragments: rows 0-7 / 8-15 x k 0-7 / 8-15
  {
    const bf16* base = q_s + (warp * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) ldmatrix_x4(qf[kt], base + kt * 16);
  }
  __syncthreads();  // stage 1 is free for tile 1

  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows lane/4 and lane/4 + 8 of the warp
  float l_r[2] = {0.f, 0.f};          // this lane's part of each row's sum
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1, kv0 = t * BK;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, s ^ 1);
      cp_async_commit();
    }
    const bf16* ks = sm + s * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;

    // S = Q K^T: a K row is a column of B, so ldmatrix without .trans;
    // matrices (keys 0-7 / 8-15) x (d 0-7 / 8-15) of a 16-key pair of tiles.
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    {
      const bf16* base = ks + ((mi >> 1) * 8 + mr) * LD + (mi & 1) * 8;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          uint32_t bf[4];
          ldmatrix_x4(bf, base + j2 * 16 * LD + kt * 16);
          mma_bf16(sc[2 * j2], qf[kt], bf[0], bf[1]);
          mma_bf16(sc[2 * j2 + 1], qf[kt], bf[2], bf[3]);
        }
      }
    }

    // scale, then the element mask on tiles that cross the kv_len edge or
    // the diagonal: masked entries are exactly kNegInf
    const bool edge = kv0 + BK > kv_valid || (a.causal && kv0 + BK - 1 > a.q_offset + q0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * a.scale;
        if (edge) {
          const int key = kv0 + j * 8 + col0 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= kv_valid || (a.causal && a.q_offset + row < key)) x = kNegInf;
        }
        sc[j][e] = x;
      }
    }

    // online softmax in registers; a row lives in the 4 lanes of a quad
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((m_r[i] - mx[i]) * kLog2e);
      m_r[i] = mx[i];
      l_r[i] *= alpha[i];
    }
    // A masked entry is 0, not exp(0): a row whose keys are all masked so
    // far has mx == kNegInf.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[j][e];
        const float p = x == kNegInf ? 0.f : exp2f((x - mx[e >> 1]) * kLog2e);
        l_r[e >> 1] += p;
        sc[j][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      oacc[j][0] *= alpha[0];
      oacc[j][1] *= alpha[0];
      oacc[j][2] *= alpha[1];
      oacc[j][3] *= alpha[1];
    }

    // O += P V: P's C fragments are, rounded to bf16, the A fragments of the
    // next product; V through ldmatrix.trans, matrices (keys 0-7 / 8-15) x
    // (d 0-7 / 8-15).
    {
      const bf16* base = vs + ((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pf[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int d2 = 0; d2 < DT / 2; ++d2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, base + kk * 16 * LD + d2 * 16);
          mma_bf16(oacc[2 * d2], pf, bf[0], bf[1]);
          mma_bf16(oacc[2 * d2 + 1], pf, bf[2], bf[3]);
        }
      }
    }
    cp_async_wait<0>();  // tile t + 1 has landed
    __syncthreads();     // and every warp is done with stage s
  }

  // l == 0 only when every key of the row was masked: write zeros.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + i * 8;
    if (row < a.Sq) {
      bf16* orow = o + (long long)row * a.o_ss + col0;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float x0 = l == 0.f ? 0.f : oacc[j][2 * i] / l;
        const float x1 = l == 0.f ? 0.f : oacc[j][2 * i + 1] / l;
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. Decode (BQ = 1): a CTA per (KV split, query position, group of q-heads).
// ---------------------------------------------------------------------------

// Shared memory: 4 / sizeof(T) stages (f32 one, bf16 two, so the same bytes)
// of K and V tiles, bk rows of D elements + 16 bytes; then f32 Q
// (kDecodeRows x D), scores/P (kDecodeRows x bk), m, l, alpha.
__host__ __device__ constexpr int decode_smem_bytes(int bk, int d, int item) {
  return (4 / item) * 2 * bk * (d * item + 16) + 4 * kDecodeRows * (d + bk + 3);
}

// Split s of n_split takes KV tiles [s * n / n_split, (s + 1) * n / n_split)
// of the n tiles of the live keys; the wrapper's split_bounds is the same rule.
__device__ __forceinline__ int split_tile(int s, int n_tiles, int n_split) {
  return (int)((long long)s * n_tiles / n_split);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads, D > 128 ? 1 : 2)
    fa_decode_kernel(const Args a, float* part, int n_split, float* lse) {
  constexpr int kStages = 4 / sizeof(T);
  constexpr int kVec = 16 / sizeof(T);
  constexpr int LD = D + kVec;  // an odd number of 16-byte units: no bank conflicts per key
  constexpr int CPR = D / kVec;  // even for every compiled D: two threads share a key
  constexpr int kAcc = (kDecodeRows * D + kDecodeThreads - 1) / kDecodeThreads;  // epilogue
  constexpr int kQuads = D / 4;  // groups of 4 columns; lane l owns quads l, l + 32, ... in P V
  constexpr int kQPL = (kQuads + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bk = a.bk;
  T* const kv_s = reinterpret_cast<T*>(smem_raw);  // stage s: K at s * 2 * bk * LD, then V
  float* const q_s = reinterpret_cast<float*>(kv_s + kStages * 2 * bk * LD);
  float* const p_s = q_s + kDecodeRows * D;
  float* const m_s = p_s + kDecodeRows * bk;
  float* const l_s = m_s + kDecodeRows;
  float* const alpha_s = l_s + kDecodeRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.Hq / a.Hkv, groups = (G + kDecodeRows - 1) / kDecodeRows;
  const int split = blockIdx.x, qi = blockIdx.y / groups;
  const int g0 = (blockIdx.y % groups) * kDecodeRows, rows = min(kDecodeRows, G - g0);
  const int b = blockIdx.z / a.Hkv, hk = blockIdx.z % a.Hkv;
  const int h0 = hk * G + g0;  // first q-head of this CTA
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + qi * a.q_ss + h0 * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // The live keys every split is cut from, and this query position's end.
  const int kv_valid = min(a.kv_len, a.Skv);
  const int live = a.causal ? min(kv_valid, a.q_offset + a.Sq) : kv_valid;
  const int row_end = a.causal ? min(kv_valid, a.q_offset + qi + 1) : kv_valid;
  const int n_tiles = live > 0 ? (live + bk - 1) / bk : 0;
  const int lo = split_tile(split, n_tiles, n_split) * bk;
  const int hi = min(split_tile(split + 1, n_tiles, n_split) * bk, row_end);
  const int nt = hi > lo ? (hi - lo + bk - 1) / bk : 0;  // every key in [lo, hi) is live

  auto load = [&](int t, int s) {  // only rows below hi: nothing past kv_len is read
    const int kv0 = lo + t * bk, n = min(bk, hi - kv0);
    T* ks = kv_s + s * 2 * bk * LD;
    T* vs = ks + bk * LD;
    for (int i = tid; i < n * CPR; i += kDecodeThreads) {
      const int r = i / CPR, c = (i % CPR) * kVec;
      cp_async16(ks + r * LD + c, k + (long long)(kv0 + r) * a.k_ss + c);
      cp_async16(vs + r * LD + c, v + (long long)(kv0 + r) * a.v_ss + c);
    }
  };
  if (nt > 0) {  // the first tile is in flight while q comes in
    load(0, 0);
    cp_async_commit();
  }
  for (int i = tid; i < kDecodeRows * CPR; i += kDecodeThreads) {
    const int g = i / CPR, c = (i % CPR) * kVec;
    float qf[kVec];
    if (g < rows) {
      widen(__ldg(reinterpret_cast<const uint4*>(q + g * a.q_sh + c)), qf, T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) qf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) q_s[g * D + c + e] = qf[e];
  }
  if (tid < kDecodeRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // P V: warp w takes keys w, w + 8, ... of a tile; lane l owns columns
  // 4q .. 4q + 3 of every q-head for quads q = l, l + 32, ... below D / 4,
  // so no sum waits on a long chain
  float acc[kDecodeRows][kQPL][4];
#pragma unroll
  for (int g = 0; g < kDecodeRows; ++g)
#pragma unroll
    for (int u = 0; u < kQPL; ++u) acc[g][u][0] = acc[g][u][1] = acc[g][u][2] = acc[g][u][3] = 0.f;
  __syncthreads();

  for (int t = 0; t < nt; ++t) {
    const int n = min(bk, hi - (lo + t * bk));
    const T* ks = kv_s + (t % kStages) * 2 * bk * LD;
    const T* vs = ks + bk * LD;
    if (kStages > 1 && t + 1 < nt) {
      load(t + 1, (t + 1) % kStages);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: threads 2c and 2c + 1 take half of key c's D each, for every
    // q-head of the CTA (two partial sums each), and meet by one shuffle
    {
      const int key = tid >> 1, half = tid & 1;
      float sc[kDecodeRows][2];
#pragma unroll
      for (int g = 0; g < kDecodeRows; ++g) sc[g][0] = sc[g][1] = 0.f;
      if (key < n) {
        const T* kr = ks + key * LD + half * (D / 2);
#pragma unroll
        for (int j = 0; j < CPR / 2; ++j) {
          float kf[kVec];
          widen(*reinterpret_cast<const uint4*>(kr + j * kVec), kf, T());
#pragma unroll
          for (int g = 0; g < kDecodeRows; ++g) {
            if (g < rows) {
              const float4* qg =
                  reinterpret_cast<const float4*>(q_s + g * D + half * (D / 2) + j * kVec);
#pragma unroll
              for (int e4 = 0; e4 < kVec / 4; ++e4) {
                const float4 qv = qg[e4];
                float& x = sc[g][(j * (kVec / 4) + e4) & 1];
                x = fmaf(qv.x, kf[4 * e4], x);
                x = fmaf(qv.y, kf[4 * e4 + 1], x);
                x = fmaf(qv.z, kf[4 * e4 + 2], x);
                x = fmaf(qv.w, kf[4 * e4 + 3], x);
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kDecodeRows; ++g) {
        if (g < rows) {  // the same for the whole CTA: every lane reaches the shuffle
          float x = sc[g][0] + sc[g][1];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          if (half == 0 && key < n) p_s[g * bk + key] = x * a.scale;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per q-head; P rounded to T, l sums f32
    for (int g = warp; g < rows; g += kDecodeWarps) {
      float* pr = p_s + g * bk;
      float mx = kNegInf;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, pr[c]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < n; c += 32) {
        const float e = expf(pr[c] - m_new);
        sum += e;
        pr[c] = to_f32(from_f32<T>(e));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this warp's keys of the tile
#pragma unroll
    for (int g = 0; g < kDecodeRows; ++g) {
      const float al = g < rows ? alpha_s[g] : 0.f;
#pragma unroll
      for (int u = 0; u < kQPL; ++u) {
        acc[g][u][0] *= al;
        acc[g][u][1] *= al;
        acc[g][u][2] *= al;
        acc[g][u][3] *= al;
      }
    }
#pragma unroll
    for (int u = 0; u < kQPL; ++u) {
      const int quad = lane + 32 * u;
      if (quad < kQuads) {
#pragma unroll 4
        for (int kk = warp; kk < n; kk += kDecodeWarps) {
          float vf[4];
          widen4(vs + kk * LD + 4 * quad, vf);
#pragma unroll
          for (int g = 0; g < kDecodeRows; ++g) {
            if (g < rows) {
              const float pv = p_s[g * bk + kk];
              acc[g][u][0] = fmaf(pv, vf[0], acc[g][u][0]);
              acc[g][u][1] = fmaf(pv, vf[1], acc[g][u][1]);
              acc[g][u][2] = fmaf(pv, vf[2], acc[g][u][2]);
              acc[g][u][3] = fmaf(pv, vf[3], acc[g][u][3]);
            }
          }
        }
      }
    }
    __syncthreads();
    if (kStages == 1 && t + 1 < nt) {
      load(t + 1, 0);
      cp_async_commit();
    }
  }

  // The warps' sums meet in the K/V buffers, free now (at least 8 * bk * D
  // bytes >= the 8 * 8 * D floats needed).
  float* const red = reinterpret_cast<float*>(kv_s);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kQPL; ++u) {
    const int quad = lane + 32 * u;
    if (quad < kQuads) {
#pragma unroll
      for (int g = 0; g < kDecodeRows; ++g)
        if (g < rows)
          *reinterpret_cast<float4*>(red + (warp * kDecodeRows + g) * D + 4 * quad) =
              make_float4(acc[g][u][0], acc[g][u][1], acc[g][u][2], acc[g][u][3]);
    }
  }
  __syncthreads();
  float out[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kDecodeThreads, g = i / D, c = i % D;
    out[j] = 0.f;
    if (g < rows) {
#pragma unroll
      for (int w = 0; w < kDecodeWarps; ++w) out[j] += red[(w * kDecodeRows + g) * D + c];
    }
  }

  // One split writes the output (zeros where l == 0). Several write their
  // partial (acc, m, l) rows of D + 2 floats for fa_combine_kernel.
  if (n_split > 1) {
    const long long row0 = ((long long)b * a.Sq + qi) * a.Hq + h0;  // partial row of q-head h0
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kDecodeThreads, g = i / D, c = i % D;
      if (g < rows) {
        float* pr = part + ((row0 + g) * n_split + split) * (D + 2);
        pr[c] = out[j];
        if (c == 0) {
          pr[D] = m_s[g];
          pr[D + 1] = l_s[g];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kDecodeThreads, g = i / D, c = i % D;
    if (g < rows) {
      const float l = l_s[g];
      T* o = static_cast<T*>(a.o) + b * a.o_sb + qi * a.o_ss + (h0 + g) * a.o_sh;
      o[c] = from_f32<T>(l == 0.f ? 0.f : out[j] / l);
    }
  }
  if (lse != nullptr && tid < rows) {  // rows (batch, position, q-head), q-heads fastest
    const float l = l_s[tid];
    lse[((long long)b * a.Sq + qi) * a.Hq + h0 + tid] =
        l == 0.f ? __uint_as_float(kMinusInfBits) : m_s[tid] + logf(l);
  }
}

// The split decode's merge: a warp per output row (batch, position, q-head)
// weighs the n_split partials by log-sum-exp. A split with no live key has
// m = kNegInf and l = 0, so it weighs nothing next to a live one; a row whose
// l is 0 in total writes zeros (and a log-sum-exp of -inf where asked).
constexpr int kCombineWarps = 4;

template <typename T, int D>
__global__ void __launch_bounds__(kCombineWarps * 32) fa_combine_kernel(const Args a,
                                                                       const float* part,
                                                                       int n_split, int n_rows,
                                                                       float* lse) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const float* pr = part + (long long)row * n_split * (D + 2);
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, pr[s * (D + 2) + D]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) l += pr[s * (D + 2) + D + 1] * expf(pr[s * (D + 2) + D] - M);
  const int h = row % a.Hq, qi = (row / a.Hq) % a.Sq, b = row / (a.Hq * a.Sq);
  T* o = static_cast<T*>(a.o) + b * a.o_sb + qi * a.o_ss + h * a.o_sh;
  for (int c = lane; c < D; c += 32) {
    float x = 0.f;
    for (int s = 0; s < n_split; ++s) x += pr[s * (D + 2) + c] * expf(pr[s * (D + 2) + D] - M);
    o[c] = from_f32<T>(l == 0.f ? 0.f : x / l);
  }
  if (lse != nullptr && lane == 0) lse[row] = l == 0.f ? __uint_as_float(kMinusInfBits) : M + logf(l);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Above 48 KB a block's shared memory must be opted into, once per instance.
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fma(const Args& a, int B, cudaStream_t stream) {
  auto kernel = fa_fwd_kernel<float, D, kRowTile>;
  // at D = 192 the largest tiles pass the opt-in: those are refused below
  constexpr int kMostBytes = smem_floats(kRowTile, kMaxBk, D) * (int)sizeof(float);
  static const cudaError_t configured =
      opt_in(kernel, kMostBytes < kMaxSmem ? kMostBytes : kMaxSmem);
  if (configured != cudaSuccess) return configured;
  if (smem_floats(kRowTile, a.bk, D) * (int)sizeof(float) > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((a.Sq + kRowTile - 1) / kRowTile, a.Hq, B);
  kernel<<<grid, kThreads, smem_floats(kRowTile, a.bk, D) * sizeof(float), stream>>>(a);
  return cudaGetLastError();
}

template <int D, int BK>
cudaError_t launch_mma(const Args& a, int B, cudaStream_t stream) {
  auto kernel = fa_mma_kernel<D, BK>;
  static const cudaError_t configured = opt_in(kernel, mma_smem_bytes(BK, D));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((a.Sq + kRowTile - 1) / kRowTile, a.Hq, B);
  kernel<<<grid, kThreads, mma_smem_bytes(BK, D), stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_mma(const Args& a, int B, cudaStream_t stream) {
  switch (a.bk) {
    case 32: return launch_mma<D, 32>(a, B, stream);
    case 64: return launch_mma<D, 64>(a, B, stream);
    case 96: return launch_mma<D, 96>(a, B, stream);
    case 128: return launch_mma<D, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}
// D = 192 keeps Q (48), O (96) and S (4 bk / 8) in registers: up to 64 keys
template <>
cudaError_t dispatch_mma<192>(const Args& a, int B, cudaStream_t stream) {
  switch (a.bk) {
    case 32: return launch_mma<192, 32>(a, B, stream);
    case 64: return launch_mma<192, 64>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t launch_decode(const Args& a, int B, float* part, int n_split, float* lse,
                          cudaStream_t stream) {
  auto kernel = fa_decode_kernel<T, D>;
  static const cudaError_t configured =
      opt_in(kernel, decode_smem_bytes(kMaxBk, D, (int)sizeof(T)));
  if (configured != cudaSuccess) return configured;
  const int groups = (a.Hq / a.Hkv + kDecodeRows - 1) / kDecodeRows;
  if (n_split < 1 || (n_split > 1 && part == nullptr) ||
      (long long)a.Sq * groups > 65535 || (long long)B * a.Hkv > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(n_split, a.Sq * groups, B * a.Hkv);
  kernel<<<grid, kDecodeThreads, decode_smem_bytes(a.bk, D, (int)sizeof(T)), stream>>>(
      a, part, n_split, n_split == 1 ? lse : nullptr);
  if (n_split == 1) return cudaGetLastError();
  const int n_rows = B * a.Sq * a.Hq;
  fa_combine_kernel<T, D><<<(n_rows + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32,
                            0, stream>>>(a, part, n_split, n_rows, lse);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Args& a, int B, int is_bf16, int bq, float* part, int n_split,
                     float* lse, cudaStream_t stream) {
  if (bq == 1)
    return is_bf16 ? launch_decode<bf16, D>(a, B, part, n_split, lse, stream)
                   : launch_decode<float, D>(a, B, part, n_split, lse, stream);
  if (lse != nullptr) return cudaErrorInvalidValue;  // only the decode instance writes it
  if (bq == kRowTile) return is_bf16 ? dispatch_mma<D>(a, B, stream) : launch_fma<D>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// What a call's launch depends on besides its pointers and runtime scalars:
// the shapes, the element strides of dims (b, S, h) of q, k, v, o in that
// order, the dtype (is_bf16 != 0: bfloat16, else float32), the CTA tile and
// the device. The launcher builds one per layout and reuses it.
struct FaLayout {
  int B, Hq, Hkv, Sq, Skv, D, is_bf16, bq, bk, device;
  long long strides[12];
};

// Dynamic shared memory, in bytes, of one CTA with row tile bq, KV tile bk
// and head dim d, for bf16 (is_bf16 != 0) or float32 inputs.
extern "C" int fa_smem_bytes(int bq, int bk, int d, int is_bf16) {
  if (bq == 1) return decode_smem_bytes(bk, d, is_bf16 ? 2 : 4);
  return is_bf16 ? mma_smem_bytes(bk, d) : smem_floats(bq, bk, d) * (int)sizeof(float);
}

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o (B, Sq, Hq, D), all of one dtype
// with d contiguous, laid out as `l` says. q/k/v rows must be 16-byte
// aligned, o rows 4-byte aligned. For bq == 1 and n_split > 1, `part` is f32
// scratch of B * Sq * Hq * n_split * (D + 2) floats: the decode kernel writes
// the partials there and fa_combine_kernel, launched next on the same stream,
// merges them into o. `lse`, where not null (bq == 1 only), is f32 of
// B * Sq * Hq: each output row's log-sum-exp of its scaled live scores, -inf
// for a row with none. Launches on `stream` of device l->device (the
// caller's current device is restored). Returns the launch's cudaError_t.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, void* part,
                          void* lse, const FaLayout* l, int kv_len, int q_offset, int causal,
                          float scale, int n_split, void* stream) {
  if (l->Hkv < 1 || l->Hq % l->Hkv != 0 || l->bk < 1 || l->bk > kMaxBk)
    return cudaErrorInvalidValue;
  const long long* st = l->strides;
  const Args a{q, k, v, o, l->Hq, l->Hkv, l->Sq, l->Skv,
               st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
               kv_len, q_offset, causal, l->bk, scale};
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != l->device) err = cudaSetDevice(l->device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  const int B = l->B, bf = l->is_bf16, bq = l->bq;
  switch (l->D) {
    case 16: err = dispatch<16>(a, B, bf, bq, p, n_split, ls, s); break;
    case 32: err = dispatch<32>(a, B, bf, bq, p, n_split, ls, s); break;
    case 64: err = dispatch<64>(a, B, bf, bq, p, n_split, ls, s); break;
    case 80: err = dispatch<80>(a, B, bf, bq, p, n_split, ls, s); break;
    case 128: err = dispatch<128>(a, B, bf, bq, p, n_split, ls, s); break;
    case 192: err = dispatch<192>(a, B, bf, bq, p, n_split, ls, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != l->device) cudaSetDevice(prev);
  return err;
}
