// Tiled matrix product C = A . B on the CUDA cores of Hopper (sm_90a): the
// IEEE f32 FMA instance of the matmul kernel, plain C entry for ctypes.
//
// Replaces: src/repro/kernels/matmul/matmul.py, `matmul_pallas` (kernel body
//   `_matmul_kernel`), the TPU kernel whose tiles `codesign.plan` picks in the
//   co-design loop (plan a GEMM, launch it, check it, calibrate the model).
//   Its bf16 tensor-core twin is `matmul_wgmma.cu`; `matmul.py` routes each
//   product to one of the two (`instance_for`).
//
// What it computes (the same function as `_matmul_kernel`): C (M, N) = A (M, K)
// . B (K, N) with an f32 accumulator, cast to the output type on the store.
// A and B are f32 or bf16 (both the same); bf16 products accumulate in f32.
// f32 inputs are multiplied in IEEE f32 FMA (no TF32), so the product agrees
// with an f32 reference to the tests' 2e-5. This instance takes every shape
// and every layout the op takes: it is the route's floor for bf16 operands
// that TMA cannot read (a row not 16-byte aligned, say).
//
// What bounds it on this card: operations, for the shapes the loop plans
// (512x3072x768 does 2.42 GFLOP on 17.3 MB; 0.036 ms at the 67 TFLOP/s f32
// FMA peak, 0.0052 ms by bytes).
//
// Design: one CTA of 256 threads (8 warps) per (BM, BN) output tile, BM and
// BN in {64, 128}, K slice BK in {16, 32, 48, 64} whose three slices fit half
// the shared-memory opt-in (the tile the planner picks; each a compiled
// instance). Each warp owns a 32x64, 32x32 or 16x32
// sub-tile and each thread an 8x8, 8x4 or 4x4 outer product, fed per k by
// 16-byte shared loads. The TPU's sequential K axis becomes the loop inside
// the CTA over a ring of three BK-deep slices of A and B in shared memory,
// f32 and k-major (row k holds the slice's BM values of A, or BN of B), one
// barrier per slice. Each operand fills its slices in one of three ways,
// chosen per call by its layout:
//   * ASYNC: f32 whose M (A) or N (B) dim is contiguous and 16-byte aligned
//     goes in by 16-byte `cp.async` (zero-filled past the edges);
//   * VEC: f32 whose K dim is contiguous and 16-byte aligned (A row-major,
//     the forward's case) is read 16 bytes along K into registers before the
//     slice in flight is multiplied and stored transposed after it;
//   * SCALAR: anything else (bf16, unaligned, strided) element by element
//     through registers, widened to f32, the same way.
// A row k of a slice is cut into 16-byte chunks stored at chunk ^ ((k / 4) % 8),
// so the transposing stores of VEC (8 k-chunks of 4 rows per warp) and the
// 16-byte reads of the product both hit 32 distinct banks. Ragged M, N and K
// edges are masked, so nothing is padded.
// Not done here (later work): 3xTF32 tensor-core products, a persistent
// schedule, split-K for grids smaller than the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kSmemBudget = 232448 / 2;  // half the 227 KB a CTA may opt into
enum Mode { kScalar = 0, kVec = 1, kAsync = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// One operand as the loaders see it: element (mn, k) of a tile at
// p[mn * s_mn + k * s_k], mn < extent (M for A, N for B).
struct Operand {
  const void* p;
  long long s_mn, s_k;
  int extent, mode, k_fast;  // k_fast: SCALAR walks k fastest (s_k == 1)
};

struct Args {
  Operand a, b;
  void* C;  // (M, N) contiguous
  int M, N, K, out_bf16;
};

__host__ __device__ constexpr int smem_floats(int bm, int bn, int bk) {
  return kStages * bk * (bm + bn);
}

// Float offset of element (mn, k) in a slice whose rows hold MN floats.
template <int MN>
__device__ __forceinline__ int swz(int mn, int k) {
  return k * MN + ((((mn >> 2) ^ (k >> 2)) & 7) | ((mn >> 2) & ~7)) * 4 + (mn & 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kGroup = 16;  // K depth a register stage holds: slices fill in groups of 16

// ASYNC: one BK-deep slice of an operand, 16-byte chunks along MN straight
// into shared memory (zero-filled past the M/N and K edges).
template <int MN, int BK>
__device__ __forceinline__ void issue_async(const Operand& o, float* s, int mn0, int k0, int K) {
  const float* p = static_cast<const float*>(o.p);
#pragma unroll
  for (int i = 0; i < MN * BK / 4 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int mq = c % (MN / 4), k = c / (MN / 4);
    const int mn = mn0 + mq * 4, kg = k0 + k;
    int bytes = 0;
    const float* src = p;
    if (kg < K && mn < o.extent) {
      bytes = 4 * min(4, o.extent - mn);
      src = p + (long long)kg * o.s_k + mn;
    }
    cp_async16(s + swz<MN>(mq * 4, k), src, bytes);
  }
}

// The register stage of one operand for one 16-deep group of a slice: VEC
// keeps 16-byte chunks along K, SCALAR single elements (both as f32). A
// group is loaded before the group in flight is multiplied and stored after
// it, so the stage costs MN * 16 / 256 registers whatever the slice's depth.
template <typename T, int MN>
struct Stage {
  static constexpr int kChunks = MN * kGroup / 4 / kThreads;  // VEC: 16-byte chunks a thread
  static constexpr int kElems = MN * kGroup / kThreads;       // SCALAR: elements a thread
  float r[kElems];

  // the group of K values [k0, k0 + 16) of the operand
  __device__ __forceinline__ void load(const Operand& o, int mn0, int k0, int K) {
    const T* p = static_cast<const T*>(o.p);
    if (o.mode == kVec) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = threadIdx.x + i * kThreads;
        const int kq = c % (kGroup / 4), mn = mn0 + c / (kGroup / 4), kg = k0 + kq * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (mn < o.extent) {
          const T* row = p + (long long)mn * o.s_mn;
          if (kg + 3 < K) {
            if constexpr (sizeof(T) == 4) v = *reinterpret_cast<const float4*>(row + kg);
          } else {
            if (kg < K) v.x = to_f32(row[kg]);
            if (kg + 1 < K) v.y = to_f32(row[kg + 1]);
            if (kg + 2 < K) v.z = to_f32(row[kg + 2]);
          }
        }
        r[4 * i] = v.x; r[4 * i + 1] = v.y; r[4 * i + 2] = v.z; r[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int k = o.k_fast ? e % kGroup : e / MN, mn = o.k_fast ? e / kGroup : e % MN;
        const int gm = mn0 + mn, kg = k0 + k;
        r[i] = (gm < o.extent && kg < K) ? to_f32(p[(long long)gm * o.s_mn + (long long)kg * o.s_k])
                                         : 0.f;
      }
    }
  }

  // into rows [kofs, kofs + 16) of the slice at s
  __device__ __forceinline__ void store(const Operand& o, float* s, int kofs) const {
    if (o.mode == kVec) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = threadIdx.x + i * kThreads;
        const int kq = c % (kGroup / 4), mn = c / (kGroup / 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[swz<MN>(mn, kofs + kq * 4 + e)] = r[4 * i + e];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int k = o.k_fast ? e % kGroup : e / MN, mn = o.k_fast ? e / kGroup : e % MN;
        s[swz<MN>(mn, kofs + k)] = r[i];
      }
    }
  }
};

// Registers: a 64x64 tile's 4x4 thread tile fits 128 a thread, so two CTAs
// share an SM; the larger tiles take up to 255 and one CTA an SM (on the
// card, 128 registers spilled them and cost more than the second CTA gave).
template <int BM, int BN>
constexpr int kMinBlocks = BM * BN == 4096 ? 2 : 1;

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, kMinBlocks<BM, BN>) matmul_fma_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // thread tile TM x TN: two (or one) 16-byte groups along M, two (or one) along N
  constexpr int TM = BM * BN >= 8192 ? 8 : 4, TN = BM * BN >= 16384 ? 8 : 4;
  constexpr int WARPS_M = BM / (4 * TM);  // a warp: 4 x 8 lanes, (4 TM) x (8 TN) outputs
  constexpr int kStage = BK * (BM + BN);
  static_assert(WARPS_M * (BN / (8 * TN)) * 32 == kThreads, "8 warps cover the tile");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = lane / 8, tn = lane % 8;
  const int wm = (warp % WARPS_M) * 4 * TM, wn = (warp / WARPS_M) * 8 * TN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_async = a.a.mode == kAsync, b_async = a.b.mode == kAsync;

  Stage<T, BM> sa;
  Stage<T, BN> sb;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // the 16-byte chunk a thread reads first in a slice row; in row k it sits
  // at that chunk XOR (k / 4) % 8
  const int ca = (wm >> 2) + tm, cb = (wn >> 2) + tn;

  const int n_slices = (a.K + BK - 1) / BK;
  // prologue: slices 0 .. kStages - 2 (register-staged operands synchronously)
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_slices) {
      float* As = smem + t * kStage;
      float* Bs = As + BK * BM;
      if (a_async) issue_async<BM, BK>(a.a, As, m0, t * BK, a.K);
      if (b_async) issue_async<BN, BK>(a.b, Bs, n0, t * BK, a.K);
#pragma unroll
      for (int g = 0; g < BK; g += kGroup) {
        if (!a_async) { sa.load(a.a, m0, t * BK + g, a.K); sa.store(a.a, As, g); }
        if (!b_async) { sb.load(a.b, n0, t * BK + g, a.K); sb.store(a.b, Bs, g); }
      }
    }
    cp_async_commit();
  }

  for (int t = 0; t < n_slices; ++t) {
    cp_async_wait<kStages - 2>();  // slice t's copies have landed (this thread's)
    __syncthreads();               // ... everyone's; and everyone is done with slice t - 1
    const int tf = t + kStages - 1;  // the slice to fill, into the stage slice t - 1 used
    const bool fill = tf < n_slices;
    float* Af = smem + (tf % kStages) * kStage;
    float* Bf = Af + BK * BM;
    if (fill && a_async) issue_async<BM, BK>(a.a, Af, m0, tf * BK, a.K);
    if (fill && b_async) issue_async<BN, BK>(a.b, Bf, n0, tf * BK, a.K);
    cp_async_commit();

    const float4* As4 = reinterpret_cast<const float4*>(smem + (t % kStages) * kStage);
    const float4* Bs4 = As4 + BK * BM / 4;
#pragma unroll 1
    for (int g = 0; g < BK; g += kGroup) {
      if (fill && !a_async) sa.load(a.a, m0, tf * BK + g, a.K);
      if (fill && !b_async) sb.load(a.b, n0, tf * BK + g, a.K);
      // four rows share one XOR: address them from one pointer each
#pragma unroll
      for (int q = 0; q < kGroup / 4; ++q) {
        const int kb = g / 4 + q, sw = kb & 7;
        const float4* pa = As4 + kb * BM + (ca ^ sw);
        const float4* pa2 = As4 + kb * BM + ((ca + 4) ^ sw);  // TM == 8: rows 16 further
        const float4* pb = Bs4 + kb * BN + (cb ^ sw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float av[TM], bv[TN];
          float4 v = pa[e * (BM / 4)];
          av[0] = v.x; av[1] = v.y; av[2] = v.z; av[3] = v.w;
          if constexpr (TM == 8) {
            v = pa2[e * (BM / 4)];
            av[4] = v.x; av[5] = v.y; av[6] = v.z; av[7] = v.w;
          }
          v = pb[e * (BN / 4)];
          bv[0] = v.x; bv[1] = v.y; bv[2] = v.z; bv[3] = v.w;
          if constexpr (TN == 8) {
            v = pb[e * (BN / 4) + 8];
            bv[4] = v.x; bv[5] = v.y; bv[6] = v.z; bv[7] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      if (fill && !a_async) sa.store(a.a, Af, g);
      if (fill && !b_async) sb.store(a.b, Bf, g);
    }
  }
  cp_async_wait<0>();

  // thread (tm, tn) holds rows wm + 16 i' + 4 tm + {0..3} and columns
  // wn + 32 j' + 4 tn + {0..3}
  const bool vec_out = (a.N & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + wm + (i / 4) * 16 + tm * 4 + (i & 3);
    if (gm >= a.M) continue;
#pragma unroll
    for (int j4 = 0; j4 < TN / 4; ++j4) {
      const int gn = n0 + wn + j4 * 32 + tn * 4;
      const long long o = (long long)gm * a.N + gn;
      const float v0 = acc[i][4 * j4], v1 = acc[i][4 * j4 + 1];
      const float v2 = acc[i][4 * j4 + 2], v3 = acc[i][4 * j4 + 3];
      if (vec_out && gn + 3 < a.N) {
        if (a.out_bf16)
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.C) + o) =
              make_uint2(pack_bf16(v0, v1), pack_bf16(v2, v3));
        else
          *reinterpret_cast<float4*>(static_cast<float*>(a.C) + o) = make_float4(v0, v1, v2, v3);
        continue;
      }
      const float v[4] = {v0, v1, v2, v3};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gn + e >= a.N) break;
        if (a.out_bf16)
          static_cast<__nv_bfloat16*>(a.C)[o + e] = __float2bfloat16(v[e]);
        else
          static_cast<float*>(a.C)[o + e] = v[e];
      }
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = matmul_fma_kernel<T, BM, BN, BK>;
  constexpr int smem = smem_floats(BM, BN, BK) * (int)sizeof(float);
  static int configured = -1;  // the device the attribute was last set on
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && configured != dev) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = dev;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The compiled K slices of a tile: those whose three slices fit half the
// opt-in (two CTAs an SM), the budget the planner's space binds.
constexpr bool compiled(int bm, int bn, int bk) {
  return smem_floats(bm, bn, bk) * (int)sizeof(float) <= kSmemBudget;
}

template <typename T, int BM, int BN>
int dispatch_bk(const Args& a, int bk, cudaStream_t s) {
  switch (bk) {
    case 16: return launch<T, BM, BN, 16>(a, s);
    case 32: return launch<T, BM, BN, 32>(a, s);
    case 48: if constexpr (compiled(BM, BN, 48)) return launch<T, BM, BN, 48>(a, s); break;
    case 64: if constexpr (compiled(BM, BN, 64)) return launch<T, BM, BN, 64>(a, s); break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const Args& a, int bm, int bn, int bk, cudaStream_t s) {
  if (bm == 64 && bn == 64) return dispatch_bk<T, 64, 64>(a, bk, s);
  if (bm == 64 && bn == 128) return dispatch_bk<T, 64, 128>(a, bk, s);
  if (bm == 128 && bn == 64) return dispatch_bk<T, 128, 64>(a, bk, s);
  if (bm == 128 && bn == 128) return dispatch_bk<T, 128, 128>(a, bk, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int matmul_smem_bytes(int bm, int bn, int bk) {
  return smem_floats(bm, bn, bk) * (int)sizeof(float);
}

// The layout of one product, as matmul.py's `_FmaLayout` passes it (once
// built per layout and reused, so a call converts five arguments).
struct FmaLayout {
  long long sa_m, sa_k, sb_k, sb_n;  // A read at A[m * sa_m + k * sa_k], B at B[k * sb_k + n * sb_n]
  int M, N, K;
  int a_mode, b_mode;  // each operand's loader: 0 SCALAR, 1 VEC, 2 ASYNC
  int in_bf16, out_bf16, bm, bn, bk, device;
};

// A (M, K) and B (K, N) of one dtype (float32, or bfloat16 when in_bf16),
// C (M, N) contiguous, float32 or bfloat16 (out_bf16). VEC and ASYNC need
// f32, a 16-byte aligned base, a unit stride on K (VEC) or on M / N (ASYNC)
// and the other stride a multiple of 4. CTA tile (bm, bn) in {64, 128}^2, K
// slice bk in {16, 32, 48, 64} with its slices within kSmemBudget. Launches
// on `stream` of l->device (the caller's current device is restored).
// Returns the launch's cudaError_t.
extern "C" int matmul_forward(const void* A, const void* B, void* C, const FmaLayout* l,
                              void* stream) {
  if (l->M < 1 || l->N < 1 || l->K < 1 || l->a_mode < 0 || l->a_mode > 2 || l->b_mode < 0 ||
      l->b_mode > 2 || (l->in_bf16 && (l->a_mode != kScalar || l->b_mode != kScalar)))
    return cudaErrorInvalidValue;
  const Args a{{A, l->sa_m, l->sa_k, l->M, l->a_mode, l->sa_k == 1},
               {B, l->sb_n, l->sb_k, l->N, l->b_mode, l->sb_k == 1},
               C, l->M, l->N, l->K, l->out_bf16};
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != l->device) err = cudaSetDevice(l->device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ret = l->in_bf16 ? dispatch<__nv_bfloat16>(a, l->bm, l->bn, l->bk, s)
                             : dispatch<float>(a, l->bm, l->bn, l->bk, s);
  if (prev != l->device) cudaSetDevice(prev);
  return ret;
}
