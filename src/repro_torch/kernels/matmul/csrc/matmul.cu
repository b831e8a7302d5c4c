// Tiled matrix product C = A . B for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces: src/repro/kernels/matmul/matmul.py, `matmul_pallas` (kernel body
//   `_matmul_kernel`), the TPU kernel whose tiles `codesign.plan` picks in the
//   co-design loop (plan a GEMM, launch it, check it, calibrate the model).
//
// What it computes (the same function as `_matmul_kernel`): C (M, N) = A (M, K)
// . B (K, N) with an f32 accumulator, cast to the output type on the store.
// A and B are f32 or bf16 (both the same); bf16 products accumulate in f32.
// f32 inputs are multiplied in IEEE f32 FMA (no TF32), so the product agrees
// with an f32 reference to the tests' 2e-5.
//
// What bounds it on this card: operations, for the shapes the loop plans
// (512x3072x768 does 2.42 GFLOP on 17.3 MB; bound 0.036 ms at the 67 TFLOP/s
// f32 FMA peak, 0.0052 ms by bytes). This first version runs on the CUDA
// cores for f32 and bf16 alike, so for bf16 it stays far from the 989
// TFLOP/s tensor-core bound.
//
// Design: one CTA of 256 threads per (BM, BN) output tile, BM and BN in
// {64, 128} (the CTA tile the planner picks, compiled per instance). The
// TPU's sequential K grid axis becomes the loop inside the CTA: bk-deep
// slices of A and B go through shared memory (f32, two stages in a ring, so
// one barrier per slice and the next slice's loads are issued before the
// current slice's products), and each thread keeps a (BM/16) x (BN/16)
// register tile of the accumulator, fed by 16-byte shared loads. The kernel
// reads A and B through row and column strides, so a transposed operand
// (the backward's g . B^T and A^T . g) is read in place, and it masks the
// ragged M, N and K edges itself, so nothing is padded.
// Not done yet (later work): tensor cores (wgmma) fed by TMA, a persistent
// schedule over output tiles, and split-K for grids smaller than the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, each a (BM/16) x (BN/16) register tile
constexpr int kPad = 4;         // shared row padding in floats (keeps 16-byte rows)
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;  // the 227 KB a CTA may opt into on an H100

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* A;
  const void* B;
  void* C;  // (M, N) contiguous
  int M, N, K, bk, out_bf16;
  long long sa_m, sa_k, sb_k, sb_n;  // element strides of A (M, K) and B (K, N)
};

// Shared memory in floats: kStages x (A slice bk x (BM + kPad), B slice bk x (BN + kPad)).
__host__ __device__ constexpr int smem_floats(int bm, int bn, int bk) {
  return kStages * bk * (bm + kPad + bn + kPad);
}

// One bk-deep slice of A and B into shared memory, k-major, as f32; zeros
// outside the matrices. The fast thread index walks whichever operand dim
// has unit stride, so global reads coalesce for either orientation.
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_slice(const Args& a, const T* A, const T* B, float* As,
                                           float* Bs, int m0, int n0, int k0) {
  const int bk = a.bk, tid = threadIdx.x;
  constexpr int lda = BM + kPad, ldb = BN + kPad;
  const bool a_k_fast = a.sa_k == 1;
  for (int idx = tid; idx < BM * bk; idx += kThreads) {
    const int r = a_k_fast ? idx / bk : idx % BM;
    const int c = a_k_fast ? idx % bk : idx / BM;
    const int gm = m0 + r, gk = k0 + c;
    As[c * lda + r] = (gm < a.M && gk < a.K)
                          ? to_f32(A[(long long)gm * a.sa_m + (long long)gk * a.sa_k])
                          : 0.f;
  }
  const bool b_n_fast = a.sb_n == 1;
  for (int idx = tid; idx < BN * bk; idx += kThreads) {
    const int j = b_n_fast ? idx % BN : idx / bk;
    const int c = b_n_fast ? idx / BN : idx % bk;
    const int gn = n0 + j, gk = k0 + c;
    Bs[c * ldb + j] = (gn < a.N && gk < a.K)
                          ? to_f32(B[(long long)gk * a.sb_k + (long long)gn * a.sb_n])
                          : 0.f;
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads) matmul_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int lda = BM + kPad, ldb = BN + kPad;
  const int bk = a.bk;
  const int stage = bk * (lda + ldb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* A = static_cast<const T*>(a.A);
  const T* B = static_cast<const T*>(a.B);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_slices = (a.K + bk - 1) / bk;
  load_slice<T, BM, BN>(a, A, B, smem, smem + bk * lda, m0, n0, 0);
  __syncthreads();
  for (int s = 0; s < n_slices; ++s) {
    float* As = smem + (s & 1) * stage;
    float* Bs = As + bk * lda;
    if (s + 1 < n_slices) {
      float* As_next = smem + ((s + 1) & 1) * stage;
      load_slice<T, BM, BN>(a, A, B, As_next, As_next + bk * lda, m0, n0, (s + 1) * bk);
    }
#pragma unroll 4
    for (int kk = 0; kk < bk; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(As + kk * lda + ty * TM + i);
        av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(Bs + kk * ldb + tx * TN + j);
        bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the slice just read is the one the next iteration overwrites
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= a.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= a.N) continue;
      const long long o = (long long)gm * a.N + gn;
      if (a.out_bf16)
        static_cast<__nv_bfloat16*>(a.C)[o] = __float2bfloat16(acc[i][j]);
      else
        static_cast<float*>(a.C)[o] = acc[i][j];
    }
  }
}

template <typename T, int BM, int BN>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = matmul_kernel<T, BM, BN>;
  const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  const size_t smem = smem_floats(BM, BN, a.bk) * sizeof(float);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int bm, int bn, cudaStream_t stream) {
  if (bm == 64 && bn == 64) return launch<T, 64, 64>(a, stream);
  if (bm == 64 && bn == 128) return launch<T, 64, 128>(a, stream);
  if (bm == 128 && bn == 64) return launch<T, 128, 64>(a, stream);
  if (bm == 128 && bn == 128) return launch<T, 128, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int matmul_smem_bytes(int bm, int bn, int bk) {
  return smem_floats(bm, bn, bk) * (int)sizeof(float);
}

// A (M, K) and B (K, N) of one dtype (0 = float32, 1 = bfloat16), read
// through the element strides sa_m, sa_k, sb_k, sb_n; C (M, N) contiguous,
// float32 (out_dtype 0) or bfloat16 (1). CTA tile (bm, bn) in {64, 128}^2,
// K slice bk a multiple of 16 whose shared memory fits the opt-in. Returns
// the launch's cudaError_t.
extern "C" int matmul_forward(const void* A, const void* B, void* C, int M, int N, int K,
                              long long sa_m, long long sa_k, long long sb_k, long long sb_n,
                              int in_dtype, int out_dtype, int bm, int bn, int bk,
                              void* stream) {
  if (M < 1 || N < 1 || K < 1 || bk < 16 || bk % 16 ||
      matmul_smem_bytes(bm, bn, bk) > kMaxSmem)
    return cudaErrorInvalidValue;
  const Args a{A, B, C, M, N, K, bk, out_dtype == 1, sa_m, sa_k, sb_k, sb_n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return dispatch<float>(a, bm, bn, s);
  if (in_dtype == 1) return dispatch<__nv_bfloat16>(a, bm, bn, s);
  return cudaErrorInvalidValue;
}
