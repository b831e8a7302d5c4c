// Tiled matrix product C = A . B on the tensor cores of Hopper (sm_90a): the
// bf16 wgmma + TMA instance of the matmul kernel, plain C entry for ctypes.
//
// Replaces: src/repro/kernels/matmul/matmul.py, `matmul_pallas` (kernel body
//   `_matmul_kernel`), for bf16 operands that TMA can read (unit stride on
//   one dim, 16-byte aligned base and rows); `matmul.py` routes every other
//   product to the f32 FMA instance in `matmul.cu` (`instance_for`).
//
// What it computes (the same function as `_matmul_kernel`): C (M, N) = A (M, K)
// . B (K, N), bf16 inputs, f32 accumulator, cast to f32 or bf16 on the store.
//
// What bounds it on this card: operations at the loop's large shapes
// (4096x3072x1024: 25.8 GFLOP on 39.8 MB, 0.026 ms at the 989 TFLOP/s bf16
// dense peak, 0.012 ms by bytes).
//
// Design: one CTA per (BM, BN) output tile, BM in {64, 128}, BN in {64, 128,
// 256}, not persistent. Warpgroup 0 is the producer: one thread keeps a ring
// of `stages` shared-memory stages full with TMA loads, each stage one
// 64-deep K slice of A (BM x 64) and B (64 x BN) in the 128-byte swizzle
// (one bf16 swizzle row is 64 values), with a full and an empty mbarrier per
// stage. Warpgroups 1 .. BM / 64 are the consumers: each owns 64 rows of the
// tile and runs four `wgmma.mma_async` m64nBNk16 per stage into BN / 2 f32
// registers a thread, keeping one stage's products in flight while it waits
// for the next. `setmaxnreg` moves registers from the producer to the
// consumers when there are two. Every operand orientation the op and its
// backward produce is read in place: a K-major tile (A row-major; B = y^T)
// as one TMA box of 64 K values by the tile's rows, an M- or N-major tile (A =
// x^T; B row-major, the forward's case) as 64 x 64 boxes with K outermost,
// multiplied with wgmma's transpose bit. TMA zero-fills past every edge, so
// the K edge needs nothing; the epilogue masks the ragged M and N edges and
// stores f32 or bf16 straight from the accumulators. The tensor maps are
// encoded on the host per call (their pointers change) through the driver
// entry point the runtime hands out, so the library links no -lcuda.
// Not done here (later work): a persistent tile schedule, a TMA-store
// epilogue, clusters with multicast loads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

namespace {

constexpr int kMaxSmem = 232448;      // the 227 KB a CTA may opt into on an H100
constexpr int kAtom = 64;             // bf16 values in one 128-byte swizzle row: a stage's K depth
constexpr uint32_t kRowBytes = 128;   // one swizzle row
constexpr uint32_t kBoxBytes = 64 * kRowBytes;  // one 64 x 64 bf16 TMA box
constexpr uint64_t kHangNs = 10000000000ull;    // a wait this long is a fault: trap, do not hang

struct TcArgs {
  void* C;  // (M, N) contiguous
  int M, N, K, stages, out_bf16;
};

// Dynamic shared memory of one CTA: the 1024-byte alignment the swizzle
// needs, the stages, and a full and an empty mbarrier (8 bytes each) a stage.
__host__ __device__ constexpr int tc_smem_bytes(int bm, int bn, int stages) {
  return 1024 + stages * (bm + bn) * (int)kRowBytes + stages * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete; trap after kHangNs, so
// a wrong parity fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

// One 2-D TMA box into shared memory at `dst`, completing on mbarrier `bar`;
// (c0, c1) are the box's coordinates, innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
// K-major: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// offset); a k16 step moves the start 32 bytes inside the swizzle row.
// M/N-major: 64-wide M/N chunks one 8 KB box apart (the leading offset),
// 8-row K groups 1024 bytes apart; a k16 step moves the start 16 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products (no instruction is emitted).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A and B from shared memory;
// TA / TB: the operand is M- / N-major (the transpose bits).
#define WG_F8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,\n"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,\n"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,\n"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,\n"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56), WG_F8(64), WG_F8(72), WG_F8(80), WG_F8(88), WG_F8(96), WG_F8(104), WG_F8(112), WG_F8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_n64<TA, TB>(d, da, db);
  else if constexpr (BN == 128) wgmma_n128<TA, TB>(d, da, db);
  else wgmma_n256<TA, TB>(d, da, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int BM, int BN, int TA, int TB>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, const TcArgs a) {
  constexpr int NC = BM / 64;  // consumer warpgroups, 64 rows each
  constexpr uint32_t kStageBytes = (BM + BN) * kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int S = a.stages;
  const uint32_t full0 = base + S * kStageBytes, empty0 = full0 + 8 * S;
  const int nk = (a.K + kAtom - 1) / kAtom;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full, kStageBytes);
        const uint32_t sa = base + s * kStageBytes, sb = sa + BM * kRowBytes;
        const int k0 = kt * kAtom;
        if constexpr (TA) {
#pragma unroll
          for (int i = 0; i < BM / 64; ++i) tma_load(sa + i * kBoxBytes, &map_a, full, m0 + 64 * i, k0);
        } else {
          tma_load(sa, &map_a, full, k0, m0);
        }
        if constexpr (TB) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) tma_load(sb + j * kBoxBytes, &map_b, full, n0 + 64 * j, k0);
        } else {
          tma_load(sb, &map_b, full, k0, n0);
        }
      }
    }
  } else {  // consumers
    if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      mbar_wait(full0 + 8 * s, (kt / S) & 1);
      const uint32_t sa = base + s * kStageBytes + c * kBoxBytes;
      const uint32_t sb = base + s * kStageBytes + BM * kRowBytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kAtom / 16; ++kk) {
        const uint64_t da = TA ? desc(sa + kk * 16 * kRowBytes, kBoxBytes, 1024)
                               : desc(sa + kk * 32, 16, 1024);
        const uint64_t db = TB ? desc(sb + kk * 16 * kRowBytes, kBoxBytes, 1024)
                               : desc(sb + kk * 32, 16, 1024);
        wgmma<BN, TA, TB>(acc, da, db);
      }
      wgmma_commit();
      fence_acc(acc);
      if (S == 1) {  // a ring of one stage: release it once its products are done
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty0);
      } else {  // keep this stage's products in flight; the previous stage's are done
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % S));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // accumulator layout of m64nN: warp w of the warpgroup holds rows
    // 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
    const int w = (threadIdx.x % 128) / 32;
    const int row0 = m0 + c * 64 + w * 16 + lane / 4, col0 = n0 + 2 * (lane % 4);
    const bool pair_ok = (a.N & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= a.M || col >= a.N) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const long long o = (long long)row * a.N + col;
        if (a.out_bf16) {
          __nv_bfloat16* C = static_cast<__nv_bfloat16*>(a.C);
          if (pair_ok) {
            *reinterpret_cast<uint32_t*>(C + o) = pack_bf16(v0, v1);
          } else {
            C[o] = __float2bfloat16(v0);
            if (col + 1 < a.N) C[o + 1] = __float2bfloat16(v1);
          }
        } else {
          float* C = static_cast<float*>(a.C);
          if (pair_ok) {
            *reinterpret_cast<float2*>(C + o) = make_float2(v0, v1);
          } else {
            C[o] = v0;
            if (col + 1 < a.N) C[o + 1] = v1;
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 matrix whose `inner` dim is contiguous and whose
// `outer` dim has element stride `lead`, read in boxes of box_inner x
// box_outer with the 128-byte swizzle; zeros past every edge.
int make_map(CUtensorMap* map, const void* ptr, int inner, int outer, long long lead,
             int box_inner, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)lead * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

template <int BM, int BN, int TA, int TB>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const TcArgs& a, cudaStream_t stream) {
  auto kernel = matmul_wgmma_kernel<BM, BN, TA, TB>;
  static int configured = -1;  // the device the opt-in was last set on
  int dev = 0;
  cudaGetDevice(&dev);
  if (configured != dev) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = dev;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  kernel<<<grid, 128 * (BM / 64 + 1), tc_smem_bytes(BM, BN, a.stages), stream>>>(ma, mb, a);
  return cudaGetLastError();
}

template <int BM, int BN>
int dispatch_orient(const CUtensorMap& ma, const CUtensorMap& mb, const TcArgs& a, int a_mn,
                    int b_mn, cudaStream_t s) {
  if (!a_mn && b_mn) return launch<BM, BN, 0, 1>(ma, mb, a, s);  // the forward
  if (!a_mn && !b_mn) return launch<BM, BN, 0, 0>(ma, mb, a, s);  // g . y^T
  if (a_mn && b_mn) return launch<BM, BN, 1, 1>(ma, mb, a, s);  // x^T . g
  return launch<BM, BN, 1, 0>(ma, mb, a, s);
}

int dispatch(const CUtensorMap& ma, const CUtensorMap& mb, const TcArgs& a, int bm, int bn,
             int a_mn, int b_mn, cudaStream_t s) {
  if (bm == 64 && bn == 64) return dispatch_orient<64, 64>(ma, mb, a, a_mn, b_mn, s);
  if (bm == 64 && bn == 128) return dispatch_orient<64, 128>(ma, mb, a, a_mn, b_mn, s);
  if (bm == 64 && bn == 256) return dispatch_orient<64, 256>(ma, mb, a, a_mn, b_mn, s);
  if (bm == 128 && bn == 64) return dispatch_orient<128, 64>(ma, mb, a, a_mn, b_mn, s);
  if (bm == 128 && bn == 128) return dispatch_orient<128, 128>(ma, mb, a, a_mn, b_mn, s);
  if (bm == 128 && bn == 256) return dispatch_orient<128, 256>(ma, mb, a, a_mn, b_mn, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int matmul_wgmma_smem_bytes(int bm, int bn, int stages) {
  return tc_smem_bytes(bm, bn, stages);
}

// The layout of one product, as matmul.py's `_TcLayout` passes it (once
// built per layout and reused, so a call converts five arguments). A is
// K-major (a_mn 0: A[m * lda + k]) or M-major (1: A[m + k * lda]); B is
// K-major (b_mn 0: B[k + n * ldb]) or N-major (1: B[k * ldb + n]).
struct TcLayout {
  long long lda, ldb;
  int M, N, K, a_mn, b_mn, out_bf16, bm, bn, stages, device;
};

namespace {

int encode_maps(CUtensorMap* ma, CUtensorMap* mb, const void* A, const void* B,
                const TcLayout* l) {
  const int ret = l->a_mn ? make_map(ma, A, l->M, l->K, l->lda, 64, 64)
                          : make_map(ma, A, l->K, l->M, l->lda, 64, l->bm);
  if (ret != 0) return ret;
  return l->b_mn ? make_map(mb, B, l->N, l->K, l->ldb, 64, 64)
                 : make_map(mb, B, l->K, l->N, l->ldb, 64, l->bn);
}

}  // namespace

// A (M, K) and B (K, N) bf16 with 16-byte aligned bases and lda, ldb
// multiples of 8; C (M, N) contiguous, float32 or bfloat16 (out_bf16). CTA
// tile (bm, bn) in {64, 128} x {64, 128, 256}, `stages` 64-deep K slices in
// the ring. The tensor maps are encoded here, every call (the pointers
// change). Launches on `stream` of l->device (the caller's current device is
// restored). Returns the launch's cudaError_t.
extern "C" int matmul_wgmma_forward(const void* A, const void* B, void* C, const TcLayout* l,
                                    void* stream) {
  if (l->M < 1 || l->N < 1 || l->K < 1 || l->stages < 1 ||
      tc_smem_bytes(l->bm, l->bn, l->stages) > kMaxSmem ||
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) % 16 || l->lda % 8 ||
      l->ldb % 8 || l->lda < 1 || l->ldb < 1)
    return cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != l->device) err = cudaSetDevice(l->device);
  if (err != cudaSuccess) return err;
  CUtensorMap ma, mb;
  int ret = encode_maps(&ma, &mb, A, B, l);
  if (ret == 0) {
    const TcArgs a{C, l->M, l->N, l->K, l->stages, l->out_bf16};
    ret = dispatch(ma, mb, a, l->bm, l->bn, l->a_mn, l->b_mn, static_cast<cudaStream_t>(stream));
  }
  if (prev != l->device) cudaSetDevice(prev);
  return ret;
}

// Host nanoseconds one call spends encoding its two tensor maps: the mean of
// kEncodeReps encodes of the maps for this layout (a measurement hook;
// nothing is launched). Negative on an encoding error.
extern "C" long long matmul_wgmma_encode_ns(const void* A, const void* B, const TcLayout* l) {
  constexpr int kEncodeReps = 1000;
  CUtensorMap ma, mb;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < kEncodeReps; ++i)
    if (encode_maps(&ma, &mb, A, B, l) != 0) return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() / kEncodeReps;
}
