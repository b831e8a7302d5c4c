// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, `ssd_intra_chunk_pallas`
//   (kernel body `_ssd_kernel`), the TPU kernel every Mamba-2 block's
//   full-sequence pass calls when kernels are on.
//
// What it computes (the function of `_ssd_kernel`), per (batch, head, chunk)
// of cl steps, all in f32:
//   cum    = inclusive cumsum of dA over the chunk
//   L[i,j] = exp(cum_i - cum_j) for j <= i, else 0
//   y_diag = ((C B^T) * L) x                       (cl, hp)
//   S_c    = B^T (x * exp(cum_end - cum))           (n, hp)
//   dte    = exp(cum)                               (cl)
// L comes from differences of the inclusive cumsum, as on the TPU, and the
// exponentials underflow to 0 over long chunks exactly as they do there.
// Over a 256-step chunk cum reaches ~-180, where an f32 ulp is ~1.5e-5, so
// cum is never stored whole: warp 0's lane t sums a run of `per` consecutive
// steps in f32 (lo_s, a few units at most) and the lanes' totals are scanned
// in f64 (hi_s, the sum of the runs before step s's run, kept per step).
// cum_i - cum_j is then (hi_i - hi_j) rounded once to f32, plus lo_i - lo_j:
// a pair of nearby steps (the entries of L that are not negligible) never
// sees the rounding of a large cum.
//
// What bounds it on this card: operations. Per chunk of 256 steps with
// n = hp = 64 the lower-triangular products are ~10.5 MFLOP against ~280 KB
// of operands, ~37 FLOP/byte, above the ~20 FLOP/byte where the f32 FMA
// units (67 TFLOP/s), not HBM, become the limit. The products stay in f32
// FMA: TF32 tensor cores keep 10 mantissa bits, too few for the 1e-4
// tolerance over 64-long dots. So the design keeps the FMA units fed from
// shared memory and skips work above the diagonal:
//   * x, dA, B and C are read in the model layout (b, l, nh, *) through
//     strides; no head-major copy is made, and B/C may be expanded over
//     heads with stride 0 (one group shared by all heads);
//   * the (cl, cl) score block never exists whole (256 KB at cl = 256 would
//     not fit in 227 KB of shared memory): a CTA owns a 64-row tile of y,
//     builds its scores 64 columns at a time, and stops at the diagonal;
//   * each thread computes a 4 x 4 register tile of every product from
//     16-byte shared-memory loads;
//   * one more CTA per chunk computes S_c and dte, so the rows' CTAs never
//     reduce across each other.
// Not done yet (later work): tensor-core products (3xTF32 or wgmma) with
// TMA loads, and reusing one chunk's B/x tiles across its row tiles.
//
// Grid: x = (batch, chunk, head) flattened, y = row tiles + 1 (the state
// CTA), 256 threads as 16 x 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // row and column tile
constexpr int kPad = kT + 4;      // shared row stride in floats (16-byte rows)
constexpr int kPad4 = kPad / 4;   // the same in float4
constexpr int kThreads = 256;
constexpr int kMaxChunk = 1024;
constexpr int kMaxDim = 64;       // hp and n

struct Args {
  const float* x;   // (b, l, nh, hp)
  const float* dA;  // (b, l, nh)
  const float* B;   // (b, l, nh, n)
  const float* C;   // (b, l, nh, n)
  float* y;         // (b, l, nh, hp) contiguous
  float* S;         // (b, nc, nh, n, hp) contiguous
  float* dte;       // (b, l, nh) contiguous
  int nh, nc, cl, hp, n;
  long long x_sb, x_sl, x_sh;  // element strides of (b, l, h); the last dim is contiguous
  long long a_sb, a_sl, a_sh;
  long long b_sb, b_sl, b_sh;
  long long c_sb, c_sl, c_sh;
};

// Shared memory in floats: hi (cl doubles, rounded up to 2), lo (cl, rounded
// up to 4; both keep the tiles 16-byte aligned) and four 64 x kPad tiles.
__host__ __device__ constexpr int smem_floats(int cl) {
  return (cl + 1) / 2 * 4 + (cl + 3) / 4 * 4 + 4 * kT * kPad;
}

// Steps of the chunk per lane of the cumsum: a multiple of 4, so the 4 rows
// (or columns) a thread owns in a 64-step tile lie in one lane's run.
__host__ __device__ constexpr int steps_per_lane(int cl) { return ((cl + 31) / 32 + 3) / 4 * 4; }

// dst[k * kPad + r] = src row (r0 + r), element k: a (rows x dims) tile of
// the model layout stored dim-major; zeros outside the chunk and the dims.
__device__ __forceinline__ void load_transposed(float* dst, const float* src, long long s_l,
                                                int r0, int rows, int dims) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, k = e % kT;
    dst[k * kPad + r] = (r < rows && k < dims) ? __ldg(src + (r0 + r) * s_l + k) : 0.f;
  }
}

// dst[r * kPad + p] = src row (r0 + r), element p, times w[r] if given.
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long s_l,
                                          int r0, int rows, int dims, const float* w) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, p = e % kT;
    float v = 0.f;
    if (r < rows && p < dims) {
      v = __ldg(src + (r0 + r) * s_l + p);
      if (w) v *= w[r];
    }
    dst[r * kPad + p] = v;
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[a][.] += sum_c A[(ty*4 + a) * kPad + c] * X[c * kPad + tx*4 + .] over
// c < kT: A row-major by output row, X row-major by the contracted index.
__device__ __forceinline__ void accumulate_rows(float (&acc)[4][4], const float* A,
                                                const float* X, int ty, int tx) {
  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* X4 = reinterpret_cast<const float4*>(X);
#pragma unroll 2
  for (int c4 = 0; c4 < kT / 4; ++c4) {
    float4 xv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) xv[u] = X4[(c4 * 4 + u) * kPad4 + tx];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 av = A4[(ty * 4 + a) * kPad4 + c4];
      fma4(acc[a], av.x, xv[0]);
      fma4(acc[a], av.y, xv[1]);
      fma4(acc[a], av.z, xv[2]);
      fma4(acc[a], av.w, xv[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) ssd_intra_chunk_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  double* hi = reinterpret_cast<double*>(smem4);          // hi[s]: the sum before s's run
  float* lo = reinterpret_cast<float*>(hi + (a.cl + 1) / 2 * 2);  // lo[s]: the run up to s
  float* t0 = lo + (a.cl + 3) / 4 * 4;
  float* t1 = t0 + kT * kPad;
  float* t2 = t1 + kT * kPad;
  float* t3 = t2 + kT * kPad;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x % a.nh;
  const int c = (blockIdx.x / a.nh) % a.nc;
  const int bi = blockIdx.x / (a.nh * a.nc);
  const int n_row_tiles = (a.cl + kT - 1) / kT;
  // heaviest first: the state CTA, then row tiles from the last (most
  // columns below the diagonal) to the first
  const int tile = n_row_tiles - blockIdx.y;
  const long long l0 = (long long)c * a.cl;  // first step of the chunk
  const long long L = (long long)a.nc * a.cl;

  const float* x = a.x + bi * a.x_sb + l0 * a.x_sl + h * a.x_sh;
  const float* dA = a.dA + bi * a.a_sb + l0 * a.a_sl + h * a.a_sh;
  const float* B = a.B + bi * a.b_sb + l0 * a.b_sl + h * a.b_sh;
  const float* C = a.C + bi * a.c_sb + l0 * a.c_sl + h * a.c_sh;

  // Inclusive cumsum of dA over the chunk by warp 0, as cum_s = hi[s] +
  // lo[s]: each lane sums its run of steps in f32, then the lanes scan their
  // totals in f64.
  if (tid < 32) {
    const int per = steps_per_lane(a.cl), s0 = tid * per, s1 = min(s0 + per, a.cl);
    float run = 0.f;
    for (int s = s0; s < s1; ++s) {
      run += __ldg(dA + s * a.a_sl);
      lo[s] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += up;
    }
    for (int s = s0; s < s1; ++s) hi[s] = incl - run;
  }
  __syncthreads();
  // cum_i - cum_j, rounded once
  auto cum_diff = [&](int i, int j) { return (float)(hi[i] - hi[j]) + (lo[i] - lo[j]); };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (tile == n_row_tiles) {
    // The state CTA: S_c[k, p] = sum_j B[j, k] * exp(cum_end - cum_j) * x[j, p]
    // for k = ty*4 + ., p = tx*4 + .; and dte = exp(cum).
    float* w = t3;  // exp(cum_end - cum_j) of the current column tile
    for (int j0 = 0; j0 < a.cl; j0 += kT) {
      const int cols = min(kT, a.cl - j0);
      __syncthreads();
      for (int j = tid; j < kT; j += kThreads) w[j] = j < cols ? expf(cum_diff(a.cl - 1, j0 + j)) : 0.f;
      __syncthreads();
      load_transposed(t0, B, a.b_sl, j0, cols, a.n);    // t0[k][j] = B[j0 + j, k]
      load_rows(t1, x, a.x_sl, j0, cols, a.hp, w);      // t1[j][p] = x[j0 + j, p] * w[j]
      __syncthreads();
      accumulate_rows(acc, t0, t1, ty, tx);
    }
    float* S = a.S + ((((long long)bi * a.nc + c) * a.nh + h) * a.n) * a.hp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx * 4 + j;
        if (k < a.n && p < a.hp) S[(long long)k * a.hp + p] = acc[i][j];
      }
    }
    for (int s = tid; s < a.cl; s += kThreads)
      a.dte[((long long)bi * L + l0 + s) * a.nh + h] = expf((float)(hi[s] + lo[s]));
    return;
  }

  // A row-tile CTA: y rows [i0, i0 + rows) of the chunk.
  const int i0 = tile * kT;
  const int rows = min(kT, a.cl - i0);
  float* Ct = t0;  // Ct[k][r] = C[i0 + r, k]
  float* Bt = t1;  // Bt[k][j] = B[j0 + j, k]
  float* xs = t2;  // xs[j][p] = x[j0 + j, p]
  float* Ss = t3;  // Ss[r][j] = masked, decayed scores
  load_transposed(Ct, C, a.c_sl, i0, rows, a.n);
  const float4* Ct4 = reinterpret_cast<const float4*>(Ct);
  const float4* Bt4 = reinterpret_cast<const float4*>(Bt);
  float4* Ss4 = reinterpret_cast<float4*>(Ss);

  // column tiles up to and including the diagonal one
  for (int j0 = 0; j0 < i0 + rows; j0 += kT) {
    const int cols = min(kT, a.cl - j0);
    __syncthreads();  // the previous tile's Bt, xs and Ss are consumed
    load_transposed(Bt, B, a.b_sl, j0, cols, a.n);
    load_rows(xs, x, a.x_sl, j0, cols, a.hp, nullptr);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < a.n; ++k) {
      const float4 cv = Ct4[k * kPad4 + ty];
      const float4 bv = Bt4[k * kPad4 + tx];
      fma4(s[0], cv.x, bv);
      fma4(s[1], cv.y, bv);
      fma4(s[2], cv.z, bv);
      fma4(s[3], cv.w, bv);
    }
    // this thread's 4 rows lie in one lane's run, and so do its 4 columns:
    // one hi difference serves them all, folded into the rows' lo
    const int r0 = i0 + ty * 4, c0 = j0 + tx * 4;
    const float dh = r0 < a.cl && c0 < a.cl ? (float)(hi[r0] - hi[c0]) : 0.f;
    const float4 lc = *reinterpret_cast<const float4*>(lo + c0);
    const float lcol[4] = {lc.x, lc.y, lc.z, lc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      const float lr = lo[r] + dh;
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + j;
        out[j] = (r < a.cl && col <= r) ? s[i][j] * expf(lr - lcol[j]) : 0.f;
      }
      Ss4[(ty * 4 + i) * kPad4 + tx] = make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();
    accumulate_rows(acc, Ss, xs, ty, tx);
  }

  float* y = a.y + ((long long)bi * L + l0) * a.nh * a.hp + (long long)h * a.hp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx * 4 + j;
      if (r < rows && p < a.hp) y[(long long)(i0 + r) * a.nh * a.hp + p] = acc[i][j];
    }
  }
}

}  // namespace

// Dynamic shared memory, in bytes, of one CTA for chunk length cl.
extern "C" int ssd_smem_bytes(int cl) { return smem_floats(cl) * (int)sizeof(float); }

// x (b, l, nh, hp), dA (b, l, nh), B/C (b, l, nh, n): float32, the last dim
// contiguous; `strides` holds the element strides of dims (b, l, h) of x,
// dA, B, C in that order (a head stride of 0 shares one B/C among heads).
// Outputs, contiguous float32: y (b, l, nh, hp), S (b, nc, nh, n, hp),
// dte (b, l, nh), with l = nc * cl. Returns the launch's cudaError_t.
extern "C" int ssd_intra_chunk(const float* x, const float* dA, const float* B, const float* C,
                               float* y, float* S, float* dte, int b, int nh, int nc, int cl,
                               int hp, int n, const long long* strides, void* stream) {
  if (b < 1 || nh < 1 || nc < 1 || cl < 1 || cl > kMaxChunk || hp < 1 || hp > kMaxDim ||
      n < 1 || n > kMaxDim)
    return cudaErrorInvalidValue;
  const Args a{x, dA, B, C, y, S, dte, nh, nc, cl, hp, n,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  static const cudaError_t configured = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(kMaxChunk) * (int)sizeof(float));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((unsigned)b * nc * nh, (cl + kT - 1) / kT + 1);
  const size_t smem = smem_floats(cl) * sizeof(float);
  ssd_intra_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
