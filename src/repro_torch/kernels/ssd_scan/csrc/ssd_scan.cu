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
// cum is never stored whole: lane t of a warp sums a run of `per`
// consecutive steps in f32 (lo_s, a few units at most) and the lanes' totals
// are scanned in f64 (hi_s, the sum of the runs before step s's run, kept
// per step). cum_i - cum_j is then (hi_i - hi_j) rounded once to f32, plus
// lo_i - lo_j: a pair of nearby steps (the entries of L that are not
// negligible) never sees the rounding of a large cum.
//
// What bounds it on this card: bytes, once the products run on the tensor
// cores. At zamba2-2.7b's training shape (b = 2, 80 heads, 8 chunks of 256,
// hp = n = 64, one B/C group) x, y, S_c, dA and dte, with B and C read once,
// are ~193 MB (0.058 ms at 3.35 TB/s); the products need 8.1 GFLOP when the
// score block C B^T is built once per (batch, chunk): 0.12 ms on the f32
// FMA units, 0.049 ms as 3xTF32 on the tensor cores. The design:
//   * every product runs on TF32 tensor cores (`mma.sync.m16n8k8`) in a
//     3xTF32 split (see split_tf32): acc += lo hi + hi lo + hi hi in an f32
//     accumulator. Plain TF32 keeps 10 mantissa bits, too few for the 1e-4
//     tolerance over 64-long dots; the split keeps ~20;
//   * where B and C are one group shared by the heads (head stride 0, as
//     zamba2 passes them), a score kernel builds each chunk's C B^T once, in
//     64 x 64 tiles of its lower triangle, into scratch the launcher
//     allocates, and the main kernel reads it for every head: 80 heads share
//     one score block. With per-head B/C each row group builds its own;
//   * a CTA of the main kernel covers one head's whole chunk (64 hp columns
//     of it; a wider head runs as slices). Its 8 warps each own a 16-row
//     group of work: y rows (scores, masked and decayed by L, times x), or
//     16 S_c rows (S_c is y for "rows" e_k of the state, decayed to the
//     chunk's end: its A operand is B^T scaled by exp(cum_end - cum_j)).
//     Groups run 8 at a time, ordered by how many columns they read; warps
//     w and w + 4 share a scheduler, so each pair takes a long and a short
//     group. Every CTA does the same work;
//   * the cumsum runs once per (chunk, head); the chunk's columns stream in
//     32-step tiles (x rows; B rows where a state group or a score build
//     needs them; each row warp's 16 x 32 score block) through a 2-stage
//     cp.async ring with one barrier per tile;
//   * shared rows are padded so that every fragment load hits 32 distinct
//     banks (x and B rows 4 mod 32 floats, score rows 8 mod 32 for 8-byte
//     loads);
//   * the C-fragment layout of the scores is reused as the A fragment of
//     the product with x by pairing k = t with column 2t and k = t + 4 with
//     column 2t + 1 (the x rows are read in the same order), and each pass
//     of the 3xTF32 products runs over 4 or 8 independent n8 tiles;
//   * x, dA, B and C are read in the model layout (b, l, nh, *) through
//     strides, 16 bytes at a time where the rows allow it; sizes that are
//     not multiples of 8 (or of 4) are zero-filled by the copies.
// Measured slower on the H100 and not kept (PERF.md): several heads
// per CTA sharing scores built in the CTA (their accumulators cap a thread
// at one CTA an SM), x split once per tile into fragment order, 12 or 16
// warps a CTA, 3 stages, 64-step tiles.
//
// Grid: the score kernel (batch, chunk, lower-triangle tile), 128 threads;
// the main kernel (batch, chunk, head, hp slice) flattened, 256 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;     // rows of a work group: one mma m16 tile
constexpr int kJT = 32;       // steps of the chunk per streamed tile
constexpr int kQ = kJT / 8;   // k8 steps of a tile
constexpr int kP = 64;        // hp columns of a CTA
constexpr int kNT = kP / 8;   // n8 tiles of them
constexpr int kLdX = kP + 4;  // x tile row stride in floats (4 mod 32)
constexpr int kLdS = kJT + 8;  // score tile row stride in floats (8 mod 32)
constexpr int kStages = 2;     // tiles in flight
constexpr int kST = 64;        // square tile of the score kernel
constexpr int kSThreads = 128;  // score kernel: a warp per 16 of its 64 rows
constexpr int kMaxChunk = 1024;
constexpr int kMaxDim = 128;  // hp and n
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* x;   // (b, l, nh, hp)
  const float* dA;  // (b, l, nh)
  const float* B;   // (b, l, nh, n)
  const float* C;   // (b, l, nh, n)
  const float* sc;  // (b, nc, cl, cl) C B^T of each chunk, when B and C are shared by the heads
  float* y;         // (b, l, nh, hp) contiguous
  float* S;         // (b, nc, nh, n, hp) contiguous
  float* dte;       // (b, l, nh) contiguous
  int nh, nc, cl, hp, n;
  int vec;                     // rows of x, B and C are 16-byte aligned
  long long x_sb, x_sl, x_sh;  // element strides of (b, l, h); the last dim is contiguous
  long long a_sb, a_sl, a_sh;
  long long b_sb, b_sl, b_sh;
  long long c_sb, c_sl, c_sh;
};

// B-tile and C-row stride in floats for state dims up to nmax (4 mod 32).
__host__ __device__ constexpr int ld_b(int nmax) { return nmax + 4; }
__host__ __device__ constexpr int cl_pad(int cl) { return (cl + kJT - 1) / kJT * kJT; }
// Floats of one stage: the B rows and x rows of a tile, and with shared
// scores each warp's 16 x 32 block of them.
__host__ __device__ constexpr int stage_floats(int nmax, bool shared) {
  return kJT * ld_b(nmax) + kJT * kLdX + (shared ? kWarps * kRows * kLdS : 0);
}
// Dynamic shared memory of one CTA: hi (f64) per step; the ring of tiles;
// the C rows of a pass's row groups (scores built in the CTA); lo (f32)
// per step.
__host__ __device__ constexpr int smem_bytes_for(int cl, int nmax, bool shared) {
  return 8 * cl_pad(cl) + 4 * (kStages * stage_floats(nmax, shared) +
                               (shared ? 0 : kWarps * kRows * ld_b(nmax)) + cl_pad(cl));
}
__host__ __device__ constexpr int score_smem_bytes(int nmax) { return 2 * kST * ld_b(nmax) * 4; }

// Steps of the chunk per lane of the cumsum: a multiple of 4, so a lane's
// two columns 2t, 2t + 1 of a k8 step lie in one lane's run.
__host__ __device__ constexpr int steps_per_lane(int cl) { return ((cl + 31) / 32 + 3) / 4 * 4; }

// ---- PTX: cp.async, ex2, mma.sync; the TF32 split ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes to dst, of which the first `bytes` come from src and the rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups are still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a = hi + lo for 3xTF32, both passed as f32 bits, of which the tensor
// core reads the top 19 (a TF32 value, truncated): hi is a itself, so the
// core sees a truncated to TF32, and lo = a - that, exact in f32, which
// the core truncates in turn (its error, below 2^-20 |a|, is the split's).
// Two f32/integer operations: a TF32 conversion instruction (cvt.rna.tf32)
// costs more issue slots than the products it feeds.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a);
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
}
// c (16x8 f32) += a (16x8 tf32, row-major) * b (8x8 tf32, column-major)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// acc[N0 + i] += a b_i in 3xTF32 for N independent n8 tiles, the small
// terms first; b_i's two values are b[i * step] and b[i * step + ld]. The
// three passes run over all N tiles in turn, so that no product waits on
// the one before it.
template <int N0, int N, int M>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[M][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const float* b, int step,
                                           int ld) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    split_tf32(b[i * step], bh[i][0], bl[i][0]);
    split_tf32(b[i * step + ld], bh[i][1], bl[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(acc[N0 + i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(acc[N0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(acc[N0 + i], ah, bh[i][0], bh[i][1]);
}
// acc (16 x 64) += A (16 x 8) x (8 x 64): x's rows for k = t and t + 4 at
// xr and xr + kLdX, its columns 8 apart; four n8 tiles at a time
__device__ __forceinline__ void mma_x(float (&acc)[kNT][4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const float* xr) {
  mma_3xtf32<0, kNT / 2>(acc, ah, al, xr, 8, kLdX);
  mma_3xtf32<kNT / 2, kNT / 2>(acc, ah, al, xr + 8 * (kNT / 2), 8, kLdX);
}

// A (rows x dims) block of src (row stride s_l elements, unit inner stride)
// into dst (row stride ld floats), as rows_max x cols with zeros outside;
// cols is a multiple of 4. With vec, 16-byte copies (src rows 16-byte
// aligned), else 4-byte ones. Threads tid, tid + nthr, ... take part.
__device__ __forceinline__ void copy_block(float* dst, int ld, const float* src, long long s_l,
                                           int rows, int rows_max, int dims, int cols, int vec,
                                           int tid, int nthr) {
  const int nv = cols / 4;
  for (int e = tid; e < rows_max * nv; e += nthr) {
    const int r = e / nv, c = (e - r * nv) * 4;
    float* d = dst + r * ld + c;
    const bool row_ok = r < rows;
    const float* s = row_ok ? src + r * s_l + c : src;
    if (vec) {
      const int bytes = row_ok && c < dims ? 4 * min(4, dims - c) : 0;
      cp_async16(d, bytes ? s : src, bytes);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = row_ok && c + u < dims;
        cp_async4(d + u, ok ? s + u : src, ok ? 4 : 0);
      }
    }
  }
}

// The score block C B^T of one chunk, a 64 x 64 tile (I, J <= I) per CTA,
// in 3xTF32, into (b, nc, cl, cl): built once for every head that shares
// B and C. A warp takes 16 rows; the upper half of a diagonal tile is
// written too (the main kernel masks it).
template <int NMAX>
__global__ void __launch_bounds__(kSThreads) ssd_scores_kernel(const Args a) {
  constexpr int LDB = ld_b(NMAX);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const cs = reinterpret_cast<float*>(smem_raw);  // [kST][LDB] C rows
  float* const bs = cs + kST * LDB;                        // [kST][LDB] B rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3;
  const int T = (a.cl + kST - 1) / kST, pairs = T * (T + 1) / 2;
  const int bc = blockIdx.x / pairs;
  int I = 0, p = blockIdx.x % pairs;
  while (p > I) p -= ++I;  // tile (I, J = p) of the lower triangle
  const int J = p, c = bc % a.nc, bi = bc / a.nc;
  const long long l0 = (long long)c * a.cl;
  copy_block(cs, LDB, a.C + bi * a.c_sb + (l0 + kST * I) * a.c_sl, a.c_sl,
             min(kST, a.cl - kST * I), kST, a.n, NMAX, a.vec, tid, kSThreads);
  copy_block(bs, LDB, a.B + bi * a.b_sb + (l0 + kST * J) * a.b_sl, a.b_sl,
             min(kST, a.cl - kST * J), kST, a.n, NMAX, a.vec, tid, kSThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[kST / 8][4];
#pragma unroll
  for (int i = 0; i < kST / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int ks = 0; ks < (a.n + 7) / 8; ++ks) {
    const float* cr = cs + (16 * warp + gi) * LDB + 8 * ks + ti;
    uint32_t ah[4], al[4];
    split_tf32(cr[0], ah[0], al[0]);
    split_tf32(cr[8 * LDB], ah[1], al[1]);
    split_tf32(cr[4], ah[2], al[2]);
    split_tf32(cr[8 * LDB + 4], ah[3], al[3]);
    const float* br = bs + gi * LDB + 8 * ks + ti;
    mma_3xtf32<0, kST / 16>(acc, ah, al, br, 8 * LDB, 4);
    mma_3xtf32<kST / 16, kST / 16>(acc, ah, al, br + kST / 2 * LDB, 8 * LDB, 4);
  }
  float* out = const_cast<float*>(a.sc) + ((long long)bc * a.cl + kST * I) * a.cl + kST * J;
#pragma unroll
  for (int nt = 0; nt < kST / 8; ++nt) {
    const int col = 8 * nt + 2 * ti;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + gi + 8 * half;
      if (kST * I + row >= a.cl) continue;
      float* dst = out + (long long)row * a.cl + col;
      if (kST * J + col + 1 < a.cl && a.cl % 2 == 0)  // 8-byte aligned: cl and col are even
        *reinterpret_cast<float2*>(dst) = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      else {
        if (kST * J + col < a.cl) dst[0] = acc[nt][2 * half];
        if (kST * J + col + 1 < a.cl) dst[1] = acc[nt][2 * half + 1];
      }
    }
  }
}

// The scores of a row group for one tile, C-fragment ordered: c0, c1 at
// (row gi, columns 2ti, 2ti + 1) of each k8 step, c2, c3 at row gi + 8.
// Built here from the group's C rows and the tile's B rows, or read from
// the block the score kernel wrote.
template <int NMAX>
__device__ __forceinline__ void build_scores(float (&sc)[kQ][4], const float* st,
                                             const float* crow, int n, int gi, int ti) {
  constexpr int LDB = ld_b(NMAX);
#pragma unroll
  for (int q = 0; q < kQ; ++q) sc[q][0] = sc[q][1] = sc[q][2] = sc[q][3] = 0.f;
  // all four steps, also above the diagonal (masked later), so that their
  // products run side by side
  for (int ks = 0; ks < (n + 7) / 8; ++ks) {
    const float* cr = crow + gi * LDB + ks * 8 + ti;
    uint32_t ah[4], al[4];
    split_tf32(cr[0], ah[0], al[0]);
    split_tf32(cr[8 * LDB], ah[1], al[1]);
    split_tf32(cr[4], ah[2], al[2]);
    split_tf32(cr[8 * LDB + 4], ah[3], al[3]);
    mma_3xtf32<0, kQ>(sc, ah, al, st + gi * LDB + ks * 8 + ti, 8 * LDB, 4);
  }
}

// One tile of a row group: y rows [i0, i0 + 16) += the tile's 32 columns
// of ((C B^T) * L) x, with sc the group's scores of the tile.
__device__ __forceinline__ void row_tile(float (&acc)[kNT][4], const float (&sc)[kQ][4],
                                         const float* xs, const double* hi, const float* lo,
                                         int cl, int i0, int j0, int gi, int ti) {
  // k8 steps of the tile that reach the group's last row (and the chunk)
  const int nq = min(kQ, (min(i0 + kRows, cl) - j0 + 7) / 8);
  const int ra = i0 + gi, rb = ra + 8;
  const double hia = hi[ra], hib = hi[rb];
  const float loa = lo[ra], lob = lo[rb];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (q < nq) {
      // this lane's columns ca, ca + 1 lie in one lane's run: one hi each row
      const int ca = j0 + 8 * q + 2 * ti;
      const double hic = hi[ca];
      const float2 lc = *reinterpret_cast<const float2*>(lo + ca);
      const float da = (float)(hia - hic), db = (float)(hib - hic);
      float m0 = sc[q][0] * exp2_approx(kLog2e * (da + (loa - lc.x)));
      float m1 = sc[q][1] * exp2_approx(kLog2e * (da + (loa - lc.y)));
      float m2 = sc[q][2] * exp2_approx(kLog2e * (db + (lob - lc.x)));
      float m3 = sc[q][3] * exp2_approx(kLog2e * (db + (lob - lc.y)));
      if (j0 + 8 * q + 7 > i0 || i0 + kRows > cl) {  // the step crosses the diagonal or the chunk
        m0 = ca <= ra && ra < cl ? m0 : 0.f;
        m1 = ca + 1 <= ra && ra < cl ? m1 : 0.f;
        m2 = ca <= rb && rb < cl ? m2 : 0.f;
        m3 = ca + 1 <= rb && rb < cl ? m3 : 0.f;
      }
      // as the A fragment of the product with x: k = ti is column ca and
      // k = ti + 4 is column ca + 1
      uint32_t ah[4], al[4];
      split_tf32(m0, ah[0], al[0]);
      split_tf32(m2, ah[1], al[1]);
      split_tf32(m1, ah[2], al[2]);
      split_tf32(m3, ah[3], al[3]);
      mma_x(acc, ah, al, xs + (8 * q + 2 * ti) * kLdX);
    }
  }
}

// One tile of a state group: S_c rows [m0, m0 + 16) += the tile's 32
// columns of (B^T * exp(cum_end - cum)) x.
template <int NMAX>
__device__ __forceinline__ void state_tile(float (&acc)[kNT][4], const float* st,
                                           const double* hi, const float* lo, int cl, int m0,
                                           int j0, int gi, int ti) {
  constexpr int LDB = ld_b(NMAX);
  const int nq = min(kQ, (cl - j0 + 7) / 8);
  const double hie = hi[cl - 1];
  const float le = lo[cl - 1];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (q < nq) {
      const int jr = 8 * q + 2 * ti, ca = j0 + jr;
      const float* br = st + jr * LDB + m0 + gi;
      const float2 lc = *reinterpret_cast<const float2*>(lo + ca);
      const float de = (float)(hie - hi[ca]);
      const float w0 = ca < cl ? exp2_approx(kLog2e * (de + (le - lc.x))) : 0.f;
      const float w1 = ca + 1 < cl ? exp2_approx(kLog2e * (de + (le - lc.y))) : 0.f;
      // B at (step ca, state m0 + gi), (ca, m0 + gi + 8), then step ca + 1
      uint32_t ah[4], al[4];
      split_tf32(br[0] * w0, ah[0], al[0]);
      split_tf32(br[8] * w0, ah[1], al[1]);
      split_tf32(br[LDB] * w1, ah[2], al[2]);
      split_tf32(br[LDB + 8] * w1, ah[3], al[3]);
      mma_x(acc, ah, al, st + kJT * LDB + jr * kLdX + gi);
    }
  }
}

// The chunk's y_diag, S_c and dte for one head and up to 64 of its hp
// columns. SHARED: B and C are the same for every head, and the scores
// come from the score kernel; else each row group builds its own.
template <bool SHARED, int NMAX>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(const Args a) {
  constexpr int LDB = ld_b(NMAX);
  constexpr int kStage = stage_floats(NMAX, SHARED);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int clp = cl_pad(a.cl);
  double* const hi = reinterpret_cast<double*>(smem_raw);  // [clp] hi_s
  float* const tiles = reinterpret_cast<float*>(hi + clp);  // ring: B, x, (scores)
  float* const c_rows = tiles + kStages * kStage;  // [kWarps][kRows][LDB] when not SHARED
  float* const lo = c_rows + (SHARED ? 0 : kWarps * kRows * LDB);  // [clp] lo_s

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, ti = lane & 3;  // mma fragment row group and column
  const int n_slices = (a.hp + kP - 1) / kP;
  int blk = blockIdx.x;
  const int slice = blk % n_slices;
  blk /= n_slices;
  const int h = blk % a.nh;
  blk /= a.nh;
  const int c = blk % a.nc, bi = blk / a.nc;
  const int p0 = slice * kP;
  const int pw = min(kP, a.hp - p0);  // this CTA's hp columns (the tiles are zero past them)
  const long long l0 = (long long)c * a.cl, L = (long long)a.nc * a.cl;

  // The inclusive cumsum of dA as cum_s = hi[s] + lo[s], by warp 0: each
  // lane sums its run of steps in f32, then the lanes scan their totals in
  // f64. Past the chunk both are 0.
  if (warp == 0) {
    const float* dA = a.dA + bi * a.a_sb + l0 * a.a_sl + h * a.a_sh;
    const int per = steps_per_lane(a.cl), s0 = lane * per, s1 = min(s0 + per, a.cl);
    float run = 0.f;
    for (int s = s0; s < s1; ++s) {
      run += __ldg(dA + s * a.a_sl);
      lo[s] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    for (int s = s0; s < s1; ++s) hi[s] = incl - run;
    for (int s = a.cl + lane; s < clp; s += 32) {
      hi[s] = 0.0;
      lo[s] = 0.f;
    }
  }
  __syncthreads();
  if (slice == 0)
    for (int s = tid; s < a.cl; s += kThreads)
      a.dte[(bi * L + l0 + s) * a.nh + h] = expf((float)(hi[s] + lo[s]));

  // Work groups: n_state groups of 16 S_c rows, which read every column,
  // then the row groups from the last, row group r reading columns
  // [0, 16 (r + 1)). A pass runs kWarps of them; warps w and w + 4 share a
  // scheduler, so one takes a long group of the pass and the other a short.
  const int n_state = (a.n + kRows - 1) / kRows, n_row = (a.cl + kRows - 1) / kRows;
  const int total = n_state + n_row;
  const int slot = warp < kWarps / 2 ? warp : kWarps + kWarps / 2 - 1 - warp;
  auto extent = [&](int k) {
    return k < n_state ? a.cl : min(kRows * (n_row - (k - n_state)), a.cl);
  };
  const float* scores = SHARED ? a.sc + (long long)(bi * a.nc + c) * a.cl * a.cl : nullptr;

  float acc[kNT][4];
  for (int base = 0; base < total; base += kWarps) {
    const int k = base + slot;
    const bool active = k < total, state = k < n_state;
    const int r = n_row - 1 - (k - n_state);  // the row group, when not a state group
    const int ext = active ? extent(k) : 0;
    const int n_tiles = (extent(base) + kJT - 1) / kJT;
    // B rows serve the state groups and, built here, the scores
    const bool need_b = !SHARED || base < n_state;
    auto load_tile = [&](int t, float* st) {
      const int j0 = t * kJT, rows = min(kJT, a.cl - j0);
      if (need_b)
        copy_block(st, LDB, a.B + bi * a.b_sb + (l0 + j0) * a.b_sl + h * a.b_sh, a.b_sl, rows,
                   kJT, a.n, NMAX, a.vec, tid, kThreads);
      copy_block(st + kJT * LDB, kLdX, a.x + bi * a.x_sb + (l0 + j0) * a.x_sl + h * a.x_sh + p0,
                 a.x_sl, rows, kJT, pw, kP, a.vec, tid, kThreads);
      if (SHARED && active && !state && j0 < ext)  // this warp's scores of the tile
        copy_block(st + kJT * LDB + kJT * kLdX + warp * kRows * kLdS, kLdS,
                   scores + (long long)(kRows * r) * a.cl + j0, a.cl,
                   min(kRows, a.cl - kRows * r), kRows, min(kJT, a.cl - j0), kJT,
                   a.cl % 4 == 0, lane, 32);
    };
    if (!SHARED && active && !state)
      copy_block(c_rows + warp * kRows * LDB, LDB,
                 a.C + bi * a.c_sb + (l0 + kRows * r) * a.c_sl + h * a.c_sh, a.c_sl,
                 min(kRows, a.cl - kRows * r), kRows, a.n, NMAX, a.vec, lane, 32);
    // tiles 0 .. kStages - 2 in flight; one commit group per tile (empty past the last)
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) load_tile(t, tiles + t * kStage);
      cp_async_commit();
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();
      // tile t (and the pass's C rows) landed for every thread, and every
      // warp is done with tile t - 1, whose stage takes tile t + kStages - 1
      __syncthreads();
      if (t + kStages - 1 < n_tiles)
        load_tile(t + kStages - 1, tiles + (t + kStages - 1) % kStages * kStage);
      cp_async_commit();
      const float* st = tiles + t % kStages * kStage;
      const int j0 = t * kJT;
      if (j0 < ext) {
        if (state) {
          state_tile<NMAX>(acc, st, hi, lo, a.cl, kRows * k, j0, gi, ti);
        } else {
          float sc[kQ][4];
          if (SHARED) {
            const float* ss = st + kJT * LDB + kJT * kLdX + (warp * kRows + gi) * kLdS + 2 * ti;
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              const float2 u = *reinterpret_cast<const float2*>(ss + 8 * q);
              const float2 v = *reinterpret_cast<const float2*>(ss + 8 * kLdS + 8 * q);
              sc[q][0] = u.x;
              sc[q][1] = u.y;
              sc[q][2] = v.x;
              sc[q][3] = v.y;
            }
          } else {
            build_scores<NMAX>(sc, st, c_rows + warp * kRows * LDB, a.n, gi, ti);
          }
          row_tile(acc, sc, st + kJT * LDB + gi, hi, lo, a.cl, kRows * r, j0, gi, ti);
        }
      }
    }
    __syncthreads();  // the next pass's copies may land in every stage

    if (active) {
      const int row0 = kRows * (state ? k : r) + gi;
      const int rows = state ? a.n : a.cl;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int p = 8 * nt + 2 * ti;
        if (p >= pw) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half;
          if (row >= rows) continue;
          float* dst = (state ? a.S + ((((long long)bi * a.nc + c) * a.nh + h) * a.n + row) * a.hp
                              : a.y + ((bi * L + l0 + row) * a.nh + h) * a.hp) + p0 + p;
          if (p + 1 < pw && a.hp % 2 == 0)  // 8-byte aligned: rows and p are even
            *reinterpret_cast<float2*>(dst) = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
          else {
            dst[0] = acc[nt][2 * half];
            if (p + 1 < pw) dst[1] = acc[nt][2 * half + 1];
          }
        }
      }
    }
  }
}

// Above 48 KB a block's shared memory must be opted into, once per
// instance: for the longest chunk.
template <bool SHARED, int NMAX>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  if (SHARED) {
    auto scores = ssd_scores_kernel<NMAX>;
    static const cudaError_t ready = cudaFuncSetAttribute(
        scores, cudaFuncAttributeMaxDynamicSharedMemorySize, score_smem_bytes(NMAX));
    if (ready != cudaSuccess) return ready;
    const int T = (a.cl + kST - 1) / kST;
    scores<<<b * a.nc * T * (T + 1) / 2, kSThreads, score_smem_bytes(NMAX), stream>>>(a);
  }
  auto kernel = ssd_chunk_kernel<SHARED, NMAX>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes_for(kMaxChunk, NMAX, SHARED));
  if (configured != cudaSuccess) return configured;
  const long long grid = (long long)b * a.nc * a.nh * ((a.hp + kP - 1) / kP);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, smem_bytes_for(a.cl, NMAX, SHARED), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, of one CTA of the main kernel for chunk
// length cl and state dim n, with B/C shared by the heads (shared != 0:
// the scores come from the score kernel) or not.
extern "C" int ssd_smem_bytes(int cl, int n, int shared) {
  return smem_bytes_for(cl, n <= 64 ? 64 : kMaxDim, shared != 0);
}

// x (b, l, nh, hp), dA (b, l, nh), B/C (b, l, nh, n): float32, the last dim
// contiguous; `strides` holds the element strides of dims (b, l, h) of x,
// dA, B, C in that order. With `scores` (b * nc * cl * cl floats of
// scratch), B and C must have head stride 0 (one group shared by the
// heads): the score kernel writes each chunk's C B^T there once, and the
// main kernel, launched next on the same stream, reads it for every head.
// Without, each CTA builds its own. Outputs, contiguous float32:
// y (b, l, nh, hp), S (b, nc, nh, n, hp), dte (b, l, nh), with
// l = nc * cl. Returns the launches' cudaError_t.
extern "C" int ssd_intra_chunk(const float* x, const float* dA, const float* B, const float* C,
                               float* scores, float* y, float* S, float* dte, int b, int nh,
                               int nc, int cl, int hp, int n, const long long* strides,
                               void* stream) {
  if (b < 1 || nh < 1 || nc < 1 || cl < 1 || cl > kMaxChunk || hp < 1 || hp > kMaxDim || n < 1 ||
      n > kMaxDim || (scores && (strides[8] != 0 || strides[11] != 0)))
    return cudaErrorInvalidValue;
  // 16-byte copies where every row of x, B and C starts 16-byte aligned
  int vec = ((uintptr_t)x | (uintptr_t)B | (uintptr_t)C) % 16 == 0;
  const int row_strides[] = {0, 1, 2, 6, 7, 8, 9, 10, 11};
  for (int i : row_strides)
    if (strides[i] % 4) vec = 0;
  const Args a{x, dA, B, C, scores, y, S, dte, nh, nc, cl, hp, n, vec,
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scores) return n <= 64 ? launch<true, 64>(a, b, s) : launch<true, kMaxDim>(a, b, s);
  return n <= 64 ? launch<false, 64>(a, b, s) : launch<false, kMaxDim>(a, b, s);
}
