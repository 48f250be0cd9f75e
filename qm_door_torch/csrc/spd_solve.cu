// K1: batched small SPD solve  X = (A + shift*I)^-1 Y  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel qm_door_tpu/ops/pallas_chol.py:spd_solve
// (_spd_kernel, with _chol_t and _chol_solve_t): unrolled Cholesky with
// pivots rsqrt(max(a_kk, 1e-30)), then forward and back substitution. Only
// A's lower triangle is used: both solver call sites hand over exactly
// symmetric matrices (Riccati symmetrizes Quu; the projection's
// M = Gv Gv^T + diag is symmetric by construction).
//
// Shapes on the paths (f32), and what bounds each on an H100:
//   projection:  25728 systems (384 x 67 nodes), n = 12, m = 49, once a step:
//                ~129 MB (A's lower triangle and Y read once, X written once;
//                ~2.8 flops a byte, far under the ~20 flops a byte where
//                67 TFLOP/s of f32 overtakes 3.35 TB/s), ~38 us: bytes.
//   every other: the Riccati gain (384 x 30 x 31; 384 x 36 x 31 at nu = 36),
//                the WBC's Newton solves (512 or 1024 x 36 x 1, 512 x 42 x 1)
//                and Gram solves (30 / 52 x 36, 36 / 58 x 42), one robot's
//                batch-1 forms of all of these: each moves under 15 MB
//                (under 5 us) and the batch is at most a few warps an SM,
//                so one system's dependent chain (n pivots, two n-step
//                substitutions) plus the launch is the kernel's time:
//                latency. The designs below shorten that chain and keep
//                every lane busy on it.
//
// Variants, chosen in Python by shape only (ops/spd_solve.py:k1_variant);
// each launch runs the one it is asked for or returns an error:
//
// reg16 / reg32 (n <= 16 / n <= 32, m <= 64): one warp a system, the system
//   in registers (chol_warp.cuh). The warp stages A and Y in shared memory
//   with cp.async (16-byte copies where aligned), lane i takes row i of A's
//   lower triangle into NP registers (rows n..NP-1 identity, never stored),
//   factors with shuffles (no barrier per pivot, no shared-memory traffic),
//   writes L to shared memory once, and solves with the right-hand-side
//   columns over lanes (lane c keeps column c, and c + 32 when m > 32, in
//   registers; each sweep is ~n^2/2 independent FMAs a column with L read as
//   warp-uniform float4 broadcasts). X is written back coalesced, lane c
//   column c of each row. Blocks of 4 warps, as many as fit on the card at
//   once, and each warp walks the batch with a grid stride, staging the
//   next system with cp.async into a second buffer while it solves this one
//   (the projection shape: bytes). At the gain shape each warp gets one
//   system and its latency is the kernel's time. m <= 64 keeps
//   z[2][NP] in registers without spills (ptxas -v, chip_smoke.py).
//
// reg64 (n <= 64 where reg16 / reg32 do not take it: 32 < n, or m > 64):
//   reg32 grown to two rows a lane. The rows are padded to NP = 48 (n <= 48:
//   the WBC's 36 and 42) or 64; lane i holds row i in 32 registers (a row
//   below 32 has nothing past column 31) and row i + 32 in NP, and the
//   factor moves column k by shuffles straight into both rows' updates:
//   no barrier and no shared-memory round trip a pivot, where PR 1's kernel
//   walked a row's update serially through shared memory on one lane with
//   three __syncwarp a pivot. Then, by m:
//   - m = 1 (every Newton solve): the right-hand side stays held by rows.
//     At step i the lane of row i forms z_i = y_i / L_ii and broadcasts it
//     by one shuffle; every lane takes it off its two rows (L_ri from its
//     registers forward, from L's rows in shared memory back, lanes reading
//     consecutive words): 2n steps of one shuffle and two FMAs, where PR 1's
//     kernel ran ~n^2 dependent shared-memory read-modify-writes on lane 0.
//   - m > 1: L to shared memory once, by columns and by rows with 1 / L_ii on
//     the diagonals (chol_warp::store_factor2_lean), one column a lane in
//     registers, 32 columns a pass, L read as warp-uniform float4 broadcasts
//     and multiplied by 1 / L_ii (chol_warp::solve_cols); past m = 64 the
//     columns are read from and written to device memory directly, so no m
//     is too large.
//   1 / L_ii is the reciprocal of the factor's diagonal, so a pivot under
//   1e-30 solves as the reference's division by L_ii does. Steps past n are
//   skipped in the substitutions; the factor runs all NP pivots (straight-
//   line code, the padding rows are identity). Blocks of 4 warps (fewer if
//   a warp's buffers need it), one system a warp; a batch past what the
//   card holds at once runs in further waves of blocks (no grid stride:
//   see spd_reg64_kernel).
//
// blk128 (64 < n <= 128; no path calls it: wbc/qp.py:solve_qp_batched's
//   stacked systems, n = 92, are a test reference): a block of 8 warps a
//   system, A padded to a multiple of 32 rows in shared memory (66.6 KB at
//   n = 128), a blocked right-looking Cholesky with 32-column panels: warp 0
//   factors the diagonal block in registers (chol_warp::factor_lean_ref<32>),
//   the threads solve the rows below it a row each, all 256 threads share
//   the trailing update in 4 x 4 register tiles (three barriers a panel,
//   where PR 1's one warp ran a serial ~n^2/2-step chain a lane). The
//   substitutions take the right-hand sides a warp each, held by rows as
//   reg64's m = 1 (four rows a lane), Y and X straight from and to device
//   memory. One block a system.
//
// smem (PR 1's kernel; never dispatched, kept to be timed in turns against
//   the variants above, chip_smoke.py (a)): one warp per system, several
//   systems per block, the system staged in dynamic shared memory, a
//   right-looking factor with one row a lane, one lane per RHS column. It
//   refuses a system too large for a block's shared memory.
//
// No tensor cores: ROADMAP's precision rule keeps the solver chain in true
// f32 (TF32 keeps 10 of f32's 23 mantissa bits; reduced-precision operands
// break the Cholesky/Riccati chain, docs/PERF.md:307-309).
//
// K1-ll (qm_door_tpu/ops/pallas_chol.py:spd_solve_ll, lanes-last (n,n,B) and
// (n,m,B) arrays) enters the same variants with other strides: element
// (i,j) of system b sits at b*sys + (i*cols + j)*elem, with (sys, elem) =
// (n*cols, 1) batch-major and (1, B) lanes-last. Lanes-last loads are not
// coalesced within a warp (its lanes walk one system at stride B); the
// neighbouring warps read the neighbouring systems, so a sector fetched once
// mostly serves them from L1/L2. Nothing calls it on the solver's path.
//
// Launch shape of reg16 / reg32 (k1_launch_shapes.py at the repository
// root builds and times the alternatives; NVIDIA H100 80GB HBM3, 700 W):
// - 4-warp blocks, as many as the card holds at once, each warp walking the
//   batch with the next system staged. At the gain shape (384 systems, one
//   a warp) they time the same as one-warp blocks, one system each (within
//   1%); from ~4000 systems up they are 6-14% faster. A measuring build
//   with -DQM_K1_ONE_WARP_BLOCKS launches the one-warp form instead.
// - NP = 16 asks ptxas for 4 blocks an SM (QM_K1_REG16_BLOCKS, 128
//   registers): at the projection shape 3 blocks (157 registers) and 5 (96)
//   were slower, 6 (80) slower still and spilling.

#include <cuda_runtime.h>

#include "chol_warp.cuh"

#ifndef QM_K1_REG16_BLOCKS
#define QM_K1_REG16_BLOCKS 4
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kMaxN = 128;
constexpr int kMaxSystemsPerBlock = 4;
constexpr int kRegMaxM = 64;      // two right-hand-side columns a lane
constexpr int kRegBlockWarps = 4;  // warps a block for large batches

// PR 1's shared-memory kernel (one warp per system, several systems per
// block), variant smem: nothing dispatches to it; it is timed in turns
// against reg64 and blk128.
__global__ void spd_solve_kernel(const float* __restrict__ A,
                                 const float* __restrict__ Y,
                                 float* __restrict__ X,
                                 int batch, int n, int m, int lda, float shift,
                                 int systems_per_block, long long sys_a, long long sys_y,
                                 long long elem) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long sys = (long long)blockIdx.x * systems_per_block + warp;
  if (sys >= batch) return;  // ragged batch tail: only __syncwarp below

  float* sA = smem + (size_t)warp * (n * lda + n * m);
  float* sY = sA + n * lda;
  const float* gA = A + sys * sys_a;
  const float* gY = Y + sys * sys_y;
  float* gX = X + sys * sys_y;

  for (int idx = lane; idx < n * n; idx += kWarp) {
    const int i = idx / n;
    const int j = idx - i * n;
    if (j <= i) sA[i * lda + j] = gA[idx * elem] + (i == j ? shift : 0.0f);
  }
  for (int idx = lane; idx < n * m; idx += kWarp) sY[idx] = gY[idx * elem];
  __syncwarp();

  // Right-looking Cholesky on the lower triangle: L overwrites A.
  for (int k = 0; k < n; ++k) {
    const float inv_d = rsqrtf(fmaxf(sA[k * lda + k], 1e-30f));
    __syncwarp();  // every lane has read the pivot before it is scaled
    for (int i = k + lane; i < n; i += kWarp) sA[i * lda + k] *= inv_d;
    __syncwarp();
    for (int i = k + 1 + lane; i < n; i += kWarp) {
      const float lik = sA[i * lda + k];
      for (int j = k + 1; j <= i; ++j) sA[i * lda + j] -= lik * sA[j * lda + k];
    }
    __syncwarp();
  }

  // L L^T X = Y, one lane per RHS column: L z = y, then L^T x = z.
  for (int c = lane; c < m; c += kWarp) {
    for (int i = 0; i < n; ++i) {
      const float zi = sY[i * m + c] / sA[i * lda + i];
      sY[i * m + c] = zi;
      for (int r = i + 1; r < n; ++r) sY[r * m + c] -= sA[r * lda + i] * zi;
    }
    for (int i = n - 1; i >= 0; --i) {
      float s = 0.0f;
      for (int r = i + 1; r < n; ++r) s += sA[r * lda + i] * sY[r * m + c];
      sY[i * m + c] = (sY[i * m + c] - s) / sA[i * lda + i];
    }
  }
  __syncwarp();
  for (int idx = lane; idx < n * m; idx += kWarp) gX[idx * elem] = sY[idx];
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
int launch_smem(const float* A, const float* Y, float* X, int batch, int n, int m, float shift,
                long long sys_a, long long sys_y, long long elem, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || m < 1 || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int lda = n | 1;  // odd row stride: lanes walking a column hit distinct banks
  const size_t per_system = (size_t)(n * lda + n * m) * sizeof(float);

  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_system > (size_t)max_smem) return (int)cudaErrorInvalidValue;

  // Several systems per block when the batch fills the card twice over;
  // one per block for small batches, so they spread over every SM.
  int spb = batch / (2 * sms);
  if (spb > kMaxSystemsPerBlock) spb = kMaxSystemsPerBlock;
  if (spb > (int)(max_smem / per_system)) spb = (int)(max_smem / per_system);
  if (spb < 1) spb = 1;
  const size_t smem = spb * per_system;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spd_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (batch + spb - 1) / spb;
  spd_solve_kernel<<<grid, spb * kWarp, smem, stream>>>(
      A, Y, X, batch, n, m, lda, shift, spb, sys_a, sys_y, elem);
  return (int)cudaGetLastError();
}


// One warp a system, grid-stride over the batch with the next system's A
// and Y staged while this one is solved (two buffers a warp). NP = 16 is
// held to QM_K1_REG16_BLOCKS blocks an SM (see the launch shape above);
// NP = 32 takes the registers it wants (255, no spills).
template <int NP, int CPL>
__global__ void __launch_bounds__(kRegBlockWarps * kWarp, NP == 16 ? QM_K1_REG16_BLOCKS : 1)
spd_reg_kernel(const float* __restrict__ A, const float* __restrict__ Y,
               float* __restrict__ X, int batch, int n, int m, float shift,
               long long sys_a, long long sys_y, long long elem) {
  namespace cw = chol_warp;
  extern __shared__ __align__(16) float stage_smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int buf_a = cw::stage_floats(n * n), buf_y = cw::stage_floats(n * m);
  float* base = stage_smem + (size_t)warp * (2 * (buf_a + buf_y) + cw::factor_floats<NP>());
  float *cur_a = base, *cur_y = base + buf_a;
  float *next_a = cur_y + buf_y, *next_y = next_a + buf_a;
  float* sLt = next_y + buf_y;
  float* sL = sLt + NP * NP;

  const long long stride = (long long)gridDim.x * warps;
  long long sys = (long long)blockIdx.x * warps + warp;
  if (sys >= batch) return;  // ragged batch tail: only __syncwarp below
  int off_a = cw::stage(cur_a, A + sys * sys_a, n * n, elem, lane);
  int off_y = cw::stage(cur_y, Y + sys * sys_y, n * m, elem, lane);
  cw::cp_async_commit();

  for (; sys < batch; sys += stride) {
    const long long nxt = sys + stride;
    int next_off_a = 0, next_off_y = 0;
    if (nxt < batch) {
      next_off_a = cw::stage(next_a, A + nxt * sys_a, n * n, elem, lane);
      next_off_y = cw::stage(next_y, Y + nxt * sys_y, n * m, elem, lane);
    }
    cw::cp_async_commit();
    cw::cp_async_wait<1>();  // this system's group has landed (the next may not)
    __syncwarp();

    float a[NP], ivd[NP];
    cw::load_rows<NP>(a, cur_a + off_a, n, shift, lane);
    cw::factor<NP>(a, ivd);
    cw::store_factor<NP>(a, sLt, sL, lane);
    float z[CPL][NP];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = lane + c * kWarp;
#pragma unroll
      for (int r = 0; r < NP; ++r)
        z[c][r] = (col < m && r < n) ? cur_y[off_y + r * m + col] : 0.0f;
    }
    __syncwarp();  // L is in shared memory; this system's buffers are read

    cw::solve<NP, CPL>(z, sLt, sL, ivd);

    float* gX = X + sys * sys_y;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = lane + c * kWarp;
#pragma unroll
      for (int r = 0; r < NP; ++r)
        if (col < m && r < n) gX[(r * m + col) * elem] = z[c][r];
    }
    __syncwarp();  // every lane is done with sL / sLt before the next factor

    float* t = cur_a; cur_a = next_a; next_a = t;
    t = cur_y; cur_y = next_y; next_y = t;
    off_a = next_off_a;
    off_y = next_off_y;
  }
}

template <int NP, int CPL>
int launch_reg_cols(const float* A, const float* Y, float* X, int batch, int n, int m,
                    float shift, long long sys_a, long long sys_y, long long elem,
                    cudaStream_t stream) {
  const int per_warp = 2 * (chol_warp::stage_floats(n * n) + chol_warp::stage_floats(n * m)) +
                       chol_warp::factor_floats<NP>();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
#ifdef QM_K1_ONE_WARP_BLOCKS
  // Measuring build: one-warp blocks, one system each; a warp's shared
  // memory stays under 48 KB (at most 2 * (1028 + 2052) + 2176 floats).
  const int warps = 1;
  const long long grid = batch;
  const size_t smem = (size_t)per_warp * sizeof(float);
#else
  const int warps = kRegBlockWarps;
  const size_t smem = (size_t)warps * per_warp * sizeof(float);
  const void* fn = (const void*)spd_reg_kernel<NP, CPL>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, warps * kWarp, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  long long grid = (batch + warps - 1) / warps;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
#endif
  spd_reg_kernel<NP, CPL><<<(int)grid, warps * kWarp, smem, stream>>>(
      A, Y, X, batch, n, m, shift, sys_a, sys_y, elem);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_reg(const float* A, const float* Y, float* X, int batch, int n, int m, float shift,
               long long sys_a, long long sys_y, long long elem, cudaStream_t stream) {
  if (n < 1 || n > NP || m < 1 || m > kRegMaxM || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  if (m <= kWarp)
    return launch_reg_cols<NP, 1>(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, stream);
  return launch_reg_cols<NP, 2>(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, stream);
}


// --- reg64: 32 < n <= 64, or m > 64 at any n <= 64 -----------------------------

// How a reg64 warp solves, by m: kRows for m = 1 (the right-hand side held
// by rows, solve_rows2), kCols for m > 1 (one column a lane, 32 columns a
// pass, solve_cols; past m = 64 the columns are read from device memory
// and not staged). Two columns a lane, as reg32 holds them, put z[2][64] in
// local memory (ptxas: a 512-byte stack frame) and took minutes to build.
enum Reg64Mode { kRows = 0, kCols = 1 };

template <int NP, int MODE>
__host__ __device__ constexpr int reg64_factor_floats() {
  return MODE == kRows ? chol_warp::rows2_floats<NP>() : chol_warp::factor_floats<NP>();
}

// Floats of one staged system: A, and Y unless Y is read in chunks (m > 64).
__host__ __device__ inline int reg64_stage_floats(int n, int m) {
  return chol_warp::stage_floats(n * n) + (m > kRegMaxM ? 0 : chol_warp::stage_floats(n * m));
}

// One warp a system, two rows a lane (chol_warp.cuh: load_rows2, factor2),
// one system a warp: the warp stages A (and Y unless chunked) with cp.async,
// factors, solves and writes X. Batches past what the card holds at once
// run as further waves of blocks, staged while the SM's other blocks
// compute. A grid-stride loop staging the next system (reg16 / reg32's
// form) kept its pointers and offsets live across the factor, whose
// shuffles take the other registers: ptxas spilled 260-840 bytes in every
// instantiation with it and none without it.
template <int NP, int MODE>
__global__ void __launch_bounds__(kRegBlockWarps * kWarp, 1)
spd_reg64_kernel(const float* __restrict__ A, const float* __restrict__ Y,
                 float* __restrict__ X, int batch, int n, int m, float shift,
                 long long sys_a, long long sys_y, long long elem) {
  namespace cw = chol_warp;
  extern __shared__ __align__(16) float stage_smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long sys = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (sys >= batch) return;  // ragged batch tail: only __syncwarp below
  const bool chunked = m > kRegMaxM;  // Y straight from device memory
  float* sA = stage_smem + (size_t)warp * (reg64_stage_floats(n, m) +
                                           reg64_factor_floats<NP, MODE>());
  float* sY = sA + cw::stage_floats(n * n);
  float* sF = sY + (chunked ? 0 : cw::stage_floats(n * m));
  const int off_a = cw::stage(sA, A + sys * sys_a, n * n, elem, lane);
  const int off_y = chunked ? 0 : cw::stage(sY, Y + sys * sys_y, n * m, elem, lane);
  cw::cp_async_commit();
  cw::cp_async_wait<0>();
  __syncwarp();

  float a0[kWarp], a1[NP], ivd0 = 1.0f, ivd1 = 1.0f;
  cw::load_rows2<NP>(a0, a1, sA + off_a, n, shift, lane);
  float* gX = X + sys * sys_y;
  if constexpr (MODE == kRows) {
    const float* y = sY + off_y;
    float y0 = lane < n ? y[lane] : 0.0f;
    float y1 = lane + kWarp < n ? y[lane + kWarp] : 0.0f;
    cw::factor2<NP>(a0, a1, ivd0, ivd1, lane);
    cw::store_rows2<NP>(a0, a1, sF, lane);
    __syncwarp();  // row i of L is in shared memory for every lane
    cw::solve_rows2<NP>(y0, y1, a0, a1, ivd0, ivd1, sF, n, lane);
    if (lane < n) gX[lane * elem] = y0;
    if (lane + kWarp < n) gX[(lane + kWarp) * elem] = y1;
  } else {
    float* sLt = sF;
    float* sL = sF + NP * NP;
    cw::factor2<NP>(a0, a1, ivd0, ivd1, lane);
    cw::store_factor2_lean<NP>(a0, a1, ivd0, ivd1, sLt, sL, lane);
    __syncwarp();  // L is in shared memory for every lane
    // Y from the staged buffer, or (m > 64) from device memory
    const float* ys = chunked ? Y + sys * sys_y : sY + off_y;
    const long long ye = chunked ? elem : 1;
    for (int col = lane; col - lane < m; col += kWarp) {  // 32 columns a pass
      float z[NP];
      const float* yc = ys + col * ye;
      const long long ystep = m * ye;
#pragma unroll
      for (int r = 0; r < NP; ++r) z[r] = (col < m && r < n) ? yc[r * ystep] : 0.0f;
      cw::solve_cols<NP>(z, sLt, sL, n);
      float* xc = gX + col * elem;
      const long long xstep = m * elem;
#pragma unroll
      for (int r = 0; r < NP; ++r)
        if (col < m && r < n) xc[r * xstep] = z[r];
    }
  }
}

template <int NP, int MODE>
int launch_reg64_mode(const float* A, const float* Y, float* X, int batch, int n, int m,
                      float shift, long long sys_a, long long sys_y, long long elem,
                      cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t per_warp =
      (size_t)(reg64_stage_floats(n, m) + reg64_factor_floats<NP, MODE>()) * sizeof(float);
  int warps = kRegBlockWarps;
  while (warps > 1 && warps * per_warp > (size_t)max_smem) --warps;
  const size_t smem = warps * per_warp;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)spd_reg64_kernel<NP, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = (batch + warps - 1) / warps;
  spd_reg64_kernel<NP, MODE><<<(int)grid, warps * kWarp, smem, stream>>>(
      A, Y, X, batch, n, m, shift, sys_a, sys_y, elem);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_reg64_np(const float* A, const float* Y, float* X, int batch, int n, int m,
                    float shift, long long sys_a, long long sys_y, long long elem,
                    cudaStream_t stream) {
  if (m == 1)
    return launch_reg64_mode<NP, kRows>(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, stream);
  return launch_reg64_mode<NP, kCols>(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, stream);
}

int launch_reg64(const float* A, const float* Y, float* X, int batch, int n, int m, float shift,
                 long long sys_a, long long sys_y, long long elem, cudaStream_t stream) {
  if (n < 1 || n > 64 || m < 1 || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  if (n <= 48)
    return launch_reg64_np<48>(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, stream);
  return launch_reg64_np<64>(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, stream);
}

// --- blk128: 64 < n <= 128 ------------------------------------------------------

constexpr int kBlkThreads = 256;  // 8 warps a system
constexpr int kPanel = 32;

// Shared memory of one blk128 system: A padded to np = n rounded up to 32
// rows (odd row stride np + 1), then the pivots' inv and 1 / L_ii.
__host__ __device__ inline int blk128_floats(int n) {
  const int np = (n + kPanel - 1) / kPanel * kPanel;
  return np * (np + 1) + 2 * np;
}

// One block of 8 warps a system. A blocked right-looking Cholesky with
// 32-column panels, in place in shared memory: warp 0 factors the panel's
// diagonal block in registers (chol_warp::factor_lean_ref<32>), the threads solve
// the rows below it a row each (L21 = A21 L11^-T, 32 steps, L11 read as
// broadcasts), and all 256 threads share the trailing update
// A22 -= L21 L21^T in 4 x 4 register tiles of its lower triangle: three
// barriers a panel. The substitutions then take the right-hand sides a warp
// each, held by rows (lane l holds rows l, l + 32, l + 64, l + 96): at step i
// row i's lane forms the unknown and broadcasts it by shuffle, and every lane
// updates its rows from L in shared memory. Y and X go straight between
// device memory and registers, so no m is too large.
__global__ void __launch_bounds__(kBlkThreads, 2)
spd_blk128_kernel(const float* __restrict__ A, const float* __restrict__ Y,
                  float* __restrict__ X, int n, int m, float shift, long long sys_a,
                  long long sys_y, long long elem) {
  extern __shared__ __align__(16) float blk_smem[];
  const int np = (n + kPanel - 1) / kPanel * kPanel;
  const int ld = np + 1;
  float* sA = blk_smem;
  float* sInv = sA + np * ld;  // rsqrt(max(pivot, 1e-30)): the factor's column scale
  float* sRcp = sInv + np;     // 1 / L_ii: the substitutions' scale
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const long long sys = blockIdx.x;
  const float* gA = A + sys * sys_a;
  const float* gY = Y + sys * sys_y;
  float* gX = X + sys * sys_y;

  // A's lower triangle by cp.async (every copy in flight at once), rows
  // n..np-1 identity; then the shift on the diagonal
  for (int idx = tid; idx < np * np; idx += kBlkThreads) {
    const int i = idx / np;
    const int j = idx - i * np;
    if (j <= i) {
      if (i < n)
        chol_warp::cp_async4(sA + i * ld + j, gA + (long long)(i * n + j) * elem);
      else
        sA[i * ld + j] = i == j ? 1.0f : 0.0f;
    }
  }
  chol_warp::cp_async_commit();
  chol_warp::cp_async_wait<0>();
  __syncthreads();
  if (tid < n) sA[tid * ld + tid] += shift;
  __syncthreads();

  for (int c0 = 0; c0 < np; c0 += kPanel) {
    if (warp == 0) {  // the diagonal block, a row a lane, in registers
      float a[kPanel], ivd = 0.0f;
      float* row = sA + (c0 + lane) * ld + c0;
#pragma unroll
      for (int j = 0; j < kPanel; ++j) a[j] = j <= lane ? row[j] : 0.0f;
      chol_warp::factor_lean_ref<kPanel>(a, ivd, lane);
#pragma unroll
      for (int j = 0; j < kPanel; ++j)
        if (j <= lane) row[j] = a[j];
      sInv[c0 + lane] = ivd;
      sRcp[c0 + lane] = chol_warp::recip(row[lane]);
    }
    __syncthreads();
    const int below = np - c0 - kPanel;
    for (int t = tid; t < below; t += kBlkThreads) {  // L21 = A21 L11^-T, a row a thread
      float x[kPanel];
      float* row = sA + (c0 + kPanel + t) * ld + c0;
#pragma unroll
      for (int j = 0; j < kPanel; ++j) x[j] = row[j];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const float xj = x[j] * sInv[c0 + j];
        x[j] = xj;
#pragma unroll
        for (int u = 0; u < kPanel; ++u)
          if (u > j) x[u] = fmaf(-sA[(c0 + u) * ld + c0 + j], xj, x[u]);
      }
#pragma unroll
      for (int j = 0; j < kPanel; ++j) row[j] = x[j];
    }
    __syncthreads();
    const int tiles = below / 4;  // A22 -= L21 L21^T, its lower triangle in 4 x 4 tiles
    for (int q = tid; q < tiles * (tiles + 1) / 2; q += kBlkThreads) {
      int I = (int)((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
      while ((I + 1) * (I + 2) / 2 <= q) ++I;
      while (I * (I + 1) / 2 > q) --I;
      const int J = q - I * (I + 1) / 2;
      const int i0 = c0 + kPanel + 4 * I, j0 = c0 + kPanel + 4 * J;
      float acc[4][4] = {};
#pragma unroll 8
      for (int t = 0; t < kPanel; ++t) {
        float li[4], lj[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          li[u] = sA[(i0 + u) * ld + c0 + t];
          lj[u] = sA[(j0 + u) * ld + c0 + t];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(li[u], lj[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (j0 + v <= i0 + u) sA[(i0 + u) * ld + j0 + v] -= acc[u][v];
    }
    __syncthreads();
  }

  // L L^T x = y, a right-hand side a warp, held by rows
  constexpr int kSlots = kMaxN / kWarp;
  const int panels = np / kPanel;
  for (int c = warp; c < m; c += kBlkThreads / kWarp) {
    float z[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int r = lane + s * kWarp;
      z[s] = r < n ? gY[(long long)(r * m + c) * elem] : 0.0f;
    }
    for (int p = 0; p < panels; ++p) {  // forward: z_i = y_i / L_ii, z_r -= L_ri z_i (r > i)
#pragma unroll
      for (int ii = 0; ii < kPanel; ++ii) {
        const int i = p * kPanel + ii;
        if (i < n) {
          const float own = p == 0 ? z[0] : p == 1 ? z[1] : p == 2 ? z[2] : z[3];
          const float zi = __shfl_sync(chol_warp::kFull, own * sRcp[i], ii);
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const int r = lane + s * kWarp;
            if (r == i)
              z[s] = zi;
            else if (r > i && r < n)
              z[s] = fmaf(-sA[r * ld + i], zi, z[s]);
          }
        }
      }
    }
    for (int p = panels - 1; p >= 0; --p) {  // back: x_i = z_i / L_ii, z_r -= L_ir x_i (r < i)
#pragma unroll
      for (int ii = kPanel - 1; ii >= 0; --ii) {
        const int i = p * kPanel + ii;
        if (i < n) {
          const float own = p == 0 ? z[0] : p == 1 ? z[1] : p == 2 ? z[2] : z[3];
          const float xi = __shfl_sync(chol_warp::kFull, own * sRcp[i], ii);
          const float* row = sA + i * ld;
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const int r = lane + s * kWarp;
            if (r == i)
              z[s] = xi;
            else if (r < i)
              z[s] = fmaf(-row[r], xi, z[s]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int r = lane + s * kWarp;
      if (r < n) gX[(long long)(r * m + c) * elem] = z[s];
    }
  }
}

int launch_blk128(const float* A, const float* Y, float* X, int batch, int n, int m, float shift,
                  long long sys_a, long long sys_y, long long elem, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || m < 1 || batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)blk128_floats(n) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(spd_blk128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  spd_blk128_kernel<<<batch, kBlkThreads, smem, stream>>>(A, Y, X, n, m, shift, sys_a, sys_y,
                                                           elem);
  return (int)cudaGetLastError();
}

}  // namespace

// The variants' entry points, one signature: A (batch systems of
// n x n), Y and X (batch systems of n x m); strides in floats: system b of A
// starts at b*sys_a, of Y and X at b*sys_y, elements within a system are
// elem apart ((n*n, n*m, 1) batch-major, (1, 1, batch) lanes-last). Each
// launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the variant does not take.
extern "C" int qm_spd_solve_reg16_f32(const float* A, const float* Y, float* X, int batch,
                                      int n, int m, float shift, long long sys_a,
                                      long long sys_y, long long elem, void* stream) {
  return launch_reg<16>(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem,
                        (cudaStream_t)stream);
}

extern "C" int qm_spd_solve_reg32_f32(const float* A, const float* Y, float* X, int batch,
                                      int n, int m, float shift, long long sys_a,
                                      long long sys_y, long long elem, void* stream) {
  return launch_reg<32>(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem,
                        (cudaStream_t)stream);
}

extern "C" int qm_spd_solve_reg64_f32(const float* A, const float* Y, float* X, int batch,
                                      int n, int m, float shift, long long sys_a,
                                      long long sys_y, long long elem, void* stream) {
  return launch_reg64(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, (cudaStream_t)stream);
}

extern "C" int qm_spd_solve_blk128_f32(const float* A, const float* Y, float* X, int batch,
                                       int n, int m, float shift, long long sys_a,
                                       long long sys_y, long long elem, void* stream) {
  return launch_blk128(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, (cudaStream_t)stream);
}

// PR 1's kernel (one row a lane, one lane a column), kept only to be timed
// in turns against the variants that replaced it: nothing dispatches to it.
extern "C" int qm_spd_solve_smem_f32(const float* A, const float* Y, float* X, int batch,
                                     int n, int m, float shift, long long sys_a,
                                     long long sys_y, long long elem, void* stream) {
  return launch_smem(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, (cudaStream_t)stream);
}
