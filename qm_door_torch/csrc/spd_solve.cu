// K1: batched small SPD solve  X = (A + shift*I)^-1 Y  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel qm_door_tpu/ops/pallas_chol.py:spd_solve
// (_spd_kernel, with _chol_t and _chol_solve_t): unrolled Cholesky with
// pivots rsqrt(max(a_kk, 1e-30)), then forward and back substitution. Only
// A's lower triangle is used: both solver call sites hand over exactly
// symmetric matrices (Riccati symmetrizes Quu; the projection's
// M = Gv Gv^T + diag is symmetric by construction).
//
// Shapes on the solver's main path (f32):
//   projection:    25728 systems (384 x 67 nodes), n = 12, m = 49, once a step
//   Riccati gain:    384 systems, n = 30, m = 31, 67 calls a step
// What bounds each on an H100: the projection call moves ~129 MB (A's lower
// triangle and Y read once, X written once; ~2.8 flops a byte, far under the
// ~20 flops a byte where 67 TFLOP/s of f32 overtakes 3.35 TB/s), ~38 us:
// bytes, so it needs many loads in flight. A gain call moves ~3.6 MB
// (~1.1 us); there one system's latency is the kernel's time: 384 systems
// are under 3 warps an SM, and each is a chain of 30 pivots and two
// 30-step substitutions, plus the launch itself.
//
// Three variants, chosen in Python by shape only (ops/spd_solve.py:k1_variant);
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
//   No tensor cores: ROADMAP's precision rule keeps the solver chain in true
//   f32 (TF32 keeps 10 of f32's 23 mantissa bits; reduced-precision operands
//   break the Cholesky/Riccati chain, docs/PERF.md:307-309).
//
// smem (n <= 128, any m whose system fits a block's shared memory; the WBC
//   shapes n = 36/42, m = 1, the 58 x 58 Gram solve and the stacked
//   interior-point systems of wbc/qp.py:solve_qp_batched, n + nv up to 92
//   with m = 1, 34.6 KB a system): one warp per
//   system, several systems per block. The warp stages the system's lower
//   triangle (+ shift on the diagonal) and its Y in dynamic shared memory
//   with coalesced loads, factors in place (right-looking, lanes across
//   rows, the same 1e-30 pivot guard), substitutes with one lane per RHS
//   column (columns in strides of 32), and writes X back coalesced. A warp
//   past the ragged end returns. A system too large for a block's shared
//   memory is refused with an error, never run short.
//
// K1-ll (qm_door_tpu/ops/pallas_chol.py:spd_solve_ll, lanes-last (n,n,B) and
// (n,m,B) arrays) enters the same variants with other strides: element
// (i,j) of system b sits at b*sys + (i*cols + j)*elem, with (sys, elem) =
// (n*cols, 1) batch-major and (1, B) lanes-last. Lanes-last loads are not
// coalesced within a warp (its lanes walk one system at stride B); the
// neighbouring warps read the neighbouring systems, so a sector fetched once
// mostly serves them from L1/L2. Nothing calls it on the solver's path.
//
// Launch shape of the reg variants (k1_launch_shapes.py at the repository
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

// The shared-memory kernel (one warp per system, several systems per block).
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

}  // namespace

// The three variants' entry points, one signature: A (batch systems of
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

extern "C" int qm_spd_solve_smem_f32(const float* A, const float* Y, float* X, int batch,
                                     int n, int m, float shift, long long sys_a,
                                     long long sys_y, long long elem, void* stream) {
  return launch_smem(A, Y, X, batch, n, m, shift, sys_a, sys_y, elem, (cudaStream_t)stream);
}
