// K1: batched small SPD solve  X = (A + shift*I)^-1 Y  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel qm_door_tpu/ops/pallas_chol.py:spd_solve
// (_spd_kernel, with _chol_t and _chol_solve_t): unrolled Cholesky with
// pivots rsqrt(max(a_kk, 1e-30)), then forward and back substitution.
//
// Shapes on the solver's main path (f32):
//   projection:    25728 systems (384 x 67 nodes), n = 12, m = 49, once a step
//   Riccati gain:    384 systems, n = 30, m = 31, 67 calls a step
// Bound on an H100: memory. Each system reads A (n*n) and Y (n*m) once and
// writes X (n*m) once, against ~n^3/3 + 2 n^2 m flops: at n = 12, m = 49 that
// is ~2.8 flops a byte, far under the ~20 flops a byte where f32 CUDA cores
// (67 TFLOP/s) overtake 3.35 TB/s of HBM. The projection call moves ~136 MB
// (~40 us); a gain call moves ~4.2 MB (~1.3 us), where launch latency
// dominates instead.
//
// Design: one warp per system, several systems per block. The warp stages
// the system's lower triangle (+ shift on the diagonal) and its Y in dynamic
// shared memory with coalesced loads, factors in place (right-looking, lanes
// across rows, the same 1e-30 pivot guard), substitutes with one lane per
// RHS column (columns in strides of 32), and writes X back coalesced: each
// byte crosses HBM once. Both call sites hand over exactly symmetric
// matrices (Riccati symmetrizes Quu; the projection's M = Gv Gv^T + diag is
// symmetric by construction), so only the lower triangle is read. No
// lanes-last transpose and no identity padding of the batch tail: a warp
// past the ragged end returns. n <= 64, any m, as long as one system's
// n*(n|1) + n*m floats fit in a block's shared memory; otherwise the launch
// is refused with an error, never run short.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxN = 64;
constexpr int kMaxSystemsPerBlock = 4;

__global__ void spd_solve_kernel(const float* __restrict__ A,
                                 const float* __restrict__ Y,
                                 float* __restrict__ X,
                                 int batch, int n, int m, int lda, float shift,
                                 int systems_per_block) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long sys = (long long)blockIdx.x * systems_per_block + warp;
  if (sys >= batch) return;  // ragged batch tail: only __syncwarp below

  float* sA = smem + (size_t)warp * (n * lda + n * m);
  float* sY = sA + n * lda;
  const float* gA = A + sys * n * n;
  const float* gY = Y + sys * n * m;
  float* gX = X + sys * n * m;

  for (int idx = lane; idx < n * n; idx += kWarp) {
    const int i = idx / n;
    const int j = idx - i * n;
    if (j <= i) sA[i * lda + j] = gA[idx] + (i == j ? shift : 0.0f);
  }
  for (int idx = lane; idx < n * m; idx += kWarp) sY[idx] = gY[idx];
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
  for (int idx = lane; idx < n * m; idx += kWarp) gX[idx] = sY[idx];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int qm_spd_solve_f32(const float* A, const float* Y, float* X,
                                int batch, int n, int m, float shift,
                                void* stream) {
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
  spd_solve_kernel<<<grid, spb * kWarp, smem, (cudaStream_t)stream>>>(
      A, Y, X, batch, n, m, lda, shift, spb);
  return (int)cudaGetLastError();
}
