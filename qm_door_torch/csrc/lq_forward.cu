// K3d: the LQ forward rollout with input recovery, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel qm_door_tpu/ops/pallas_lq.py:riccati_forward_ll
// (_forward_kernel). Per scenario, from dx_0, for k = 0 .. N-1:
//   u_red = kff_k + K_k dx_k,
//   du_k  = p_k + blkdiag(diag(fm_k), P_k) u_red + [0; Px_v,k] dx_k,
//   dx_k+1 = A_k dx_k + B_k u_red + d_k.
// Widths are the TPU kernel's: nx = nu = 30, 12 force and 18 joint-velocity
// inputs.
//
// Shape on the solver's path: 384 scenarios x 67 nodes, f32. Bound on an
// H100: bytes, 3,726 floats a node (A, B, K, P, Px_v, d, kff, p, fm read
// once; dx, du written once), ~383 MB, ~0.114 ms at 3.35 TB/s; the flops
// (~8 kflop a node) are nothing. What the kernel meets first is the serial
// chain of 67 nodes, each a dependent load-multiply-reduce.
//
// Design: one block per scenario, one warp per output row (30 warps), lanes
// across the 30 columns: each warp reads its rows of K, A, B, P, Px_v as
// coalesced 120-byte runs and reduces with shuffles; dx and u_red live in
// shared memory (two barriers a node). Each warp loads the next node's rows
// into registers while it works on this one, so the loads of node k+1 are
// in flight during node k's chain. Every byte crosses HBM once. No batch
// padding, no lanes-last layout.

#include <cuda_runtime.h>

namespace {

constexpr int NX = 30;
constexpr int NU = 30;
constexpr int NV = 18;
constexpr int NC = 12;
constexpr int kWarp = 32;
constexpr int kThreads = NX * kWarp;

struct Row {  // one warp's operands of one node, lane l holding column l
  float K, A, B, P, Px;   // rows i of K, A, B; rows i-12 of P, Px_v
  float kff, p, d, fm;    // entries i (fm only for i < 12)
};

__device__ inline float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ inline Row load_row(const float* __restrict__ gA, const float* __restrict__ gB,
                               const float* __restrict__ gd, const float* __restrict__ gK,
                               const float* __restrict__ gkff, const float* __restrict__ gp,
                               const float* __restrict__ gP, const float* __restrict__ gPx,
                               const float* __restrict__ gfm, size_t node, int i, int l) {
  Row r;
  const bool col = l < NX;
  r.K = col ? gK[(node * NU + i) * NX + l] : 0.0f;
  r.A = col ? gA[(node * NX + i) * NX + l] : 0.0f;
  r.B = l < NU ? gB[(node * NX + i) * NU + l] : 0.0f;
  r.P = (i >= NC && l < NV) ? gP[(node * NV + i - NC) * NV + l] : 0.0f;
  r.Px = (i >= NC && col) ? gPx[(node * NV + i - NC) * NX + l] : 0.0f;
  r.kff = gkff[node * NU + i];
  r.p = gp[node * NU + i];
  r.d = gd[node * NX + i];
  r.fm = i < NC ? gfm[node * NC + i] : 0.0f;
  return r;
}

__global__ void __launch_bounds__(kThreads)
forward_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
               const float* __restrict__ gd, const float* __restrict__ gK,
               const float* __restrict__ gkff, const float* __restrict__ gp,
               const float* __restrict__ gP, const float* __restrict__ gPx,
               const float* __restrict__ gfm, const float* __restrict__ gdx0,
               float* __restrict__ gdX, float* __restrict__ gdU, int N) {
  __shared__ float dx[2][kWarp];
  __shared__ float u[kWarp];
  const int b = blockIdx.x;
  const int i = threadIdx.x / kWarp;  // output row
  const int l = threadIdx.x % kWarp;  // column
  if (threadIdx.x < kWarp) {  // columns 30 and 31 stay 0: the lanes past the matrices
    dx[0][threadIdx.x] = threadIdx.x < NX ? gdx0[(size_t)b * NX + threadIdx.x] : 0.0f;
    dx[1][threadIdx.x] = 0.0f;
    u[threadIdx.x] = 0.0f;
  }
  Row cur = load_row(gA, gB, gd, gK, gkff, gp, gP, gPx, gfm, (size_t)b * N, i, l);
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    const size_t node = (size_t)b * N + k;
    Row nxt = cur;
    if (k + 1 < N) nxt = load_row(gA, gB, gd, gK, gkff, gp, gP, gPx, gfm, node + 1, i, l);
    const float* x = dx[k & 1];
    const float xl = x[l];  // 0 past column 29
    const float ui = cur.kff + warp_sum(cur.K * xl);
    if (l == 0) u[i] = ui;
    __syncthreads();

    const float ul = u[l];
    float du;
    if (i < NC) {
      du = cur.p + cur.fm * ui;
    } else {
      const float a = warp_sum(l < NV ? cur.P * u[NC + l] : 0.0f);
      du = cur.p + a + warp_sum(cur.Px * xl);
    }
    const float xn = warp_sum(cur.A * xl) + warp_sum(cur.B * ul) + cur.d;
    if (l == 0) {
      gdX[((size_t)b * (N + 1) + k) * NX + i] = x[i];
      gdU[node * NU + i] = du;
      dx[(k + 1) & 1][i] = xn;
    }
    cur = nxt;
    __syncthreads();
  }
  if (l == 0) gdX[((size_t)b * (N + 1) + N) * NX + i] = dx[N & 1][i];
}

}  // namespace

// Batch-major: A (batch, N, 30, 30), B (batch, N, 30, 30), d (batch, N, 30),
// K (batch, N, 30, 30), kff and p (batch, N, 30), P (batch, N, 18, 18),
// Px_v (batch, N, 18, 30), fm (batch, N, 12), dx0 (batch, 30) -> dX (batch,
// N+1, 30), dU (batch, N, 30). Returns cudaGetLastError().
extern "C" int qm_lq_forward_f32(const float* A, const float* B, const float* d,
                                 const float* K, const float* kff, const float* p,
                                 const float* P, const float* Px_v, const float* fm,
                                 const float* dx0, float* dX, float* dU, int batch, int N,
                                 void* stream) {
  if (batch < 0 || N < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  forward_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(A, B, d, K, kff, p, P, Px_v,
                                                               fm, dx0, dX, dU, N);
  return (int)cudaGetLastError();
}
