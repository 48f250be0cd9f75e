// K2 / K3c: the whole backward Riccati sweep in one launch, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels that share this arithmetic:
//   K2  qm_door_tpu/ops/pallas_riccati.py:riccati_backward_fused (_ric_bwd_kernel),
//       Hessian inputs (lxx, luu, lxx_f) symmetrized up front;
//   K3c qm_door_tpu/ops/pallas_lq.py:riccati_backward_ll (_backward_kernel),
//       inputs as given, luu read through its upper triangle (_chol_t reads rows).
// The template flag kSym selects K2's input symmetrization; everything else
// is one kernel. Both form Qxx and Quu in the exactly symmetric product form
// of pallas_riccati.py:_mmT_sym, so the carry S stays symmetric in f32. The
// TPU's K3c forms Qxx = lxx + A^T SA instead: the skew part of S then rides
// A^T (.) A from node to node and in f32 grows about |A|^2 a node (with
// |A| ~ 1.1 over 67 nodes the literal form's K turns NaN in f32, see
// tests/test_torch_lq_kernels.py); in exact arithmetic the forms are equal.
//
// Per node k = N-1 .. 0, with the carry (S, s) starting at (lxx_f, lx_f):
//   Sd = S^T d + s,  Qx = lx + A^T Sd,  Qu = lu + B^T Sd,  SA = S^T A,  SB = S^T B,
//   Qxx = lxx + sym(A^T SA),  Quu = luu + sym(B^T SB) (+ shift I),  sym(M) = (M + M^T)/2,
//   Qux = lux + B^T SA,  [K | kff] = -Quu^-1 [Qux | Qu]  (Cholesky, pivots
//   rsqrt(max(., 1e-30)) as in pallas_chol.py:_chol_t),
//   S <- Qxx + sym(Qux^T K),  s <- Qx + Qux^T kff.
//
// Shape on the solver's path: 384 scenarios x 67 nodes, nx = nu = 30, f32.
// Bound on an H100: each node's A, B, d, l* (5,520 floats at 30/30) is read
// once and K, kff written once: ~570 MB, ~0.17 ms at 3.35 TB/s; ~396 kflop a
// node, ~0.15 ms at 67 TFLOP/s. What the kernel meets first is latency: the
// 67 nodes are a serial chain, and each node is a chain of small products,
// a 30-step Cholesky and two 30-step substitutions.
//
// Design: one block of 256 threads (8 warps) per scenario, not K1's one warp
// per system. The carry S, s and every node's data live in shared memory
// for the whole sweep; nothing but K and kff goes back to HBM, once. Each
// node's data is loaded coalesced into shared memory; every product is a
// sum over the leading index (X^T Y), computed in 2 x 4 register tiles
// spread over the block's threads (shared-memory bandwidth is what the
// products are bound by), and the symmetric forms as 1/2 (M + M^T) of one
// product M, which keeps them exactly symmetric. The Cholesky runs on the
// lower triangle of Quu in shared memory (odd row stride), block-parallel
// over the trailing update (warps over rows, lanes over columns), with one
// __syncthreads per pivot: column k is scaled one step late, while step k+1
// updates columns > k+1. The two substitutions keep the right-hand sides in
// registers: each warp takes every 8th of the nx + 1 columns, its lanes the
// rows (lane and lane + 32), and each solved entry reaches the other rows by
// a shuffle; they multiply by 1 / L_ii instead of dividing. K2 symmetrizes
// lxx, luu and lxx_f on the fly (reads (i,j) and (j,i)); K3c reads them as
// given. The 8 warps run 3 blocks an SM, so the 384 scenarios fit one wave.
// Generic nx, nu <= 36 (nu = 36 is the force-tracking width); no batch
// padding, no lanes-last layout. f32 FMAs on the CUDA cores, no tensor
// cores: the chain needs true f32.

#include <cuda_runtime.h>

// Diagnostic build (-DQM_SWEEP_PHASE_CLOCKS, chip_smoke.py phase (d)): each
// thread sums the clock64() cycles of the six phases of a node (load, SA/SB,
// Q terms, Cholesky, substitutions, S update); block 0's thread 0 writes its
// sums to `clocks`. The normal build compiles PHASE to nothing.
#ifdef QM_SWEEP_PHASE_CLOCKS
#define PHASE(ph)                                \
  {                                              \
    const long long t_now = clock64();           \
    phase_cycles[ph] += t_now - phase_start;     \
    phase_start = t_now;                         \
  }
#else
#define PHASE(ph)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxDim = 36;  // rows live in lanes lane and lane + 32
constexpr int kColsPerWarp = (kMaxDim + 1 + kWarps - 1) / kWarps;  // nx + 1 right-hand sides
constexpr int kSlack = 8;  // floats after the last buffer, for tile over-reads
constexpr int kRowsPerWarp = (kMaxDim - 1 + kWarps - 1) / kWarps;   // trailing rows of a pivot

// X^T Y over 2 x 4 register tiles: each thread reads 2 + 4 floats of shared
// memory per step of the sum and does 8 FMAs (one float each way for the
// untiled form), which is what the products are bound by.
__device__ __forceinline__ int tiles(int p, int r) { return ((p + 1) / 2) * ((r + 3) / 4); }

__device__ __forceinline__ void tile_origin(int w, int r, int& i0, int& j0) {
  const int groups = (r + 3) / 4;
  i0 = 2 * (w / groups);
  j0 = 4 * (w - (w / groups) * groups);
}

// acc[u][v] = sum_{q < n} X[q*ldx + i0 + u] * Y[q*ldy + j0 + v]. Rows and
// columns past the matrix read neighbouring shared memory (kSlack floats at
// the end keep that inside the allocation); the caller stores none of them.
__device__ __forceinline__ void tile_tn(const float* X, int ldx, const float* Y, int ldy, int n,
                                        int i0, int j0, float (&acc)[2][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  for (int q = 0; q < n; ++q) {
    const float x0 = X[q * ldx + i0], x1 = X[q * ldx + i0 + 1];
    const float* y = Y + q * ldy + j0;
    const float y0 = y[0], y1 = y[1], y2 = y[2], y3 = y[3];
    acc[0][0] = fmaf(x0, y0, acc[0][0]);
    acc[0][1] = fmaf(x0, y1, acc[0][1]);
    acc[0][2] = fmaf(x0, y2, acc[0][2]);
    acc[0][3] = fmaf(x0, y3, acc[0][3]);
    acc[1][0] = fmaf(x1, y0, acc[1][0]);
    acc[1][1] = fmaf(x1, y1, acc[1][1]);
    acc[1][2] = fmaf(x1, y2, acc[1][2]);
    acc[1][3] = fmaf(x1, y3, acc[1][3]);
  }
}

__host__ __device__ inline int smem_floats(int nx, int nu) {
  const int nxx = nx * nx, nxu = nx * nu;
  return 5 * nxx + 3 * nxu + nu * nu + nu * (nu | 1) + nu * (nx + 1) + 4 * nx + 3 * nu + kSlack;
}

// 3 blocks an SM (<= 85 registers a thread): the 384 scenarios of the
// solver's path then run in one wave on 132 SMs.
template <bool kSym>
__global__ void __launch_bounds__(kThreads, 3)
riccati_bwd_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
                   const float* __restrict__ gd, const float* __restrict__ glx,
                   const float* __restrict__ glu, const float* __restrict__ glxx,
                   const float* __restrict__ gluu, const float* __restrict__ glux,
                   const float* __restrict__ glxx_f, const float* __restrict__ glx_f,
                   float* __restrict__ gK, float* __restrict__ gkff,
                   int N, int nx, int nu, float shift, long long* clocks) {
  extern __shared__ float sm[];
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * nu;
  const int ldf = nu | 1;  // odd row stride: lanes walking a column hit distinct banks
  const int m = nx + 1;    // right-hand sides [Qux | Qu]
  float* S = sm;            // nx x nx carry
  float* A = S + nxx;       // nx x nx
  float* Bm = A + nxx;      // nx x nu
  float* lxx = Bm + nxu;    // nx x nx
  float* SA = lxx + nxx;    // nx x nx
  float* Qxx = SA + nxx;    // nx x nx
  float* SB = Qxx + nxx;    // nx x nu
  float* Qux = SB + nxu;    // nu x nx (lux, then Qux in place)
  float* luu = Qux + nxu;   // nu x nu
  float* F = luu + nuu;     // nu x ldf: Quu, then L in its lower triangle
  float* X = F + nu * ldf;  // nu x m: [Qux | Qu], then the solution
  float* s = X + nu * m;    // nx carry
  float* d = s + nx;        // nx
  float* Qx = d + nx;       // nx (lx, then Qx in place)
  float* Sd = Qx + nx;      // nx
  float* invd = Sd + nx;    // nu pivots' rsqrt
  float* lu = invd + nu;    // nu
  float* rinv = lu + nu;    // nu: 1 / L_ii

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
#ifdef QM_SWEEP_PHASE_CLOCKS
  long long phase_cycles[6] = {0, 0, 0, 0, 0, 0};
  long long phase_start = clock64();
#endif

  const float* Sf = glxx_f + (size_t)b * nxx;
  for (int idx = tid; idx < nxx; idx += kThreads) {
    const int i = idx / nx, j = idx - i * nx;
    S[idx] = kSym ? 0.5f * (Sf[idx] + Sf[j * nx + i]) : Sf[idx];
  }
  for (int i = tid; i < nx; i += kThreads) s[i] = glx_f[(size_t)b * nx + i];

  for (int k = N - 1; k >= 0; --k) {
    const size_t node = (size_t)b * N + k;
    // --- the previous node's carry: S <- Qxx + 1/2 (M + M^T), M = Qux^T K in
    // S; and this node's data, coalesced, into shared memory ----------------
    if (k < N - 1) {
      for (int idx = tid; idx < nxx; idx += kThreads) {
        const int i = idx / nx, j = idx - i * nx;
        if (j > i) continue;
        const float h = 0.5f * (S[idx] + S[j * nx + i]);
        S[idx] = Qxx[idx] + h;
        S[j * nx + i] = Qxx[j * nx + i] + h;
      }
    }
    for (int idx = tid; idx < nxx; idx += kThreads) {
      A[idx] = gA[node * nxx + idx];
      lxx[idx] = glxx[node * nxx + idx];
    }
    for (int idx = tid; idx < nxu; idx += kThreads) {
      Bm[idx] = gB[node * nxu + idx];
      Qux[idx] = glux[node * nxu + idx];
    }
    for (int idx = tid; idx < nuu; idx += kThreads) luu[idx] = gluu[node * nuu + idx];
    for (int i = tid; i < nx; i += kThreads) {
      d[i] = gd[node * nx + i];
      Qx[i] = glx[node * nx + i];
    }
    for (int i = tid; i < nu; i += kThreads) lu[i] = glu[node * nu + i];
    __syncthreads(); PHASE(0);

    // --- SA = S^T A, SB = S^T B (2 x 4 tiles), Sd = S^T d + s ----------------
    {
      const int tA = tiles(nx, nx), tB = tiles(nx, nu);
      for (int w = tid; w < tA + tB + nx; w += kThreads) {
        if (w < tA + tB) {
          const bool a = w < tA;
          const int r = a ? nx : nu;
          int i0, j0;
          tile_origin(a ? w : w - tA, r, i0, j0);
          float acc[2][4];
          tile_tn(S, nx, a ? A : Bm, r, nx, i0, j0, acc);
          float* out = a ? SA : SB;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (i0 + u < nx && j0 + v < r) out[(i0 + u) * r + j0 + v] = acc[u][v];
        } else {
          const int i = w - tA - tB;
          float acc = 0.0f;
          for (int q = 0; q < nx; ++q) acc = fmaf(S[q * nx + i], d[q], acc);
          Sd[i] = acc + s[i];
        }
      }
    }
    __syncthreads(); PHASE(1);

    // --- A^T SA (into Qxx), B^T SB (into F, full), Qux = lux + B^T SA, Qx, Qu
    {
      const int tX = tiles(nx, nx), tU = tiles(nu, nu), tQ = tiles(nu, nx);
      for (int w = tid; w < tX + tU + tQ + nx + nu; w += kThreads) {
        if (w < tX + tU + tQ) {
          const int which = w < tX ? 0 : (w < tX + tU ? 1 : 2);
          const int v0 = which == 0 ? w : (which == 1 ? w - tX : w - tX - tU);
          const int p = which == 0 ? nx : nu, r = which == 1 ? nu : nx;
          int i0, j0;
          tile_origin(v0, r, i0, j0);
          float acc[2][4];
          if (which == 0) tile_tn(A, nx, SA, nx, nx, i0, j0, acc);
          else if (which == 1) tile_tn(Bm, nu, SB, nu, nx, i0, j0, acc);
          else tile_tn(Bm, nu, SA, nx, nx, i0, j0, acc);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int i = i0 + u, j = j0 + v;
              if (i >= p || j >= r) continue;
              if (which == 0) {
                Qxx[i * nx + j] = acc[u][v];
              } else if (which == 1) {
                F[i * ldf + j] = acc[u][v];
              } else {
                const float q = Qux[i * nx + j] + acc[u][v];
                Qux[i * nx + j] = q;
                X[i * m + j] = q;
              }
            }
        } else if (w < tX + tU + tQ + nx) {
          const int i = w - tX - tU - tQ;
          float acc = 0.0f;
          for (int q = 0; q < nx; ++q) acc = fmaf(A[q * nx + i], Sd[q], acc);
          Qx[i] = Qx[i] + acc;
        } else {
          const int i = w - tX - tU - tQ - nx;
          float acc = 0.0f;
          for (int q = 0; q < nx; ++q) acc = fmaf(Bm[q * nu + i], Sd[q], acc);
          X[i * m + nx] = lu[i] + acc;
        }
      }
    }
    __syncthreads(); PHASE(2);

    // --- Qxx = lxx + 1/2 (M + M^T); Quu = luu + 1/2 (M + M^T) (+ shift I)
    // into F's lower triangle; K3c reads luu's upper triangle, as the TPU's
    // _chol_t reads rows ------------------------------------------------------
    for (int idx = tid; idx < nxx + nuu; idx += kThreads) {
      if (idx < nxx) {
        const int i = idx / nx, j = idx - i * nx;
        if (j > i) continue;
        const float h = 0.5f * (Qxx[idx] + Qxx[j * nx + i]);
        const float lij = kSym ? 0.5f * (lxx[idx] + lxx[j * nx + i]) : lxx[idx];
        const float lji = kSym ? lij : lxx[j * nx + i];
        Qxx[idx] = lij + h;
        Qxx[j * nx + i] = lji + h;
      } else {
        const int r = idx - nxx, i = r / nu, j = r - i * nu;
        if (j > i) continue;
        const float h = 0.5f * (F[i * ldf + j] + F[j * ldf + i]);
        const float l = kSym ? 0.5f * (luu[i * nu + j] + luu[j * nu + i]) : luu[j * nu + i];
        F[i * ldf + j] = l + h + (i == j ? shift : 0.0f);
      }
    }
    __syncthreads(); PHASE(2);

    // --- Cholesky of F's lower triangle, one barrier per pivot ---------------
    // Step c: pivot rsqrt, trailing update of columns > c (warps over rows,
    // lanes over columns; every load of the step is issued before its
    // stores), and the scaling of column c-1, which step c does not read.
    for (int c = 0; c < nu; ++c) {
      const float inv = rsqrtf(fmaxf(F[c * ldf + c], 1e-30f));
      if (tid == 0) invd[c] = inv;
      if (c > 0 && tid <= nu - c) F[(c - 1 + tid) * ldf + c - 1] *= invd[c - 1];
      const int j0 = c + 1 + lane, j1 = j0 + kWarp;
      const float ljc0 = j0 < nu ? F[j0 * ldf + c] * inv : 0.0f;
      const float ljc1 = j1 < nu ? F[j1 * ldf + c] * inv : 0.0f;
      float lic[kRowsPerWarp], f0[kRowsPerWarp], f1[kRowsPerWarp];
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        const int i = c + 1 + warp + kWarps * t;
        lic[t] = i < nu ? F[i * ldf + c] * inv : 0.0f;
        f0[t] = (i < nu && j0 <= i) ? F[i * ldf + j0] : 0.0f;
        f1[t] = (i < nu && j1 <= i) ? F[i * ldf + j1] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        const int i = c + 1 + warp + kWarps * t;
        if (i < nu && j0 <= i) F[i * ldf + j0] = f0[t] - lic[t] * ljc0;
        if (i < nu && j1 <= i) F[i * ldf + j1] = f1[t] - lic[t] * ljc1;
      }
      __syncthreads(); PHASE(3);
    }
    if (tid == 0) F[(nu - 1) * ldf + nu - 1] *= invd[nu - 1];
    __syncthreads(); PHASE(3);
    if (tid < nu) rinv[tid] = 1.0f / F[tid * ldf + tid];
    __syncthreads(); PHASE(3);

    // --- L L^T X = [Qux | Qu]: each warp takes every kWarps-th column, its
    // lanes the rows (lane and lane + 32); the pivot entry moves by shuffle
    {
      float y0[kColsPerWarp], y1[kColsPerWarp];
#pragma unroll
      for (int t = 0; t < kColsPerWarp; ++t) {
        const int c = warp + kWarps * t;
        y0[t] = (c < m && lane < nu) ? X[lane * m + c] : 0.0f;
        y1[t] = (c < m && lane + kWarp < nu) ? X[(lane + kWarp) * m + c] : 0.0f;
      }
      // the loads of step i + 1 are issued before step i's shuffles
      float ri = rinv[0];
      float l0 = (lane > 0 && lane < nu) ? F[lane * ldf] : 0.0f;
      float l1 = lane + kWarp < nu ? F[(lane + kWarp) * ldf] : 0.0f;
      for (int i = 0; i < nu; ++i) {  // L z = y: rows below i lose L[r][i] z_i
        const int n1 = i + 1;
        const float ri_n = n1 < nu ? rinv[n1] : 0.0f;
        const float l0_n = (n1 < nu && lane > n1 && lane < nu) ? F[lane * ldf + n1] : 0.0f;
        const float l1_n = (n1 < nu && lane + kWarp > n1 && lane + kWarp < nu)
                               ? F[(lane + kWarp) * ldf + n1] : 0.0f;
#pragma unroll
        for (int t = 0; t < kColsPerWarp; ++t) {
          const float zi = __shfl_sync(0xffffffffu, i < kWarp ? y0[t] : y1[t], i & (kWarp - 1)) * ri;
          if (lane == (i & (kWarp - 1))) {
            if (i < kWarp) y0[t] = zi; else y1[t] = zi;
          }
          y0[t] -= l0 * zi;
          y1[t] -= l1 * zi;
        }
        ri = ri_n;
        l0 = l0_n;
        l1 = l1_n;
      }
      ri = rinv[nu - 1];
      l0 = lane < nu - 1 ? F[(nu - 1) * ldf + lane] : 0.0f;
      l1 = lane + kWarp < nu - 1 ? F[(nu - 1) * ldf + lane + kWarp] : 0.0f;
      for (int i = nu - 1; i >= 0; --i) {  // L^T x = z: rows above i lose L[i][r] x_i
        const int n1 = i - 1;
        const float ri_n = n1 >= 0 ? rinv[n1] : 0.0f;
        const float l0_n = lane < n1 ? F[n1 * ldf + lane] : 0.0f;
        const float l1_n = lane + kWarp < n1 ? F[n1 * ldf + lane + kWarp] : 0.0f;
#pragma unroll
        for (int t = 0; t < kColsPerWarp; ++t) {
          const float xi = __shfl_sync(0xffffffffu, i < kWarp ? y0[t] : y1[t], i & (kWarp - 1)) * ri;
          if (lane == (i & (kWarp - 1))) {
            if (i < kWarp) y0[t] = xi; else y1[t] = xi;
          }
          y0[t] -= l0 * xi;
          y1[t] -= l1 * xi;
        }
        ri = ri_n;
        l0 = l0_n;
        l1 = l1_n;
      }
#pragma unroll
      for (int t = 0; t < kColsPerWarp; ++t) {
        const int c = warp + kWarps * t;
        if (c < m && lane < nu) X[lane * m + c] = y0[t];
        if (c < m && lane + kWarp < nu) X[(lane + kWarp) * m + c] = y1[t];
      }
    }
    __syncthreads(); PHASE(4);

    // --- K, kff out; M = Qux^T K into S (its symmetric part joins Qxx at the
    // next node's load), s <- Qx + Qux^T kff ---------------------------------
    for (int idx = tid; idx < nxu; idx += kThreads) {
      const int i = idx / nx, j = idx - i * nx;
      gK[node * nxu + idx] = -X[i * m + j];
    }
    for (int i = tid; i < nu; i += kThreads) gkff[node * nu + i] = -X[i * m + nx];
    {
      const int tS = tiles(nx, nx);
      for (int w = tid; w < tS + nx; w += kThreads) {
        if (w < tS) {
          int i0, j0;
          tile_origin(w, nx, i0, j0);
          float acc[2][4];
          tile_tn(Qux, nx, X, m, nu, i0, j0, acc);  // Qux^T X = -Qux^T K
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (i0 + u < nx && j0 + v < nx) S[(i0 + u) * nx + j0 + v] = -acc[u][v];
        } else {
          const int i = w - tS;
          float acc = 0.0f;
          for (int q = 0; q < nu; ++q) acc -= Qux[q * nx + i] * X[q * m + nx];
          s[i] = Qx[i] + acc;
        }
      }
    }
    __syncthreads(); PHASE(5);
  }
#ifdef QM_SWEEP_PHASE_CLOCKS
  if (clocks != nullptr && b == 0 && tid == 0)
    for (int q = 0; q < 6; ++q) clocks[q] = phase_cycles[q];
#endif
}

}  // namespace

// Batch-major inputs: A (batch, N, nx, nx), B (batch, N, nx, nu), d and lx
// (batch, N, nx), lu (batch, N, nu), lxx (batch, N, nx, nx), luu (batch, N,
// nu, nu), lux (batch, N, nu, nx), lxx_f (batch, nx, nx), lx_f (batch, nx);
// outputs K (batch, N, nu, nx), kff (batch, N, nu). symmetrize != 0 runs K2,
// 0 runs K3c. `clocks` (6 int64, or NULL) is written by the diagnostic build
// only. Launches on `stream` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int qm_riccati_bwd_f32(const float* A, const float* B, const float* d,
                                  const float* lx, const float* lu, const float* lxx,
                                  const float* luu, const float* lux, const float* lxx_f,
                                  const float* lx_f, float* K, float* kff,
                                  int batch, int N, int nx, int nu, float shift,
                                  int symmetrize, void* stream, long long* clocks) {
  if (batch < 0 || N < 1 || nx < 1 || nu < 1 || nx > kMaxDim || nu > kMaxDim)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t smem = (size_t)smem_floats(nx, nu) * sizeof(float);
  const void* fn = symmetrize ? (const void*)riccati_bwd_kernel<true>
                              : (const void*)riccati_bwd_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (symmetrize)
    riccati_bwd_kernel<true><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
        A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, K, kff, N, nx, nu, shift, clocks);
  else
    riccati_bwd_kernel<false><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
        A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, K, kff, N, nx, nu, shift, clocks);
  return (int)cudaGetLastError();
}
