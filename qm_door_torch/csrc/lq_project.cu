// K3a / K3b: the LQ stage's equality projection and substitution, node by
// node, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU calls of qm_door_tpu/ops/pallas_lq.py:project_lq:
//   K3a _project_geom_kernel: M = Gv Gv^T + diag(1 - act), its Cholesky,
//       W = M^-1 [g0 | Gx | Gv], then p, P = I - Gv^T W_v, Px_v = -Gv^T W_x,
//       A_bar = A + B_v Px_v, B_bar = [B_F diag(fm) | B_v P], d_bar = d + B p;
//   K3b _project_cost_kernel: the substitution du = p + Pu u_red + Px dx into
//       lx, lu, lxx, luu, lux (with the Hessian shift), Pu = blkdiag(diag(fm), P),
//       Px = [0; Px_v].
// The widths are the TPU kernels' own: nx = nu = 30, 12 force inputs, 18
// joint-velocity inputs, 12 constraint rows (pallas_lq.py:54-57).
//
// Shape on the solver's path: 384 x 67 = 25,728 independent nodes, f32.
// Bound on an H100: bytes. K3a moves 5,178 floats a node (~533 MB, ~0.159
// ms at 3.35 TB/s) for ~94 kflop (~0.036 ms at 67 TFLOP/s); K3b moves 6,426
// floats a node (~661 MB, ~0.197 ms) for ~200 kflop (~0.077 ms).
//
// What held the scalar-product kernels (one 128-thread block a node, one output
// entry a thread, both operands of every FMA read from shared memory) was
// the SM's shared-memory pipe and, in K3a, a serial 12 x 12 factor and 49
// substitutions out of shared memory (their phase clocks: PERF.md §6).
// Design now, for both kernels: 128-thread blocks, 5 an SM, each looping
// over the nodes (grid = SMs x 5, node_loop_grid below) with two buffer
// sets: the next node's inputs arrive while this one computes, each input
// as one bulk copy (cp.async.bulk, the TMA's 1-D form) on the set's
// mbarrier (4-byte cp.async where an input is not 16-byte aligned, and for
// the 30-float vectors, 120 bytes a node). Every product is a register
// tile (4 x 6 or 2 x 6 outputs a thread, float2 fragments, 24 FMAs for 5
// or 8 shared-memory reads), each distinct product computed once. Outputs
// are staged in shared memory and leave as bulk stores. K3a factors and
// solves on chol_warp.cuh's NP = 16 register routines (the kernels' notes
// below). Pure f32 on the CUDA cores, no tensor cores. No batch padding,
// no lanes-last layout, no transposed copies of B or Gv.
//
// Builds: -DQM_LQ_SCALAR_PRODUCTS compiles the scalar-product kernels instead
// (a measuring build: chip_smoke.py (d) times the two in turns; nothing at
// run time chooses it); -DQM_LQ_PHASE_CLOCKS adds the phase clocks to
// either; -DQM_LQ_GEOM_BLOCKS, -DQM_LQ_COST_BLOCKS set the blocks an SM
// (lq_launch_shapes.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "chol_warp.cuh"

// Diagnostic build (-DQM_LQ_PHASE_CLOCKS, chip_smoke.py phase (d)): each
// thread sums the clock64() cycles of the six phases of its nodes; block
// 0's thread 0 writes its sums and the number of nodes it ran to `clocks`.
// The normal build compiles PHASE to nothing.
#ifdef QM_LQ_PHASE_CLOCKS
#define PHASE(ph)                                \
  {                                              \
    const long long t_now = clock64();           \
    phase_cycles[ph] += t_now - phase_start;     \
    phase_start = t_now;                         \
  }
#define PHASE_CLOCKS_START                       \
  long long phase_cycles[6] = {0, 0, 0, 0, 0, 0}; \
  long long phase_start = clock64();
#define PHASE_CLOCKS_STORE(nodes_done)                                     \
  if (clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {          \
    for (int q = 0; q < 6; ++q) clocks[q] = phase_cycles[q];               \
    clocks[6] = (nodes_done);                                              \
  }
#else
#define PHASE(ph)
#define PHASE_CLOCKS_START
#define PHASE_CLOCKS_STORE(nodes_done)
#endif

namespace {

using namespace bulk_copy;

constexpr int kThreads = 128;
constexpr int NX = 30;
constexpr int NU = 30;
constexpr int NV = 18;
constexpr int NC = 12;
constexpr int NW = 1 + NX + NV;  // right-hand sides [g0 | Gx | Gv]

#ifdef QM_LQ_SCALAR_PRODUCTS  // the measuring build: the scalar-product kernels

constexpr int LDM = NC | 1;  // odd row stride of M

__global__ void __launch_bounds__(kThreads)
project_geom_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
                    const float* __restrict__ gd, const float* __restrict__ gg0,
                    const float* __restrict__ gGx, const float* __restrict__ gGv,
                    const float* __restrict__ gFb, const float* __restrict__ gact,
                    const float* __restrict__ gfm, float* __restrict__ oA,
                    float* __restrict__ oB, float* __restrict__ od, float* __restrict__ op,
                    float* __restrict__ oP, float* __restrict__ oPx,
                    long long* clocks) {
  __shared__ float Bm[NX * NU];
  __shared__ float Gv[NC * NV];
  __shared__ float M[NC * LDM];
  __shared__ float W[NC * NW];
  __shared__ float P[NV * NV];
  __shared__ float Px[NV * NX];
  __shared__ float p[NU];
  __shared__ float act[NC], fm[NC];

  const size_t node = blockIdx.x;
  const int tid = threadIdx.x;
  PHASE_CLOCKS_START

  for (int idx = tid; idx < NX * NU; idx += kThreads) Bm[idx] = gB[node * NX * NU + idx];
  for (int idx = tid; idx < NC * NV; idx += kThreads) Gv[idx] = gGv[node * NC * NV + idx];
  for (int idx = tid; idx < NC * NX; idx += kThreads) {
    const int r = idx / NX, c = idx - r * NX;
    W[r * NW + 1 + c] = gGx[node * NC * NX + idx];
  }
  if (tid < NC) {
    W[tid * NW] = gg0[node * NC + tid];
    act[tid] = gact[node * NC + tid];
    fm[tid] = gfm[node * NC + tid];
    p[tid] = -(1.0f - fm[tid]) * gFb[node * NC + tid];
  }
  __syncthreads(); PHASE(0);

  // M = Gv Gv^T + diag(1 - act) (lower triangle); W's last 18 columns = Gv
  for (int idx = tid; idx < NC * NC + NC * NV; idx += kThreads) {
    if (idx < NC * NC) {
      const int i = idx / NC, j = idx - i * NC;
      if (j > i) continue;
      float acc = 0.0f;
      for (int q = 0; q < NV; ++q) acc = fmaf(Gv[i * NV + q], Gv[j * NV + q], acc);
      M[i * LDM + j] = acc + (i == j ? 1.0f - act[i] : 0.0f);
    } else {
      const int r = (idx - NC * NC) / NV, c = (idx - NC * NC) - r * NV;
      W[r * NW + 1 + NX + c] = Gv[r * NV + c];
    }
  }
  __syncthreads(); PHASE(1);

  if (tid < 32) {  // right-looking Cholesky in one warp, L overwrites M
    const int lane = tid;
    for (int k = 0; k < NC; ++k) {
      const float inv = rsqrtf(fmaxf(M[k * LDM + k], 1e-30f));
      __syncwarp();
      if (lane >= k && lane < NC) M[lane * LDM + k] *= inv;
      __syncwarp();
      if (lane > k && lane < NC) {
        const float lik = M[lane * LDM + k];
        for (int j = k + 1; j <= lane; ++j) M[lane * LDM + j] -= lik * M[j * LDM + k];
      }
      __syncwarp();
    }
  }
  __syncthreads(); PHASE(2);

  for (int c = tid; c < NW; c += kThreads) {  // L L^T W = [g0 | Gx | Gv]
    for (int i = 0; i < NC; ++i) {
      const float zi = W[i * NW + c] / M[i * LDM + i];
      W[i * NW + c] = zi;
      for (int r = i + 1; r < NC; ++r) W[r * NW + c] -= M[r * LDM + i] * zi;
    }
    for (int i = NC - 1; i >= 0; --i) {
      float acc = 0.0f;
      for (int r = i + 1; r < NC; ++r) acc += M[r * LDM + i] * W[r * NW + c];
      W[i * NW + c] = (W[i * NW + c] - acc) / M[i * LDM + i];
    }
  }
  __syncthreads(); PHASE(3);

  // p_v = -Gv^T W_0, Px_v = -Gv^T W_x, P = I - Gv^T W_v
  for (int idx = tid; idx < NV + NV * NX + NV * NV; idx += kThreads) {
    float acc = 0.0f;
    if (idx < NV) {
      for (int r = 0; r < NC; ++r) acc = fmaf(Gv[r * NV + idx], W[r * NW], acc);
      p[NC + idx] = -acc;
    } else if (idx < NV + NV * NX) {
      const int e = idx - NV, i = e / NX, j = e - i * NX;
      for (int r = 0; r < NC; ++r) acc = fmaf(Gv[r * NV + i], W[r * NW + 1 + j], acc);
      Px[e] = -acc;
    } else {
      const int e = idx - NV - NV * NX, i = e / NV, j = e - i * NV;
      for (int r = 0; r < NC; ++r) acc = fmaf(Gv[r * NV + i], W[r * NW + 1 + NX + j], acc);
      P[e] = (i == j ? 1.0f : 0.0f) - acc;
    }
  }
  __syncthreads(); PHASE(4);

  // A_bar = A + B_v Px_v, B_bar = [B_F diag(fm) | B_v P], d_bar = d + B p
  for (int idx = tid; idx < NX * NX; idx += kThreads) {
    const int i = idx / NX, j = idx - i * NX;
    float acc = 0.0f;
    for (int q = 0; q < NV; ++q) acc = fmaf(Bm[i * NU + NC + q], Px[q * NX + j], acc);
    oA[node * NX * NX + idx] = gA[node * NX * NX + idx] + acc;
  }
  for (int idx = tid; idx < NX * NU; idx += kThreads) {
    const int i = idx / NU, j = idx - i * NU;
    float v;
    if (j < NC) {
      v = Bm[idx] * fm[j];
    } else {
      v = 0.0f;
      for (int q = 0; q < NV; ++q) v = fmaf(Bm[i * NU + NC + q], P[q * NV + j - NC], v);
    }
    oB[node * NX * NU + idx] = v;
  }
  for (int i = tid; i < NX; i += kThreads) {
    float acc = 0.0f;
    for (int q = 0; q < NU; ++q) acc = fmaf(Bm[i * NU + q], p[q], acc);
    od[node * NX + i] = gd[node * NX + i] + acc;
  }
  for (int i = tid; i < NU; i += kThreads) op[node * NU + i] = p[i];
  for (int idx = tid; idx < NV * NV; idx += kThreads) oP[node * NV * NV + idx] = P[idx];
  for (int idx = tid; idx < NV * NX; idx += kThreads) oPx[node * NV * NX + idx] = Px[idx];
  PHASE(5);
  PHASE_CLOCKS_STORE(1)
}

__global__ void __launch_bounds__(kThreads)
project_cost_kernel(const float* __restrict__ glx, const float* __restrict__ glu,
                    const float* __restrict__ glxx, const float* __restrict__ gluu,
                    const float* __restrict__ glux, const float* __restrict__ gp,
                    const float* __restrict__ gP, const float* __restrict__ gPx,
                    const float* __restrict__ gfm, float shift, float* __restrict__ olx,
                    float* __restrict__ olu, float* __restrict__ olxx,
                    float* __restrict__ oluu, float* __restrict__ olux,
                    long long* clocks) {
  __shared__ float luu[NU * NU];
  __shared__ float lux[NU * NX];
  __shared__ float P[NV * NV];
  __shared__ float Px[NV * NX];
  __shared__ float T1[NV * NX];    // luu_vv^T Px_v
  __shared__ float term[NU * NX];  // lux + luu[12:]^T Px_v
  __shared__ float FVP[NC * NV];   // luu_vF^T P
  __shared__ float PVF[NV * NC];   // P^T luu_vF
  __shared__ float PVVT[NV * NV];  // luu_vv^T P
  __shared__ float p[NU], lup[NU], fm[NC];

  const size_t node = blockIdx.x;
  const int tid = threadIdx.x;
  PHASE_CLOCKS_START

  for (int idx = tid; idx < NU * NU; idx += kThreads) luu[idx] = gluu[node * NU * NU + idx];
  for (int idx = tid; idx < NU * NX; idx += kThreads) lux[idx] = glux[node * NU * NX + idx];
  for (int idx = tid; idx < NV * NV; idx += kThreads) P[idx] = gP[node * NV * NV + idx];
  for (int idx = tid; idx < NV * NX; idx += kThreads) Px[idx] = gPx[node * NV * NX + idx];
  if (tid < NU) p[tid] = gp[node * NU + tid];
  if (tid < NC) fm[tid] = gfm[node * NC + tid];
  __syncthreads(); PHASE(0);

  // luu is read as symmetric, as the TPU kernel reads it: luu[:, i] through row i
  constexpr int kP1 = NU + NV * NX + NC * NV + NV * NC + NV * NV + NU * NX;
  for (int idx = tid; idx < kP1; idx += kThreads) {
    float acc = 0.0f;
    int e = idx;
    if (e < NU) {  // lu_p = lu + luu^T p
      for (int q = 0; q < NU; ++q) acc = fmaf(luu[q * NU + e], p[q], acc);
      lup[e] = glu[node * NU + e] + acc;
      continue;
    }
    e -= NU;
    if (e < NV * NX) {
      const int i = e / NX, j = e - i * NX;
      for (int q = 0; q < NV; ++q) acc = fmaf(luu[(NC + q) * NU + NC + i], Px[q * NX + j], acc);
      T1[e] = acc;
      continue;
    }
    e -= NV * NX;
    if (e < NC * NV) {
      const int i = e / NV, j = e - i * NV;
      for (int q = 0; q < NV; ++q) acc = fmaf(luu[(NC + q) * NU + i], P[q * NV + j], acc);
      FVP[e] = acc;
      continue;
    }
    e -= NC * NV;
    if (e < NV * NC) {
      const int i = e / NC, j = e - i * NC;
      for (int q = 0; q < NV; ++q) acc = fmaf(P[q * NV + i], luu[(NC + q) * NU + j], acc);
      PVF[e] = acc;
      continue;
    }
    e -= NV * NC;
    if (e < NV * NV) {
      const int i = e / NV, j = e - i * NV;
      for (int q = 0; q < NV; ++q)
        acc = fmaf(luu[(NC + q) * NU + NC + i], P[q * NV + j], acc);
      PVVT[e] = acc;
      continue;
    }
    e -= NV * NV;
    {
      const int i = e / NX, j = e - i * NX;
      for (int q = 0; q < NV; ++q) acc = fmaf(luu[(NC + q) * NU + i], Px[q * NX + j], acc);
      term[e] = lux[e] + acc;
    }
  }
  __syncthreads(); PHASE(1);

  // lx_bar, lu_bar
  for (int i = tid; i < NX + NU; i += kThreads) {
    if (i < NX) {
      float a = 0.0f, b = 0.0f;
      for (int q = 0; q < NV; ++q) a = fmaf(Px[q * NX + i], lup[NC + q], a);
      for (int q = 0; q < NU; ++q) b = fmaf(lux[q * NX + i], p[q], b);
      olx[node * NX + i] = (glx[node * NX + i] + a) + b;
    } else {
      const int u = i - NX;
      float v;
      if (u < NC) {
        v = fm[u] * lup[u];
      } else {
        v = 0.0f;
        for (int q = 0; q < NV; ++q) v = fmaf(P[q * NV + u - NC], lup[NC + q], v);
      }
      olu[node * NU + u] = v;
    }
  }
  PHASE(2);
  // lxx_bar = lxx + Px^T lux_v + lux_v^T Px + Px^T (luu_vv^T Px)
  for (int idx = tid; idx < NX * NX; idx += kThreads) {
    const int i = idx / NX, j = idx - i * NX;
    float a = 0.0f, b = 0.0f, c = 0.0f;
    for (int q = 0; q < NV; ++q) {
      a = fmaf(Px[q * NX + i], lux[(NC + q) * NX + j], a);
      b = fmaf(lux[(NC + q) * NX + i], Px[q * NX + j], b);
      c = fmaf(Px[q * NX + i], T1[q * NX + j], c);
    }
    olxx[node * NX * NX + idx] = ((glxx[node * NX * NX + idx] + a) + b) + c;
  }
  PHASE(3);
  // luu_bar = Pu^T luu Pu + blkdiag(diag(1 - fm), I - P) + shift I
  for (int idx = tid; idx < NU * NU; idx += kThreads) {
    const int i = idx / NU, j = idx - i * NU;
    float v;
    if (i < NC && j < NC) {
      v = luu[idx] * fm[i] * fm[j] + (i == j ? (1.0f - fm[i]) + shift : 0.0f);
    } else if (i < NC) {
      v = FVP[i * NV + j - NC] * fm[i];
    } else if (j < NC) {
      v = PVF[(i - NC) * NC + j] * fm[j];
    } else {
      float acc = 0.0f;
      for (int q = 0; q < NV; ++q) acc = fmaf(PVVT[q * NV + i - NC], P[q * NV + j - NC], acc);
      v = acc + ((i == j ? 1.0f + shift : 0.0f) - P[(i - NC) * NV + j - NC]);
    }
    oluu[node * NU * NU + idx] = v;
  }
  PHASE(4);
  // lux_bar = Pu^T (lux + luu Px)
  for (int idx = tid; idx < NU * NX; idx += kThreads) {
    const int i = idx / NX, j = idx - i * NX;
    float v;
    if (i < NC) {
      v = term[idx] * fm[i];
    } else {
      v = 0.0f;
      for (int q = 0; q < NV; ++q) v = fmaf(P[q * NV + i - NC], term[(NC + q) * NX + j], v);
    }
    olux[node * NU * NX + idx] = v;
  }
  PHASE(5);
  PHASE_CLOCKS_STORE(1)
}

#else  // the normal build: K3a and K3b on register tiles

// K3b's block shape: 128 threads, one node at a time, looping over the
// nodes in a grid of (SMs x kCostBlocks) blocks (node_loop_grid).
// -DQM_LQ_COST_BLOCKS is a measuring build (lq_launch_shapes.py); the normal
// build's 5 blocks of 42.4 KB fill an SM's shared memory, at 96 registers
// and no spills, and beat 4 by 13% (NVIDIA H100 80GB HBM3, 700 W). A tile's
// sum is unrolled 6 steps (3 and 18 measured 1–2% slower, 18 spilling).
#ifndef QM_LQ_COST_BLOCKS
#define QM_LQ_COST_BLOCKS 5
#endif
constexpr int kCostBlocks = QM_LQ_COST_BLOCKS;
constexpr int kUnroll = 6;

// acc[u][v] = sum_{q < kDepth} A[q * lda + u] * B[q * ldb + v] (u < 4, v < 6):
// a 4 x 6 register tile of X^T Y, summed in q's order (the order of the
// TPU kernel's _mtm). A step of the sum reads two float2 of A and three of
// B (8-byte aligned) for 24 FMAs; the lanes of a warp on one tile row or
// column read the same addresses (a broadcast).
template <int kDepth>
__device__ __forceinline__ void tile46(const float* A, int lda, const float* B, int ldb,
                                       float (&acc)[4][6]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 6; ++v) acc[u][v] = 0.0f;
#pragma unroll kUnroll
  for (int q = 0; q < kDepth; ++q) {
    const float2 a0 = *reinterpret_cast<const float2*>(A + q * lda);
    const float2 a1 = *reinterpret_cast<const float2*>(A + q * lda + 2);
    const float2 b0 = *reinterpret_cast<const float2*>(B + q * ldb);
    const float2 b1 = *reinterpret_cast<const float2*>(B + q * ldb + 2);
    const float2 b2 = *reinterpret_cast<const float2*>(B + q * ldb + 4);
    const float av[4] = {a0.x, a0.y, a1.x, a1.y};
    const float bv[6] = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 6; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  }
}

// One node's inputs in shared memory, each as it lies in HBM (a set; two
// sets, node after node), every buffer 16-byte aligned.
struct CostSet {
  static constexpr int kLuu = 0, kLux = kLuu + NU * NU, kPx = kLux + NU * NX,
                       kP = kPx + NV * NX, kFm = kP + NV * NV, kLx = kFm + NC, kLu = kLx + 32,
                       kp = kLu + 32, kFloats = kp + 32;
  // bytes of the bulk-copied inputs (luu, lux, Px_v, P, fm)
  static constexpr unsigned kBulkBytes = (2 * NX * NX + NV * NX + NV * NV + NC) * 4;
};
// The buffers every node shares, after the two sets.
struct CostShared {
  static constexpr int kX = 2 * CostSet::kFloats,  // Px^T lux_v, 30 x 30
      kT1 = kX + NX * NX,                          // luu_vv^T Px, 18 x 30
      kTV = kT1 + NV * NX,                         // lux_v + luu_v^T Px, 18 x 30
      kPVVT = kTV + NV * NX,                       // luu_vv^T P, 18 x 18
      kLup = kPVVT + NV * NV,                      // lu + luu^T p, 32
      kOut = kLup + 32,                            // lxx (then lxx_bar), luu_bar, lux_bar
      kBar = kOut + 3 * NX * NX,                   // mbarriers: one a set, one for lxx
      kFloats = kBar + 8;
};
constexpr size_t kCostSmemBytes = CostShared::kFloats * sizeof(float);

// Set off node `node`'s copies into `set`: with kBulk (every input 16-byte
// aligned) thread 0 issues one bulk copy an input (luu, lux, Px_v, P, fm:
// whole multiples of 16 bytes a node) on the set's mbarrier; otherwise
// the block copies them with 4-byte cp.async. The 30-float vectors (lx,
// lu, p: 120 bytes, not 16-byte aligned on odd nodes) always go by 4-byte
// cp.async, one float a thread.
template <bool kBulk>
__device__ __forceinline__ void stage_cost_node(float* set, uint64_t* bar, const float* glx,
                                                const float* glu, const float* gluu,
                                                const float* glux,
                                                const float* gp, const float* gP,
                                                const float* gPx, const float* gfm,
                                                size_t node, int tid) {
  const float* src[5] = {gluu + node * NU * NU, glux + node * NU * NX, gPx + node * NV * NX,
                         gP + node * NV * NV, gfm + node * NC};
  constexpr int kDst[5] = {CostSet::kLuu, CostSet::kLux, CostSet::kPx, CostSet::kP,
                           CostSet::kFm};
  constexpr int kCount[5] = {NU * NU, NU * NX, NV * NX, NV * NV, NC};
  if constexpr (kBulk) {
    if (tid == 0) {
      mbar_expect(bar, CostSet::kBulkBytes);
#pragma unroll
      for (int m = 0; m < 5; ++m) bulk_load(set + kDst[m], src[m], 4 * kCount[m], bar);
    }
  } else {
#pragma unroll
    for (int m = 0; m < 5; ++m)
      for (int e = tid; e < kCount[m]; e += kThreads)
        chol_warp::cp_async4(set + kDst[m] + e, src[m] + e);
  }
  if (tid < NX) {
    chol_warp::cp_async4(set + CostSet::kLx + tid, glx + node * NX + tid);
    chol_warp::cp_async4(set + CostSet::kLu + tid, glu + node * NU + tid);
    chol_warp::cp_async4(set + CostSet::kp + tid, gp + node * NU + tid);
  }
  chol_warp::cp_async_commit();
}

// Per node, with the TPU kernel's sums (pallas_lq.py:_project_cost_kernel):
//   phase 1, 104 4 x 6 tiles and lup:
//     Y = luu_v^T [Px_v | P] (30 x 48, 64 tiles): rows < 12 give lux_bar's
//       force rows (lux + Y) fm and luu_bar's off-diagonal blocks Y fm, each
//       written at (i, 12 + j) and (12 + j, i) (the TPU kernel's FVP and
//       PVF are one product and its transpose); rows >= 12 give T1 =
//       luu_vv^T Px_v, term_v = lux_v + T1 and PVVT = luu_vv^T P;
//     X = Px_v^T lux_v (30 x 30, 40 tiles); lup = lu + luu^T p;
//   phase 2, 80 tiles and the vectors:
//     lxx_bar = ((lxx + X) + X^T) + Px_v^T T1 (40 tiles);
//     lux_bar's joint rows P^T term_v (25 tiles);
//     luu_bar's joint block PVVT^T P + ((1 + shift) I - P) (15 tiles);
//     luu_bar's force block, lx_bar, lu_bar (48 threads);
//   then lxx_bar, luu_bar, lux_bar leave shared memory as three bulk stores.
// lxx is read once, into its own sum: it is copied straight into lxx_bar's
// buffer at the node's start and summed there in place.
// Every product is 18 deep. Tile rows and columns past an operand's end
// (the 4 x 6 grid's padding) read neighbouring shared memory and are never
// stored.
template <bool kBulk>
__global__ void __launch_bounds__(kThreads, kCostBlocks)
project_cost_kernel(const float* __restrict__ glx, const float* __restrict__ glu,
                    const float* __restrict__ glxx, const float* __restrict__ gluu,
                    const float* __restrict__ glux, const float* __restrict__ gp,
                    const float* __restrict__ gP, const float* __restrict__ gPx,
                    const float* __restrict__ gfm, float shift, float* __restrict__ olx,
                    float* __restrict__ olu, float* __restrict__ olxx,
                    float* __restrict__ oluu, float* __restrict__ olux, unsigned nodes,
                    long long* clocks) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  PHASE_CLOCKS_START
  float* const X = sm + CostShared::kX;
  float* const T1 = sm + CostShared::kT1;
  float* const TV = sm + CostShared::kTV;
  float* const PVVT = sm + CostShared::kPVVT;
  float* const lup = sm + CostShared::kLup;
  float* const o_lxx = sm + CostShared::kOut;
  float* const o_luu = o_lxx + NX * NX;
  float* const o_lux = o_luu + NU * NU;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(sm + CostShared::kBar);

  if (kBulk && tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    mbar_init(bars + 2);
  }
  __syncthreads();
  stage_cost_node<kBulk>(sm, bars, glx, glu, gluu, glux, gp, gP, gPx, gfm, blockIdx.x, tid);
  unsigned done = 0;
  for (unsigned n = blockIdx.x; n < nodes; n += gridDim.x, ++done) {
    const size_t node = n;
    const int s = (int)(done & 1);
    const float* const set = sm + s * CostSet::kFloats;
    const float* const luu = set + CostSet::kLuu;
    const float* const lux = set + CostSet::kLux;
    const float* const Px = set + CostSet::kPx;
    const float* const P = set + CostSet::kP;
    const float* const fm = set + CostSet::kFm;
    chol_warp::cp_async_wait<0>();  // this thread's 4-byte copies of this node
    if constexpr (kBulk) mbar_wait(bars + s, (done >> 1) & 1u);  // the bulk copies
    if (tid == 0) bulk_wait_read();  // the last node's outputs have left shared memory
    __syncthreads();                 // the other set and the outputs are free
    // this node's lxx, straight into lxx_bar's buffer (free once the last
    // node's stores have read it), arrives during phase 1
    if constexpr (kBulk) {
      if (tid == 0) {
        mbar_expect(bars + 2, NX * NX * 4);
        bulk_load(o_lxx, glxx + node * NX * NX, NX * NX * 4, bars + 2);
      }
    } else {
      for (int e = tid; e < NX * NX; e += kThreads)
        chol_warp::cp_async4(o_lxx + e, glxx + node * NX * NX + e);
      chol_warp::cp_async_commit();
    }
    if (n + gridDim.x < nodes)
      stage_cost_node<kBulk>(sm + (1 - s) * CostSet::kFloats, bars + 1 - s, glx, glu, gluu,
                             glux, gp, gP, gPx, gfm, node + gridDim.x, tid);
    PHASE(0);

    // --- phase 1: Y = luu_v^T [Px_v | P], X = Px_v^T lux_v, lup ----------------
    if (tid < 64) {
      const int ti = tid >> 3, tj = tid & 7;  // rows 4 ti.. of luu's columns; 6 tj.. of [Px_v | P]
      const bool onP = tj >= 5;
      const int c0 = onP ? 6 * (tj - 5) : 6 * tj;
      float acc[4][6];
      tile46<NV>(luu + NC * NU + 4 * ti, NU, onP ? P + c0 : Px + c0, onP ? NV : NX, acc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * ti + u;
        if (r >= NU) continue;
#pragma unroll
        for (int v = 0; v < 6; ++v) {
          const int c = c0 + v;
          if (!onP && r < NC) {
            o_lux[r * NX + c] = (lux[r * NX + c] + acc[u][v]) * fm[r];
          } else if (!onP) {
            T1[(r - NC) * NX + c] = acc[u][v];
            TV[(r - NC) * NX + c] = lux[r * NX + c] + acc[u][v];
          } else if (r < NC) {
            const float val = acc[u][v] * fm[r];
            o_luu[r * NU + NC + c] = val;
            o_luu[(NC + c) * NU + r] = val;
          } else {
            PVVT[(r - NC) * NV + c] = acc[u][v];
          }
        }
      }
    } else if (tid < 104) {
      const int t = tid - 64, ti = t / 5, tj = t - 5 * (t / 5);
      float acc[4][6];
      tile46<NV>(Px + 4 * ti, NX, lux + NC * NX + 6 * tj, NX, acc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * ti + u;
        if (r >= NX) continue;
#pragma unroll
        for (int v = 0; v < 6; ++v) X[r * NX + 6 * tj + v] = acc[u][v];
      }
    } else {
      const float* const p = set + CostSet::kp;
      for (int e = tid - 104; e < NU; e += kThreads - 104) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < NU; ++q) acc = fmaf(luu[q * NU + e], p[q], acc);
        lup[e] = set[CostSet::kLu + e] + acc;
      }
    }
    if constexpr (!kBulk) chol_warp::cp_async_wait<0>();  // lxx (and the next node's copies)
    __syncthreads(); PHASE(1);

    // --- phase 2: lxx_bar, lux_bar's joint rows, luu_bar, lx_bar, lu_bar -------
    if (tid < 40) {
      const int ti = tid / 5, tj = tid - 5 * (tid / 5);
      float acc[4][6];
      tile46<NV>(Px + 4 * ti, NX, T1 + 6 * tj, NX, acc);
      if constexpr (kBulk) mbar_wait(bars + 2, done & 1u);  // lxx
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * ti + u;
        if (r >= NX) continue;
#pragma unroll
        for (int v = 0; v < 6; ++v) {
          const int c = 6 * tj + v;
          o_lxx[r * NX + c] = ((o_lxx[r * NX + c] + X[r * NX + c]) + X[c * NX + r]) + acc[u][v];
        }
      }
    } else if (tid < 65) {
      const int t = tid - 40, ti = t / 5, tj = t - 5 * (t / 5);
      float acc[4][6];
      tile46<NV>(P + 4 * ti, NV, TV + 6 * tj, NX, acc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * ti + u;
        if (r >= NV) continue;
#pragma unroll
        for (int v = 0; v < 6; ++v) o_lux[(NC + r) * NX + 6 * tj + v] = acc[u][v];
      }
    } else if (tid < 80) {
      const int t = tid - 65, ti = t / 3, tj = t - 3 * (t / 3);
      float acc[4][6];
      tile46<NV>(PVVT + 4 * ti, NV, P + 6 * tj, NV, acc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * ti + u;
        if (r >= NV) continue;
#pragma unroll
        for (int v = 0; v < 6; ++v) {
          const int c = 6 * tj + v;
          o_luu[(NC + r) * NU + NC + c] =
              acc[u][v] + ((r == c ? 1.0f + shift : 0.0f) - P[r * NV + c]);
        }
      }
    } else {
      for (int e = tid - 80; e < NC * NC; e += kThreads - 80) {
        const int i = e / NC, j = e - i * NC;
        o_luu[i * NU + j] =
            luu[i * NU + j] * fm[i] * fm[j] + (i == j ? (1.0f - fm[i]) + shift : 0.0f);
      }
      const int e = tid - 80;
      if (e < NX) {
        const float* const p = set + CostSet::kp;
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int q = 0; q < NV; ++q) a = fmaf(Px[q * NX + e], lup[NC + q], a);
#pragma unroll
        for (int q = 0; q < NU; ++q) b = fmaf(lux[q * NX + e], p[q], b);
        olx[node * NX + e] = (set[CostSet::kLx + e] + a) + b;
        float v;
        if (e < NC) {
          v = fm[e] * lup[e];
        } else {
          v = 0.0f;
#pragma unroll
          for (int q = 0; q < NV; ++q) v = fmaf(P[q * NV + e - NC], lup[NC + q], v);
        }
        olu[node * NU + e] = v;
      }
    }
    fence_proxy_async();  // this thread's outputs, before the bulk stores read them
    __syncthreads(); PHASE(2);

    // --- lxx_bar, luu_bar, lux_bar to HBM: three bulk stores -------------------
    if (tid == 0) {
      bulk_store(olxx + node * NX * NX, o_lxx, NX * NX * 4);
      bulk_store(oluu + node * NU * NU, o_luu, NU * NU * 4);
      bulk_store(olux + node * NU * NX, o_lux, NU * NX * 4);
      bulk_commit();
    }
    PHASE(3);
  }
  if (tid == 0) bulk_wait_read();  // shared memory outlives the last stores' reads
  PHASE_CLOCKS_STORE(done)
}


// --- K3a ----------------------------------------------------------------------

// K3a's block shape: 128 threads, one node at a time, looping over the
// nodes in a grid of (SMs x kGeomBlocks) blocks; -DQM_LQ_GEOM_BLOCKS is a
// measuring build (lq_launch_shapes.py). The normal build's 5 blocks (96
// registers) are the widest that do not spill, with its sums unrolled 3
// steps; they beat 4 blocks by 18% (NVIDIA H100 80GB HBM3, 700 W), and 6
// blocks spill.
#ifndef QM_LQ_GEOM_BLOCKS
#define QM_LQ_GEOM_BLOCKS 5
#endif
constexpr int kGeomBlocks = QM_LQ_GEOM_BLOCKS;
constexpr int kGeomUnroll = 3;  // steps of tile26's sum, and of -Gv^T w's rows
constexpr int kNP = 16;  // the 12 x 12 Gram padded to chol_warp.cuh's NP = 16

// acc[u][v] = sum_{q < kDepth} A[u * lda + q] * Y[q * ldy + v] (u < 2, v < 6):
// a 2 x 6 register tile of A Y with A by rows, summed in q's order. Two
// steps of the sum read one float2 of each A row and three float2 of each Y
// row (8-byte aligned, kDepth even) for 24 FMAs.
template <int kDepth>
__device__ __forceinline__ void tile26(const float* A, int lda, const float* Y, int ldy,
                                       float (&acc)[2][6]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 6; ++v) acc[u][v] = 0.0f;
#pragma unroll kGeomUnroll
  for (int q = 0; q < kDepth; q += 2) {
    float a[2][2], y[2][6];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float2 t = *reinterpret_cast<const float2*>(A + u * lda + q);
      a[u][0] = t.x;
      a[u][1] = t.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        const float2 t = *reinterpret_cast<const float2*>(Y + (q + h) * ldy + 2 * w);
        y[h][2 * w] = t.x;
        y[h][2 * w + 1] = t.y;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 6; ++v) acc[u][v] = fmaf(a[u][h], y[h][v], acc[u][v]);
  }
}

// One node's inputs (a set; two sets, node after node), each as it lies in
// HBM, every buffer 16-byte aligned.
struct GeomSet {
  static constexpr int kA = 0, kB = kA + NX * NX, kGx = kB + NX * NU, kGv = kGx + NC * NX,
                       kg0 = kGv + NC * NV, kFb = kg0 + 16, kAct = kFb + 16, kFm = kAct + 16,
                       kd = kFm + 16, kFloats = kd + 32;
  // bytes of the bulk-copied inputs (A, B, Gx, Gv, g0, F_bar, act, fm)
  static constexpr unsigned kBulkBytes = (2 * NX * NX + NC * NX + NC * NV + 4 * NC) * 4;
};
// L's two copies first (float4 reads), then the two sets, then the buffers
// every node shares: the outputs staged for their bulk stores and p.
struct GeomShared {
  static constexpr int kLt = 0, kL = kNP * kNP, kSets = chol_warp::factor_floats<kNP>(),
                       kA = kSets + 2 * GeomSet::kFloats,  // A_bar, 30 x 30
      kB = kA + NX * NX,                                   // B_bar, 30 x 30
      kPx = kB + NX * NU,                                  // Px_v, 18 x 30
      kP = kPx + NV * NX,                                  // P, 18 x 18
      kp = kP + NV * NV,                                   // p, 30
      kBar = kp + 32, kFloats = kBar + 4;
};
constexpr size_t kGeomSmemBytes = GeomShared::kFloats * sizeof(float);

// Set off node `node`'s copies into `set`, as stage_cost_node: the 16-byte
// multiples (A, B, Gx, Gv and the 12-float g0, F_bar, act, fm) by bulk copy
// or 4-byte cp.async, d by 4-byte cp.async.
template <bool kBulk>
__device__ __forceinline__ void stage_geom_node(float* set, uint64_t* bar, const float* gA,
                                                const float* gB, const float* gd,
                                                const float* gg0, const float* gGx,
                                                const float* gGv, const float* gFb,
                                                const float* gact, const float* gfm,
                                                size_t node, int tid) {
  const float* src[8] = {gA + node * NX * NX, gB + node * NX * NU, gGx + node * NC * NX,
                         gGv + node * NC * NV, gg0 + node * NC, gFb + node * NC,
                         gact + node * NC, gfm + node * NC};
  constexpr int kDst[8] = {GeomSet::kA, GeomSet::kB, GeomSet::kGx, GeomSet::kGv,
                           GeomSet::kg0, GeomSet::kFb, GeomSet::kAct, GeomSet::kFm};
  constexpr int kCount[8] = {NX * NX, NX * NU, NC * NX, NC * NV, NC, NC, NC, NC};
  if constexpr (kBulk) {
    if (tid == 0) {
      mbar_expect(bar, GeomSet::kBulkBytes);
#pragma unroll
      for (int m = 0; m < 8; ++m) bulk_load(set + kDst[m], src[m], 4 * kCount[m], bar);
    }
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      for (int e = tid; e < kCount[m]; e += kThreads)
        chol_warp::cp_async4(set + kDst[m] + e, src[m] + e);
  }
  if (tid < NX) chol_warp::cp_async4(set + GeomSet::kd + tid, gd + node * NX + tid);
  chol_warp::cp_async_commit();
}

// Per node, with the TPU kernel's arithmetic (pallas_lq.py:_project_geom_kernel):
//   phase 1, on chol_warp.cuh's NP = 16 register-lean routines: warp 0's
//     lane i < 12 forms row i of M = Gv Gv^T + diag(1 - act) in registers
//     (its own Gv row held, the others read as broadcasts), factors it
//     (factor_lean: pivots rsqrt(max(., 1e-30))) and stores L; then the 49
//     columns of W = M^-1 [g0 | Gx | Gv], one a thread of warps 0 and 1
//     (warp 1 waits for L at a 64-thread named barrier), each solved in
//     registers (solve_lean) and turned into its output column: -Gv^T w
//     (p_v, Px_v) or e_j - Gv^T w (P), 12 deep;
//   warps 1-3 first: B_bar's force block B_F diag(fm), p's force part
//     -(1 - fm) F_bar;
//   phase 2, 120 2 x 6 tiles of B_v [Px_v | P] (30 x 48, 18 deep): A_bar =
//     A + B_v Px_v and B_bar's joint block B_v P; 8 threads d_bar = d + B p;
//   then A_bar, B_bar, P, Px_v leave shared memory as four bulk stores, p
//   and d_bar as plain stores.
template <bool kBulk>
__global__ void __launch_bounds__(kThreads, kGeomBlocks)
project_geom_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
                    const float* __restrict__ gd, const float* __restrict__ gg0,
                    const float* __restrict__ gGx, const float* __restrict__ gGv,
                    const float* __restrict__ gFb, const float* __restrict__ gact,
                    const float* __restrict__ gfm, float* __restrict__ oA,
                    float* __restrict__ oB, float* __restrict__ od, float* __restrict__ op,
                    float* __restrict__ oP, float* __restrict__ oPx, unsigned nodes,
                    long long* clocks) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  PHASE_CLOCKS_START
  float* const sLt = sm + GeomShared::kLt;
  float* const sL = sm + GeomShared::kL;
  float* const o_A = sm + GeomShared::kA;
  float* const o_B = sm + GeomShared::kB;
  float* const o_Px = sm + GeomShared::kPx;
  float* const o_P = sm + GeomShared::kP;
  float* const p = sm + GeomShared::kp;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(sm + GeomShared::kBar);
  float* const sets = sm + GeomShared::kSets;

  if (kBulk && tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  __syncthreads();
  stage_geom_node<kBulk>(sets, bars, gA, gB, gd, gg0, gGx, gGv, gFb, gact, gfm, blockIdx.x, tid);
  unsigned done = 0;
  for (unsigned n = blockIdx.x; n < nodes; n += gridDim.x, ++done) {
    const size_t node = n;
    const int s = (int)(done & 1);
    const float* const set = sets + s * GeomSet::kFloats;
    const float* const A = set + GeomSet::kA;
    const float* const B = set + GeomSet::kB;
    const float* const Gv = set + GeomSet::kGv;
    const float* const fm = set + GeomSet::kFm;
    chol_warp::cp_async_wait<0>();
    if constexpr (kBulk) mbar_wait(bars + s, (done >> 1) & 1u);
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    if (n + gridDim.x < nodes)
      stage_geom_node<kBulk>(sets + (1 - s) * GeomSet::kFloats, bars + 1 - s, gA, gB, gd, gg0,
                             gGx, gGv, gFb, gact, gfm, node + gridDim.x, tid);
    PHASE(0);

    // --- phase 1: the projector (warps 0, 1); B_bar's force block, p_F (1-3) --
    if (warp == 0) {
      float a[kNP];
      {
        const float* const act = set + GeomSet::kAct;
        const bool real = lane < NC;
        float g[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) g[q] = real ? Gv[lane * NV + q] : 0.0f;
#pragma unroll
        for (int j = 0; j < kNP; ++j) {
          float acc = 0.0f;
          if (j < NC) {
#pragma unroll
            for (int q = 0; q < NV; ++q) acc = fmaf(g[q], Gv[j * NV + q], acc);
          }
          float v = (real && j <= lane) ? acc : 0.0f;
          if (j == lane) v = real ? v + (1.0f - act[lane]) : 1.0f;
          a[j] = v;
        }
      }
      PHASE(1);
      float ivd = 0.0f;
      chol_warp::factor_lean<kNP>(a, ivd, lane);
      PHASE(2);
      chol_warp::store_factor_lean<kNP>(a, ivd, sLt, sL, lane);
      asm volatile("bar.arrive 1, 64;\n" ::: "memory");  // L is there for warp 1
      __syncwarp();
    } else {
      const float* const Fb = set + GeomSet::kFb;
      for (int e = tid - 32; e < NX * NC; e += kThreads - 32) {
        const int i = e / NC, j = e - i * NC;
        o_B[i * NU + j] = B[i * NU + j] * fm[j];
      }
      if (tid - 32 < NC) p[tid - 32] = -(1.0f - fm[tid - 32]) * Fb[tid - 32];
      if (warp == 1) asm volatile("bar.sync 1, 64;\n" ::: "memory");  // warp 0's L
    }
    if (warp < 2) {
      // lane c of warp w solves column k = 32 w + c of W = M^-1 [g0 | Gx | Gv]
      // and turns it into column k - 1 of Px_v (-Gv^T w), k - 31 of P
      // (e_j - Gv^T w) or, for k = 0, p_v (-Gv^T w)
      const int k = tid;
      if (k < NW) {
        const float* const g0 = set + GeomSet::kg0;
        const float* const Gx = set + GeomSet::kGx;
        float z[kNP];
#pragma unroll
        for (int r = 0; r < kNP; ++r) {
          float v = 0.0f;
          if (r < NC) v = k == 0 ? g0[r] : (k <= NX ? Gx[r * NX + k - 1] : Gv[r * NV + k - 1 - NX]);
          z[r] = v;
        }
        chol_warp::solve_lean<kNP>(z, sLt, sL);
        PHASE(3);
        float* const dst = k == 0 ? p + NC : (k <= NX ? o_Px + k - 1 : o_P + k - 1 - NX);
        const int stride = k == 0 ? 1 : (k <= NX ? NX : NV);
        const int diag = k > NX ? k - 1 - NX : -1;
#pragma unroll kGeomUnroll
        for (int i = 0; i < NV; i += 2) {
          float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
          for (int r = 0; r < NC; ++r) {
            const float2 gv = *reinterpret_cast<const float2*>(Gv + r * NV + i);
            acc0 = fmaf(gv.x, z[r], acc0);
            acc1 = fmaf(gv.y, z[r], acc1);
          }
          dst[i * stride] = (i == diag ? 1.0f : 0.0f) - acc0;
          dst[(i + 1) * stride] = (i + 1 == diag ? 1.0f : 0.0f) - acc1;
        }
        PHASE(4);
      }
    }
    __syncthreads();

    // --- phase 2: A_bar, B_bar's joint block, d_bar; the stores ---------------
    if (tid < 120) {
      const int ti = tid >> 3, tj = tid & 7;  // rows 2 ti..; 6 tj.. of [Px_v | P]
      const bool onP = tj >= 5;
      const int c0 = onP ? 6 * (tj - 5) : 6 * tj;
      float acc[2][6];
      tile26<NV>(B + 2 * ti * NU + NC, NU, onP ? o_P + c0 : o_Px + c0, onP ? NV : NX, acc);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 2 * ti + u;
#pragma unroll
        for (int v = 0; v < 6; ++v) {
          if (onP)
            o_B[r * NU + NC + c0 + v] = acc[u][v];
          else
            o_A[r * NX + c0 + v] = A[r * NX + c0 + v] + acc[u][v];
        }
      }
    } else {
      const float* const d = set + GeomSet::kd;
      for (int i = tid - 120; i < NX; i += kThreads - 120) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < NU; ++q) acc = fmaf(B[i * NU + q], p[q], acc);
        od[node * NX + i] = d[i] + acc;
        op[node * NU + i] = p[i];
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      bulk_store(oA + node * NX * NX, o_A, NX * NX * 4);
      bulk_store(oB + node * NX * NU, o_B, NX * NU * 4);
      bulk_store(oPx + node * NV * NX, o_Px, NV * NX * 4);
      bulk_store(oP + node * NV * NV, o_P, NV * NV * 4);
      bulk_commit();
    }
    PHASE(5);
  }
  if (tid == 0) bulk_wait_read();
  PHASE_CLOCKS_STORE(done)
}

// The grid of a kernel that loops over `nodes` > 0 nodes: one wave of
// `blocks_per_sm` blocks an SM on the current device, never more blocks
// than nodes. Returns 0 or the CUDA error of reading the SM count.
int node_loop_grid(long long nodes, int blocks_per_sm, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long slots = (long long)sms * blocks_per_sm;
  *grid = (int)(nodes < slots ? nodes : slots);
  return 0;
}

#endif  // QM_LQ_SCALAR_PRODUCTS

int launch_check(long long nodes) {
  return nodes < 0 || nodes > 0x7fffffffLL ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

using bulk_copy::aligned;

// K3a over `nodes` batch-major nodes: A, B (nodes, 30, 30), d (nodes, 30),
// g0 (nodes, 12), Gx (nodes, 12, 30), Gv (nodes, 12, 18), F_bar, act, fm
// (nodes, 12) -> A_bar, B_bar (nodes, 30, 30), d_bar, p (nodes, 30),
// P (nodes, 18, 18), Px_v (nodes, 18, 30). The grid is one block a node
// in the scalar-product build, else node_loop_grid's; `clocks` (7 int64,
// or NULL) is written by the phase-clock build only. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a launch it refuses.
extern "C" int qm_lq_project_geom_f32(const float* A, const float* B, const float* d,
                                      const float* g0, const float* Gx, const float* Gv,
                                      const float* F_bar, const float* act, const float* fm,
                                      float* A_bar, float* B_bar, float* d_bar, float* p,
                                      float* P, float* Px_v, long long nodes, void* stream,
                                      long long* clocks) {
  const int err = launch_check(nodes);
  if (err != 0 || nodes == 0) return err;
#ifdef QM_LQ_SCALAR_PRODUCTS
  project_geom_kernel<<<(unsigned)nodes, kThreads, 0, (cudaStream_t)stream>>>(
      A, B, d, g0, Gx, Gv, F_bar, act, fm, A_bar, B_bar, d_bar, p, P, Px_v, clocks);
#else
  if (!(aligned(A_bar, 16) && aligned(B_bar, 16) && aligned(P, 16) && aligned(Px_v, 16)))
    return (int)cudaErrorInvalidValue;
  const bool bulk = aligned(A, 16) && aligned(B, 16) && aligned(Gx, 16) && aligned(Gv, 16) &&
                    aligned(g0, 16) && aligned(F_bar, 16) && aligned(act, 16) &&
                    aligned(fm, 16);
  const void* fn = bulk ? (const void*)project_geom_kernel<true>
                        : (const void*)project_geom_kernel<false>;
  const cudaError_t attr =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGeomSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  int blocks = 0;
  const int grid_err = node_loop_grid(nodes, kGeomBlocks, &blocks);
  if (grid_err != 0) return grid_err;
  if (bulk)
    project_geom_kernel<true><<<blocks, kThreads, kGeomSmemBytes, (cudaStream_t)stream>>>(
        A, B, d, g0, Gx, Gv, F_bar, act, fm, A_bar, B_bar, d_bar, p, P, Px_v, (unsigned)nodes,
        clocks);
  else
    project_geom_kernel<false><<<blocks, kThreads, kGeomSmemBytes, (cudaStream_t)stream>>>(
        A, B, d, g0, Gx, Gv, F_bar, act, fm, A_bar, B_bar, d_bar, p, P, Px_v, (unsigned)nodes,
        clocks);
#endif
  return (int)cudaGetLastError();
}

// K3b over `nodes` batch-major nodes: lx, lu (nodes, 30), lxx, luu, lux
// (nodes, 30, 30), p (nodes, 30), P (nodes, 18, 18), Px_v (nodes, 18, 30),
// fm (nodes, 12) -> the projected lx, lu, lxx, luu (shift on the diagonal),
// lux; the grid and `clocks` as for K3a. The outputs' bases must be 16-byte
// aligned (the wrapper allocates them); the inputs may have any alignment.
extern "C" int qm_lq_project_cost_f32(const float* lx, const float* lu, const float* lxx,
                                      const float* luu, const float* lux, const float* p,
                                      const float* P, const float* Px_v, const float* fm,
                                      float shift, float* lx_bar, float* lu_bar,
                                      float* lxx_bar, float* luu_bar, float* lux_bar,
                                      long long nodes, void* stream, long long* clocks) {
  const int err = launch_check(nodes);
  if (err != 0 || nodes == 0) return err;
#ifdef QM_LQ_SCALAR_PRODUCTS
  project_cost_kernel<<<(unsigned)nodes, kThreads, 0, (cudaStream_t)stream>>>(
      lx, lu, lxx, luu, lux, p, P, Px_v, fm, shift, lx_bar, lu_bar, lxx_bar, luu_bar,
      lux_bar, clocks);
#else
  if (!(aligned(lxx_bar, 16) && aligned(luu_bar, 16) && aligned(lux_bar, 16)))
    return (int)cudaErrorInvalidValue;
  // bulk copies need 16-byte aligned inputs (every node's block of each is a
  // multiple of 16 bytes, so the base decides); else 4-byte cp.async
  const bool bulk = aligned(lxx, 16) && aligned(luu, 16) && aligned(lux, 16) &&
                    aligned(P, 16) && aligned(Px_v, 16) && aligned(fm, 16);
  const void* fn = bulk ? (const void*)project_cost_kernel<true>
                        : (const void*)project_cost_kernel<false>;
  const cudaError_t attr =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kCostSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  int blocks = 0;
  const int grid_err = node_loop_grid(nodes, kCostBlocks, &blocks);
  if (grid_err != 0) return grid_err;
  if (bulk)
    project_cost_kernel<true><<<blocks, kThreads, kCostSmemBytes, (cudaStream_t)stream>>>(
        lx, lu, lxx, luu, lux, p, P, Px_v, fm, shift, lx_bar, lu_bar, lxx_bar, luu_bar,
        lux_bar, (unsigned)nodes, clocks);
  else
    project_cost_kernel<false><<<blocks, kThreads, kCostSmemBytes, (cudaStream_t)stream>>>(
        lx, lu, lxx, luu, lux, p, P, Px_v, fm, shift, lx_bar, lu_bar, lxx_bar, luu_bar,
        lux_bar, (unsigned)nodes, clocks);
#endif
  return (int)cudaGetLastError();
}
