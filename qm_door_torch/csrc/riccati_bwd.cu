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
// Design: one block per scenario, 3 blocks an SM, so the 384 scenarios fit
// one wave. The carry S, s and every node's data live in shared memory for
// the whole sweep; nothing but K and kff goes back to HBM, once. Each node's
// data reaches shared memory coalesced; every product is a sum over the
// leading index (X^T Y), computed in 2 x 4 register tiles spread over
// the block's threads (shared-memory bandwidth is what the products are
// bound by), and the symmetric forms as 1/2 (M + M^T) of one product M,
// which keeps them exactly symmetric. K2 symmetrizes lxx, luu and lxx_f on
// the fly (reads (i,j) and (j,i)); K3c reads them as given.
//
// Three variants differ in the Cholesky and the solve of
// [K | kff] = -Quu^-1 [Qux | Qu] and in their block (one C entry point
// each; ops/riccati_fused.py:sweep_variant picks reg or reg2 by shape):
// - reg (nu <= 32, the solver's path), 128 threads (4 warps): one warp, on
//   chol_warp.cuh's register-lean routines. Lane i loads row i of Quu
//   (padded to 32 with identity rows) and the warp factors it with
//   shuffles, no barrier per pivot; it stores L by columns and by rows,
//   with 1 / L_ii on the diagonal; then lane c solves column c of the
//   nx + 1 right-hand sides in registers, reading L as warp-uniform float4
//   chunks. nx + 1 > 32 (nx up to 36) takes a second warp for columns 32..,
//   behind a 64-thread named barrier. L's two copies add 8.5 KB of shared
//   memory a block. Registers: the factor is what needs them; 128 threads
//   at 3 blocks an SM give 168 and no spills, where 256 or 224 threads (80
//   registers) and 192 (96) spill. The node's Layout is carved
//   anew from opaque dims at the node's start and after the solve (see
//   opaque()), so nothing derived from the dims rides over the factor in a
//   register. Node loads: two sets of node buffers (A, B, d, lx, lu, lxx,
//   luu, lux; lux and lx turn into Qux and Qx in place, so each set has its
//   own), node k in set k & 1. Once node k's data has landed, the whole
//   block sets off node k-1's copies (4-byte cp.async, coalesced, any
//   alignment) into the other set, and node k-1 waits for them at its
//   start: the loads leave the chain but for that wait. 67.8 KB of shared
//   memory a block at 30/30 (3 blocks an SM fit in 227 KB).
// - reg2 (32 < nu <= 36, the force-tracking width): reg's block, loads and
//   phases; the factoring warp holds rows 0..31 a row a lane and rows
//   32..35 by columns (lane j keeps their column j, every lane their 4 x 4
//   corner), padded to 36 = kMaxDim with identity rows (chol_warp.cuh's
//   load_rows_tail / factor_tail / store_factor_tail), and the column solve
//   runs all 36 steps as reg's runs 32 (solve_lean: straight-line code; the
//   identity rows keep z zero; solve_cols' branch a step, which skips the
//   steps past nu, held each step's loads behind it and took 14.4k cycles a
//   node against reg's 4.8k at 30/30). Registers: two rows a
//   lane (factor2, a0[32] + a1[36]) spilled 28 bytes at reg's 168; the tail
//   by columns holds 46 floats. Shared memory: reg's layout grown to 30/36
//   needs 87.5 KB, over the 76.8 KB that 3 blocks an SM leave a block;
//   padding to 36, not 48, shrinks L's two copies from 4,800 to 2,736
//   floats, and Quu (F) lies in L's buffer (F is dead once the factoring
//   warp holds its rows): 73.9 KB at 30/36, so the 384 scenarios stay one
//   wave.
// - smem (the first kernel, nu <= 36; reached only when forced, to be timed
//   beside reg2), 256 threads (8 warps, 80 registers): the block-parallel
//   Cholesky on the lower triangle
//   of Quu in shared memory (odd row stride; warps over rows, lanes over
//   columns of the trailing update), one __syncthreads per pivot, column k
//   scaled one step late; then two substitutions with each warp on every
//   8th column and its lanes on the rows (lane and lane + 32), each solved
//   entry passed on by a shuffle. Each node's data is loaded at its start.
// All multiply by 1 / L_ii instead of dividing. Generic nx <= 36; no batch
// padding, no lanes-last layout. f32 FMAs on the CUDA cores, no tensor
// cores: the chain needs true f32.

#include <cuda_runtime.h>

#include "chol_warp.cuh"

// The register variants' block shape (reg and reg2): threads a block and
// the blocks an SM they are compiled for, which set their registers a
// thread (ptxas: 168 at 128 x 3, 128 at 128 x 4, 96 at 192 x 3, 80 at 224
// or 256 x 3). 128 x 3 is the normal build: the widest shape whose factor
// does not spill. Other shapes are measuring builds of reg
// (sweep_launch_shapes.py at the repository root).
#ifndef QM_SWEEP_REG_THREADS
#define QM_SWEEP_REG_THREADS 128
#endif
#ifndef QM_SWEEP_REG_BLOCKS
#define QM_SWEEP_REG_BLOCKS 3
#endif

// The register variants' node loads: node k-1's data is copied with
// cp.async into a second buffer set while node k computes. The measuring
// build -DQM_SWEEP_SYNC_LOADS loads each node at its start instead, as the
// smem variant does (sweep_launch_shapes.py times the two on reg).
#ifdef QM_SWEEP_SYNC_LOADS
constexpr bool kRegAsyncLoads = false;
#else
constexpr bool kRegAsyncLoads = true;
#endif

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

enum Variant { kSmem = 0, kReg = 1, kReg2 = 2 };  // a template argument of the kernel

constexpr int kThreads = 256;  // smem variant's block
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxDim = 36;    // smem and reg2: rows live in lanes lane and lane + 32
constexpr int kRegMaxNu = 32;  // reg variant: Quu in one warp's registers, a row a lane
constexpr int kNP = 32;        // its padded size (rows nu..31 are identity)
constexpr int kNP2 = kMaxDim;  // reg2's padded size (rows nu..35 identity)
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

// The shared buffers of one block (smem_floats<V>() floats) for variant V:
// the register variants' L, twice (sLt by columns, sL by rows, 16-byte
// aligned; reg2's F lies in it); one set of node buffers, or two when the
// loads run a node ahead (`sets`, node k in set k & 1); then the buffers
// every node shares.
template <int V>
struct Layout {
  static constexpr int kPad = V == kReg2 ? kNP2 : kNP;  // L's padded size
  static constexpr int kFactor = V == kSmem ? 0 : chol_warp::factor_floats<kPad>();
  static constexpr bool kFInL = V == kReg2;  // F in L's buffer (dead once factored)

  int nx, nu, nxx, nxu, nuu;
  int ldf;  // F's odd row stride: lanes walking a column hit distinct banks
  int m;    // right-hand sides [Qux | Qu]
  float *sLt, *sL;  // reg, reg2: L by columns and by rows
  // node buffers, of the set `set`
  float *A, *Bm;    // nx x nx, nx x nu
  float *lxx;       // nx x nx
  float *luu;       // nu x nu
  float *Qux;       // nu x nx (lux, then Qux in place)
  float *d, *Qx;    // nx, nx (lx, then Qx in place)
  float *lu;        // nu
  // shared by every node
  float *S;         // nx x nx carry
  float *SA, *Qxx;  // nx x nx
  float *SB;        // nx x nu
  float *F;         // nu x ldf: Quu, then (smem) L in its lower triangle
  float *X;         // nu x m: [Qux | Qu], then the solution
  float *s, *Sd;    // nx carry, nx
  float *invd;      // smem: nu pivots' rsqrt
  float *rinv;      // smem: nu of 1 / L_ii

  __host__ __device__ static int set_floats(int nx, int nu) {
    return 2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu;
  }
  __host__ __device__ static int shared_floats(int nx, int nu) {
    return 3 * nx * nx + nx * nu + (kFInL ? 0 : nu * (nu | 1)) + nu * (nx + 1) + 2 * nx +
           2 * nu;
  }

  __device__ __forceinline__ Layout(float* sm, int nx_, int nu_, int sets, int set)
      : nx(nx_), nu(nu_), nxx(nx_ * nx_), nxu(nx_ * nu_), nuu(nu_ * nu_), ldf(nu_ | 1),
        m(nx_ + 1) {
    sLt = sm;
    sL = sLt + kPad * kPad;
    float* base = sm + kFactor;
    A = base + set * set_floats(nx, nu);
    Bm = A + nxx;
    lxx = Bm + nxu;
    luu = lxx + nxx;
    Qux = luu + nuu;
    d = Qux + nxu;
    Qx = d + nx;
    lu = Qx + nx;
    S = base + sets * set_floats(nx, nu);
    SA = S + nxx;
    Qxx = SA + nxx;
    SB = Qxx + nxx;
    F = kFInL ? sm : SB + nxu;
    X = kFInL ? SB + nxu : F + nu * ldf;
    s = X + nu * m;
    Sd = s + nx;
    invd = Sd + nx;
    rinv = invd + nu;
  }
};

template <int V>
__host__ __device__ inline int smem_floats(int nx, int nu, int sets) {
  return Layout<V>::kFactor + sets * Layout<V>::set_floats(nx, nu) +
         Layout<V>::shared_floats(nx, nu) + kSlack;
}

// The whole block copies node `node`'s data into the node buffers of `at`
// with 4-byte cp.async (coalesced; any alignment) and commits the group.
template <int kT, class L>
__device__ __forceinline__ void prefetch_node(const L& at, const float* gA, const float* gB,
                                              const float* gd, const float* glx,
                                              const float* glu, const float* glxx,
                                              const float* gluu, const float* glux,
                                              size_t node, int tid) {
  const auto copy = [tid](float* dst, const float* src, int count) {
    for (int i = tid; i < count; i += kT) chol_warp::cp_async4(dst + i, src + i);
  };
  copy(at.A, gA + node * at.nxx, at.nxx);
  copy(at.lxx, glxx + node * at.nxx, at.nxx);
  copy(at.Bm, gB + node * at.nxu, at.nxu);
  copy(at.Qux, glux + node * at.nxu, at.nxu);
  copy(at.luu, gluu + node * at.nuu, at.nuu);
  copy(at.d, gd + node * at.nx, at.nx);
  copy(at.Qx, glx + node * at.nx, at.nx);
  copy(at.lu, glu + node * at.nu, at.nu);
  chol_warp::cp_async_commit();
}

// v, which the compiler must treat as unknown in the register variants. Each node
// and its S update carve the Layout from opaque dims, so no pointer, stride
// or tile origin derived from them is hoisted out of the node loop and held
// in a register over the factor and solve, which need the registers.
template <bool kOpaque>
__device__ __forceinline__ int opaque(int v) {
  if constexpr (kOpaque) asm volatile("" : "+r"(v));
  return v;
}

// 3 blocks an SM: the 384 scenarios of the solver's path then run in one
// wave on 132 SMs. V selects the variant's Cholesky and solve (Variant).
template <bool kSym, int V>
__global__ void __launch_bounds__(V == kSmem ? kThreads : QM_SWEEP_REG_THREADS,
                                  V == kSmem ? 3 : QM_SWEEP_REG_BLOCKS)
riccati_bwd_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
                   const float* __restrict__ gd, const float* __restrict__ glx,
                   const float* __restrict__ glu, const float* __restrict__ glxx,
                   const float* __restrict__ gluu, const float* __restrict__ glux,
                   const float* __restrict__ glxx_f, const float* __restrict__ glx_f,
                   float* __restrict__ gK, float* __restrict__ gkff,
                   int N, int nx_in, int nu_in, float shift, long long* clocks) {
  constexpr bool kRegs = V != kSmem;  // either register variant
  constexpr int kT = kRegs ? QM_SWEEP_REG_THREADS : kThreads;
  constexpr bool kAsync = kRegs && kRegAsyncLoads;
  constexpr int kSets = kAsync ? 2 : 1;
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
#ifdef QM_SWEEP_PHASE_CLOCKS
  long long phase_cycles[6] = {0, 0, 0, 0, 0, 0};
  long long phase_start = clock64();
#endif

  {
    const Layout<V> lay(sm, nx_in, nu_in, kSets, (N - 1) & (kSets - 1));
    const float* Sf = glxx_f + (size_t)b * lay.nxx;
    for (int idx = tid; idx < lay.nxx; idx += kT) {
      const int i = idx / lay.nx, j = idx - i * lay.nx;
      lay.S[idx] = kSym ? 0.5f * (Sf[idx] + Sf[j * lay.nx + i]) : Sf[idx];
    }
    for (int i = tid; i < lay.nx; i += kT) lay.s[i] = glx_f[(size_t)b * lay.nx + i];
    if constexpr (kAsync)
      prefetch_node<kT>(lay, gA, gB, gd, glx, glu, glxx, gluu, glux, (size_t)b * N + N - 1, tid);
  }

  for (int k = N - 1; k >= 0; --k) {
    const size_t node = (size_t)b * N + k;
    const Layout<V> lay(sm, opaque<kRegs>(nx_in), opaque<kRegs>(nu_in), kSets, k & (kSets - 1));
    // --- the previous node's carry: S <- Qxx + 1/2 (M + M^T), M = Qux^T K in
    // S; and this node's data in shared memory: waited for, with the next
    // node's copies set off into the other set (reg, reg2), or loaded
    // coalesced (smem, and the register variants' -DQM_SWEEP_SYNC_LOADS) ---
    if (k < N - 1) {
      for (int idx = tid; idx < lay.nxx; idx += kT) {
        const int i = idx / lay.nx, j = idx - i * lay.nx;
        if (j > i) continue;
        const float h = 0.5f * (lay.S[idx] + lay.S[j * lay.nx + i]);
        lay.S[idx] = lay.Qxx[idx] + h;
        lay.S[j * lay.nx + i] = lay.Qxx[j * lay.nx + i] + h;
      }
    }
    if constexpr (kAsync) {
      chol_warp::cp_async_wait<0>();  // this thread's copies of node k
      __syncthreads();                 // everyone's; set (k - 1) & 1 is free
      if (k > 0) {
        const Layout<V> next(sm, lay.nx, lay.nu, kSets, (k - 1) & 1);
        prefetch_node<kT>(next, gA, gB, gd, glx, glu, glxx, gluu, glux, node - 1, tid);
      }
    } else {
      for (int idx = tid; idx < lay.nxx; idx += kT) {
        lay.A[idx] = gA[node * lay.nxx + idx];
        lay.lxx[idx] = glxx[node * lay.nxx + idx];
      }
      for (int idx = tid; idx < lay.nxu; idx += kT) {
        lay.Bm[idx] = gB[node * lay.nxu + idx];
        lay.Qux[idx] = glux[node * lay.nxu + idx];
      }
      for (int idx = tid; idx < lay.nuu; idx += kT) lay.luu[idx] = gluu[node * lay.nuu + idx];
      for (int i = tid; i < lay.nx; i += kT) {
        lay.d[i] = gd[node * lay.nx + i];
        lay.Qx[i] = glx[node * lay.nx + i];
      }
      for (int i = tid; i < lay.nu; i += kT) lay.lu[i] = glu[node * lay.nu + i];
      __syncthreads();
    }
    PHASE(0);

    // --- SA = S^T A, SB = S^T B (2 x 4 tiles), Sd = S^T d + s ----------------
    {
      const int tA = tiles(lay.nx, lay.nx), tB = tiles(lay.nx, lay.nu);
      for (int w = tid; w < tA + tB + lay.nx; w += kT) {
        if (w < tA + tB) {
          const bool a = w < tA;
          const int r = a ? lay.nx : lay.nu;
          int i0, j0;
          tile_origin(a ? w : w - tA, r, i0, j0);
          float acc[2][4];
          tile_tn(lay.S, lay.nx, a ? lay.A : lay.Bm, r, lay.nx, i0, j0, acc);
          float* out = a ? lay.SA : lay.SB;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (i0 + u < lay.nx && j0 + v < r) out[(i0 + u) * r + j0 + v] = acc[u][v];
        } else {
          const int i = w - tA - tB;
          float acc = 0.0f;
          for (int q = 0; q < lay.nx; ++q) acc = fmaf(lay.S[q * lay.nx + i], lay.d[q], acc);
          lay.Sd[i] = acc + lay.s[i];
        }
      }
    }
    __syncthreads(); PHASE(1);

    // --- A^T SA (into Qxx), B^T SB (into F, full), Qux = lux + B^T SA, Qx, Qu
    {
      const int tX = tiles(lay.nx, lay.nx), tU = tiles(lay.nu, lay.nu), tQ = tiles(lay.nu, lay.nx);
      for (int w = tid; w < tX + tU + tQ + lay.nx + lay.nu; w += kT) {
        if (w < tX + tU + tQ) {
          const int which = w < tX ? 0 : (w < tX + tU ? 1 : 2);
          const int v0 = which == 0 ? w : (which == 1 ? w - tX : w - tX - tU);
          const int p = which == 0 ? lay.nx : lay.nu, r = which == 1 ? lay.nu : lay.nx;
          int i0, j0;
          tile_origin(v0, r, i0, j0);
          float acc[2][4];
          if (which == 0) tile_tn(lay.A, lay.nx, lay.SA, lay.nx, lay.nx, i0, j0, acc);
          else if (which == 1) tile_tn(lay.Bm, lay.nu, lay.SB, lay.nu, lay.nx, i0, j0, acc);
          else tile_tn(lay.Bm, lay.nu, lay.SA, lay.nx, lay.nx, i0, j0, acc);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int i = i0 + u, j = j0 + v;
              if (i >= p || j >= r) continue;
              if (which == 0) {
                lay.Qxx[i * lay.nx + j] = acc[u][v];
              } else if (which == 1) {
                lay.F[i * lay.ldf + j] = acc[u][v];
              } else {
                const float q = lay.Qux[i * lay.nx + j] + acc[u][v];
                lay.Qux[i * lay.nx + j] = q;
                lay.X[i * lay.m + j] = q;
              }
            }
        } else if (w < tX + tU + tQ + lay.nx) {
          const int i = w - tX - tU - tQ;
          float acc = 0.0f;
          for (int q = 0; q < lay.nx; ++q) acc = fmaf(lay.A[q * lay.nx + i], lay.Sd[q], acc);
          lay.Qx[i] = lay.Qx[i] + acc;
        } else {
          const int i = w - tX - tU - tQ - lay.nx;
          float acc = 0.0f;
          for (int q = 0; q < lay.nx; ++q) acc = fmaf(lay.Bm[q * lay.nu + i], lay.Sd[q], acc);
          lay.X[i * lay.m + lay.nx] = lay.lu[i] + acc;
        }
      }
    }
    __syncthreads(); PHASE(2);

    // --- Qxx = lxx + 1/2 (M + M^T); Quu = luu + 1/2 (M + M^T) (+ shift I)
    // into F's lower triangle; K3c reads luu's upper triangle, as the TPU's
    // _chol_t reads rows ------------------------------------------------------
    for (int idx = tid; idx < lay.nxx + lay.nuu; idx += kT) {
      if (idx < lay.nxx) {
        const int i = idx / lay.nx, j = idx - i * lay.nx;
        if (j > i) continue;
        const float h = 0.5f * (lay.Qxx[idx] + lay.Qxx[j * lay.nx + i]);
        const float lij = kSym ? 0.5f * (lay.lxx[idx] + lay.lxx[j * lay.nx + i]) : lay.lxx[idx];
        const float lji = kSym ? lij : lay.lxx[j * lay.nx + i];
        lay.Qxx[idx] = lij + h;
        lay.Qxx[j * lay.nx + i] = lji + h;
      } else {
        const int r = idx - lay.nxx, i = r / lay.nu, j = r - i * lay.nu;
        if (j > i) continue;
        const float h = 0.5f * (lay.F[i * lay.ldf + j] + lay.F[j * lay.ldf + i]);
        const float l = kSym ? 0.5f * (lay.luu[i * lay.nu + j] + lay.luu[j * lay.nu + i])
                             : lay.luu[j * lay.nu + i];
        lay.F[i * lay.ldf + j] = l + h + (i == j ? shift : 0.0f);
      }
    }
    __syncthreads(); PHASE(2);

    if constexpr (kRegs) {
      // --- Cholesky and solve on chol_warp.cuh's register routines: warp 0
      // factors Quu (reg: lane i row i, padded to 32; reg2: lane i row i,
      // rows 32..35 by columns, padded to 36; identity rows past nu) and
      // stores L; then
      // lane c of warps 0 .. nsolve-1 solves column c of [Qux | Qu] (m <=
      // 32: warp 0 alone, no barrier; m > 32: warps 0 and 1 behind a
      // 64-thread named barrier). No barrier per pivot.
      constexpr int NP = Layout<V>::kPad;
      const int nsolve = (lay.m + kWarp - 1) / kWarp;
      if (warp < nsolve) {
        if (warp == 0) {
          if constexpr (V == kReg) {
            float a[kNP];
            float ivd = 1.0f;
            chol_warp::load_rows_ld<kNP>(a, lay.F, lay.nu, lay.ldf, lane);
            chol_warp::factor_lean<kNP>(a, ivd, lane);
            chol_warp::store_factor_lean<kNP>(a, ivd, lay.sLt, lay.sL, lane);
          } else {
            constexpr int T = kNP2 - kWarp;  // rows 32..35, held by columns
            float a[kWarp], t[T], c[T][T], ivc[T];
            float ivd = 1.0f;
            chol_warp::load_rows_tail<T>(a, t, c, lay.F, lay.nu, lay.ldf, lane);
            __syncwarp();  // F lies in L's buffer: every lane has read it before L is stored
            chol_warp::factor_tail<T>(a, t, c, ivd, ivc, lane);
            chol_warp::store_factor_tail<T>(a, t, c, ivd, ivc, lay.sLt, lay.sL, lane);
          }
          PHASE(3);
        }
        if (nsolve > 1)
          asm volatile("bar.sync 1, %0;" ::"n"(2 * kWarp) : "memory");
        else
          __syncwarp();
        const int c = warp * kWarp + lane;
        float z[NP];
#pragma unroll
        for (int r = 0; r < NP; ++r)
          z[r] = (c < lay.m && r < lay.nu) ? lay.X[r * lay.m + c] : 0.0f;
        chol_warp::solve_lean<NP>(z, lay.sLt, lay.sL);
        if (c < lay.m) {
#pragma unroll
          for (int r = 0; r < NP; ++r)
            if (r < lay.nu) lay.X[r * lay.m + c] = z[r];
        }
      }
      __syncthreads(); PHASE(4);
    } else {
      // --- Cholesky of F's lower triangle, one barrier per pivot ---------------
      // Step c: pivot rsqrt, trailing update of columns > c (warps over rows,
      // lanes over columns; every load of the step is issued before its
      // stores), and the scaling of column c-1, which step c does not read.
      for (int c = 0; c < lay.nu; ++c) {
        const float inv = rsqrtf(fmaxf(lay.F[c * lay.ldf + c], 1e-30f));
        if (tid == 0) lay.invd[c] = inv;
        if (c > 0 && tid <= lay.nu - c) lay.F[(c - 1 + tid) * lay.ldf + c - 1] *= lay.invd[c - 1];
        const int j0 = c + 1 + lane, j1 = j0 + kWarp;
        const float ljc0 = j0 < lay.nu ? lay.F[j0 * lay.ldf + c] * inv : 0.0f;
        const float ljc1 = j1 < lay.nu ? lay.F[j1 * lay.ldf + c] * inv : 0.0f;
        float lic[kRowsPerWarp], f0[kRowsPerWarp], f1[kRowsPerWarp];
#pragma unroll
        for (int t = 0; t < kRowsPerWarp; ++t) {
          const int i = c + 1 + warp + kWarps * t;
          lic[t] = i < lay.nu ? lay.F[i * lay.ldf + c] * inv : 0.0f;
          f0[t] = (i < lay.nu && j0 <= i) ? lay.F[i * lay.ldf + j0] : 0.0f;
          f1[t] = (i < lay.nu && j1 <= i) ? lay.F[i * lay.ldf + j1] : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < kRowsPerWarp; ++t) {
          const int i = c + 1 + warp + kWarps * t;
          if (i < lay.nu && j0 <= i) lay.F[i * lay.ldf + j0] = f0[t] - lic[t] * ljc0;
          if (i < lay.nu && j1 <= i) lay.F[i * lay.ldf + j1] = f1[t] - lic[t] * ljc1;
        }
        __syncthreads(); PHASE(3);
      }
      if (tid == 0) lay.F[(lay.nu - 1) * lay.ldf + lay.nu - 1] *= lay.invd[lay.nu - 1];
      __syncthreads(); PHASE(3);
      if (tid < lay.nu) lay.rinv[tid] = 1.0f / lay.F[tid * lay.ldf + tid];
      __syncthreads(); PHASE(3);

      // --- L L^T X = [Qux | Qu]: each warp takes every kWarps-th column, its
      // lanes the rows (lane and lane + 32); the pivot entry moves by shuffle
      {
        float y0[kColsPerWarp], y1[kColsPerWarp];
#pragma unroll
        for (int t = 0; t < kColsPerWarp; ++t) {
          const int c = warp + kWarps * t;
          y0[t] = (c < lay.m && lane < lay.nu) ? lay.X[lane * lay.m + c] : 0.0f;
          y1[t] = (c < lay.m && lane + kWarp < lay.nu) ? lay.X[(lane + kWarp) * lay.m + c] : 0.0f;
        }
        // the loads of step i + 1 are issued before step i's shuffles
        float ri = lay.rinv[0];
        float l0 = (lane > 0 && lane < lay.nu) ? lay.F[lane * lay.ldf] : 0.0f;
        float l1 = lane + kWarp < lay.nu ? lay.F[(lane + kWarp) * lay.ldf] : 0.0f;
        for (int i = 0; i < lay.nu; ++i) {  // L z = y: rows below i lose L[r][i] z_i
          const int n1 = i + 1;
          const float ri_n = n1 < lay.nu ? lay.rinv[n1] : 0.0f;
          const float l0_n =
              (n1 < lay.nu && lane > n1 && lane < lay.nu) ? lay.F[lane * lay.ldf + n1] : 0.0f;
          const float l1_n = (n1 < lay.nu && lane + kWarp > n1 && lane + kWarp < lay.nu)
                                 ? lay.F[(lane + kWarp) * lay.ldf + n1] : 0.0f;
#pragma unroll
          for (int t = 0; t < kColsPerWarp; ++t) {
            const float zi =
                __shfl_sync(0xffffffffu, i < kWarp ? y0[t] : y1[t], i & (kWarp - 1)) * ri;
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
        ri = lay.rinv[lay.nu - 1];
        l0 = lane < lay.nu - 1 ? lay.F[(lay.nu - 1) * lay.ldf + lane] : 0.0f;
        l1 = lane + kWarp < lay.nu - 1 ? lay.F[(lay.nu - 1) * lay.ldf + lane + kWarp] : 0.0f;
        for (int i = lay.nu - 1; i >= 0; --i) {  // L^T x = z: rows above i lose L[i][r] x_i
          const int n1 = i - 1;
          const float ri_n = n1 >= 0 ? lay.rinv[n1] : 0.0f;
          const float l0_n = lane < n1 ? lay.F[n1 * lay.ldf + lane] : 0.0f;
          const float l1_n = lane + kWarp < n1 ? lay.F[n1 * lay.ldf + lane + kWarp] : 0.0f;
#pragma unroll
          for (int t = 0; t < kColsPerWarp; ++t) {
            const float xi =
                __shfl_sync(0xffffffffu, i < kWarp ? y0[t] : y1[t], i & (kWarp - 1)) * ri;
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
          if (c < lay.m && lane < lay.nu) lay.X[lane * lay.m + c] = y0[t];
          if (c < lay.m && lane + kWarp < lay.nu) lay.X[(lane + kWarp) * lay.m + c] = y1[t];
        }
      }
      __syncthreads(); PHASE(4);
    }

    // --- K, kff out; M = Qux^T K into S (its symmetric part joins Qxx at the
    // next node's load), s <- Qx + Qux^T kff; on a layout carved anew (see
    // opaque) -----------------------------------------------------------------
    {
      const Layout<V> lay(sm, opaque<kRegs>(nx_in), opaque<kRegs>(nu_in), kSets,
                          k & (kSets - 1));
      for (int idx = tid; idx < lay.nxu; idx += kT) {
        const int i = idx / lay.nx, j = idx - i * lay.nx;
        gK[node * lay.nxu + idx] = -lay.X[i * lay.m + j];
      }
      for (int i = tid; i < lay.nu; i += kT) gkff[node * lay.nu + i] = -lay.X[i * lay.m + lay.nx];
      {
        const int tS = tiles(lay.nx, lay.nx);
        for (int w = tid; w < tS + lay.nx; w += kT) {
          if (w < tS) {
            int i0, j0;
            tile_origin(w, lay.nx, i0, j0);
            float acc[2][4];
            tile_tn(lay.Qux, lay.nx, lay.X, lay.m, lay.nu, i0, j0, acc);  // Qux^T X = -Qux^T K
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                if (i0 + u < lay.nx && j0 + v < lay.nx)
                  lay.S[(i0 + u) * lay.nx + j0 + v] = -acc[u][v];
          } else {
            const int i = w - tS;
            float acc = 0.0f;
            for (int q = 0; q < lay.nu; ++q)
              acc -= lay.Qux[q * lay.nx + i] * lay.X[q * lay.m + lay.nx];
            lay.s[i] = lay.Qx[i] + acc;
          }
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


// The nu range variant V takes: reg 1..32, reg2 33..36, smem 1..36.
constexpr int max_nu(int V) { return V == kReg ? kRegMaxNu : kMaxDim; }
constexpr int min_nu(int V) { return V == kReg2 ? kRegMaxNu + 1 : 1; }

// Variant V's kernel for (nx, nu, symmetrize) and its dynamic shared memory,
// with the kernel's shared-memory limit raised to it where it passes 48 KB.
// Returns 0, cudaErrorInvalidValue for a shape V does not take, or the CUDA
// error of the attribute call.
template <int V>
int prepare(int nx, int nu, int symmetrize, const void** fn, size_t* smem) {
  if (nx < 1 || nu < min_nu(V) || nx > kMaxDim || nu > max_nu(V))
    return (int)cudaErrorInvalidValue;
  const int sets = V != kSmem && kRegAsyncLoads ? 2 : 1;
  *smem = (size_t)smem_floats<V>(nx, nu, sets) * sizeof(float);
  *fn = symmetrize ? (const void*)riccati_bwd_kernel<true, V>
                   : (const void*)riccati_bwd_kernel<false, V>;
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
  return 0;
}

template <int V>
int launch(const float* A, const float* B, const float* d, const float* lx, const float* lu,
           const float* lxx, const float* luu, const float* lux, const float* lxx_f,
           const float* lx_f, float* K, float* kff, int batch, int N, int nx, int nu,
           float shift, int symmetrize, void* stream, long long* clocks) {
  if (batch < 0 || N < 1) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t smem = 0;
  const int err = prepare<V>(nx, nu, symmetrize, &fn, &smem);
  if (err != 0 || batch == 0) return err;
  constexpr int kT = V == kSmem ? kThreads : QM_SWEEP_REG_THREADS;
  if (symmetrize)
    riccati_bwd_kernel<true, V><<<batch, kT, smem, (cudaStream_t)stream>>>(
        A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, K, kff, N, nx, nu, shift, clocks);
  else
    riccati_bwd_kernel<false, V><<<batch, kT, smem, (cudaStream_t)stream>>>(
        A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, K, kff, N, nx, nu, shift, clocks);
  return (int)cudaGetLastError();
}

// The blocks an SM of variant V's kernel at (nx, nu), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor counts them on the current
// device for its block and shared memory.
template <int V>
int blocks_per_sm(int nx, int nu, int symmetrize, int* blocks) {
  const void* fn = nullptr;
  size_t smem = 0;
  const int err = prepare<V>(nx, nu, symmetrize, &fn, &smem);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, V == kSmem ? kThreads : QM_SWEEP_REG_THREADS, smem);
}

}  // namespace

// Batch-major inputs: A (batch, N, nx, nx), B (batch, N, nx, nu), d and lx
// (batch, N, nx), lu (batch, N, nu), lxx (batch, N, nx, nx), luu (batch, N,
// nu, nu), lux (batch, N, nu, nx), lxx_f (batch, nx, nx), lx_f (batch, nx);
// outputs K (batch, N, nu, nx), kff (batch, N, nu). symmetrize != 0 runs K2,
// 0 runs K3c. One entry point a variant, all nx <= 36: reg takes nu <= 32,
// reg2 32 < nu <= 36, smem nu <= 36 (ops/riccati_fused.py:sweep_variant
// picks reg or reg2 by shape). `clocks` (6 int64, or NULL) is written by
// the diagnostic build only. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// the variant does not take.
#define QM_SWEEP_ENTRY(name, V)                                                               \
  extern "C" int qm_riccati_bwd_##name##_f32(                                                 \
      const float* A, const float* B, const float* d, const float* lx, const float* lu,       \
      const float* lxx, const float* luu, const float* lux, const float* lxx_f,               \
      const float* lx_f, float* K, float* kff, int batch, int N, int nx, int nu, float shift, \
      int symmetrize, void* stream, long long* clocks) {                                      \
    return launch<V>(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, K, kff, batch, N, nx, nu,   \
                     shift, symmetrize, stream, clocks);                                      \
  }                                                                                           \
  /* the blocks an SM of the variant's kernel at (nx, nu) into *blocks; */                    \
  /* returns 0 or the CUDA error (cudaErrorInvalidValue: a shape it refuses) */               \
  extern "C" int qm_riccati_bwd_##name##_blocks_per_sm(int nx, int nu, int symmetrize,        \
                                                       int* blocks) {                         \
    return blocks_per_sm<V>(nx, nu, symmetrize, blocks);                                      \
  }

QM_SWEEP_ENTRY(reg, kReg)
QM_SWEEP_ENTRY(reg2, kReg2)
QM_SWEEP_ENTRY(smem, kSmem)
