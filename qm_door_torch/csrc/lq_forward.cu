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
// (~8 kflop a node) are nothing. Each scenario is a serial chain of 67
// nodes, so the bound needs every scenario streaming at once, each with
// enough bytes in flight to cover HBM's latency: at 384 x 1 MB over 132 SMs,
// ~26 GB/s an SM.
//
// What the PR 2 kernel (one 960-thread block a scenario, a warp a row,
// each warp's next-node rows prefetched into registers) lost: its blocks
// fit 1 an SM, so the 384 scenarios ran in 3 waves; and only one node was
// in flight, so every node waited out most of a round trip to HBM (its
// wave table and phase clocks: PERF.md §6). It stays as the measuring
// build -DQM_FWD_ROW_WARPS.
//
// Design now: one scenario a block, as the chain requires, in 128-thread
// blocks, 3 an SM (__launch_bounds__(128, 3); 59 KB of shared memory
// each), so 396 scenarios are resident at once. Warp 3 is the producer: it
// keeps a ring of kStages node buffers in shared memory filled kStages - 1
// nodes ahead of the node being computed, each node's matrices (A, B, K,
// Px_v, P, fm: whole multiples of 16 bytes a node) as one bulk copy
// (cp.async.bulk) each on the stage's mbarrier; the 120-byte vectors (d,
// kff, p) are not 16-byte aligned on odd nodes and go as 4-byte cp.async,
// which arrive on the same mbarrier (cp.async.mbarrier.arrive). Inputs
// whose base is not 16-byte aligned take the 4-byte path for everything
// (the second template instantiation, chosen by the C entry point). Warps
// 0-2 compute, a row a thread, each row read from shared memory as float2
// (rows of 30 or 18 floats: conflict-free) against dx or u_red held in
// registers: phase 1, warp 0 u_red = kff + K dx (and the force part of du),
// warp 1 A dx + d, warp 2 p_v + Px_v dx, all from dx alone; phase 2 (after
// u_red), warp 1 dx_next = (A dx + d) + B u_red, warp 2 du_v = .. + P u_v.
// A row a thread has no shuffle reductions on the chain and leaves the
// chain two 15-step float2 sums deep a node. dx and u_red live in shared
// memory between phases; two 96-thread named barriers a node, then warp 0
// hands the stage back to the producer on the stage's second mbarrier. dX
// and dU rows leave as coalesced stores of the lanes that computed them.
// Every byte crosses HBM once. No batch padding, no lanes-last layout.
//
// Builds: -DQM_FWD_ROW_WARPS compiles the PR 2 kernel instead (a measuring
// build: chip_smoke.py (d) times the two in turns; nothing at run time
// chooses it); -DQM_FWD_PHASE_CLOCKS adds the phase clocks to either. A
// ring of 3 or 5 stages, or 4 blocks an SM, measured the same as 4 stages
// at 3 blocks (within 0.3%, PERF.md §6), so both stay fixed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "chol_warp.cuh"

// Diagnostic build (-DQM_FWD_PHASE_CLOCKS, chip_smoke.py phase (d)): block
// 0's thread 0 sums the clock64() cycles of the five phases of its nodes
// and writes the sums and the node count to `clocks` (6 int64). The normal
// build compiles PHASE to nothing.
#ifdef QM_FWD_PHASE_CLOCKS
#define PHASE(ph)                                \
  {                                              \
    const long long t_now = clock64();           \
    phase_cycles[ph] += t_now - phase_start;     \
    phase_start = t_now;                         \
  }
#define PHASE_CLOCKS_START                          \
  long long phase_cycles[5] = {0, 0, 0, 0, 0};      \
  long long phase_start = clock64();
#define PHASE_CLOCKS_STORE(nodes_done)                                     \
  if (clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {          \
    for (int q = 0; q < 5; ++q) clocks[q] = phase_cycles[q];               \
    clocks[5] = (nodes_done);                                              \
  }
#else
#define PHASE(ph)
#define PHASE_CLOCKS_START
#define PHASE_CLOCKS_STORE(nodes_done)
#endif

namespace {

constexpr int NX = 30;
constexpr int NU = 30;
constexpr int NV = 18;
constexpr int NC = 12;
constexpr int kWarp = 32;

#ifdef QM_FWD_ROW_WARPS  // the measuring build: the PR 2 kernel

// One block per scenario, one warp per output row (30 warps), lanes across
// the 30 columns: each warp reads its rows of K, A, B, P, Px_v as coalesced
// 120-byte runs and reduces with shuffles; dx and u_red live in shared
// memory (two barriers a node). Each warp loads the next node's rows into
// registers while it works on this one.
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

// The phase-clock build stores `v` to shared memory before a phase ends, so
// the phase's clock is read only once v (and the loads it depends on) is
// there; the normal build drops it.
#ifdef QM_FWD_PHASE_CLOCKS
#define PHASE_AFTER(ph, v)     \
  {                            \
    sink[l] = (v);             \
    PHASE(ph)                  \
  }
#else
#define PHASE_AFTER(ph, v)
#endif

__global__ void __launch_bounds__(kThreads)
forward_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
               const float* __restrict__ gd, const float* __restrict__ gK,
               const float* __restrict__ gkff, const float* __restrict__ gp,
               const float* __restrict__ gP, const float* __restrict__ gPx,
               const float* __restrict__ gfm, const float* __restrict__ gdx0,
               float* __restrict__ gdX, float* __restrict__ gdU, int N, long long* clocks) {
  __shared__ float dx[2][kWarp];
  __shared__ float u[kWarp];
#ifdef QM_FWD_PHASE_CLOCKS
  __shared__ volatile float sink[kWarp];
#endif
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
  PHASE_CLOCKS_START

  for (int k = 0; k < N; ++k) {
    const size_t node = (size_t)b * N + k;
    Row nxt = cur;
    if (k + 1 < N) nxt = load_row(gA, gB, gd, gK, gkff, gp, gP, gPx, gfm, node + 1, i, l);
    // phase 0: the wait for this node's rows (loaded during the last node)
    PHASE_AFTER(0, cur.K + cur.A + cur.B + cur.P + cur.Px + cur.kff + cur.p + cur.d + cur.fm)
    const float* x = dx[k & 1];
    const float xl = x[l];  // 0 past column 29
    const float ui = cur.kff + warp_sum(cur.K * xl);
    if (l == 0) u[i] = ui;
    PHASE(1)  // u
    __syncthreads();

    const float ul = u[l];
    float du;
    if (i < NC) {
      du = cur.p + cur.fm * ui;
    } else {
      const float a = warp_sum(l < NV ? cur.P * u[NC + l] : 0.0f);
      du = cur.p + a + warp_sum(cur.Px * xl);
    }
    PHASE_AFTER(2, du)  // du
    const float xn = warp_sum(cur.A * xl) + warp_sum(cur.B * ul) + cur.d;
    PHASE_AFTER(3, xn)  // dx_next
    if (l == 0) {
      gdX[((size_t)b * (N + 1) + k) * NX + i] = x[i];
      gdU[node * NU + i] = du;
      dx[(k + 1) & 1][i] = xn;
    }
    cur = nxt;
    __syncthreads();
    PHASE(4)  // stores
  }
  if (l == 0) gdX[((size_t)b * (N + 1) + N) * NX + i] = dx[N & 1][i];
  PHASE_CLOCKS_STORE(N)
}

constexpr size_t kSmemBytes = 0;
const void* kernel_for(bool) { return (const void*)forward_kernel; }

#else  // the normal build: a ring of bulk-copied nodes, 128-thread blocks

using namespace bulk_copy;

constexpr int kStages = 4;  // the ring: the node being computed and 3 in flight
constexpr int kBlocks = 3;  // blocks an SM: 396 scenarios resident at once
constexpr int kThreads = 128;
constexpr int kComputeThreads = 96;  // warps 0-2; warp 3 produces
constexpr int kProducer = 3;
constexpr int kRowBarrier = 1;       // the named barrier of warps 0-2

// One node's operands in shared memory, each as it lies in HBM (a stage),
// every buffer 16-byte aligned; the bulk-copied ones first.
struct Stage {
  static constexpr int kA = 0, kB = kA + NX * NX, kK = kB + NX * NU, kPx = kK + NU * NX,
                       kP = kPx + NV * NX, kFm = kP + NV * NV, kd = kFm + NC, kKff = kd + 32,
                       kp = kKff + 32, kFloats = kp + 32;
  static constexpr unsigned kBulkBytes = kd * 4;  // A, B, K, Px_v, P, fm
};
// After the ring: dx and u_red (32 floats each), then the mbarriers, a
// stage's "full" (its copies landed) and "free" (warps 0-2 are done with it).
struct Shared {
  static constexpr int kDx = kStages * Stage::kFloats, kU = kDx + 32, kBar = kU + 32,
                       kFloats = kBar + 4 * kStages;
};
constexpr size_t kSmemBytes = Shared::kFloats * sizeof(float);
// the full barrier's arrivals a phase: lane 0's (with the bulk bytes) and
// one from each producer lane's cp.async copies
constexpr unsigned kFullArrivals = kWarp + 1;

__device__ __forceinline__ void named_barrier() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kRowBarrier), "n"(kComputeThreads) : "memory");
}

// sum_j row[j] x[j] over kLen (even) entries, row read as float2 (8-byte
// aligned), in four interleaved partial sums.
template <int kLen>
__device__ __forceinline__ float dot(const float* row, const float (&x)[kLen]) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < kLen / 2; ++m) {
    const float2 r = *reinterpret_cast<const float2*>(row + 2 * m);
    acc[2 * (m & 1)] = fmaf(r.x, x[2 * m], acc[2 * (m & 1)]);
    acc[2 * (m & 1) + 1] = fmaf(r.y, x[2 * m + 1], acc[2 * (m & 1) + 1]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// x[0 .. kLen) from shared memory (8-byte aligned; the same address on every
// lane, a broadcast) into registers.
template <int kLen>
__device__ __forceinline__ void load_vec(const float* src, float (&x)[kLen]) {
#pragma unroll
  for (int m = 0; m < kLen / 2; ++m) {
    const float2 v = *reinterpret_cast<const float2*>(src + 2 * m);
    x[2 * m] = v.x;
    x[2 * m + 1] = v.y;
  }
}

// Warp 3: node n into stage n % kStages, once warps 0-2 have freed it, for
// every node of the scenario. kBulk: lane 0 expects the matrices' bytes on
// the stage's full barrier and issues one bulk copy each; otherwise the
// lanes copy them with 4-byte cp.async. The vectors always go by 4-byte
// cp.async (lanes 0-29), and every lane's copies arrive on the full barrier.
template <bool kBulk>
__device__ __forceinline__ void produce(float* ring, uint64_t* full, uint64_t* free_,
                                        const float* gA, const float* gB, const float* gd,
                                        const float* gK, const float* gkff, const float* gp,
                                        const float* gP, const float* gPx, const float* gfm,
                                        size_t node0, int N, int lane) {
  constexpr int kDst[6] = {Stage::kA, Stage::kB, Stage::kK, Stage::kPx, Stage::kP, Stage::kFm};
  constexpr int kCount[6] = {NX * NX, NX * NU, NU * NX, NV * NX, NV * NV, NC};
  for (int n = 0; n < N; ++n) {
    const int s = n % kStages;
    if (n >= kStages) mbar_wait(free_ + s, (unsigned)(n / kStages - 1) & 1u);
    float* const st = ring + s * Stage::kFloats;
    const size_t node = node0 + n;
    const float* src[6] = {gA + node * NX * NX, gB + node * NX * NU, gK + node * NU * NX,
                           gPx + node * NV * NX, gP + node * NV * NV, gfm + node * NC};
    if constexpr (kBulk) {
      if (lane == 0) {
        mbar_expect(full + s, Stage::kBulkBytes);
#pragma unroll
        for (int m = 0; m < 6; ++m) bulk_load(st + kDst[m], src[m], 4 * kCount[m], full + s);
      }
    } else {
#pragma unroll
      for (int m = 0; m < 6; ++m)
        for (int e = lane; e < kCount[m]; e += kWarp)
          chol_warp::cp_async4(st + kDst[m] + e, src[m] + e);
      if (lane == 0) mbar_arrive(full + s);
    }
    if (lane < NX) {
      chol_warp::cp_async4(st + Stage::kd + lane, gd + node * NX + lane);
      chol_warp::cp_async4(st + Stage::kKff + lane, gkff + node * NU + lane);
      chol_warp::cp_async4(st + Stage::kp + lane, gp + node * NU + lane);
    }
    cp_async_mbar_arrive(full + s);
  }
  chol_warp::cp_async_commit();
  chol_warp::cp_async_wait<0>();  // no copy outlives its issuing thread
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads, kBlocks)
forward_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
               const float* __restrict__ gd, const float* __restrict__ gK,
               const float* __restrict__ gkff, const float* __restrict__ gp,
               const float* __restrict__ gP, const float* __restrict__ gPx,
               const float* __restrict__ gfm, const float* __restrict__ gdx0,
               float* __restrict__ gdX, float* __restrict__ gdU, int N, long long* clocks) {
  extern __shared__ __align__(16) float sm[];
  float* const dx = sm + Shared::kDx;
  float* const u = sm + Shared::kU;
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + Shared::kBar);
  uint64_t* const free_ = full + kStages;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const size_t b = blockIdx.x;
  const size_t node0 = b * N;
  float* const dX = gdX + b * (size_t)(N + 1) * NX;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kFullArrivals);
      mbar_init(free_ + s, 1);
    }
  }
  if (tid < NX) {
    const float x0 = gdx0[b * NX + tid];
    dx[tid] = x0;
    dX[tid] = x0;
  }
  __syncthreads();
  if (warp == kProducer) {
    produce<kBulk>(sm, full, free_, gA, gB, gd, gK, gkff, gp, gP, gPx, gfm, node0, N, lane);
    return;
  }

  PHASE_CLOCKS_START
  for (int k = 0; k < N; ++k) {
    const int s = k % kStages;
    const float* const st = sm + s * Stage::kFloats;
    const size_t node = node0 + k;
    mbar_wait(full + s, (unsigned)(k / kStages) & 1u);
    PHASE(0)  // the wait for this node's operands
    float x[NX];
    load_vec(dx, x);
    // phase 1, from dx alone: u_red (warp 0), A dx + d (warp 1), p_v + Px_v dx (warp 2)
    float carry = 0.0f;
    if (warp == 0) {
      if (lane < NU) {
        const float ui = st[Stage::kKff + lane] + dot(st + Stage::kK + lane * NX, x);
        u[lane] = ui;
        if (lane < NC) gdU[node * NU + lane] = st[Stage::kp + lane] + st[Stage::kFm + lane] * ui;
      }
    } else if (warp == 1) {
      if (lane < NX) carry = st[Stage::kd + lane] + dot(st + Stage::kA + lane * NX, x);
    } else if (lane < NV) {
      carry = st[Stage::kp + NC + lane] + dot(st + Stage::kPx + lane * NX, x);
    }
    PHASE(1)  // u (thread 0's own rows)
    named_barrier();  // u_red is in; every read of dx is done
    PHASE(2)  // the rest of phase 1: A dx, Px_v dx
    // phase 2, from u_red: dx_next (warp 1), du_v (warp 2)
    if (warp == 1) {
      if (lane < NX) {
        float ur[NU];
        load_vec(u, ur);
        const float xn = carry + dot(st + Stage::kB + lane * NU, ur);
        dx[lane] = xn;
        dX[(size_t)(k + 1) * NX + lane] = xn;
      }
    } else if (warp == 2) {
      if (lane < NV) {
        float uv[NV];
        load_vec(u + NC, uv);
        gdU[node * NU + NC + lane] = carry + dot(st + Stage::kP + lane * NV, uv);
      }
    }
    named_barrier();  // dx_next is in; every read of u_red and of the stage is done
    PHASE(3)  // dx_next and du_v (warps 1, 2)
    if (tid == 0) mbar_arrive(free_ + s);
    PHASE(4)  // the stage handed back
  }
  PHASE_CLOCKS_STORE(N)
}

const void* kernel_for(bool bulk) {
  return bulk ? (const void*)forward_kernel<true> : (const void*)forward_kernel<false>;
}

#endif  // QM_FWD_ROW_WARPS

}  // namespace

// Batch-major: A (batch, N, 30, 30), B (batch, N, 30, 30), d (batch, N, 30),
// K (batch, N, 30, 30), kff and p (batch, N, 30), P (batch, N, 18, 18),
// Px_v (batch, N, 18, 30), fm (batch, N, 12), dx0 (batch, 30) -> dX (batch,
// N+1, 30), dU (batch, N, 30); one block a scenario. Bulk copies when A, B,
// K, P, Px_v and fm are 16-byte aligned, else 4-byte cp.async. `clocks` (6
// int64, or NULL) is written by the phase-clock build only. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a launch it refuses.
extern "C" int qm_lq_forward_f32(const float* A, const float* B, const float* d,
                                 const float* K, const float* kff, const float* p,
                                 const float* P, const float* Px_v, const float* fm,
                                 const float* dx0, float* dX, float* dU, int batch, int N,
                                 void* stream, long long* clocks) {
  if (batch < 0 || N < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
#ifdef QM_FWD_ROW_WARPS
  forward_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(A, B, d, K, kff, p, P, Px_v,
                                                               fm, dx0, dX, dU, N, clocks);
#else
  using bulk_copy::aligned;
  const bool bulk = aligned(A, 16) && aligned(B, 16) && aligned(K, 16) && aligned(P, 16) &&
                    aligned(Px_v, 16) && aligned(fm, 16);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel_for(bulk), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  if (bulk)
    forward_kernel<true><<<batch, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        A, B, d, K, kff, p, P, Px_v, fm, dx0, dX, dU, N, clocks);
  else
    forward_kernel<false><<<batch, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        A, B, d, K, kff, p, P, Px_v, fm, dx0, dX, dU, N, clocks);
#endif
  return (int)cudaGetLastError();
}

// The blocks an SM of this build's kernel (the bulk instantiation in the
// normal build), as cudaOccupancyMaxActiveBlocksPerMultiprocessor counts
// them on the current device for its block and shared memory. Returns 0 or
// the CUDA error.
extern "C" int qm_lq_forward_blocks_per_sm(int* blocks) {
  const void* fn = kernel_for(true);
  if (kSmemBytes > 0) {
    const cudaError_t attr = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, kSmemBytes);
}
