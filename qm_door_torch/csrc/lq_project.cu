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
// Design: one block of 128 threads per node (K1's projection pattern with
// the substitution products fused in), 12.6 KB (K3a) / 19.8 KB (K3b) of
// shared memory, so a dozen blocks share an SM and keep its loads in
// flight. The operands that are read many times (B, Gv, W, P, Px_v, luu,
// lux, ...) are staged in shared memory with coalesced loads; those read
// once (A, d, lx, lxx) stream from HBM straight into the output sums. Each
// product is one output entry per thread, consecutive threads on
// consecutive columns. The 12 x 12 Cholesky runs in one warp (lanes across
// rows, the same rsqrt(max(., 1e-30)) pivots), the 49 substitutions one
// thread per right-hand side. Outputs are written once, coalesced. No batch
// padding, no lanes-last layout, no transposed copies of B or Gv: the
// kernel reads B and Gv as they are.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int NX = 30;
constexpr int NU = 30;
constexpr int NV = 18;
constexpr int NC = 12;
constexpr int NW = 1 + NX + NV;  // right-hand sides [g0 | Gx | Gv]
constexpr int LDM = NC | 1;      // odd row stride of M

__global__ void __launch_bounds__(kThreads)
project_geom_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
                    const float* __restrict__ gd, const float* __restrict__ gg0,
                    const float* __restrict__ gGx, const float* __restrict__ gGv,
                    const float* __restrict__ gFb, const float* __restrict__ gact,
                    const float* __restrict__ gfm, float* __restrict__ oA,
                    float* __restrict__ oB, float* __restrict__ od, float* __restrict__ op,
                    float* __restrict__ oP, float* __restrict__ oPx) {
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
  __syncthreads();

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
  __syncthreads();

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
  __syncthreads();

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
  __syncthreads();

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
  __syncthreads();

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
}

__global__ void __launch_bounds__(kThreads)
project_cost_kernel(const float* __restrict__ glx, const float* __restrict__ glu,
                    const float* __restrict__ glxx, const float* __restrict__ gluu,
                    const float* __restrict__ glux, const float* __restrict__ gp,
                    const float* __restrict__ gP, const float* __restrict__ gPx,
                    const float* __restrict__ gfm, float shift, float* __restrict__ olx,
                    float* __restrict__ olu, float* __restrict__ olxx,
                    float* __restrict__ oluu, float* __restrict__ olux) {
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

  for (int idx = tid; idx < NU * NU; idx += kThreads) luu[idx] = gluu[node * NU * NU + idx];
  for (int idx = tid; idx < NU * NX; idx += kThreads) lux[idx] = glux[node * NU * NX + idx];
  for (int idx = tid; idx < NV * NV; idx += kThreads) P[idx] = gP[node * NV * NV + idx];
  for (int idx = tid; idx < NV * NX; idx += kThreads) Px[idx] = gPx[node * NV * NX + idx];
  if (tid < NU) p[tid] = gp[node * NU + tid];
  if (tid < NC) fm[tid] = gfm[node * NC + tid];
  __syncthreads();

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
  __syncthreads();

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
}

int launch_check(long long nodes) {
  if (nodes < 0 || nodes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// K3a over `nodes` batch-major nodes: A, B (nodes, 30, 30), d (nodes, 30),
// g0 (nodes, 12), Gx (nodes, 12, 30), Gv (nodes, 12, 18), F_bar, act, fm
// (nodes, 12) -> A_bar, B_bar (nodes, 30, 30), d_bar, p (nodes, 30),
// P (nodes, 18, 18), Px_v (nodes, 18, 30). Returns cudaGetLastError().
extern "C" int qm_lq_project_geom_f32(const float* A, const float* B, const float* d,
                                      const float* g0, const float* Gx, const float* Gv,
                                      const float* F_bar, const float* act, const float* fm,
                                      float* A_bar, float* B_bar, float* d_bar, float* p,
                                      float* P, float* Px_v, long long nodes, void* stream) {
  const int err = launch_check(nodes);
  if (err != 0 || nodes == 0) return err;
  project_geom_kernel<<<(unsigned)nodes, kThreads, 0, (cudaStream_t)stream>>>(
      A, B, d, g0, Gx, Gv, F_bar, act, fm, A_bar, B_bar, d_bar, p, P, Px_v);
  return (int)cudaGetLastError();
}

// K3b over `nodes` batch-major nodes: lx, lu (nodes, 30), lxx, luu, lux
// (nodes, 30, 30), p (nodes, 30), P (nodes, 18, 18), Px_v (nodes, 18, 30),
// fm (nodes, 12) -> the projected lx, lu, lxx, luu (shift on the diagonal),
// lux. Returns cudaGetLastError().
extern "C" int qm_lq_project_cost_f32(const float* lx, const float* lu, const float* lxx,
                                      const float* luu, const float* lux, const float* p,
                                      const float* P, const float* Px_v, const float* fm,
                                      float shift, float* lx_bar, float* lu_bar,
                                      float* lxx_bar, float* luu_bar, float* lux_bar,
                                      long long nodes, void* stream) {
  const int err = launch_check(nodes);
  if (err != 0 || nodes == 0) return err;
  project_cost_kernel<<<(unsigned)nodes, kThreads, 0, (cudaStream_t)stream>>>(
      lx, lu, lxx, luu, lux, p, P, Px_v, fm, shift, lx_bar, lu_bar, lxx_bar, luu_bar,
      lux_bar);
  return (int)cudaGetLastError();
}
