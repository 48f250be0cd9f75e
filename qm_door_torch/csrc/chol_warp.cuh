// Warp-level building blocks for small SPD solves on Hopper (sm_90a): one
// warp factors one n x n system (n <= NP, NP in {16, 32}) in registers and
// solves it for up to 32 * CPL right-hand-side columns.
//
//   stage()          copy one system's A or Y into shared memory with cp.async
//                    (16-byte copies where the source allows, 4-byte at the
//                    ends or for strided data); the caller commits and waits.
//   load_rows()      lane i takes row i of A's lower triangle (+ shift on the
//                    diagonal) into NP registers; rows n..NP-1 are identity.
//   factor()         right-looking Cholesky in registers, fully unrolled over
//                    all NP pivots: at pivot k the lanes exchange column k by
//                    __shfl_sync, every lane computes rsqrt(max(a_kk, 1e-30))
//                    itself, and lane i updates its row. No barrier, no
//                    shared memory.
//   store_factor()   L to shared memory twice: by columns (sLt, for the
//                    forward sweep) and by rows (sL, for the back sweep).
//   solve()          L L^T x = z with the columns over lanes: lane c keeps
//                    column c (and c + 32) in registers; L reaches the lanes
//                    as warp-uniform float4 reads of sLt / sL, and each sweep
//                    is ~n^2/2 FMAs a column, right-looking, multiplying by
//                    1 / L_ii instead of dividing.
//
// Used by spd_solve.cu (K1). Pure f32 on the CUDA cores: the solver chain
// keeps true f32 (no tensor cores, no TF32).
//
// Register-lean forms, for a caller whose block shape caps its registers
// (riccati_bwd.cu's reg variant, K2/K3c: one warp of a 128-thread block
// factors and solves while the block's other phases share the budget;
// they hold the 32-float row or column and nothing else of NP floats):
//   load_rows_ld()       load_rows() with a row stride of its own (the
//                        sweep's odd stride) and no shift.
//   factor_lean()        factor()'s arithmetic, but each shuffled A_jk goes
//                        straight into its update (no s[NP]), and lane k
//                        keeps only its own pivot's 1 / L_kk (no ivd[NP]).
//   store_factor_lean()  store_factor(), then each lane's 1 / L_ii over the
//                        diagonal of sLt and sL (the solve reads no L_ii).
//   solve_lean()         solve() for one column a lane, reading L as
//                        float4 chunks inside each step (no col[NP] /
//                        row[NP]) and 1 / L_ii from the chunk that holds the
//                        diagonal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace chol_warp {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Floats a staging buffer of `count` elements takes: up to 3 floats of
// alignment offset in front, rounded up to 16 bytes.
__host__ __device__ constexpr int stage_floats(int count) { return (count + 3 + 3) & ~3; }

// The whole warp copies `count` floats, element e at src[e * elem], into
// `buf` (16-byte aligned, stage_floats(count) long). Returns the offset off
// (the same on every lane) at which element e lands: buf[off + e]. Packed
// data (elem == 1) goes as 16-byte copies, with the source's misalignment
// (off = its float index mod 4) kept in shared memory so both sides stay
// aligned, and 4-byte copies for the head and tail; nothing outside
// [src, src + count) is read. Strided data goes element by element.
__device__ __forceinline__ int stage(float* buf, const float* src, int count, long long elem,
                                     int lane) {
  if (elem != 1) {
    for (int e = lane; e < count; e += kWarp) cp_async4(buf + e, src + e * elem);
    return 0;
  }
  const int off = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min((4 - off) & 3, count);
  if (lane < head) cp_async4(buf + off + lane, src + lane);
  const int chunks = (count - head) >> 2;
  for (int q = lane; q < chunks; q += kWarp)
    cp_async16(buf + off + head + 4 * q, src + head + 4 * q);
  const int done = head + 4 * chunks;
  if (lane < count - done) cp_async4(buf + off + done + lane, src + done + lane);
  return off;
}

// Lane i (< n) takes row i of the staged A (row stride n, lower triangle
// only, + shift on the diagonal); lanes n..NP-1 take identity rows, and
// entries above the diagonal start at 0. Lanes >= NP hold zeros.
template <int NP>
__device__ __forceinline__ void load_rows(float (&a)[NP], const float* sA, int n, float shift,
                                          int lane) {
  const bool real = lane < n;
  const float* row = sA + lane * n;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float v = (real && j <= lane) ? row[j] : 0.0f;
    if (j == lane) v = real ? v + shift : 1.0f;
    a[j] = v;
  }
}

// In place: a[j] = L[i][j] for j <= i on lane i, ivd[k] = 1 / L[k][k] on
// every lane. Entries above the diagonal become scratch and are never read.
// Pivot k: s_j = A_jk from lane j (j >= k),  inv = rsqrt(max(s_k, 1e-30)),
//   L_ik = a_k * inv,  a_j -= L_ik * inv * s_j  (= L_ik L_jk) for j > k.
// The chain from pivot to pivot is one shuffle, the rsqrt, two multiplies
// and one FMA; the other shuffles and FMAs of the pivot issue beside it.
// All NP pivots run, the identity rows n..NP-1 too (they change nothing):
// straight-line code schedules across pivots, which measured faster than
// skipping the padding behind a branch per pivot, at both main-path shapes.
// Every loop has a constant trip count and a guard on the unrolled indices
// that the compiler folds (a bound that depends on an outer index keeps the
// inner loop rolled and puts the arrays in local memory).
template <int NP>
__device__ __forceinline__ void factor(float (&a)[NP], float (&ivd)[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float s[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (j >= k) s[j] = __shfl_sync(kFull, a[k], j);
    const float inv = rsqrtf(fmaxf(s[k], 1e-30f));
    const float l = a[k] * inv;
    const float l_inv = l * inv;
    ivd[k] = inv;
    a[k] = l;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (j > k) a[j] = fmaf(-l_inv, s[j], a[j]);
  }
}

// Row stride of sL: NP + 4 floats keeps the float4 stores of 8 lanes (one
// shared-memory wavefront) on distinct banks.
template <int NP>
__host__ __device__ constexpr int row_stride() { return NP + 4; }

template <int NP>
__host__ __device__ constexpr int factor_floats() { return NP * NP + NP * row_stride<NP>(); }

// sLt[j * NP + i] = L[i][j] (columns of L, contiguous) and
// sL[i * row_stride + j] = L[i][j] (rows). Both 16-byte aligned.
template <int NP>
__device__ __forceinline__ void store_factor(const float (&a)[NP], float* sLt, float* sL,
                                             int lane) {
  if (lane < NP) {
#pragma unroll
    for (int j = 0; j < NP; ++j) sLt[j * NP + lane] = a[j];
    float4* row = reinterpret_cast<float4*>(sL + lane * row_stride<NP>());
#pragma unroll
    for (int q = 0; q < NP / 4; ++q)
      row[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
}

// L L^T x = z in place for the CPL columns z[c] a lane holds (rows >= n are
// zero and stay zero: L is zero beside its identity rows). Forward,
// right-looking: z_i *= 1/L_ii, then z_r -= L_ri z_i for r > i (column i of
// L from sLt); back, right-looking: x_i = z_i / L_ii, then z_r -= L_ir x_i
// for r < i (row i of L from sL). Each step's reads of L do not depend on
// z, so they issue ahead; the chain is one multiply and one FMA a row.
template <int NP, int CPL>
__device__ __forceinline__ void solve(float (&z)[CPL][NP], const float* sLt, const float* sL,
                                      const float (&ivd)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float col[NP];
    const float4* src = reinterpret_cast<const float4*>(sLt + i * NP);
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {
      if (4 * q + 3 > i) {
        const float4 v = src[q];
        col[4 * q] = v.x; col[4 * q + 1] = v.y; col[4 * q + 2] = v.z; col[4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const float zi = z[c][i] * ivd[i];
      z[c][i] = zi;
#pragma unroll
      for (int r = 0; r < NP; ++r)
        if (r > i) z[c][r] = fmaf(-col[r], zi, z[c][r]);
    }
  }
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    float row[NP];
    const float4* src = reinterpret_cast<const float4*>(sL + i * row_stride<NP>());
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {
      if (4 * q < i) {
        const float4 v = src[q];
        row[4 * q] = v.x; row[4 * q + 1] = v.y; row[4 * q + 2] = v.z; row[4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const float xi = z[c][i] * ivd[i];
      z[c][i] = xi;
#pragma unroll
      for (int r = 0; r < NP; ++r)
        if (r < i) z[c][r] = fmaf(-row[r], xi, z[c][r]);
    }
  }
}

// --- register-lean forms (see the note at the top) ---------------------------

// Lane i (< n) takes row i of A's lower triangle from sA (row stride ld);
// lanes n..NP-1 take identity rows; entries above the diagonal start at 0.
template <int NP>
__device__ __forceinline__ void load_rows_ld(float (&a)[NP], const float* sA, int n, int ld,
                                             int lane) {
  const bool real = lane < n;
  const float* row = sA + lane * ld;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float v = (real && j <= lane) ? row[j] : 0.0f;
    if (j == lane && !real) v = 1.0f;
    a[j] = v;
  }
}

// factor()'s pivots, in the same order and rounding: a[j] = L[i][j] for
// j <= i on lane i, and `ivd` = 1 / L[i][i] on lane i.
template <int NP>
__device__ __forceinline__ void factor_lean(float (&a)[NP], float& ivd, int lane) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const float inv = rsqrtf(fmaxf(__shfl_sync(kFull, a[k], k), 1e-30f));
    const float l = a[k] * inv;
    const float l_inv = l * inv;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (j > k) a[j] = fmaf(-l_inv, __shfl_sync(kFull, a[k], j), a[j]);
    a[k] = l;
    if (lane == k) ivd = inv;
  }
}

// store_factor(), with 1 / L_ii in place of L_ii on both diagonals.
template <int NP>
__device__ __forceinline__ void store_factor_lean(const float (&a)[NP], float ivd, float* sLt,
                                                  float* sL, int lane) {
  store_factor<NP>(a, sLt, sL, lane);
  if (lane < NP) {
    sLt[lane * NP + lane] = ivd;
    sL[lane * row_stride<NP>() + lane] = ivd;
  }
}

// solve() for the one column z a lane holds, on store_factor_lean()'s
// layout: step i reads the float4 chunks of column (row) i of L that hold
// the diagonal and the rows below (above) it, one chunk at a time.
template <int NP>
__device__ __forceinline__ void solve_lean(float (&z)[NP], const float* sLt, const float* sL) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {  // forward: z_i *= 1/L_ii, z_r -= L_ri z_i (r > i)
    const float4* col = reinterpret_cast<const float4*>(sLt + i * NP);
    float zi = 0.0f;
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {
      if (4 * q + 3 >= i) {
        const float4 v = col[q];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * q + e;
          if (r == i) {
            zi = z[i] * w[e];
            z[i] = zi;
          } else if (r > i) {
            z[r] = fmaf(-w[e], zi, z[r]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {  // back: x_i = z_i / L_ii, z_r -= L_ir x_i (r < i)
    const float4* row = reinterpret_cast<const float4*>(sL + i * row_stride<NP>());
    float xi = 0.0f;
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {  // the chunk with the diagonal first
      if (q == i / 4) {
        const float4 v = row[q];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e == i) {
            xi = z[i] * w[e];
            z[i] = xi;
          }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < i) z[4 * q + e] = fmaf(-w[e], xi, z[4 * q + e]);
      }
    }
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {
      if (4 * q + 3 < i) {
        const float4 v = row[q];
        z[4 * q] = fmaf(-v.x, xi, z[4 * q]);
        z[4 * q + 1] = fmaf(-v.y, xi, z[4 * q + 1]);
        z[4 * q + 2] = fmaf(-v.z, xi, z[4 * q + 2]);
        z[4 * q + 3] = fmaf(-v.w, xi, z[4 * q + 3]);
      }
    }
  }
}

}  // namespace chol_warp
