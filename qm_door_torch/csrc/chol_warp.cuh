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
//   factor_lean_ref()    factor_lean() with the reference's rounding of the
//                        update, A_ij -= L_ik L_jk (spd_solve.cu's blk128
//                        factors its diagonal blocks with it).
//
// Two rows a lane, for 32 < n <= NP with NP in {48, 64} (spd_solve.cu's
// reg64 variant): lane i holds row i in a0[32] (a row below 32 has no
// entries past column 31) and row i + 32 in a1[NP].
//   load_rows2()         load_rows() for both rows.
//   factor2()            factor_lean()'s pivots over the two rows: column k
//                        comes by shuffles from the lanes that hold rows
//                        j >= k, each value straight into both rows' updates.
//                        Each lane ends with 1 / L_ii of its two rows, the
//                        reciprocal of the factor's diagonal (so a clamped
//                        pivot solves as the reference's division does).
//   store_rows2()        L by rows, odd row stride (the m = 1 back sweep).
//   solve_rows2()        L L^T x = y for one right-hand side held by rows:
//                        step i forms x_i on row i's lane, broadcasts it by
//                        one shuffle, and every lane updates its two rows
//                        (forward from a0 / a1 in registers, back from the
//                        rows in shared memory): 2n steps of one shuffle and
//                        two FMAs.
//   store_factor2_lean() store_factor_lean() for the two rows.
//   solve_cols()         solve_lean() at NP = 48 / 64, steps past n
//                        skipped (one column a lane: two put z[2][64] in
//                        local memory).
//
// A tail of T <= 4 rows, for 32 < n <= 32 + T (riccati_bwd.cu's reg2
// variant, NP = 36): lane i holds row i of the leading 32 in a[32], as
// load_rows_ld(); rows 32.. are held by columns, lane j keeping t[r] =
// A[32 + r][j], and the T x T corner A[32 + r][32 + s] (s <= r) sits on
// every lane alike. factor2() at NP = 36 holds a1[36] on every lane for 4
// rows of use and spilled at the sweep's 168 registers; this holds 32 + T +
// T(T + 1)/2 floats.
//   load_rows_tail()     the three parts from rows of stride ld (identity
//                        rows from n on).
//   factor_tail()        factor_lean_ref()'s 32 pivots, each also sending
//                        the tail's column k (T shuffles from lane k) to
//                        every lane, which updates its column of the tail
//                        and the corner; then the corner's T pivots on
//                        every lane, no shuffle. 1 / L_ii as rsqrt, as
//                        factor_lean().
//   store_factor_tail()  store_factor_lean()'s layout at NP = 32 + T, which
//                        solve_lean<NP>() reads (identity rows past n).
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

// factor_lean()'s pivots and outputs, with the update rounded as the
// reference forms it: A_ij -= L_ik L_jk, where lane j forms L_jk = A_jk inv
// and the lanes exchange L_jk (the value factor2() forms on every lane).
// factor_lean()'s A_ij -= (L_ik inv) A_jk rounds otherwise, and on reg64
// that form moved the card's f32 WBC tick far from the f64 tick at level 2
// (PERF.md, section 7).
template <int NP>
__device__ __forceinline__ void factor_lean_ref(float (&a)[NP], float& ivd, int lane) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const float inv = rsqrtf(fmaxf(__shfl_sync(kFull, a[k], k), 1e-30f));
    const float l = a[k] * inv;  // L_ik on lane i
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (j > k) a[j] = fmaf(-l, __shfl_sync(kFull, l, j), a[j]);
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

// --- two rows a lane (see the note at the top) -------------------------------

// static_for<N>(f) calls f(Int<0>{}), ..., f(Int<N - 1>{}) as straight-line
// code. The two-row routines below generate their pivots and substitution
// steps this way: at NP = 48 / 64 a fully unrolled nest of them passes the
// compiler's unrolling threshold, stays a loop, and indexes the register
// arrays at run time (local memory).
template <int K>
struct Int {
  static constexpr int value = K;
};

template <int N, int K = 0, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (K < N) {
    f(Int<K>{});
    static_for<N, K + 1>(f);
  }
}

// Lane i takes rows i (a0) and i + 32 (a1) of the staged A (row stride n,
// lower triangle only, + shift on the diagonal). Rows n..NP-1 are identity
// rows, rows past NP (a1 on lanes >= NP - 32) zeros; entries above the
// diagonal start at 0.
template <int NP>
__device__ __forceinline__ void load_rows2(float (&a0)[kWarp], float (&a1)[NP], const float* sA,
                                           int n, float shift, int lane) {
  const int r1 = lane + kWarp;
#pragma unroll
  for (int j = 0; j < kWarp; ++j) {
    float v = (lane < n && j <= lane) ? sA[lane * n + j] : 0.0f;
    if (j == lane) v = lane < n ? v + shift : 1.0f;
    a0[j] = v;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float v = (r1 < n && j <= r1) ? sA[r1 * n + j] : 0.0f;
    if (j == r1) v = r1 < n ? v + shift : 1.0f;
    a1[j] = v;
  }
}

// 1 / x to within about half an ulp: the hardware's approximate reciprocal
// and one Newton step (no call to the IEEE division's slow path, which
// would save every live register around it). 0 -> inf, inf -> 0.
__device__ __forceinline__ float recip(float x) {
  const float r = __fdividef(1.0f, x);
  return r + r == r ? r : fmaf(r, fmaf(-x, r, 1.0f), r);
}

// In place: a0[j] = L[i][j] (j <= i) and a1[j] = L[i + 32][j] (j <= i + 32)
// on lane i; ivd0 / ivd1 = 1 / L of the two rows' diagonals (1 on rows past
// NP). Pivot k as the reference forms it: inv = rsqrt(max(A_kk, 1e-30)),
// L_ik = A_ik inv, A_ij -= L_ik L_jk with L_jk = A_jk inv formed from the
// shuffled A_jk on every lane (off the pivot-to-pivot chain).
template <int NP>
__device__ __forceinline__ void factor2(float (&a0)[kWarp], float (&a1)[NP], float& ivd0,
                                        float& ivd1, int lane) {
  float d0 = 1.0f, d1 = 1.0f;  // the two rows' L_ii, caught as their pivots pass
  static_for<NP>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    constexpr int k0 = k < kWarp ? k : 0;
    const float c0 = k < kWarp ? a0[k0] : 0.0f;  // A_ik of row i
    const float c1 = a1[k];                      // A_ik of row i + 32
    const float inv =
        rsqrtf(fmaxf(__shfl_sync(kFull, k < kWarp ? c0 : c1, k % kWarp), 1e-30f));
    const float l0 = c0 * inv, l1 = c1 * inv;
#pragma unroll
    for (int j = k + 1; j < NP; ++j) {
      const float ljk = __shfl_sync(kFull, j < kWarp ? c0 : c1, j % kWarp) * inv;  // L_jk
      if (j < kWarp) a0[j < kWarp ? j : 0] = fmaf(-l0, ljk, a0[j < kWarp ? j : 0]);
      a1[j] = fmaf(-l1, ljk, a1[j]);
    }
    if (k < kWarp) {
      a0[k0] = l0;
      d0 = lane == k ? l0 : d0;
    }
    a1[k] = l1;
    d1 = lane + kWarp == k ? l1 : d1;
  });
  ivd0 = recip(d0);
  ivd1 = recip(d1);
}

// Row stride of store_rows2's layout: odd, so the lanes' row stores fall on
// distinct banks.
template <int NP>
__host__ __device__ constexpr int rows2_stride() { return NP + 1; }

template <int NP>
__host__ __device__ constexpr int rows2_floats() { return NP * rows2_stride<NP>(); }

// sL[i * (NP + 1) + j] = L[i][j] for the rows a lane holds (row i < 32 up to
// column 31; entries above the diagonal are scratch and never used).
template <int NP>
__device__ __forceinline__ void store_rows2(const float (&a0)[kWarp], const float (&a1)[NP],
                                            float* sL, int lane) {
  constexpr int ld = rows2_stride<NP>();
#pragma unroll
  for (int j = 0; j < kWarp; ++j) sL[lane * ld + j] = a0[j];
  if (lane + kWarp < NP) {
#pragma unroll
    for (int j = 0; j < NP; ++j) sL[(lane + kWarp) * ld + j] = a1[j];
  }
}

// L L^T x = y for one right-hand side held by rows: y0 is row `lane`, y1 row
// lane + 32 (zero past n). Forward: at step i the lane of row i forms
// z_i = y_i / L_ii and broadcasts it; every lane takes L_ri z_i off its rows
// r > i (L_ri from a0 / a1). Back: x_i = z_i / L_ii from row i's lane; every
// lane takes L_ir x_i off its rows r < i (row i of L from sL, store_rows2's
// layout; lanes read consecutive words). Steps past n change nothing and are
// skipped (n is the same on every lane).
template <int NP>
__device__ __forceinline__ void solve_rows2(float& y0, float& y1, const float (&a0)[kWarp],
                                            const float (&a1)[NP], float ivd0, float ivd1,
                                            const float* sL, int n, int lane) {
  constexpr int ld = rows2_stride<NP>();
  static_for<NP>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    if (i < n) {
      const float zi = __shfl_sync(kFull, i < kWarp ? y0 * ivd0 : y1 * ivd1, i % kWarp);
      if (i < kWarp) {
        y0 = lane == i ? zi : (lane > i ? fmaf(-a0[i < kWarp ? i : 0], zi, y0) : y0);
        y1 = fmaf(-a1[i], zi, y1);
      } else {
        y1 = lane + kWarp == i ? zi : (lane + kWarp > i ? fmaf(-a1[i], zi, y1) : y1);
      }
    }
  });
  static_for<NP>([&](auto kc) {
    constexpr int i = NP - 1 - decltype(kc)::value;
    if (i < n) {
      const float xi = __shfl_sync(kFull, i < kWarp ? y0 * ivd0 : y1 * ivd1, i % kWarp);
      const float* row = sL + i * ld;
      if (i < kWarp) {
        const float l = lane < i ? row[lane] : 0.0f;
        y0 = lane == i ? xi : (lane < i ? fmaf(-l, xi, y0) : y0);
      } else {
        const float l1 = lane + kWarp < i ? row[lane + kWarp] : 0.0f;
        y1 = lane + kWarp == i ? xi : (lane + kWarp < i ? fmaf(-l1, xi, y1) : y1);
        y0 = fmaf(-row[lane], xi, y0);
      }
    }
  });
}

// store_factor_lean() for the two rows a lane holds: sLt[j * NP + i] = L[i][j]
// (columns) and sL[i * row_stride + j] = L[i][j] (rows), 1 / L_ii on both
// diagonals. Entries above the diagonal are not written (solve_cols never
// uses them).
template <int NP>
__device__ __forceinline__ void store_factor2_lean(const float (&a0)[kWarp], const float (&a1)[NP],
                                                   float ivd0, float ivd1, float* sLt, float* sL,
                                                   int lane) {
  constexpr int rs = row_stride<NP>();
  const int r1 = lane + kWarp;
#pragma unroll
  for (int j = 0; j < kWarp; ++j) sLt[j * NP + lane] = a0[j];
  float4* row0 = reinterpret_cast<float4*>(sL + lane * rs);
#pragma unroll
  for (int q = 0; q < kWarp / 4; ++q)
    row0[q] = make_float4(a0[4 * q], a0[4 * q + 1], a0[4 * q + 2], a0[4 * q + 3]);
  sLt[lane * NP + lane] = ivd0;
  sL[lane * rs + lane] = ivd0;
  if (r1 < NP) {
#pragma unroll
    for (int j = 0; j < NP; ++j) sLt[j * NP + r1] = a1[j];
    float4* row1 = reinterpret_cast<float4*>(sL + r1 * rs);
#pragma unroll
    for (int q = 0; q < NP / 4; ++q)
      row1[q] = make_float4(a1[4 * q], a1[4 * q + 1], a1[4 * q + 2], a1[4 * q + 3]);
    sLt[r1 * NP + r1] = ivd1;
    sL[r1 * rs + r1] = ivd1;
  }
}

// solve_lean() for the column z a lane holds, on store_factor2_lean()'s
// layout; steps past n are skipped (rows >= n of z are zero and stay zero).
template <int NP>
__device__ __forceinline__ void solve_cols(float (&z)[NP], const float* sLt, const float* sL,
                                           int n) {
  // forward: z_i *= 1/L_ii, z_r -= L_ri z_i (r > i); column i of L from sLt
  static_for<NP>([&](auto ic) {
    constexpr int i = decltype(ic)::value;
    constexpr int qd = i / 4;  // the chunk that holds the diagonal
    if (i < n) {
      const float4* col = reinterpret_cast<const float4*>(sLt + i * NP);
      const float4 v = col[qd];
      const float w[4] = {v.x, v.y, v.z, v.w};
      const float zi = z[i] * w[i % 4];
      z[i] = zi;
#pragma unroll
      for (int e = i % 4 + 1; e < 4; ++e) z[4 * qd + e] = fmaf(-w[e], zi, z[4 * qd + e]);
#pragma unroll
      for (int q = qd + 1; q < NP / 4; ++q) {
        const float4 u = col[q];
        z[4 * q] = fmaf(-u.x, zi, z[4 * q]);
        z[4 * q + 1] = fmaf(-u.y, zi, z[4 * q + 1]);
        z[4 * q + 2] = fmaf(-u.z, zi, z[4 * q + 2]);
        z[4 * q + 3] = fmaf(-u.w, zi, z[4 * q + 3]);
      }
    }
  });
  // back: x_i = z_i / L_ii, z_r -= L_ir x_i (r < i); row i of L from sL
  static_for<NP>([&](auto kc) {
    constexpr int i = NP - 1 - decltype(kc)::value;
    constexpr int qd = i / 4;
    if (i < n) {
      const float4* row = reinterpret_cast<const float4*>(sL + i * row_stride<NP>());
      const float4 v = row[qd];  // the chunk with the diagonal first
      const float w[4] = {v.x, v.y, v.z, v.w};
      const float xi = z[i] * w[i % 4];
      z[i] = xi;
#pragma unroll
      for (int e = 0; e < i % 4; ++e) z[4 * qd + e] = fmaf(-w[e], xi, z[4 * qd + e]);
#pragma unroll
      for (int q = 0; q < qd; ++q) {
        const float4 u = row[q];
        z[4 * q] = fmaf(-u.x, xi, z[4 * q]);
        z[4 * q + 1] = fmaf(-u.y, xi, z[4 * q + 1]);
        z[4 * q + 2] = fmaf(-u.z, xi, z[4 * q + 2]);
        z[4 * q + 3] = fmaf(-u.w, xi, z[4 * q + 3]);
      }
    }
  });
}

// --- a tail of rows held by columns (see the note at the top) ----------------

template <int T>
__device__ __forceinline__ void load_rows_tail(float (&a)[kWarp], float (&t)[T],
                                               float (&c)[T][T], const float* sA, int n, int ld,
                                               int lane) {
  load_rows_ld<kWarp>(a, sA, n, ld, lane);
#pragma unroll
  for (int r = 0; r < T; ++r) {
    const bool real = kWarp + r < n;
    const float* row = sA + (kWarp + r) * ld;
    t[r] = real ? row[lane] : 0.0f;
#pragma unroll
    for (int s = 0; s <= r; ++s) c[r][s] = real ? row[kWarp + s] : (s == r ? 1.0f : 0.0f);
  }
}

// In place: a[j] = L[i][j] (j <= i) on lane i, t[r] = L[32 + r][j] on lane
// j, c[r][s] = L[32 + r][32 + s] (s <= r) on every lane; ivd = 1 / L_ii on
// lane i and ivc[r] = 1 / L[32 + r][32 + r] on every lane.
template <int T>
__device__ __forceinline__ void factor_tail(float (&a)[kWarp], float (&t)[T], float (&c)[T][T],
                                            float& ivd, float (&ivc)[T], int lane) {
#pragma unroll
  for (int k = 0; k < kWarp; ++k) {
    const float inv = rsqrtf(fmaxf(__shfl_sync(kFull, a[k], k), 1e-30f));
    const float l = a[k] * inv;  // L_ik on lane i
    float lt[T];                 // L[32 + r][k], from lane k's column
#pragma unroll
    for (int r = 0; r < T; ++r) lt[r] = __shfl_sync(kFull, t[r], k) * inv;
#pragma unroll
    for (int j = 0; j < kWarp; ++j)
      if (j > k) a[j] = fmaf(-l, __shfl_sync(kFull, l, j), a[j]);
#pragma unroll
    for (int r = 0; r < T; ++r) {
      t[r] = lane > k ? fmaf(-lt[r], l, t[r]) : (lane == k ? lt[r] : t[r]);
#pragma unroll
      for (int s = 0; s <= r; ++s) c[r][s] = fmaf(-lt[r], lt[s], c[r][s]);
    }
    a[k] = l;
    if (lane == k) ivd = inv;
  }
#pragma unroll
  for (int p = 0; p < T; ++p) {
    const float inv = rsqrtf(fmaxf(c[p][p], 1e-30f));
#pragma unroll
    for (int r = p; r < T; ++r) c[r][p] *= inv;
#pragma unroll
    for (int r = p + 1; r < T; ++r)
#pragma unroll
      for (int s = p + 1; s <= r; ++s) c[r][s] = fmaf(-c[r][p], c[s][p], c[r][s]);
    ivc[p] = inv;
  }
}

// sLt[j * NP + i] = L[i][j] and sL[i * row_stride + j] = L[i][j] at
// NP = 32 + T, 1 / L_ii on both diagonals; entries above the diagonal of
// the tail are not written (solve_cols never uses them).
template <int T>
__device__ __forceinline__ void store_factor_tail(const float (&a)[kWarp], const float (&t)[T],
                                                  const float (&c)[T][T], float ivd,
                                                  const float (&ivc)[T], float* sLt, float* sL,
                                                  int lane) {
  constexpr int NP = kWarp + T;
  constexpr int rs = row_stride<NP>();
#pragma unroll
  for (int j = 0; j < kWarp; ++j) sLt[j * NP + lane] = a[j];
  float4* row = reinterpret_cast<float4*>(sL + lane * rs);
#pragma unroll
  for (int q = 0; q < kWarp / 4; ++q)
    row[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  sLt[lane * NP + lane] = ivd;
  sL[lane * rs + lane] = ivd;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    sLt[lane * NP + kWarp + r] = t[r];
    sL[(kWarp + r) * rs + lane] = t[r];
#pragma unroll
    for (int s = 0; s <= r; ++s)
      if (lane == r * T + s) {
        const float v = s == r ? ivc[r] : c[r][s];
        sLt[(kWarp + s) * NP + kWarp + r] = v;
        sL[(kWarp + r) * rs + kWarp + s] = v;
      }
  }
}

}  // namespace chol_warp
