// The IMU preintegration factor of the sliding-window bundle adjustment on
// Hopper, float32 or float64: per interval w of a window (frames w, w + 1)
// the whitened 15-residual, its analytic 15 x 30 Jacobian over [δpose_w,
// δsb_w, δpose_w+1, δsb_w+1] (imu_rows_kernel, rows mode; cost mode: |r_w|²
// alone), and one linearization's sums Σ J_wᵀ J_w and Σ J_wᵀ r_w added in
// place into the normal equations H_pp [D, D] and b_p [D] (imu_normal_kernel),
// beside each interval's |r_w|².
//
// Replaces what XLA computes inside the JAX package's jitted solve and
// MARGIN_OLD programs: lfvio_tpu/backend/solver.py:241 linearize_imu_rows
// (forward-mode autodiff of _imu_local_residual, :107, vmapped over the
// intervals, and the dense [W * 15, D] rows), the IMU part of
// assemble_normal_equations (:308, their JᵀJ) and total_cost's IMU term
// (:336 through backend/factors.py:158 imu_residuals_window); there is no
// Pallas kernel behind them. The LM solve's linearization is
// imu_normal_kernel; MARGIN_OLD's QR takes the rows of the rows mode; the
// LM's cost is the cost mode.
//
// The math is backend/factors.py::imu_jacobian's, formula for formula (its
// docstring has the blocks), each raw entry in the same order of operations:
// the f32 residual is a difference of terms far larger than itself, so a
// reordered subtraction would round it anew. r_q's derivative over bg_i
// carries the normalization of the bias-corrected Δq (imu/preintegration.py::
// bias_corrected_delta), which VINS-Mono's closed form drops.
//
// What bounds it on an H100: latency. At the high-rate solve's inputs
// (window 20, D = 322) a linearization reads about 38 KB, touches 15 KB of
// H_pp and does about 0.7 MFLOP (chip_smoke.imu_bound_ms): tens of
// nanoseconds of the card, below its least kernel duration. What a launch
// costs is the chain of dependent steps inside one block: a round trip to
// memory for the inputs, one interval's arithmetic, the whitening, for
// imu_normal the sums and the round trip of H_pp. About half of each
// launch's time behind a full queue is the launch itself, which no design
// of the block removes: imu_empty_kernel, nothing with the launch's grid,
// block and arguments, takes it (chip_smoke.py phase 14). No tensor cores:
// the products are 15 x 15 by 15 x 31, and in float32 only TF32 would reach
// them.
//
// Design:
//  * Inputs staged once. The warp that computes an interval first copies
//    every input value it reads into shared memory (Staged below: the 120
//    entries of sqrt_info's lower triangle, the Jacobian's rows 0..8 over
//    columns 9..14, Δp, Δq, Δv, Σdt, the linearization biases, gravity and
//    both frames' state) with 22 predicated cp.async instructions whose
//    addresses take a few integer operations (rows i and 14 - i of the
//    triangle fill one), then waits once: one memory latency a block, and
//    no load inside the arithmetic (a branch around each copy would
//    diverge across the warp and issue the copies one path at a time).
//    imu_normal also reads the H_pp or b_p entries each
//    thread will add to into registers before that wait, so their round
//    trip overlaps the staging and the arithmetic; the writes follow the
//    sums.
//  * A lane a column. An interval's raw rows have 31 columns (30 of the
//    Jacobian, then the residual); lane c of the interval's warp computes
//    column c's 15 raw entries in registers. Every lane recomputes for
//    itself what the columns share (R_i, R_iᵀ a, R_iᵀ b, h, |h|, f, e:
//    about 150 operations), then each column group's entries for its own
//    m = c mod 3 (the θ_i and bg_i quaternion products among them), and
//    keeps its group's by selection: the same instructions across the
//    warp (a switch over the ten groups would run their branches one after
//    another). Lane 30 computes the residual instead.
//  * Whitening in registers over the triangle: out[r] = Σ_{k ≤ r} si[r][k]
//    raw[k], k ascending, in place from r = 14 down; the si reads are the
//    same address across the warp (shared-memory broadcasts). 120 FMAs a
//    column; the upper triangle's products, all zero, are left out.
//  * imu_rows_kernel, rows mode: a block (one warp) an interval; lanes 0..29
//    store their columns of J30 (a row's 30 entries from 30 lanes), lane 30
//    the residual. An invalid interval is written as exact zeros.
//  * imu_rows_kernel, cost mode: a block (one warp) an interval, no shared
//    memory. Lane r < 15 loads its row of sqrt_info and what its residual
//    row reads, computes raw residual row r alone, and whitens by shuffles
//    of raw_k over the triangle; |r_w|² is a shuffle sum.
//  * imu_normal_kernel: a block of NRM_THREADS for each frame k. Warp 0
//    stages and computes the columns of interval k - 1 that frame k's rows
//    need (its j side and the residual), warp 1 all of interval k's (each
//    interval is evaluated by the blocks of both its frames, on separate
//    SMs: no latency, and every entry keeps one writer). The whitened
//    columns go to shared memory column by column (pitch 20: 16-byte stores
//    without bank conflicts, and a whole column in 16-byte loads); then a
//    thread a job, at most 30 products:
//    an entry of the (k, k+1) block of H_pp with its mirror, one of the 120
//    distinct entries of frame k's diagonal block (its 6 pose columns at 6k
//    and 9 speed-bias columns at 6 W1 + 9k, which lie apart in the layout)
//    written to both of its places, an entry of b_p, or interval k's |r_w|².
//    Every entry of H_pp and b_p is added to by one thread of one block,
//    with no atomics and a fixed order of every sum, so a repeat is
//    bit-identical. The extrinsic and td columns get nothing.
// No limit depends on the window: a rows or cost launch is W blocks, a
// normal launch W1 blocks, and a block's shared memory is fixed (imu_normal
// 6.6 KB in float32, 13.2 KB in float64).
#include <cuda_runtime.h>

namespace {

constexpr int RAW = 31;            // an interval's 30 Jacobian columns, then its residual
constexpr int TRI = 120;           // entries of sqrt_info's lower triangle
constexpr int JP = 20;             // imu_normal's whitened columns: the pitch of a column
constexpr int NRM_THREADS = 384;   // imu_normal_kernel: a thread a job of its assembly
// imu_normal_kernel's jobs in thread order: the (k, k+1) block's 225
// entries, the diagonal block's 120 distinct entries, b_p's 15, the cost.
constexpr int N_OFF = 225, N_DIAG = TRI, N_BP = 15;
static_assert(N_OFF + N_DIAG + N_BP + 1 <= NRM_THREADS, "imu_normal's jobs fit its block");

template <typename T>
struct ImuArgs {
  const T* p;  // [W1, 3]
  const T* q;  // [W1, 4] wxyz
  const T* v;
  const T* ba;
  const T* bg;
  const T* dp;      // [W, 3] the preintegration's Δp
  const T* dq;      // [W, 4] Δq
  const T* dv;      // [W, 3] Δv
  const T* jac;     // [W, 15, 15] d(Δ)/d[p, θ, v, ba, bg]
  const T* sum_dt;  // [W]
  const T* lba;     // [W, 3] the biases it was linearized at
  const T* lbg;
  const T* si;       // [W, 15, 15] sqrt_info (lower triangular)
  const T* gravity;  // [3]
  const bool* valid; // [W]
  int W;
};

// One interval's inputs as a block stages them (STAGED values): sqrt_info's
// lower triangle row by row (row r from r (r + 1) / 2), the preintegration
// Jacobian's rows 0..8 over columns 9..14 (the 45 entries the residual reads
// and 9 that it does not, J_q,ba: one index rule), the deltas, Σdt, the
// linearization biases, gravity, then frames i and j's state. J takes the
// Jacobian's own (row, col).
template <typename T>
struct Staged {
  T si[TRI];
  T jac[54];
  T dp[3], dq[4], dv[3], dt[1], lba[3], lbg[3], g[3];
  T p[2][3], q[2][4], v[2][3], ba[2][3], bg[2][3];
  __device__ __forceinline__ T J(int row, int col) const { return jac[6 * row + col - 9]; }
};
constexpr int STAGED = TRI + 54 + 20 + 32;
static_assert(sizeof(Staged<float>) == STAGED * sizeof(float), "Staged is packed");
static_assert(sizeof(Staged<double>) == STAGED * sizeof(double), "Staged is packed");

// The same fields read straight from device memory (the cost mode).
template <typename T>
struct Direct {
  const T *dp, *dq, *dv, *dt, *lba, *lbg, *g;
  const T (*p)[3];
  const T (*q)[4];
  const T (*v)[3];
  const T (*ba)[3];
  const T (*bg)[3];
  const T* jac;  // the interval's 15 x 15 Jacobian
  __device__ __forceinline__ T J(int row, int col) const { return jac[15 * row + col]; }
};

template <typename T>
__device__ __forceinline__ Direct<T> direct(const ImuArgs<T>& g, int w) {
  return Direct<T>{g.dp + 3 * w, g.dq + 4 * w, g.dv + 3 * w, g.sum_dt + w, g.lba + 3 * w,
                   g.lbg + 3 * w, g.gravity,
                   reinterpret_cast<const T(*)[3]>(g.p + 3 * w),
                   reinterpret_cast<const T(*)[4]>(g.q + 4 * w),
                   reinterpret_cast<const T(*)[3]>(g.v + 3 * w),
                   reinterpret_cast<const T(*)[3]>(g.ba + 3 * w),
                   reinterpret_cast<const T(*)[3]>(g.bg + 3 * w), g.jac + 225 * w};
}

// Row r and column k <= r of the lower-triangle entry e = r (r + 1) / 2 + k
// (e < 120: 8e + 1 <= 961 is exact in float, and the square root of a
// non-square lies at least 0.1 from the next odd integer).
__device__ __forceinline__ void tri_rc(int e, int& r, int& k) {
  r = (int)((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  k = e - r * (r + 1) / 2;
}

// One cp.async of a value where p holds: a predicated instruction, no branch.
template <typename T>
__device__ __forceinline__ void cp_async_if(bool p, T* dst_shared, const T* src_global) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte copies");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  if constexpr (sizeof(T) == 8)
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
                 " @p cp.async.ca.shared.global [%0], [%1], 8;\n}\n"
                 ::"r"(d), "l"(src_global), "r"((int)p));
  else
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
                 " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
                 ::"r"(d), "l"(src_global), "r"((int)p));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A warp issues its copies of interval w's Staged record, 22 predicated
// instructions with addresses a lane computes in a few integer operations.
template <typename T>
__device__ __forceinline__ void stage(const ImuArgs<T>& g, int w, Staged<T>& s, int lane) {
  // sqrt_info's lower triangle, rows i and 14 - i together (16 entries):
  // lanes 0..15 take entry l of row i, lanes 16..31 entry l of row 14 - i.
  const T* si = g.si + 225 * w;
  const int half = lane >> 4, l = lane & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = half ? 14 - i : i;
    cp_async_if(l <= r && !(half && i == 7), s.si + r * (r + 1) / 2 + l, si + 15 * r + l);
  }
  const T* J = g.jac + 225 * w;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = lane + 32 * i;
    cp_async_if(e < 54, s.jac + e, J + 15 * (e / 6) + 9 + e % 6);
  }
  // The small fields, an instruction each; frames w and w + 1 are
  // consecutive rows of each state field.
  cp_async_if(lane < 3, s.dp + lane, g.dp + 3 * w + lane);
  cp_async_if(lane < 4, s.dq + lane, g.dq + 4 * w + lane);
  cp_async_if(lane < 3, s.dv + lane, g.dv + 3 * w + lane);
  cp_async_if(lane < 1, s.dt + lane, g.sum_dt + w + lane);
  cp_async_if(lane < 3, s.lba + lane, g.lba + 3 * w + lane);
  cp_async_if(lane < 3, s.lbg + lane, g.lbg + 3 * w + lane);
  cp_async_if(lane < 3, s.g + lane, g.gravity + lane);
  cp_async_if(lane < 6, &s.p[0][0] + lane, g.p + 3 * w + lane);
  cp_async_if(lane < 8, &s.q[0][0] + lane, g.q + 4 * w + lane);
  cp_async_if(lane < 6, &s.v[0][0] + lane, g.v + 3 * w + lane);
  cp_async_if(lane < 6, &s.ba[0][0] + lane, g.ba + 3 * w + lane);
  cp_async_if(lane < 6, &s.bg[0][0] + lane, g.bg + 3 * w + lane);
}

template <typename T>
__device__ __forceinline__ void quat_mat(const T* q, T R[3][3]) {
  // geom/rotations.py::quat_to_mat: the matrix of quat_rotate.
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  R[0][0] = T(1) - T(2) * (yy + zz); R[0][1] = T(2) * (xy - wz); R[0][2] = T(2) * (xz + wy);
  R[1][0] = T(2) * (xy + wz); R[1][1] = T(1) - T(2) * (xx + zz); R[1][2] = T(2) * (yz - wx);
  R[2][0] = T(2) * (xz - wy); R[2][1] = T(2) * (yz + wx); R[2][2] = T(1) - T(2) * (xx + yy);
}

// c = a ⊗ b (geom/rotations.py::quat_mul, wxyz).
template <typename T>
__device__ __forceinline__ void qmul(const T a[4], const T b[4], T c[4]) {
  c[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  c[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  c[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  c[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// [x]× (geom/rotations.py::skew).
template <typename T>
__device__ __forceinline__ void skew3(const T x[3], T S[3][3]) {
  S[0][0] = T(0); S[0][1] = -x[2]; S[0][2] = x[1];
  S[1][0] = x[2]; S[1][1] = T(0); S[1][2] = -x[0];
  S[2][0] = -x[1]; S[2][1] = x[0]; S[2][2] = T(0);
}

// x[m] for a run-time m, without indexing registers.
template <typename T>
__device__ __forceinline__ T sel3(T x0, T x1, T x2, int m) {
  return m == 0 ? x0 : (m == 1 ? x1 : x2);
}

// What every column of an interval uses: R_i, R_iᵀ a and R_iᵀ b with
// a = ½ g T² + p_j - p_i - v_i T, b = g T + v_j - v_i, the bias offsets, and
// r_q's e = Δq'* ⊗ f, f = q_i* ⊗ q_j, Δq' = h / |h|, h = Δq ⊗ [1, ½ J_q,bg
// δbg] (with c = Δq'*).
template <typename T>
struct Common {
  T Ri[3][3], RTa[3], RTb[3], dba[3], dbg[3];
  T h[4], inh, c[4], f[4], e[4];
};

template <typename T, typename V>
__device__ __forceinline__ void interval_common(const V& s, Common<T>& o) {
  quat_mat(s.q[0], o.Ri);
  const T dt = s.dt[0];
  T a[3], b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = T(0.5) * s.g[k] * dt * dt + s.p[1][k] - s.p[0][k] - s.v[0][k] * dt;
    b[k] = s.g[k] * dt + s.v[1][k] - s.v[0][k];
    o.dba[k] = s.ba[0][k] - s.lba[k];
    o.dbg[k] = s.bg[0][k] - s.lbg[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.RTa[k] = o.Ri[0][k] * a[0] + o.Ri[1][k] * a[1] + o.Ri[2][k] * a[2];
    o.RTb[k] = o.Ri[0][k] * b[0] + o.Ri[1][k] * b[1] + o.Ri[2][k] * b[2];
  }
  T sq[4];
  sq[0] = T(1);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    sq[1 + k] = T(0.5) * (s.J(3 + k, 12) * o.dbg[0] + s.J(3 + k, 13) * o.dbg[1] +
                          s.J(3 + k, 14) * o.dbg[2]);
  T d0[4], qi_c[4], qj[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d0[k] = s.dq[k];
    qi_c[k] = k ? -s.q[0][k] : s.q[0][0];
    qj[k] = s.q[1][k];
  }
  qmul(d0, sq, o.h);
  const T nh = sqrt(o.h[0] * o.h[0] + o.h[1] * o.h[1] + o.h[2] * o.h[2] + o.h[3] * o.h[3]);
  o.inh = T(1) / nh;
  o.c[0] = o.h[0] * o.inh;
#pragma unroll
  for (int k = 1; k < 4; ++k) o.c[k] = -o.h[k] * o.inh;
  qmul(qi_c, qj, o.f);
  qmul(o.c, o.f, o.e);
}

// Raw r_p row k (x = R_iᵀ a, d = Δp[k], J = J_p row k) or r_v row k (R_iᵀ b,
// Δv[k], J_v row k): x - (d + J_ba δba + J_bg δbg); J(m) is the row's entry
// in column 9 + m.
template <typename T, typename JR>
__device__ __forceinline__ T pv_residual(T x, T d, const JR& J, const T dba[3], const T dbg[3]) {
  T pa = T(0), pg = T(0);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    pa += J(m) * dba[m];
    pg += J(3 + m) * dbg[m];
  }
  return x - (d + pa + pg);
}

// The 15 raw residual rows: r_p (0..2), r_q (3..5), r_v (6..8), r_ba, r_bg.
template <typename T, typename V>
__device__ __forceinline__ void raw_residual(const V& s, const Common<T>& o, T raw[15]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    raw[k] = pv_residual(o.RTa[k], s.dp[k], [&](int m) { return s.J(k, 9 + m); }, o.dba, o.dbg);
    raw[3 + k] = T(2) * o.e[1 + k];
    raw[6 + k] = pv_residual(o.RTb[k], s.dv[k], [&](int m) { return s.J(6 + k, 9 + m); },
                             o.dba, o.dbg);
    raw[9 + k] = s.ba[1][k] - s.ba[0][k];
    raw[12 + k] = s.bg[1][k] - s.bg[0][k];
  }
}

// Raw Jacobian column c < 30: the derivative of the 15 raw rows over
// [δp_i, δθ_i, δv_i, δba_i, δbg_i, δp_j, δθ_j, δv_j, δba_j, δbg_j][c]. Every
// lane computes each group's entries for its own m (the same instructions
// across the warp: no divergent branch) and keeps its group's.
template <typename T, typename V>
__device__ __forceinline__ void raw_column(const V& s, const Common<T>& o, int c, T raw[15]) {
  const int grp = c / 3, m = c % 3;
  T rt[3], Sa[3], Sb[3], Se[3];  // R_iᵀ[k][m] and [R_iᵀ a]×, [R_iᵀ b]×, [e_v]× at [k][m]
  {
    T SA[3][3], SB[3][3], SE[3][3];
    const T ev[3] = {o.e[1], o.e[2], o.e[3]};
    skew3(o.RTa, SA);
    skew3(o.RTb, SB);
    skew3(ev, SE);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rt[k] = sel3(o.Ri[0][k], o.Ri[1][k], o.Ri[2][k], m);
      Sa[k] = sel3(SA[k][0], SA[k][1], SA[k][2], m);
      Sb[k] = sel3(SB[k][0], SB[k][1], SB[k][2], m);
      Se[k] = sel3(SE[k][0], SE[k][1], SE[k][2], m);
    }
  }
  // θ_i's r_q: -vec(Δq'* ⊗ [0, u_m] ⊗ f).
  const T u[4] = {T(0), T(m == 0), T(m == 1), T(m == 2)};
  T t[4], t2[4];
  qmul(o.c, u, t);
  qmul(t, o.f, t2);
  // bg_i's r_q: 2 vec((dh* ⊗ f) / |h| - e (h · dh) / |h|²), dh = Δq ⊗ [0, ½ J_q,bg u_m].
  const T x[4] = {T(0), T(0.5) * s.J(3, 12 + m), T(0.5) * s.J(4, 12 + m),
                  T(0.5) * s.J(5, 12 + m)};
  T d0[4], dh[4], cf[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) d0[k] = s.dq[k];
  qmul(d0, x, dh);
  const T dot = o.h[0] * dh[0] + o.h[1] * dh[1] + o.h[2] * dh[2] + o.h[3] * dh[3];
  const T dhc[4] = {dh[0], -dh[1], -dh[2], -dh[3]};
  qmul(dhc, o.f, cf);
  const T de = dot * o.inh * o.inh;
  const T dt = s.dt[0];
  const int jc = (grp == 4 ? 12 : 9) + m;  // ba_i's or bg_i's column of J
  const bool pre = grp == 3 || grp == 4;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T jp = -s.J(k, jc), jv = -s.J(6 + k, jc);
    raw[k] = grp == 0 ? -rt[k] : grp == 1 ? Sa[k] : grp == 2 ? -dt * rt[k] : pre ? jp
           : grp == 5 ? rt[k] : T(0);
    raw[3 + k] = grp == 1 ? -t2[1 + k]
               : grp == 4 ? T(2) * (cf[1 + k] * o.inh - o.e[1 + k] * de)
               : grp == 6 ? (k == m ? o.e[0] : T(0)) + Se[k] : T(0);
    raw[6 + k] = grp == 1 ? Sb[k] : grp == 2 ? -rt[k] : pre ? jv : grp == 7 ? rt[k] : T(0);
    raw[9 + k] = k != m ? T(0) : grp == 3 ? T(-1) : grp == 8 ? T(1) : T(0);
    raw[12 + k] = k != m ? T(0) : grp == 4 ? T(-1) : grp == 9 ? T(1) : T(0);
  }
}

// raw <- sqrt_info raw over the lower triangle (si packed row by row), in
// place from the last row up, each sum over k ascending.
template <typename T>
__device__ __forceinline__ void whiten(const T* si, T raw[15]) {
#pragma unroll
  for (int r = 14; r >= 0; --r) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k <= r; ++k) acc += si[r * (r + 1) / 2 + k] * raw[k];
    raw[r] = acc;
  }
}

// Lane c's whitened column of the staged interval (c = 30: the residual).
template <typename T>
__device__ __forceinline__ void interval_column(const Staged<T>& s, int c, T col[15]) {
  Common<T> o;
  interval_common(s, o);
  if (c < 30)
    raw_column(s, o, c, col);
  else
    raw_residual(s, o, col);
  whiten(s.si, col);
}

// A whitened column of imu_normal's tile (15 entries, then a pad), moved
// with 16-byte accesses.
template <typename T>
__device__ __forceinline__ void store_col(T* p, const T v[15]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], i < 3 ? v[4 * i + 3] : 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], i < 7 ? v[2 * i + 1] : 0.0);
  }
}
template <typename T>
__device__ __forceinline__ void load_col(const T* p, T v[15]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z;
      if (i < 3) v[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const double2 x = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = x.x;
      if (i < 7) v[2 * i + 1] = x.y;
    }
  }
}

// Σ_r x[r] y[r] added to acc, r ascending.
template <typename T>
__device__ __forceinline__ T dot15(T acc, const T* px, const T* py) {
  T x[15], y[15];
  load_col(px, x);
  load_col(py, y);
#pragma unroll
  for (int r = 0; r < 15; ++r) acc += x[r] * y[r];
  return acc;
}

template <typename T>
__device__ __forceinline__ void rows_mode(const ImuArgs<T>& g, T* __restrict__ r_out,
                                          T* __restrict__ J_out) {
  __shared__ Staged<T> st;
  const int w = blockIdx.x, lane = threadIdx.x;
  stage(g, w, st, lane);
  const bool ok = g.valid[w];
  cp_async_wait_all();
  __syncwarp();
  if (lane >= RAW) return;
  T col[15];
  if (ok) {
    interval_column(st, lane, col);
  } else {
#pragma unroll
    for (int r = 0; r < 15; ++r) col[r] = T(0);
  }
  if (lane < 30) {
#pragma unroll
    for (int r = 0; r < 15; ++r) J_out[450 * w + 30 * r + lane] = col[r];
  } else {
#pragma unroll
    for (int r = 0; r < 15; ++r) r_out[15 * w + r] = col[r];
  }
}

template <typename T>
__device__ __forceinline__ void cost_mode(const ImuArgs<T>& g, T* __restrict__ cost) {
  const int w = blockIdx.x, lane = threadIdx.x;
  const int grp = lane / 3, k = lane % 3;  // lane's row: group (r_p, r_q, r_v, r_ba, r_bg), k
  const Direct<T> s = direct(g, w);
  const bool ok = g.valid[w];
  // The lane's row of the triangle, and what its raw row reads beyond the
  // shared quantities, loaded before any arithmetic.
  T sir[15], J[6], d = T(0), bj = T(0), bi = T(0);
  const int jrow = grp == 2 ? 6 + k : k;
#pragma unroll
  for (int m = 0; m < 15; ++m)
    sir[m] = (lane < 15 && m <= lane) ? g.si[225 * w + 15 * lane + m] : T(0);
  if (lane < 15) {
#pragma unroll
    for (int m = 0; m < 6; ++m) J[m] = s.J(jrow, 9 + m);
    d = grp == 2 ? s.dv[k] : s.dp[k];
    bi = grp == 4 ? s.bg[0][k] : s.ba[0][k];
    bj = grp == 4 ? s.bg[1][k] : s.ba[1][k];
  }
  T raw = T(0);
  if (lane < 15) {
    Common<T> o;
    interval_common(s, o);
    if (grp == 0 || grp == 2) {
      const T x = grp ? sel3(o.RTb[0], o.RTb[1], o.RTb[2], k)
                      : sel3(o.RTa[0], o.RTa[1], o.RTa[2], k);
      raw = pv_residual(x, d, [&](int m) { return J[m]; }, o.dba, o.dbg);
    } else if (grp == 1) {
      raw = T(2) * sel3(o.e[1], o.e[2], o.e[3], k);
    } else {
      raw = bj - bi;
    }
  }
  T acc = T(0);
#pragma unroll
  for (int m = 0; m < 15; ++m) {
    const T x = __shfl_sync(0xffffffffu, raw, m);
    if (lane < 15 && m <= lane) acc += sir[m] * x;
  }
  T x = acc * acc;
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) cost[w] = ok ? x : T(0);
}

template <typename T, bool ROWS>
__global__ void __launch_bounds__(32)
imu_rows_kernel(const ImuArgs<T> g, T* __restrict__ r_out, T* __restrict__ J_out,
                T* __restrict__ cost) {
  // A block (one warp) an interval.
  if constexpr (ROWS)
    rows_mode(g, r_out, J_out);
  else
    cost_mode(g, cost);
}

enum Job { NONE, OFF, DIAG, BP, COST };

template <typename T>
__global__ void __launch_bounds__(NRM_THREADS)
imu_normal_kernel(const ImuArgs<T> g, int D, T* __restrict__ H, T* __restrict__ b,
                  T* __restrict__ cost) {
  // Block k: warp 0 stages and computes the columns of interval k - 1
  // (frame k is its j side), warp 1 those of interval k (frame k its i
  // side); zero columns where the interval does not exist or is invalid.
  __shared__ Staged<T> st[2];
  __shared__ __align__(16) T Jw[2][RAW][JP];
  const int k = blockIdx.x, W = g.W, W1 = W + 1, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2 && k - 1 + warp >= 0 && k - 1 + warp < W) stage(g, k - 1 + warp, st[warp], lane);
  const bool v0 = g.valid[max(k - 1, 0)], v1 = g.valid[min(k, W - 1)];
  // Column of frame f's local index l (0..5 pose, 6..14 speed-bias).
  auto col = [W1](int f, int l) { return l < 6 ? 6 * f + l : 6 * W1 + 9 * f + (l - 6); };
  // This thread's job and the entries it adds to, read now.
  int kind = NONE, a = 0, c = 0;
  if (tid < N_OFF) {
    if (k < W) kind = OFF, a = tid / 15, c = tid % 15;
  } else if (tid < N_OFF + N_DIAG) {
    kind = DIAG;
    tri_rc(tid - N_OFF, c, a);  // a <= c
  } else if (tid < N_OFF + N_DIAG + N_BP) {
    kind = BP, a = tid - (N_OFF + N_DIAG);
  } else if (tid == N_OFF + N_DIAG + N_BP) {
    if (k < W) kind = COST;
  }
  const int ra = col(k, a), rc = kind == OFF ? col(k + 1, c) : col(k, c);
  const size_t at0 = (size_t)ra * D + rc, at1 = (size_t)rc * D + ra;
  T old0 = T(0), old1 = T(0);
  if (kind == OFF || kind == DIAG) {
    old0 = H[at0];
    if (kind == OFF || a != c) old1 = H[at1];
  } else if (kind == BP) {
    old0 = b[ra];
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp < 2 && lane < RAW && (warp == 1 || lane >= 15)) {
    T c15[15];
    if (warp ? k < W && v1 : k >= 1 && v0) {
      interval_column(st[warp], lane, c15);
    } else {
#pragma unroll
      for (int r = 0; r < 15; ++r) c15[r] = T(0);
    }
    store_col(Jw[warp][lane], c15);
  }
  __syncthreads();
  const T(*J0)[JP] = Jw[0];
  const T(*J1)[JP] = Jw[1];
  if (kind == OFF) {
    const T acc = dot15(T(0), J1[a], J1[15 + c]);
    H[at0] = old0 + acc;
    H[at1] = old1 + acc;
  } else if (kind == DIAG) {
    const T acc = dot15(dot15(T(0), J0[15 + a], J0[15 + c]), J1[a], J1[c]);
    H[at0] = old0 + acc;
    if (a != c) H[at1] = old1 + acc;
  } else if (kind == BP) {
    b[ra] = old0 + dot15(dot15(T(0), J0[15 + a], J0[30]), J1[a], J1[30]);
  } else if (kind == COST) {
    cost[k] = dot15(T(0), J1[30], J1[30]);
  }
}

// A launch's grid, block and arguments with nothing to do.
template <typename T>
__global__ void imu_empty_kernel(const ImuArgs<T> g, int D, T* a, T* b, T* c) {}

template <typename T>
ImuArgs<T> imu_args(const void* p, const void* q, const void* v, const void* ba, const void* bg,
                    const void* dp, const void* dq, const void* dv, const void* jac,
                    const void* sum_dt, const void* lba, const void* lbg, const void* si,
                    const void* gravity, const void* valid, int W) {
  return ImuArgs<T>{(const T*)p,   (const T*)q,       (const T*)v,    (const T*)ba,
                    (const T*)bg,  (const T*)dp,      (const T*)dq,   (const T*)dv,
                    (const T*)jac, (const T*)sum_dt,  (const T*)lba,  (const T*)lbg,
                    (const T*)si,  (const T*)gravity, (const bool*)valid, W};
}

#define IMU_IN_PARAMS                                                                          \
  const void *p, const void *q, const void *v, const void *ba, const void *bg, const void *dp, \
      const void *dq, const void *dv, const void *jac, const void *sum_dt, const void *lba,    \
      const void *lbg, const void *si, const void *gravity, const void *valid
#define IMU_IN_ARGS p, q, v, ba, bg, dp, dq, dv, jac, sum_dt, lba, lbg, si, gravity, valid

template <typename T>
int launch_rows(IMU_IN_PARAMS, int W1, int rows, void* r, void* J30, void* cost,
                cudaStream_t stream) {
  const ImuArgs<T> g = imu_args<T>(IMU_IN_ARGS, W1 - 1);
  if (rows)
    imu_rows_kernel<T, true><<<g.W, 32, 0, stream>>>(g, (T*)r, (T*)J30, nullptr);
  else
    imu_rows_kernel<T, false><<<g.W, 32, 0, stream>>>(g, nullptr, nullptr, (T*)cost);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_normal(IMU_IN_PARAMS, int W1, int D, void* H_pp, void* b_p, void* cost,
                  cudaStream_t stream) {
  const ImuArgs<T> g = imu_args<T>(IMU_IN_ARGS, W1 - 1);
  imu_normal_kernel<T><<<W1, NRM_THREADS, 0, stream>>>(g, D, (T*)H_pp, (T*)b_p, (T*)cost);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_empty(IMU_IN_PARAMS, int W1, int mode, cudaStream_t stream) {
  const ImuArgs<T> g = imu_args<T>(IMU_IN_ARGS, W1 - 1);
  if (mode == 2)
    imu_empty_kernel<T><<<W1, NRM_THREADS, 0, stream>>>(g, 0, nullptr, nullptr, nullptr);
  else
    imu_empty_kernel<T><<<g.W, 32, 0, stream>>>(g, 0, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// The inputs, all on the card: the state's p, q, v, ba, bg [W1, ·]; the
// preintegration's delta_p, delta_q, delta_v [W, ·], jacobian [W, 15, 15],
// sum_dt [W], linearized_ba, linearized_bg [W, 3]; sqrt_info [W, 15, 15]
// (lower triangular); gravity [3]; imu_valid [W] (bool); W = W1 - 1. dtype 0
// float32, 1 float64. mode 1: rows (r [W, 15], J30 [W, 15, 30]); mode 0: cost
// alone ([W]; r and J30 may be null).
extern "C" int imu_rows_launch(IMU_IN_PARAMS, int W1, int mode, int dtype, void* r, void* J30,
                               void* cost, void* stream) {
  if (W1 < 2 || (mode != 0 && mode != 1) || (dtype != 0 && dtype != 1)) return -1;
  return dtype ? launch_rows<double>(IMU_IN_ARGS, W1, mode, r, J30, cost, (cudaStream_t)stream)
               : launch_rows<float>(IMU_IN_ARGS, W1, mode, r, J30, cost, (cudaStream_t)stream);
}

// One linearization's IMU terms added into H_pp [D, D] and b_p [D] (D >= 15
// W1), and each interval's |r_w|² written to cost [W]. Inputs as
// imu_rows_launch's.
extern "C" int imu_normal_launch(IMU_IN_PARAMS, int W1, int D, int dtype, void* H_pp, void* b_p,
                                 void* cost, void* stream) {
  if (W1 < 2 || D < 15 * W1 || (dtype != 0 && dtype != 1)) return -1;
  return dtype ? launch_normal<double>(IMU_IN_ARGS, W1, D, H_pp, b_p, cost, (cudaStream_t)stream)
               : launch_normal<float>(IMU_IN_ARGS, W1, D, H_pp, b_p, cost, (cudaStream_t)stream);
}

// imu_empty_kernel with the grid, block and arguments of the cost (mode 0),
// rows (1) or normal (2) launch at W1 frames. Inputs as imu_rows_launch's.
extern "C" int imu_empty_launch(IMU_IN_PARAMS, int W1, int mode, int dtype, void* stream) {
  if (W1 < 2 || mode < 0 || mode > 2 || (dtype != 0 && dtype != 1)) return -1;
  return dtype ? launch_empty<double>(IMU_IN_ARGS, W1, mode, (cudaStream_t)stream)
               : launch_empty<float>(IMU_IN_ARGS, W1, mode, (cudaStream_t)stream);
}
