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
// docstring has the blocks). r_q's derivative over bg_i carries the
// normalization of the bias-corrected Δq (imu/preintegration.py::
// bias_corrected_delta), which VINS-Mono's closed form drops.
//
// What bounds it on an H100: latency. At the high-rate solve's inputs
// (window 20, D = 322) a linearization reads about 38 KB (the
// preintegration's Jacobians and sqrt_info the most of it), touches 15 KB
// of H_pp and does about 0.7 MFLOP (chip_smoke.imu_bound_ms): far below a
// microsecond of the card. What costs is one interval's chain of dependent
// arithmetic (the rotation, the quaternion products of r_q and its
// columns) and the short sums that follow. No tensor cores: the products are
// 15 x 15 by 15 x 31, and in float32 only TF32 would reach them.
//
// Design: a warp an interval. Lane 0 writes the raw (unwhitened) rows of
// r_p, r_v and the bias residuals and their Jacobian blocks into shared
// memory, lane 1 those of r_q; the warp then whitens all 15 x 31 entries
// (sqrt_info times the raw rows and residual), a lane an entry at a time.
// imu_normal_kernel is one block for each frame k of two such warps: the
// rows of interval k - 1 and of interval k (so each interval is evaluated
// twice, by the blocks of its two frames: cheaper than a round trip through
// device memory and a second launch). The block then writes frame k's
// diagonal 15 x 15 block of H_pp (its 6 pose columns at 6k and its 9
// speed-bias columns at 6 W1 + 9k, which lie apart in the layout), the
// (k, k+1) block from interval k with its mirror, b_p's frame-k part and
// interval k's |r_w|². Every entry of H_pp and b_p is added to by one thread
// of one block, with no atomics and a fixed order of every sum, so a repeat
// is bit-identical. The extrinsic and td columns get nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAW = 31;           // a row's 30 Jacobian columns, then its residual
constexpr int ROWS_WARPS = 4;     // intervals a block of imu_rows_kernel takes
constexpr int NRM_THREADS = 64;   // imu_normal_kernel: a warp for each of two intervals

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
  const T* si;       // [W, 15, 15] sqrt_info
  const T* gravity;  // [3]
  const bool* valid; // [W]
  int W;
};

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

// The raw rows r_p (0..2), r_v (6..8), r_ba (9..11) and r_bg (12..14) of
// interval w: the residual in column 30 and, with JAC, the nonzero Jacobian
// entries (the rest of `raw` is zero already).
template <typename T, bool JAC>
__device__ void raw_pv(const ImuArgs<T>& g, int w, T (*raw)[RAW]) {
  const int i = w, j = w + 1;
  const T* J = g.jac + 225 * w;
  T Ri[3][3];
  quat_mat(g.q + 4 * i, Ri);
  const T dt = g.sum_dt[w];
  T a[3], b[3], dba[3], dbg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = T(0.5) * g.gravity[k] * dt * dt + g.p[3 * j + k] - g.p[3 * i + k] -
           g.v[3 * i + k] * dt;
    b[k] = g.gravity[k] * dt + g.v[3 * j + k] - g.v[3 * i + k];
    dba[k] = g.ba[3 * i + k] - g.lba[3 * w + k];
    dbg[k] = g.bg[3 * i + k] - g.lbg[3 * w + k];
  }
  T RTa[3], RTb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    RTa[k] = Ri[0][k] * a[0] + Ri[1][k] * a[1] + Ri[2][k] * a[2];
    RTb[k] = Ri[0][k] * b[0] + Ri[1][k] * b[1] + Ri[2][k] * b[2];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T pa = T(0), pg = T(0), va = T(0), vg = T(0);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      pa += J[k * 15 + 9 + m] * dba[m];
      pg += J[k * 15 + 12 + m] * dbg[m];
      va += J[(6 + k) * 15 + 9 + m] * dba[m];
      vg += J[(6 + k) * 15 + 12 + m] * dbg[m];
    }
    raw[k][30] = RTa[k] - (g.dp[3 * w + k] + pa + pg);
    raw[6 + k][30] = RTb[k] - (g.dv[3 * w + k] + va + vg);
    raw[9 + k][30] = g.ba[3 * j + k] - g.ba[3 * i + k];
    raw[12 + k][30] = g.bg[3 * j + k] - g.bg[3 * i + k];
  }
  if (!JAC) return;
  T Sa[3][3], Sb[3][3];
  skew3(RTa, Sa);
  skew3(RTb, Sb);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const T rt = Ri[m][k];  // R_iᵀ
      raw[k][m] = -rt;
      raw[k][3 + m] = Sa[k][m];
      raw[k][6 + m] = -dt * rt;
      raw[k][9 + m] = -J[k * 15 + 9 + m];
      raw[k][12 + m] = -J[k * 15 + 12 + m];
      raw[k][15 + m] = rt;
      raw[6 + k][3 + m] = Sb[k][m];
      raw[6 + k][6 + m] = -rt;
      raw[6 + k][9 + m] = -J[(6 + k) * 15 + 9 + m];
      raw[6 + k][12 + m] = -J[(6 + k) * 15 + 12 + m];
      raw[6 + k][21 + m] = rt;
    }
    raw[9 + k][9 + k] = T(-1);
    raw[9 + k][24 + k] = T(1);
    raw[12 + k][12 + k] = T(-1);
    raw[12 + k][27 + k] = T(1);
  }
}

// The raw rows r_q (3..5) of interval w: r_q = 2 vec(e), e = Δq'* ⊗ f,
// f = q_i* ⊗ q_j, Δq' = h / |h|, h = Δq ⊗ [1, ½ J_q,bg δbg]; with JAC its
// columns over θ_i, bg_i and θ_j.
template <typename T, bool JAC>
__device__ void raw_q(const ImuArgs<T>& g, int w, T (*raw)[RAW]) {
  const int i = w, j = w + 1;
  const T* J = g.jac + 225 * w;
  T dbg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) dbg[k] = g.bg[3 * i + k] - g.lbg[3 * w + k];
  T s[4];
  s[0] = T(1);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    s[1 + k] = T(0.5) * (J[(3 + k) * 15 + 12] * dbg[0] + J[(3 + k) * 15 + 13] * dbg[1] +
                         J[(3 + k) * 15 + 14] * dbg[2]);
  T d0[4], qi_c[4], qj[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d0[k] = g.dq[4 * w + k];
    qi_c[k] = k ? -g.q[4 * i + k] : g.q[4 * i];
    qj[k] = g.q[4 * j + k];
  }
  T h[4], f[4], e[4];
  qmul(d0, s, h);
  const T nh = sqrt(h[0] * h[0] + h[1] * h[1] + h[2] * h[2] + h[3] * h[3]);
  const T inh = T(1) / nh;
  const T c[4] = {h[0] * inh, -h[1] * inh, -h[2] * inh, -h[3] * inh};
  qmul(qi_c, qj, f);
  qmul(c, f, e);
#pragma unroll
  for (int k = 0; k < 3; ++k) raw[3 + k][30] = T(2) * e[1 + k];
  if (!JAC) return;
  T Se[3][3];
  const T ev[3] = {e[1], e[2], e[3]};
  skew3(ev, Se);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    // θ_j: vec(e ⊗ [0, u_m]) = e_w u_m + e_v × u_m.
#pragma unroll
    for (int k = 0; k < 3; ++k) raw[3 + k][18 + m] = (k == m ? e[0] : T(0)) + Se[k][m];
    // θ_i: -vec(Δq'* ⊗ [0, u_m] ⊗ f).
    T u[4] = {T(0), T(0), T(0), T(0)};
    u[1 + m] = T(1);
    T t[4], t2[4];
    qmul(c, u, t);
    qmul(t, f, t2);
    // bg_i: 2 vec((dh* ⊗ f) / |h| - e (h · dh) / |h|²), dh = Δq ⊗ [0, ½ J_q,bg u_m].
    const T x[4] = {T(0), T(0.5) * J[3 * 15 + 12 + m], T(0.5) * J[4 * 15 + 12 + m],
                    T(0.5) * J[5 * 15 + 12 + m]};
    T dh[4], cf[4];
    qmul(d0, x, dh);
    const T dot = h[0] * dh[0] + h[1] * dh[1] + h[2] * dh[2] + h[3] * dh[3];
    const T dhc[4] = {dh[0], -dh[1], -dh[2], -dh[3]};
    qmul(dhc, f, cf);
    const T de = dot * inh * inh;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      raw[3 + k][3 + m] = -t2[1 + k];
      raw[3 + k][12 + m] = T(2) * (cf[1 + k] * inh - e[1 + k] * de);
    }
  }
}

// The warp's raw rows of interval w, in `raw` (lane 0 r_p, r_v and the
// biases; lane 1 r_q), then whitened into `out` (with JAC all 31 columns,
// else the residual's alone): out = sqrt_info raw.
template <typename T, bool JAC>
__device__ void interval_rows(const ImuArgs<T>& g, int w, int lane, T (*raw)[RAW],
                              T (*out)[RAW]) {
  if (JAC)
    for (int idx = lane; idx < 15 * RAW; idx += 32) raw[idx / RAW][idx % RAW] = T(0);
  __syncwarp();
  if (lane == 0)
    raw_pv<T, JAC>(g, w, raw);
  else if (lane == 1)
    raw_q<T, JAC>(g, w, raw);
  __syncwarp();
  const T* si = g.si + 225 * w;
  const int ncol = JAC ? RAW : 1, c0 = JAC ? 0 : 30;
  for (int idx = lane; idx < 15 * ncol; idx += 32) {
    const int r = idx / ncol, c = c0 + idx % ncol;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 15; ++k) acc += si[r * 15 + k] * raw[k][c];
    out[r][c] = acc;
  }
  __syncwarp();
}

template <typename T, bool ROWS>
__global__ void __launch_bounds__(32 * ROWS_WARPS)
imu_rows_kernel(const ImuArgs<T> g, T* __restrict__ r_out, T* __restrict__ J_out,
                T* __restrict__ cost) {
  // A warp an interval; an invalid one is written as exact zeros. The warps
  // share nothing, so a finished warp may leave.
  __shared__ T raw_s[ROWS_WARPS][15][RAW];
  __shared__ T out_s[ROWS_WARPS][15][RAW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * ROWS_WARPS + warp;
  if (w >= g.W) return;
  T(*out)[RAW] = out_s[warp];
  const bool ok = g.valid[w];
  if (ok) interval_rows<T, ROWS>(g, w, lane, raw_s[warp], out);
  if (ROWS) {
    for (int idx = lane; idx < 15 * 30; idx += 32)
      J_out[450 * w + idx] = ok ? out[idx / 30][idx % 30] : T(0);
    if (lane < 15) r_out[15 * w + lane] = ok ? out[lane][30] : T(0);
  } else {
    T x = (ok && lane < 15) ? out[lane][30] : T(0);
    x *= x;
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) cost[w] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(NRM_THREADS)
imu_normal_kernel(const ImuArgs<T> g, int D, T* __restrict__ H, T* __restrict__ b,
                  T* __restrict__ cost) {
  // Block k: warp 0 the rows of interval k - 1 (frame k is its j side),
  // warp 1 those of interval k (frame k its i side); zero rows where the
  // interval does not exist or is invalid.
  __shared__ T raw_s[2][15][RAW];
  __shared__ T Jw[2][15][RAW];
  const int k = blockIdx.x, W1 = g.W + 1, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int w = k - 1 + warp;
  if (w >= 0 && w < g.W && g.valid[w]) {
    interval_rows<T, true>(g, w, lane, raw_s[warp], Jw[warp]);
  } else {
    for (int idx = lane; idx < 15 * RAW; idx += 32) Jw[warp][idx / RAW][idx % RAW] = T(0);
  }
  __syncthreads();
  // Column of frame f's local index l (0..5 pose, 6..14 speed-bias).
  auto col = [W1](int f, int l) { return l < 6 ? 6 * f + l : 6 * W1 + 9 * f + (l - 6); };
  for (int idx = tid; idx < 225; idx += NRM_THREADS) {
    const int a = idx / 15, c = idx % 15;
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < 15; ++r) acc += Jw[0][r][15 + a] * Jw[0][r][15 + c];
#pragma unroll
    for (int r = 0; r < 15; ++r) acc += Jw[1][r][a] * Jw[1][r][c];
    H[(size_t)col(k, a) * D + col(k, c)] += acc;
  }
  if (k < g.W) {
    for (int idx = tid; idx < 225; idx += NRM_THREADS) {
      const int a = idx / 15, c = idx % 15;
      T acc = T(0);
#pragma unroll
      for (int r = 0; r < 15; ++r) acc += Jw[1][r][a] * Jw[1][r][15 + c];
      H[(size_t)col(k, a) * D + col(k + 1, c)] += acc;
      H[(size_t)col(k + 1, c) * D + col(k, a)] += acc;
    }
  }
  if (tid < 15) {
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < 15; ++r) acc += Jw[0][r][15 + tid] * Jw[0][r][30];
#pragma unroll
    for (int r = 0; r < 15; ++r) acc += Jw[1][r][tid] * Jw[1][r][30];
    b[col(k, tid)] += acc;
  } else if (tid == 32 && k < g.W) {
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < 15; ++r) acc += Jw[1][r][30] * Jw[1][r][30];
    cost[k] = acc;
  }
}

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
  const int grid = (g.W + ROWS_WARPS - 1) / ROWS_WARPS;
  if (rows)
    imu_rows_kernel<T, true><<<grid, 32 * ROWS_WARPS, 0, stream>>>(g, (T*)r, (T*)J30, nullptr);
  else
    imu_rows_kernel<T, false><<<grid, 32 * ROWS_WARPS, 0, stream>>>(g, nullptr, nullptr, (T*)cost);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_normal(IMU_IN_PARAMS, int W1, int D, void* H_pp, void* b_p, void* cost,
                  cudaStream_t stream) {
  const ImuArgs<T> g = imu_args<T>(IMU_IN_ARGS, W1 - 1);
  imu_normal_kernel<T><<<W1, NRM_THREADS, 0, stream>>>(g, D, (T*)H_pp, (T*)b_p, (T*)cost);
  return (int)cudaGetLastError();
}

}  // namespace

// The inputs, all on the card: the state's p, q, v, ba, bg [W1, ·]; the
// preintegration's delta_p, delta_q, delta_v [W, ·], jacobian [W, 15, 15],
// sum_dt [W], linearized_ba, linearized_bg [W, 3]; sqrt_info [W, 15, 15];
// gravity [3]; imu_valid [W] (bool); W = W1 - 1. dtype 0 float32, 1 float64.
// mode 1: rows (r [W, 15], J30 [W, 15, 30]); mode 0: cost alone ([W]; r and
// J30 may be null).
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
