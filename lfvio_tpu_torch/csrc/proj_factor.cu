// The projection factor of the sliding-window bundle adjustment on Hopper,
// float32 or float64: per observation the unit-sphere + td residual and its
// analytic 2 x 26 Jacobian (rows mode), or its robust cost term alone (cost
// mode), and the sums of the whitened rows into the normal equations
// H_pp [D, D], b_p [D], H_pl [D, F], H_ll [F] and b_l [F] (assemble).
//
// Replaces what XLA computes inside the JAX package's jitted solve and
// MARGIN_OLD programs: lfvio_tpu/backend/solver.py:126 linearize_projection
// (forward-mode autodiff over the 26 tangents, vmapped over the [F, W+1]
// grid), :184 linearize_proj_rows (the dense [F, W+1, 2, D] rows) and :287
// assemble_normal_equations (their Jᵀ J); there is no Pallas kernel behind
// them. The port ran the same form as thousands of small kernels a solve.
//
// The math is backend/factors.py::projection_jacobian's, formula for
// formula (its docstring has the chain): with G = s B N (B the tangent
// basis at the measured bearing, N = (I - u uᵀ)/n the normalization's
// Jacobian), every column block is G times a 3 x 3 or 3 x 1 factor, formed
// left to right as there.
//
// What bounds it on an H100: latency. At bench.py's high-rate size (384
// slots, window 20: 8064 observations, D = 322) the rows are about 1.3 MB
// and 27 MFLOP, both far below a microsecond of the card. The design is
// simple and deterministic:
//
//  * proj_rows_kernel: one thread per observation. Every state quantity is
//    read through a device pointer (the kernels run inside CUDA graphs whose
//    state changes between replays); only configuration constants are
//    scalar arguments. An observation the mask drops (invalid, unused slot,
//    the anchor itself) is skipped and written as exact zeros (weight 1).
//  * proj_assemble_kernel: one launch, three kinds of blocks, no atomics,
//    so a repeat is bit-identical. (1) One block per tile of H_pp over the
//    active column blocks (a pose of each frame, an extrinsic of each
//    camera, td), upper triangle, mirrored: each thread sums a fixed
//    stride of the observations that touch the tile, then a fixed shuffle
//    tree and the warps in order. The diagonal tiles also write b_p.
//    (2) One block per feature: its H_pl column, H_ll and b_l, each entry
//    summed over the frames in order. (3) One block per speed-bias row,
//    which no projection touches: zeros in its row and column.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_THREADS = 128;
constexpr int ASM_THREADS = 128;
constexpr int ASM_WARPS = ASM_THREADS / 32;
constexpr int NACC = 6 * 6 + 6;  // a tile's sums and its b_p part

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

template <typename T>
__device__ __forceinline__ T sqrt_t(T x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ void tangent_basis(const T* a, T B[2][3]) {
  // geom/rotations.py::tangent_basis.
  const bool is_z = fabs(a[0]) < T(1e-12) && fabs(a[1]) < T(1e-12) &&
                    fabs(a[2] - T(1)) < T(1e-12);
  const T tmp[3] = {is_z ? T(1) : T(0), T(0), is_z ? T(0) : T(1)};
  const T d = a[0] * tmp[0] + a[1] * tmp[1] + a[2] * tmp[2];
  T b1[3];
  for (int k = 0; k < 3; ++k) b1[k] = tmp[k] - a[k] * d;
  const T nb = sqrt_t(b1[0] * b1[0] + b1[1] * b1[1] + b1[2] * b1[2]);
  for (int k = 0; k < 3; ++k) B[0][k] = b1[k] / nb;
  B[1][0] = a[1] * B[0][2] - a[2] * B[0][1];
  B[1][1] = a[2] * B[0][0] - a[0] * B[0][2];
  B[1][2] = a[0] * B[0][1] - a[1] * B[0][0];
}

// Y = X M (2 x 3 by 3 x 3); MT: M transposed.
template <typename T, bool MT>
__device__ __forceinline__ void mul23(T X[2][3], T M[3][3], T Y[2][3]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T acc = X[r][0] * (MT ? M[b][0] : M[0][b]);
      acc += X[r][1] * (MT ? M[b][1] : M[1][b]);
      acc += X[r][2] * (MT ? M[b][2] : M[2][b]);
      Y[r][b] = acc;
    }
}

// Y = X [v]x (2 x 3).
template <typename T>
__device__ __forceinline__ void mul_skew(T X[2][3], const T v[3], T Y[2][3]) {
  T S[3][3] = {{T(0), -v[2], v[1]}, {v[2], T(0), -v[0]}, {-v[1], v[0], T(0)}};
  mul23<T, false>(X, S, Y);
}

// out[0..2] of row r (stride 26 between the rows) = sign * X[r][:].
template <typename T>
__device__ __forceinline__ void put_block(T* J, int col, T X[2][3], T sign) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int b = 0; b < 3; ++b) J[r * 26 + col + b] = sign * X[r][b];
}

template <typename T, bool ROWS>
__global__ void __launch_bounds__(ROWS_THREADS)
proj_rows_kernel(const T* __restrict__ p, const T* __restrict__ q, const T* __restrict__ tic,
                 const T* __restrict__ qic, const T* __restrict__ td,
                 const T* __restrict__ inv_depth, const T* __restrict__ bearing,
                 const T* __restrict__ velocity, const T* __restrict__ td_obs,
                 const bool* __restrict__ valid, const int64_t* __restrict__ anchor,
                 const bool* __restrict__ used, const int64_t* __restrict__ cam, int F, int W1,
                 int C, T s, T c, T* __restrict__ res, T* __restrict__ J26,
                 T* __restrict__ w_out, T* __restrict__ cost) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= F * W1) return;
  const int f = o / W1, j = o - f * W1;
  const int64_t a64 = anchor[f];
  const int a = (int)a64;
  const int ia = f * W1 + a;
  bool ok = valid[o] && used[f] && a64 != j && a64 >= 0 && a64 < W1;
  const int ci = (ok && cam) ? (int)cam[ia] : 0;
  const int cj = (ok && cam) ? (int)cam[o] : 0;
  ok = ok && ci >= 0 && ci < C && cj >= 0 && cj < C;
  if (!ok) {
    if (ROWS) {
      res[2 * o] = T(0);
      res[2 * o + 1] = T(0);
      for (int k = 0; k < 52; ++k) J26[52 * o + k] = T(0);
      w_out[o] = T(1);
    }
    cost[o] = T(0);
    return;
  }
  T Ri[3][3], Rj[3][3], Rci[3][3], Rcj[3][3];
  quat_mat(q + 4 * a, Ri);
  quat_mat(q + 4 * j, Rj);
  quat_mat(qic + 4 * ci, Rci);
  quat_mat(qic + 4 * cj, Rcj);
  const T tdv = td[0];
  const T* bi = bearing + 3 * ia;
  const T* vi = velocity + 3 * ia;
  const T* bj = bearing + 3 * o;
  const T* vj = velocity + 3 * o;
  const T dti = tdv - td_obs[ia], dtj = tdv - td_obs[o];
  T rho_i[3], rho_j[3];
  for (int k = 0; k < 3; ++k) {
    rho_i[k] = bi[k] - dti * vi[k];
    rho_j[k] = bj[k] - dtj * vj[k];
  }
  const T lam_raw = inv_depth[f];
  const bool small = fabs(lam_raw) < T(1e-8);
  const T lam = small ? T(1e-8) : lam_raw;
  T Pci[3], Pbi[3], Pw[3], Pbj[3], Pcj[3], t[3];
  for (int k = 0; k < 3; ++k) Pci[k] = rho_i[k] / lam;
  for (int k = 0; k < 3; ++k)
    Pbi[k] = (Rci[k][0] * Pci[0] + Rci[k][1] * Pci[1] + Rci[k][2] * Pci[2]) + tic[3 * ci + k];
  for (int k = 0; k < 3; ++k)
    Pw[k] = (Ri[k][0] * Pbi[0] + Ri[k][1] * Pbi[1] + Ri[k][2] * Pbi[2]) + p[3 * a + k];
  for (int k = 0; k < 3; ++k) t[k] = Pw[k] - p[3 * j + k];
  for (int k = 0; k < 3; ++k) Pbj[k] = Rj[0][k] * t[0] + Rj[1][k] * t[1] + Rj[2][k] * t[2];
  for (int k = 0; k < 3; ++k) t[k] = Pbj[k] - tic[3 * cj + k];
  for (int k = 0; k < 3; ++k) Pcj[k] = Rcj[0][k] * t[0] + Rcj[1][k] * t[1] + Rcj[2][k] * t[2];
  const T n_raw = sqrt_t(Pcj[0] * Pcj[0] + Pcj[1] * Pcj[1] + Pcj[2] * Pcj[2]);
  const T n = n_raw >= T(1e-12) ? n_raw : T(1e-12);
  const T m_raw = sqrt_t(rho_j[0] * rho_j[0] + rho_j[1] * rho_j[1] + rho_j[2] * rho_j[2]);
  const T m = m_raw >= T(1e-12) ? m_raw : T(1e-12);
  T u[3], mh[3], e[3];
  for (int k = 0; k < 3; ++k) {
    u[k] = Pcj[k] / n;
    mh[k] = rho_j[k] / m;
    e[k] = u[k] - mh[k];
  }
  T B[2][3];
  tangent_basis(bj, B);
  const T r0 = s * (B[0][0] * e[0] + B[0][1] * e[1] + B[0][2] * e[2]);
  const T r1 = s * (B[1][0] * e[0] + B[1][1] * e[1] + B[1][2] * e[2]);
  const T sq = r0 * r0 + r1 * r1;
  const T c2 = c * c;
  cost[o] = c2 * log1p(sq / c2);
  if (!ROWS) return;
  res[2 * o] = r0;
  res[2 * o + 1] = r1;
  w_out[o] = sqrt_t(T(1) / (T(1) + sq / c2));

  // G = s (B N), N = (I - u uᵀ) / n (no uuᵀ where the norm is clamped).
  const bool nu = n_raw >= T(1e-12);
  T N[3][3];
  for (int x = 0; x < 3; ++x)
    for (int y = 0; y < 3; ++y) N[x][y] = ((x == y ? T(1) : T(0)) - (nu ? u[x] * u[y] : T(0))) / n;
  T G[2][3];
  mul23<T, false>(B, N, G);
  for (int r = 0; r < 2; ++r)
    for (int b = 0; b < 3; ++b) G[r][b] = s * G[r][b];
  T GRc[2][3], GA[2][3], GAR[2][3], GARR[2][3], X[2][3];
  mul23<T, true>(G, Rcj, GRc);   // G R_cjᵀ
  mul23<T, true>(GRc, Rj, GA);   // G A, A = R_cjᵀ R_jᵀ
  mul23<T, false>(GA, Ri, GAR);  // G A R_i
  mul23<T, false>(GAR, Rci, GARR);  // G A R_i R_ci
  T* Jo = J26 + 52 * o;
  put_block(Jo, 0, GA, T(1));
  mul_skew(GAR, Pbi, X);
  put_block(Jo, 3, X, T(-1));
  put_block(Jo, 6, GA, T(-1));
  mul_skew(GRc, Pbj, X);
  put_block(Jo, 9, X, T(1));
  put_block(Jo, 12, GAR, T(1));
  mul_skew(GARR, Pci, X);
  put_block(Jo, 15, X, T(-1));
  put_block(Jo, 18, GRc, T(-1));
  mul_skew(G, Pcj, X);
  put_block(Jo, 21, X, T(1));
  // δλ: -G A R_i R_ci ρ_i / λ̃² (0 where λ is clamped), as
  // -G (R_cjᵀ t_cj + A (p_j - p_i - R_i t_ci)) / λ̃ (+ -G P_cj / λ̃ where n is
  // clamped; else N P_cj = 0): the baseline's part alone, free of the
  // cancellation of the first form (projection_jacobian's docstring).
  // δtd: -G A R_i R_ci vel_i / λ̃ + s B (I - m̂ m̂ᵀ) vel_j / m.
  T dd[3];
  for (int k = 0; k < 3; ++k)
    dd[k] = p[3 * j + k] - p[3 * a + k] -
            (Ri[k][0] * tic[3 * ci] + Ri[k][1] * tic[3 * ci + 1] + Ri[k][2] * tic[3 * ci + 2]);
  const T* tcj = tic + 3 * cj;
  const bool mu = m_raw >= T(1e-12);
  T Mv[3];
  for (int x = 0; x < 3; ++x) {
    T acc = T(0);
    for (int y = 0; y < 3; ++y)
      acc += (((x == y) ? T(1) : T(0)) - (mu ? mh[x] * mh[y] : T(0))) / m * vj[y];
    Mv[x] = acc;
  }
  for (int r = 0; r < 2; ++r) {
    T gl = (GRc[r][0] * tcj[0] + GRc[r][1] * tcj[1] + GRc[r][2] * tcj[2]) +
           (GA[r][0] * dd[0] + GA[r][1] * dd[1] + GA[r][2] * dd[2]);
    if (!nu) gl += G[r][0] * Pcj[0] + G[r][1] * Pcj[1] + G[r][2] * Pcj[2];
    Jo[r * 26 + 24] = small ? T(0) : -gl / lam;
    const T gv = GARR[r][0] * vi[0] + GARR[r][1] * vi[1] + GARR[r][2] * vi[2];
    const T h = s * (B[r][0] * Mv[0] + B[r][1] * Mv[1] + B[r][2] * Mv[2]);
    Jo[r * 26 + 25] = -gv / lam + h;
  }
}

// The columns of an active block: W1 poses (6 each, at 6k), C extrinsics
// (6 each, at 15 W1 + 6e), td (1, at D - 1).
struct Block {
  int kind;  // 0 pose, 1 extrinsic, 2 td
  int idx;
  int col;
  int size;
};

__device__ __forceinline__ Block active_block(int blk, int W1, int C) {
  if (blk < W1) return {0, blk, 6 * blk, 6};
  if (blk < W1 + C) return {1, blk - W1, 15 * W1 + 6 * (blk - W1), 6};
  return {2, 0, 15 * W1 + 6 * C, 1};
}

// Does observation (j, a, ci, cj) reach block b's columns?
__device__ __forceinline__ bool touches(const Block& b, int j, int a, int ci, int cj, bool ex,
                                        bool tdf) {
  if (b.kind == 0) return b.idx == j || b.idx == a;
  if (b.kind == 1) return ex && (b.idx == cj || b.idx == ci);
  return tdf;
}

// The weighted row r of observation o in block b's columns (the dense
// layout of linearize_proj_rows: the anchor-side pose block at frame a, the
// observer-side at j; the observer-side extrinsic block at cj plus the
// anchor-side at ci).
template <typename T>
__device__ __forceinline__ void block_row(const Block& b, const T* Jr, T wv, int j, int a,
                                          int ci, int cj, bool ex, bool tdf, T out[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k] = T(0);
  if (b.kind == 0) {
    const int off = b.idx == j ? 6 : 0;
    if (b.idx == j || b.idx == a)
#pragma unroll
      for (int k = 0; k < 6; ++k) out[k] = Jr[off + k] * wv;
  } else if (b.kind == 1) {
    if (!ex) return;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const T xj = b.idx == cj ? Jr[18 + k] * wv : T(0);
      const T xi = b.idx == ci ? Jr[12 + k] * wv : T(0);
      out[k] = xj + xi;
    }
  } else if (tdf) {
    out[0] = Jr[25] * wv;
  }
}

template <typename T>
__device__ __forceinline__ bool obs_mask(int o, int f, int j, const bool* valid,
                                         const int64_t* anchor, const bool* used,
                                         const int64_t* cam, int W1, int C, int& a, int& ci,
                                         int& cj) {
  const int64_t a64 = anchor[f];
  if (!(valid[o] && used[f] && a64 != j && a64 >= 0 && a64 < W1)) return false;
  a = (int)a64;
  ci = cam ? (int)cam[f * W1 + a] : 0;
  cj = cam ? (int)cam[o] : 0;
  return ci >= 0 && ci < C && cj >= 0 && cj < C;
}

template <typename T>
__global__ void __launch_bounds__(ASM_THREADS)
proj_assemble_kernel(const T* __restrict__ res, const T* __restrict__ J26,
                     const T* __restrict__ w, const bool* __restrict__ valid,
                     const int64_t* __restrict__ anchor, const bool* __restrict__ used,
                     const int64_t* __restrict__ cam, int F, int W1, int C, int ex_i, int td_i,
                     T* __restrict__ H_pp, T* __restrict__ b_p, T* __restrict__ H_pl,
                     T* __restrict__ H_ll, T* __restrict__ b_l) {
  const bool ex = ex_i != 0, tdf = td_i != 0;
  const int D = 15 * W1 + 6 * C + 1;
  const int NA = W1 + C + 1;
  const int n_tiles = NA * (NA + 1) / 2;
  const int tid = threadIdx.x;
  int blk = blockIdx.x;

  if (blk < n_tiles) {  // (1) a tile (A, B) of H_pp, A <= B
    int A = 0;
    while (blk >= NA - A) {
      blk -= NA - A;
      ++A;
    }
    const int Bi = A + blk;
    const Block ba = active_block(A, W1, C), bb = active_block(Bi, W1, C);
    T acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = T(0);
    for (int o = tid; o < F * W1; o += ASM_THREADS) {
      const int f = o / W1, j = o - f * W1;
      int a, ci, cj;
      if (!obs_mask<T>(o, f, j, valid, anchor, used, cam, W1, C, a, ci, cj)) continue;
      if (!touches(ba, j, a, ci, cj, ex, tdf) || !touches(bb, j, a, ci, cj, ex, tdf)) continue;
      const T wv = w[o];
      const T* Jo = J26 + 52 * o;
      T xa0[6], xa1[6], xb0[6], xb1[6];
      block_row(ba, Jo, wv, j, a, ci, cj, ex, tdf, xa0);
      block_row(ba, Jo + 26, wv, j, a, ci, cj, ex, tdf, xa1);
      block_row(bb, Jo, wv, j, a, ci, cj, ex, tdf, xb0);
      block_row(bb, Jo + 26, wv, j, a, ci, cj, ex, tdf, xb1);
#pragma unroll
      for (int x = 0; x < 6; ++x)
#pragma unroll
        for (int y = 0; y < 6; ++y) acc[6 * x + y] += xa0[x] * xb0[y] + xa1[x] * xb1[y];
      if (A == Bi) {
        const T rw0 = res[2 * o] * wv, rw1 = res[2 * o + 1] * wv;
#pragma unroll
        for (int x = 0; x < 6; ++x) acc[36 + x] += xa0[x] * rw0 + xa1[x] * rw1;
      }
    }
    // A fixed tree within each warp, then the warps in order.
    __shared__ T part[ASM_WARPS][NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      T v = acc[k];
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_down_sync(0xffffffffu, v, sh);
      if ((tid & 31) == 0) part[tid >> 5][k] = v;
    }
    __syncthreads();
    if (tid < NACC) {
      T v = part[0][tid];
      for (int wi = 1; wi < ASM_WARPS; ++wi) v += part[wi][tid];
      if (tid < 36) {
        const int x = tid / 6, y = tid - 6 * (tid / 6);
        if (x < ba.size && y < bb.size) {
          H_pp[(ba.col + x) * D + bb.col + y] = v;
          if (A != Bi) H_pp[(bb.col + y) * D + ba.col + x] = v;
        }
      } else if (A == Bi && tid - 36 < ba.size) {
        b_p[ba.col + tid - 36] = v;
      }
    }
    return;
  }
  blk -= n_tiles;
  if (blk < F) {  // (2) feature f: its H_pl column, H_ll and b_l
    const int f = blk;
    for (int d = tid; d < D; d += ASM_THREADS) {
      Block b;
      int k = 0;
      bool sb = false;
      if (d < 6 * W1) {
        b = active_block(d / 6, W1, C);
        k = d - 6 * (d / 6);
      } else if (d < 15 * W1) {
        sb = true;
      } else if (d < D - 1) {
        const int e = (d - 15 * W1) / 6;
        b = active_block(W1 + e, W1, C);
        k = d - 15 * W1 - 6 * e;
      } else {
        b = active_block(W1 + C, W1, C);
      }
      T acc = T(0);
      if (!sb) {
        for (int j = 0; j < W1; ++j) {
          const int o = f * W1 + j;
          int a, ci, cj;
          if (!obs_mask<T>(o, f, j, valid, anchor, used, cam, W1, C, a, ci, cj)) continue;
          if (!touches(b, j, a, ci, cj, ex, tdf)) continue;
          const T wv = w[o];
          const T* Jo = J26 + 52 * o;
          T x0[6], x1[6];
          block_row(b, Jo, wv, j, a, ci, cj, ex, tdf, x0);
          block_row(b, Jo + 26, wv, j, a, ci, cj, ex, tdf, x1);
          acc += x0[k] * (Jo[24] * wv) + x1[k] * (Jo[26 + 24] * wv);
        }
      }
      H_pl[(size_t)d * F + f] = acc;
    }
    if (tid == 0) {
      T hll = T(0), bl = T(0);
      for (int j = 0; j < W1; ++j) {
        const int o = f * W1 + j;
        int a, ci, cj;
        if (!obs_mask<T>(o, f, j, valid, anchor, used, cam, W1, C, a, ci, cj)) continue;
        const T wv = w[o];
        const T l0 = J26[52 * o + 24] * wv, l1 = J26[52 * o + 26 + 24] * wv;
        hll += l0 * l0 + l1 * l1;
        bl += l0 * (res[2 * o] * wv) + l1 * (res[2 * o + 1] * wv);
      }
      H_ll[f] = hll;
      b_l[f] = bl;
    }
    return;
  }
  blk -= F;  // (3) speed-bias row 6 W1 + blk: zeros in its row and column
  const int z = 6 * W1 + blk;
  for (int d = tid; d < D; d += ASM_THREADS) {
    H_pp[(size_t)z * D + d] = T(0);
    if (d < 6 * W1 || d >= 15 * W1) H_pp[(size_t)d * D + z] = T(0);
  }
  if (tid == 0) b_p[z] = T(0);
}

template <typename T>
int launch_rows(const void* p, const void* q, const void* tic, const void* qic, const void* td,
                const void* inv_depth, const void* bearing, const void* velocity,
                const void* td_obs, const void* valid, const void* anchor, const void* used,
                const void* cam, int F, int W1, int C, double s, double c, int rows, void* res,
                void* J26, void* w, void* cost, cudaStream_t stream) {
  const int n = F * W1;
  const int grid = (n + ROWS_THREADS - 1) / ROWS_THREADS;
#define PROJ_ROWS_ARGS                                                                      \
  (const T*)p, (const T*)q, (const T*)tic, (const T*)qic, (const T*)td, (const T*)inv_depth, \
      (const T*)bearing, (const T*)velocity, (const T*)td_obs, (const bool*)valid,           \
      (const int64_t*)anchor, (const bool*)used, (const int64_t*)cam, F, W1, C, (T)s, (T)c,  \
      (T*)res, (T*)J26, (T*)w, (T*)cost
  if (rows)
    proj_rows_kernel<T, true><<<grid, ROWS_THREADS, 0, stream>>>(PROJ_ROWS_ARGS);
  else
    proj_rows_kernel<T, false><<<grid, ROWS_THREADS, 0, stream>>>(PROJ_ROWS_ARGS);
#undef PROJ_ROWS_ARGS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_assemble(const void* res, const void* J26, const void* w, const void* valid,
                    const void* anchor, const void* used, const void* cam, int F, int W1, int C,
                    int ex, int tdf, void* H_pp, void* b_p, void* H_pl, void* H_ll, void* b_l,
                    cudaStream_t stream) {
  const int NA = W1 + C + 1;
  const int grid = NA * (NA + 1) / 2 + F + 9 * W1;
  proj_assemble_kernel<T><<<grid, ASM_THREADS, 0, stream>>>(
      (const T*)res, (const T*)J26, (const T*)w, (const bool*)valid, (const int64_t*)anchor,
      (const bool*)used, (const int64_t*)cam, F, W1, C, ex, tdf, (T*)H_pp, (T*)b_p, (T*)H_pl,
      (T*)H_ll, (T*)b_l);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 1: rows (res [F, W1, 2], J26 [F, W1, 2, 26], w [F, W1], cost [F,
// W1]); mode 0: cost alone (res, J26 and w may be null). cam may be null
// (every observation from camera 0). dtype 0 float32, 1 float64.
extern "C" int proj_rows_launch(const void* p, const void* q, const void* tic, const void* qic,
                                const void* td, const void* inv_depth, const void* bearing,
                                const void* velocity, const void* td_obs, const void* valid,
                                const void* anchor, const void* used, const void* cam, int F,
                                int W1, int C, double sqrt_info, double cauchy_c, int mode,
                                int dtype, void* res, void* J26, void* w, void* cost,
                                void* stream) {
  if (F < 0 || W1 < 1 || C < 1 || (mode != 0 && mode != 1) || (dtype != 0 && dtype != 1))
    return -1;
  if (F == 0) return 0;
  return dtype ? launch_rows<double>(p, q, tic, qic, td, inv_depth, bearing, velocity, td_obs,
                                     valid, anchor, used, cam, F, W1, C, sqrt_info, cauchy_c,
                                     mode, res, J26, w, cost, (cudaStream_t)stream)
               : launch_rows<float>(p, q, tic, qic, td, inv_depth, bearing, velocity, td_obs,
                                    valid, anchor, used, cam, F, W1, C, sqrt_info, cauchy_c,
                                    mode, res, J26, w, cost, (cudaStream_t)stream);
}

// H_pp [D, D], b_p [D], H_pl [D, F], H_ll [F], b_l [F], every entry
// written; D = 15 W1 + 6 C + 1.
extern "C" int proj_assemble_launch(const void* res, const void* J26, const void* w,
                                    const void* valid, const void* anchor, const void* used,
                                    const void* cam, int F, int W1, int C, int estimate_ex,
                                    int estimate_td, int dtype, void* H_pp, void* b_p,
                                    void* H_pl, void* H_ll, void* b_l, void* stream) {
  if (F < 0 || W1 < 1 || C < 1 || (dtype != 0 && dtype != 1)) return -1;
  if (F == 0) return 0;
  return dtype ? launch_assemble<double>(res, J26, w, valid, anchor, used, cam, F, W1, C,
                                         estimate_ex, estimate_td, H_pp, b_p, H_pl, H_ll, b_l,
                                         (cudaStream_t)stream)
               : launch_assemble<float>(res, J26, w, valid, anchor, used, cam, F, W1, C,
                                        estimate_ex, estimate_td, H_pp, b_p, H_pl, H_ll, b_l,
                                        (cudaStream_t)stream);
}
