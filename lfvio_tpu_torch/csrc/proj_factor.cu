// The projection factor of the sliding-window bundle adjustment on Hopper,
// float32 or float64: per observation the unit-sphere + td residual, its
// analytic 2 x 26 Jacobian and its robust cost term (proj_rows_kernel, rows
// mode; cost mode: the cost term alone), and the normal equations of one
// linearization in one launch (proj_normal_kernel): the whitened rows summed
// into H_pp [D, D], b_p [D], H_pl [D, F], H_ll [F] and b_l [F], beside the
// cost terms [F, W1], with no row written to device memory.
//
// Replaces what XLA computes inside the JAX package's jitted solve and
// MARGIN_OLD programs: lfvio_tpu/backend/solver.py:126 linearize_projection
// (forward-mode autodiff over the 26 tangents, vmapped over the [F, W+1]
// grid), :184 linearize_proj_rows (the dense [F, W+1, 2, D] rows) and :287
// assemble_normal_equations (their Jᵀ J); there is no Pallas kernel behind
// them. The LM solve's linearization is proj_normal_kernel; MARGIN_OLD's QR
// takes the dense rows of proj_rows_kernel; the LM's cost is the cost mode.
//
// The math is backend/factors.py::projection_jacobian's, formula for
// formula (its docstring has the chain): with G = s B N (B the tangent
// basis at the measured bearing, N = (I - u uᵀ)/n the normalization's
// Jacobian), every column block is G times a 3 x 3 or 3 x 1 factor, formed
// left to right as there (lin_obs). Every launch evaluates an observation
// the one way, lin_staged: from the frames and cameras its block staged.
//
// What bounds it on an H100: latency, then bytes. At the high-rate solve's
// inputs (384 slots, window 20, D = 322) a linearization reads and writes
// about 1.2 MB (H_pl the largest part) and does about 21 MFLOP
// (chip_smoke.proj_bound_ms), both far below a microsecond of the card;
// what costs is the chain of dependent loads and sums a block walks. No
// tensor cores: the products are 2 x 6 blocks, and in float32 only TF32
// reaches them, which keeps about three digits against a bound of 1e-5 of
// each output's scale.
//
// proj_rows_kernel, rows and cost modes: a thread an observation, 64-thread
// blocks (the 2,816 observations of a window-10, 256-slot solve spread over
// 44 SMs; 32 and 128 measured no better). A block stages the frames' and
// cameras' rotations and positions once (stage_issue / stage_finish, as
// proj_normal_kernel does). A thread issues every load that does not need
// its anchor at once (obs_mask has no branch between its loads: a
// short-circuit waits for each in turn), and its anchor's values while the
// block waits for the copies and forms the rotations. What bounds a cost
// launch is then its latency floor (proj_empty_kernel, nothing with the same
// grid, block, shared memory and arguments: 60% of it on an H100) and one
// thread's chain of about 330 dependent operations; the cost mode takes
// 1 / c² from the host in place of a division. The rows mode's 56 outputs an
// observation (J 52, res 2, w, cost) are 224 B, 208 B of them J: a warp's
// 52 stores of J, 208 B apart, are 32 sector writes each, and those bounded
// the launch. Each thread puts its values into shared memory (14 KB a block
// in float32), and the block writes its four ranges with 16-byte stores.
//
// proj_normal_kernel: one launch, each output entry written once by one
// block, no atomics and a fixed order of every sum, so a repeat is
// bit-identical. A block evaluates the rows it needs from the state (an
// observation that reaches three outputs is evaluated three times: cheaper
// than a round trip through device memory and a second launch), with the
// frames' and cameras' rotations and positions staged once in shared memory
// (cp.async, then each quaternion's matrix) while it loads its first
// anchors. A row is a long stream of dependent arithmetic that the SM's
// schedulers issue for every block it holds, so it takes one reciprocal
// each of λ̃, n and m in place of its divisions. The grid is clusters of 8
// blocks; a block's job follows from its index (Layout):
//
//  * heavy tiles, a cluster each: the diagonal pose tiles (A, A) of H_pp
//    (with b_p's pose block A) and, when the extrinsic or td is estimated,
//    every tile with an extrinsic or td block. Rank r of the cluster takes
//    features r, r + 8, ...; the ranks' sums meet in rank 0 through
//    distributed shared memory, in rank order. Features anchored at one
//    frame (nearly all of them at frame 0 on the bench's streams) thus
//    spread over 8 SMs.
//  * light tiles, a block each: the off-diagonal pose tiles (A, B), written
//    with their mirror; row A = 0 first, whose tiles hold the most.
//  * features, a warp each: its H_pl column (lane j the observation (f, j)),
//    H_ll, b_l and its cost terms.
//  * zeros: the rows and columns of H_pp and b_p that no projection
//    reaches: speed-bias, and the extrinsic or td ones when their estimate
//    is off.
//
// The relocalization rows (backend/relo_cuda.py) replace what XLA computes
// in the JAX package's relo solve: lfvio_tpu/backend/relo.py:75
// linearize_relo_rows (forward-mode autodiff, :108, vmapped over the
// features), its sums into the augmented [D + 6] system (:181-202) and its
// cost (:209). A relo row is a projection row whose observer is the loop
// pose seen through camera 0, with td = td_obs = 0 and zero velocities, so
// both launches evaluate it through lin_obs (relo_lin), each thread forming
// the rotations of its anchor frame, its camera, camera 0 and the loop pose
// from the quaternions it loads (relo_obs): a feature reads a few frames of
// the window, and a thread that forms them itself waits for no other.
// relo_cost_kernel is a thread a feature with nothing between its loads and
// its evaluation: no shared memory, no barrier. relo_normal_kernel adds one
// linearization's rows into the sums in place, in one cluster of
// RN_CLUSTER blocks: each block linearizes its share of the slots once, a
// thread a slot, which adds what the feature owns (its H_pl6 column, H_ll,
// b_l, whose old values it reads before linearizing) and puts its weighted
// row blocks (anchor pose, loop pose, each extrinsic when estimated, r w)
// into the block's shared memory at its place in the block's list of kept
// slots sorted by anchor (each thread counts the keys before its own; no
// atomics). Each block then sums every tile of H6 (an anchor's pose tiles
// over its segment of the list, the loop pose's and the extrinsics' over
// all of it; a diagonal tile's upper triangle and b6 block) over its own
// rows, a thread a sum, where the rows lie, each sum finding its tile in a
// table the block builds while its first loads are in flight (decoding the
// tile at each sum was that phase's larger part). Past the cluster's barrier
// each sum is added into H6 or b6 by one thread, which takes the blocks'
// partial sums through distributed shared memory in rank order: a repeat
// is bit-identical. What bounds them on an H100: latency (a launch several
// µs against a bound below 0.1 µs at the bench's 256 slots): two dependent
// trips to device memory, the chain of a linearization (about 750
// operations), then the sums and the adds.
//
// A tile block finds its observations through anchor[], not by scanning the
// grid: a pass over its features (one a thread) counts each one's
// candidates, a prefix sum in shared memory places them in a compact list,
// and the block's threads take the list in strides. Off-diagonal (A, B):
// (f, B) of the features anchored at A, (f, A) of those anchored at B.
// Diagonal (A, A), and (A, e) with e an extrinsic or td block: (f, j != A)
// of the features anchored at A, (f, A) of the others. Extrinsic and td
// tiles alone: every (f, j != anchor). Each candidate then passes obs_mask
// and touches, the rule of the dense layout (block_row), so an observation
// is summed into exactly the tiles its dense row reaches. A block's sums
// meet in a butterfly across each warp's lanes, then the warps in order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS_THREADS = 64;
constexpr int OUT_PER_OBS = 56;  // a rows-mode observation's outputs: J 52, res 2, w, cost
constexpr int NRM_THREADS = 128;
constexpr int NRM_WARPS = NRM_THREADS / 32;
constexpr int CLUSTER = 8;
constexpr int ZERO_ROWS = 4;     // H_pp rows a warp of a zero block writes
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
  const T inb = T(1) / nb;
  for (int k = 0; k < 3; ++k) B[0][k] = b1[k] * inb;
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

// Columns col..col+2 of both rows of J = sign * X.
template <typename T>
__device__ __forceinline__ void put_block(T J[2][26], int col, T X[2][3], T sign) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int b = 0; b < 3; ++b) J[r][col + b] = sign * X[r][b];
}

// One kept observation: anchor frame (R_i, p_i), observing frame (R_j,
// p_j), the anchor's and the observer's cameras (R_ci, t_ci; R_cj, t_cj),
// td, the raw inverse depth, the anchor's and the observer's bearing,
// velocity and td_obs. Gives the residual (r0, r1), its robust cost term
// and (JAC) its Cauchy weight w (held constant, IRLS) and its Jacobian J
// over [δpose_i, δpose_j, δex_i, δex_j, δλ, δtd]. ic2 = 1 / c², which the
// cost mode multiplies by in place of dividing by c².
template <typename T, bool JAC>
__device__ __forceinline__ void lin_obs(T Ri[3][3], T Rj[3][3], T Rci[3][3], T Rcj[3][3],
                                        const T* pa, const T* pj, const T* tci, const T* tcj,
                                        T tdv, T lam_raw,
                                        const T* bi, const T* vi, T tdo_i, const T* bj,
                                        const T* vj, T tdo_j, T s, T c, T ic2, T& r0, T& r1,
                                        T& w, T& cost, T J[2][26]) {
  const T dti = tdv - tdo_i, dtj = tdv - tdo_j;
  T rho_i[3], rho_j[3];
  for (int k = 0; k < 3; ++k) {
    rho_i[k] = bi[k] - dti * vi[k];
    rho_j[k] = bj[k] - dtj * vj[k];
  }
  const bool small = fabs(lam_raw) < T(1e-8);
  const T lam = small ? T(1e-8) : lam_raw;
  T Pci[3], Pbi[3], Pw[3], Pbj[3], Pcj[3], t[3];
  const T ilam = T(1) / lam;  // one division each for λ̃, n and m; products after
  for (int k = 0; k < 3; ++k) Pci[k] = rho_i[k] * ilam;
  for (int k = 0; k < 3; ++k)
    Pbi[k] = (Rci[k][0] * Pci[0] + Rci[k][1] * Pci[1] + Rci[k][2] * Pci[2]) + tci[k];
  for (int k = 0; k < 3; ++k)
    Pw[k] = (Ri[k][0] * Pbi[0] + Ri[k][1] * Pbi[1] + Ri[k][2] * Pbi[2]) + pa[k];
  for (int k = 0; k < 3; ++k) t[k] = Pw[k] - pj[k];
  for (int k = 0; k < 3; ++k) Pbj[k] = Rj[0][k] * t[0] + Rj[1][k] * t[1] + Rj[2][k] * t[2];
  for (int k = 0; k < 3; ++k) t[k] = Pbj[k] - tcj[k];
  for (int k = 0; k < 3; ++k) Pcj[k] = Rcj[0][k] * t[0] + Rcj[1][k] * t[1] + Rcj[2][k] * t[2];
  const T n_raw = sqrt_t(Pcj[0] * Pcj[0] + Pcj[1] * Pcj[1] + Pcj[2] * Pcj[2]);
  const T n = n_raw >= T(1e-12) ? n_raw : T(1e-12);
  const T m_raw = sqrt_t(rho_j[0] * rho_j[0] + rho_j[1] * rho_j[1] + rho_j[2] * rho_j[2]);
  const T m = m_raw >= T(1e-12) ? m_raw : T(1e-12);
  const T in = T(1) / n, im = T(1) / m;
  T u[3], mh[3], e[3];
  for (int k = 0; k < 3; ++k) {
    u[k] = Pcj[k] * in;
    mh[k] = rho_j[k] * im;
    e[k] = u[k] - mh[k];
  }
  T B[2][3];
  tangent_basis(bj, B);
  r0 = s * (B[0][0] * e[0] + B[0][1] * e[1] + B[0][2] * e[2]);
  r1 = s * (B[1][0] * e[0] + B[1][1] * e[1] + B[1][2] * e[2]);
  const T sq = r0 * r0 + r1 * r1;
  const T c2 = c * c;
  const T sqc = JAC ? sq / c2 : sq * ic2;
  cost = c2 * log1p(sqc);
  if (!JAC) return;
  w = sqrt_t(T(1) / (T(1) + sqc));

  // G = s (B N), N = (I - u uᵀ) / n (no uuᵀ where the norm is clamped).
  const bool nu = n_raw >= T(1e-12);
  T N[3][3];
  for (int x = 0; x < 3; ++x)
    for (int y = 0; y < 3; ++y) N[x][y] = ((x == y ? T(1) : T(0)) - (nu ? u[x] * u[y] : T(0))) * in;
  T G[2][3];
  mul23<T, false>(B, N, G);
  for (int r = 0; r < 2; ++r)
    for (int b = 0; b < 3; ++b) G[r][b] = s * G[r][b];
  T GRc[2][3], GA[2][3], GAR[2][3], GARR[2][3], X[2][3];
  mul23<T, true>(G, Rcj, GRc);      // G R_cjᵀ
  mul23<T, true>(GRc, Rj, GA);      // G A, A = R_cjᵀ R_jᵀ
  mul23<T, false>(GA, Ri, GAR);     // G A R_i
  mul23<T, false>(GAR, Rci, GARR);  // G A R_i R_ci
  put_block(J, 0, GA, T(1));
  mul_skew(GAR, Pbi, X);
  put_block(J, 3, X, T(-1));
  put_block(J, 6, GA, T(-1));
  mul_skew(GRc, Pbj, X);
  put_block(J, 9, X, T(1));
  put_block(J, 12, GAR, T(1));
  mul_skew(GARR, Pci, X);
  put_block(J, 15, X, T(-1));
  put_block(J, 18, GRc, T(-1));
  mul_skew(G, Pcj, X);
  put_block(J, 21, X, T(1));
  // δλ: -G A R_i R_ci ρ_i / λ̃² (0 where λ is clamped), as
  // -G (R_cjᵀ t_cj + A (p_j - p_i - R_i t_ci)) / λ̃ (+ -G P_cj / λ̃ where n is
  // clamped; else N P_cj = 0): the baseline's part alone, free of the
  // cancellation of the first form (projection_jacobian's docstring).
  // δtd: -G A R_i R_ci vel_i / λ̃ + s B (I - m̂ m̂ᵀ) vel_j / m.
  T dd[3];
  for (int k = 0; k < 3; ++k)
    dd[k] = pj[k] - pa[k] - (Ri[k][0] * tci[0] + Ri[k][1] * tci[1] + Ri[k][2] * tci[2]);
  const bool mu = m_raw >= T(1e-12);
  T Mv[3];
  for (int x = 0; x < 3; ++x) {
    T acc = T(0);
    for (int y = 0; y < 3; ++y)
      acc += (((x == y) ? T(1) : T(0)) - (mu ? mh[x] * mh[y] : T(0))) * im * vj[y];
    Mv[x] = acc;
  }
  for (int r = 0; r < 2; ++r) {
    T gl = (GRc[r][0] * tcj[0] + GRc[r][1] * tcj[1] + GRc[r][2] * tcj[2]) +
           (GA[r][0] * dd[0] + GA[r][1] * dd[1] + GA[r][2] * dd[2]);
    if (!nu) gl += G[r][0] * Pcj[0] + G[r][1] * Pcj[1] + G[r][2] * Pcj[2];
    J[r][24] = small ? T(0) : -gl * ilam;
    const T gv = GARR[r][0] * vi[0] + GARR[r][1] * vi[1] + GARR[r][2] * vi[2];
    const T h = s * (B[r][0] * Mv[0] + B[r][1] * Mv[1] + B[r][2] * Mv[2]);
    J[r][25] = -gv * ilam + h;
  }
}

// Is observation o = (f, j) kept (valid, a used slot, not the anchor
// itself, anchor and cameras in range)? Gives its anchor (0 where out of
// range) and cameras (meaningful where kept). Every load is issued at once,
// with no branch between them: a short-circuit would wait for each in turn.
__device__ __forceinline__ bool obs_mask(int o, int f, int j, const bool* valid,
                                         const int64_t* anchor, const bool* used,
                                         const int64_t* cam, int W1, int C, int& a, int& ci,
                                         int& cj) {
  const int64_t a64 = anchor[f];
  const bool vo = valid[o], uf = used[f];
  cj = cam ? (int)cam[o] : 0;
  const bool in = a64 >= 0 && a64 < W1;
  a = in ? (int)a64 : 0;
  ci = cam ? (int)cam[f * W1 + a] : 0;
  return vo && uf && in && a64 != j && ci >= 0 && ci < C && cj >= 0 && cj < C;
}

// ------------------------------------------------------------ the state, staged per block

// What every kernel reads: the state, the grid and its masks, the factor's
// constants.
template <typename T>
struct ProjInputs {
  const T* p;
  const T* q;
  const T* tic;
  const T* qic;
  const T* td;
  const T* inv_depth;
  const T* bearing;
  const T* velocity;
  const T* td_obs;
  const bool* valid;
  const int64_t* anchor;
  const bool* used;
  const int64_t* cam;
  int F, W1, C;
  T s, c, ic2;  // sqrt_info, the Cauchy c, 1 / c²
};

template <typename T>
__device__ __forceinline__ void cp_async_t(T* dst_shared, const T* src_global) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src_global));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src_global));
}

// The block's copy of the state's frames and cameras: 16 W1 + 16 C + 1
// values at the start of its dynamic shared memory.
template <typename T>
struct Stage {
  const T* R;   // [W1][9] frame rotations
  const T* P;   // [W1][3] frame positions
  const T* Rc;  // [C][9] camera rotations
  const T* Tc;  // [C][3] camera translations
  T td;
};

__host__ __device__ __forceinline__ size_t stage_values(int W1, int C) {
  return (size_t)16 * W1 + 16 * C + 1;
}

// Staging in two halves, by the block's NT threads: stage_issue starts the
// copies (p, q, tic, qic, td into shared memory), stage_finish waits for
// them and forms the matrices; a block loads what it needs next in between.
template <typename T, int NT>
__device__ __forceinline__ void stage_issue(const ProjInputs<T>& g, T* sm) {
  const int tid = threadIdx.x, W1 = g.W1, C = g.C;
  T* P = sm + 9 * W1;
  T* Q = P + 3 * W1;
  T* Tc = Q + 4 * W1 + 9 * C;
  T* Qc = Tc + 3 * C;
  for (int i = tid; i < 3 * W1; i += NT) cp_async_t(P + i, g.p + i);
  for (int i = tid; i < 4 * W1; i += NT) cp_async_t(Q + i, g.q + i);
  for (int i = tid; i < 3 * C; i += NT) cp_async_t(Tc + i, g.tic + i);
  for (int i = tid; i < 4 * C; i += NT) cp_async_t(Qc + i, g.qic + i);
  if (tid == 0) cp_async_t(Qc + 4 * C, g.td);
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T, int NT>
__device__ Stage<T> stage_finish(const ProjInputs<T>& g, T* sm) {
  const int tid = threadIdx.x, W1 = g.W1, C = g.C;
  T* R = sm;
  T* P = R + 9 * W1;
  T* Q = P + 3 * W1;
  T* Rc = Q + 4 * W1;
  T* Tc = Rc + 9 * C;
  T* Qc = Tc + 3 * C;
  T* TD = Qc + 4 * C;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int k = tid; k < W1 + C; k += NT) {
    T M[3][3];
    quat_mat(k < W1 ? Q + 4 * k : Qc + 4 * (k - W1), M);
    T* dst = k < W1 ? R + 9 * k : Rc + 9 * (k - W1);
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int y = 0; y < 3; ++y) dst[3 * x + y] = M[x][y];
  }
  __syncthreads();
  return {R, P, Rc, Tc, TD[0]};
}

template <typename T>
__device__ __forceinline__ void load33(const T* src, T M[3][3]) {
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int y = 0; y < 3; ++y) M[x][y] = src[3 * x + y];
}

// A kept observation o = (f, j): its frames and cameras, and what it reads
// of the grid beside the staged state (its anchor's and its own bearing,
// velocity and td_obs; the feature's inverse depth).
template <typename T>
struct Obs {
  int a, j, ci, cj;
  T lam, tdo_i, tdo_j;
  T bi[3], vi[3], bj[3], vj[3];
};

template <typename T>
__device__ __forceinline__ Obs<T> load_obs(const ProjInputs<T>& g, int o, int f, int j, int a,
                                           int ci, int cj) {
  Obs<T> x;
  x.a = a;
  x.j = j;
  x.ci = ci;
  x.cj = cj;
  const int ia = f * g.W1 + a;
  x.lam = g.inv_depth[f];
  x.tdo_i = g.td_obs[ia];
  x.tdo_j = g.td_obs[o];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x.bi[k] = g.bearing[3 * ia + k];
    x.vi[k] = g.velocity[3 * ia + k];
    x.bj[k] = g.bearing[3 * o + k];
    x.vj[k] = g.velocity[3 * o + k];
  }
  return x;
}

// lin_obs of a kept observation from the staged frames: the one
// per-observation path of every kernel here (JAC: the rows mode and
// proj_normal_kernel; else the cost mode).
template <typename T, bool JAC>
__device__ __forceinline__ void lin_staged(const ProjInputs<T>& g, const Stage<T>& S,
                                           const Obs<T>& x, T& r0, T& r1, T& w, T& cost,
                                           T J[2][26]) {
  T Ri[3][3], Rj[3][3], Rci[3][3], Rcj[3][3];
  load33(S.R + 9 * x.a, Ri);
  load33(S.R + 9 * x.j, Rj);
  load33(S.Rc + 9 * x.ci, Rci);
  load33(S.Rc + 9 * x.cj, Rcj);
  lin_obs<T, JAC>(Ri, Rj, Rci, Rcj, S.P + 3 * x.a, S.P + 3 * x.j, S.Tc + 3 * x.ci,
                  S.Tc + 3 * x.cj, S.td, x.lam, x.bi, x.vi, x.tdo_i, x.bj, x.vj, x.tdo_j, g.s,
                  g.c, g.ic2, r0, r1, w, cost, J);
}

// ------------------------------------------------------------ proj_rows_kernel

template <typename T>
struct RowsArgs : ProjInputs<T> {
  T* res;
  T* J26;
  T* w;
  T* cost;
};

// Dynamic shared memory of a rows or cost block: the staged state, then
// (rows) the block's outputs, J [ROWS_THREADS][52], res [ROWS_THREADS][2],
// w and cost, each range 16-byte aligned.
template <typename T>
__host__ __device__ __forceinline__ size_t rows_out_offset(int W1, int C) {
  return (stage_values(W1, C) * sizeof(T) + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ __forceinline__ size_t rows_smem(int W1, int C, bool rows) {
  return rows_out_offset<T>(W1, C) + (rows ? (size_t)OUT_PER_OBS * ROWS_THREADS * sizeof(T) : 0);
}

// count values from shared memory to device memory, both 16-byte aligned,
// by the block's threads: 16-byte stores, then what is left a value a thread.
template <typename T>
__device__ __forceinline__ void store_range(T* __restrict__ dst, const T* src, int count) {
  constexpr int V = 16 / sizeof(T);
  const int nv = count / V;
  for (int i = threadIdx.x; i < nv; i += ROWS_THREADS)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  for (int i = nv * V + threadIdx.x; i < count; i += ROWS_THREADS) dst[i] = src[i];
}

// A thread an observation o; a dropped one is written as exact zeros
// (weight 1). The state's copies, the masks, the anchor and the
// observation's own values load at once; its anchor's values load when
// the anchor is in, while the block waits for the copies and forms the
// rotations. Threads past the grid's end load the last observation and
// write nothing.
template <typename T, bool ROWS>
__global__ void __launch_bounds__(ROWS_THREADS) proj_rows_kernel(const RowsArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, W1 = g.W1, n = g.F * W1;
  const int o0 = blockIdx.x * ROWS_THREADS, o = o0 + tid, oc = min(o, n - 1);
  stage_issue<T, ROWS_THREADS>(g, sm);
  const int f = oc / W1, j = oc - f * W1;
  int a, ci, cj;
  const bool kept =
      obs_mask(oc, f, j, g.valid, g.anchor, g.used, g.cam, W1, g.C, a, ci, cj) && o < n;
  const Obs<T> x = load_obs(g, oc, f, j, a, ci, cj);
  const Stage<T> S = stage_finish<T, ROWS_THREADS>(g, sm);
  T r0 = T(0), r1 = T(0), w = T(1), cost = T(0), J[2][26] = {};
  if (kept) lin_staged<T, ROWS>(g, S, x, r0, r1, w, cost, J);
  if (!ROWS) {
    if (o < n) g.cost[o] = cost;
    return;
  }
  T* oJ = reinterpret_cast<T*>(smem_raw + rows_out_offset<T>(W1, g.C));
  T* oR = oJ + 52 * ROWS_THREADS;
  T* oW = oR + 2 * ROWS_THREADS;
  T* oC = oW + ROWS_THREADS;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 26; ++k) oJ[52 * tid + 26 * r + k] = J[r][k];
  oR[2 * tid] = r0;
  oR[2 * tid + 1] = r1;
  oW[tid] = w;
  oC[tid] = cost;
  __syncthreads();
  const int cnt = min(ROWS_THREADS, n - o0);
  store_range(g.J26 + (size_t)52 * o0, oJ, 52 * cnt);
  store_range(g.res + (size_t)2 * o0, oR, 2 * cnt);
  store_range(g.w + o0, oW, cnt);
  store_range(g.cost + o0, oC, cnt);
}

// The latency floor of a rows or cost launch: nothing, with that launch's
// grid, block, shared memory and arguments.
template <typename T>
__global__ void proj_empty_kernel(const RowsArgs<T> g) {}

// ------------------------------------------------------------ proj_normal_kernel

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

// The weighted row Jr of an observation in block b's columns (the dense
// layout of linearize_proj_rows: the anchor-side pose block at frame a, the
// observer-side at j; the observer-side extrinsic block at cj plus the
// anchor-side at ci).
template <typename T>
__device__ __forceinline__ void block_row(const Block& b, const T Jr[26], T wv, int j, int a,
                                          int ci, int cj, bool ex, bool tdf, T out[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k] = T(0);
  if (b.kind == 0) {
    if (b.idx == j || b.idx == a)
#pragma unroll
      for (int k = 0; k < 6; ++k) out[k] = (b.idx == j ? Jr[6 + k] : Jr[k]) * wv;
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
struct NormalArgs : ProjInputs<T> {
  int ex, tdf;
  T* H_pp;
  T* b_p;
  T* H_pl;
  T* H_ll;
  T* b_l;
  T* cost;
};

// The launch's jobs, in the order of the blocks: `heavy` clusters of tile
// jobs (the W1 diagonal pose tiles, then the tiles of the extrinsic and td
// blocks whose estimates are on, `n_live` of them), then single blocks
// (padded to whole clusters): `light_tiles` off-diagonal pose tiles, `feat`
// blocks of NRM_WARPS features, `zero` blocks of the rows and columns no
// projection reaches (speed-bias; extrinsic or td when off).
struct Layout {
  int D, n_live, heavy, light_tiles, feat, zero, grid;
};

__host__ __device__ __forceinline__ Layout layout(int F, int W1, int C, bool ex, bool tdf) {
  Layout L;
  L.D = 15 * W1 + 6 * C + 1;
  L.n_live = (ex ? C : 0) + (tdf ? 1 : 0);
  // Live block b (0-based) pairs with the W1 poses and live blocks 0..b.
  L.heavy = W1 + L.n_live * (W1 + 1) + L.n_live * (L.n_live - 1) / 2;
  L.light_tiles = W1 * (W1 - 1) / 2;
  L.feat = (F + NRM_WARPS - 1) / NRM_WARPS;
  L.zero = (L.D + NRM_WARPS * ZERO_ROWS - 1) / (NRM_WARPS * ZERO_ROWS);
  const int light = L.light_tiles + L.feat + L.zero;
  L.grid = CLUSTER * L.heavy + (light + CLUSTER - 1) / CLUSTER * CLUSTER;
  return L;
}

// The active block of live extrinsic / td block b: the extrinsics first.
__device__ __forceinline__ int live_block(int b, int W1, int C, bool ex) {
  return ex && b < C ? W1 + b : W1 + C;
}

// Dynamic shared memory: the staged frames and cameras (stage_values),
// each warp's extrinsic sums of a feature (6 C), then the tile's list of
// candidate observations (NRM_THREADS W1).
template <typename T>
__host__ __device__ __forceinline__ size_t stage_elems(int W1, int C) {
  return stage_values(W1, C) + (size_t)NRM_WARPS * 6 * C;
}

template <typename T>
__host__ __device__ __forceinline__ size_t list_offset(int W1, int C) {
  return (stage_elems<T>(W1, C) * sizeof(T) + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ __forceinline__ size_t normal_smem(int W1, int C) {
  return list_offset<T>(W1, C) + (size_t)NRM_THREADS * W1 * sizeof(int);
}

// Exclusive prefix sum of v over the block; total gets the sum.
__device__ __forceinline__ int block_scan(int v, int* wtot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wtot[warp] = x;
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NRM_WARPS; ++w) {
    if (w < warp) base += wtot[w];
    total += wtot[w];
  }
  __syncthreads();
  return base + x - v;
}

// Adds candidate o's terms to tile (A, B)'s sums (POSE: both pose blocks).
template <typename T, bool POSE>
__device__ __forceinline__ void tile_add(const NormalArgs<T>& g, const Stage<T>& S,
                                         const Block& ba, const Block& bb, int o, T acc[NACC]) {
  const int f = o / g.W1, j = o - f * g.W1;
  const bool ex = g.ex != 0, tdf = g.tdf != 0;
  int a, ci, cj;
  if (!obs_mask(o, f, j, g.valid, g.anchor, g.used, g.cam, g.W1, g.C, a, ci, cj)) return;
  if (!POSE && !(touches(ba, j, a, ci, cj, ex, tdf) && touches(bb, j, a, ci, cj, ex, tdf)))
    return;
  T r0, r1, w, cst, J[2][26];
  lin_staged<T, true>(g, S, load_obs(g, o, f, j, a, ci, cj), r0, r1, w, cst, J);
  T xa0[6], xa1[6], xb0[6], xb1[6];
  if (POSE) {
    const bool ia = ba.idx == a, ib = bb.idx == a;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      xa0[k] = (ia ? J[0][k] : J[0][6 + k]) * w;
      xa1[k] = (ia ? J[1][k] : J[1][6 + k]) * w;
      xb0[k] = (ib ? J[0][k] : J[0][6 + k]) * w;
      xb1[k] = (ib ? J[1][k] : J[1][6 + k]) * w;
    }
  } else {
    block_row(ba, J[0], w, j, a, ci, cj, ex, tdf, xa0);
    block_row(ba, J[1], w, j, a, ci, cj, ex, tdf, xa1);
    block_row(bb, J[0], w, j, a, ci, cj, ex, tdf, xb0);
    block_row(bb, J[1], w, j, a, ci, cj, ex, tdf, xb1);
  }
#pragma unroll
  for (int x = 0; x < 6; ++x)
#pragma unroll
    for (int y = 0; y < 6; ++y) acc[6 * x + y] += xa0[x] * xb0[y] + xa1[x] * xb1[y];
  if (ba.col == bb.col) {
    const T rw0 = r0 * w, rw1 = r1 * w;
#pragma unroll
    for (int x = 0; x < 6; ++x) acc[36 + x] += xa0[x] * rw0 + xa1[x] * rw1;
  }
}

// The sums of tile (A, B) over the features f0, f0 + step, ... (see the
// note at the top for the candidates).
template <typename T, bool POSE>
__device__ void tile_sums(const NormalArgs<T>& g, T* sm, const Block& ba, const Block& bb,
                          int f0, int step, int* list, int* wtot, T acc[NACC]) {
  const int tid = threadIdx.x, W1 = g.W1;
  const bool offdiag = POSE && ba.idx != bb.idx;
  const bool pose_rule = ba.kind == 0;  // diagonal, or a pose block and another
  const int nf = g.F > f0 ? (g.F - f0 + step - 1) / step : 0;
  // Feature k's candidates (its anchor in a).
  auto candidates = [&](int k, int& a) {
    a = -1;
    if (k >= nf) return 0;
    const int f = f0 + k * step;
    const int64_t a64 = g.anchor[f];
    if (!g.used[f] || a64 < 0 || a64 >= W1) return 0;
    a = (int)a64;
    return offdiag ? (int)(a == ba.idx || a == bb.idx) : (pose_rule && a != ba.idx ? 1 : W1 - 1);
  };
  stage_issue<T, NRM_THREADS>(g, sm);
  int a, cnt = candidates(tid, a);  // the first round's, loaded while the copies fly
  const Stage<T> S = stage_finish<T, NRM_THREADS>(g, sm);
  for (int k0 = 0; k0 < nf; k0 += NRM_THREADS) {
    const int k = k0 + tid;
    const int f = f0 + k * step;
    if (k0) cnt = candidates(k, a);
    int total;
    const int off = block_scan(cnt, wtot, total);
    if (cnt) {
      int* d = list + off;
      const int base = f * W1;
      if (offdiag)
        d[0] = base + (a == ba.idx ? bb.idx : ba.idx);
      else if (pose_rule && a != ba.idx)
        d[0] = base + ba.idx;
      else
        for (int j = 0, n = 0; j < W1; ++j)
          if (j != a) d[n++] = base + j;
    }
    __syncthreads();
    for (int i = tid; i < total; i += NRM_THREADS) tile_add<T, POSE>(g, S, ba, bb, list[i], acc);
    __syncthreads();
  }
}

// Sum each of the block's NACC accumulators, into out: within each warp a
// butterfly over the accumulators padded to 64, which at each of its five
// steps (lane distance 16, 8, ..., 1) keeps half of a lane's entries and
// adds its partner's copy of them (62 shuffles, where a tree for each
// accumulator takes 5 NACC), leaving entries 2l and 2l + 1 in lane l; then
// the warps in order.
template <int O, typename T>
__device__ __forceinline__ void butterfly_step(T v[64], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < 2 * O; ++i) {
    const T send = up ? v[i] : v[i + 2 * O];
    const T keep = up ? v[i + 2 * O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <typename T>
__device__ __forceinline__ void block_sum(T acc[NACC], T (*part)[NACC], T* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T v[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) v[k] = k < NACC ? acc[k] : T(0);
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  if (2 * lane < NACC) part[warp][2 * lane] = v[0];
  if (2 * lane + 1 < NACC) part[warp][2 * lane + 1] = v[1];
  __syncthreads();
  if (tid < NACC) {
    T v = part[0][tid];
    for (int wi = 1; wi < NRM_WARPS; ++wi) v += part[wi][tid];
    out[tid] = v;
  }
  __syncthreads();
}

// Entry tid < NACC of tile (A, B) into H_pp (and its mirror) or b_p.
template <typename T>
__device__ __forceinline__ void tile_write(const NormalArgs<T>& g, int D, const Block& ba,
                                           const Block& bb, int tid, T v) {
  if (tid < 36) {
    const int x = tid / 6, y = tid - 6 * (tid / 6);
    if (x < ba.size && y < bb.size) {
      g.H_pp[(size_t)(ba.col + x) * D + bb.col + y] = v;
      if (ba.col != bb.col) g.H_pp[(size_t)(bb.col + y) * D + ba.col + x] = v;
    }
  } else if (ba.col == bb.col && tid - 36 < ba.size) {
    g.b_p[ba.col + tid - 36] = v;
  }
}

// Tile (A, B) of H_pp: HEAVY, a cluster whose ranks split the features;
// else one block.
template <typename T, bool HEAVY>
__device__ void tile_job(const NormalArgs<T>& g, const Layout& L, int A, int B, int f0,
                         int step, T* sm, int* list, int* wtot, T (*part)[NACC], T* bsum) {
  const Block ba = active_block(A, g.W1, g.C), bb = active_block(B, g.W1, g.C);
  T acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = T(0);
  if (ba.kind == 0 && bb.kind == 0)
    tile_sums<T, true>(g, sm, ba, bb, f0, step, list, wtot, acc);
  else
    tile_sums<T, false>(g, sm, ba, bb, f0, step, list, wtot, acc);
  block_sum(acc, part, bsum);
  const int tid = threadIdx.x;
  if (!HEAVY) {
    if (tid < NACC) tile_write(g, L.D, ba, bb, tid, bsum[tid]);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's bsum is complete
  if (cluster.block_rank() == 0 && tid < NACC) {
    T v = bsum[tid];
    for (int r = 1; r < CLUSTER; ++r) v += cluster.map_shared_rank(bsum, r)[tid];
    tile_write(g, L.D, ba, bb, tid, v);
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

// Feature f's H_pl column, H_ll, b_l and cost terms: a warp, lane j the
// observation (f, j) (j + 32, ... where W1 > 32), every sum a fixed tree.
template <typename T>
__device__ void feature_job(const NormalArgs<T>& g, const Stage<T>& S, int D, int f, T* exs) {
  const int lane = threadIdx.x & 31, W1 = g.W1, F = g.F, C = g.C;
  const bool ex = g.ex != 0, tdf = g.tdf != 0;
  const int64_t a64 = g.anchor[f];
  const int a = a64 >= 0 && a64 < W1 ? (int)a64 : -1;
  T sa[6], hll = T(0), bl = T(0), stdl = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) sa[k] = T(0);
  for (int j0 = 0; j0 < W1; j0 += 32) {
    const int j = j0 + lane, o = f * W1 + j;
    int aa = 0, ci = 0, cj = 0;
    const bool kept = j < W1 && obs_mask(o, f, j, g.valid, g.anchor, g.used, g.cam, W1, C, aa,
                                         ci, cj);
    T hpl[6], J[2][26], w = T(0), l0 = T(0), l1 = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) hpl[k] = T(0);
    T cst = T(0);
    if (kept) {
      T r0, r1;
      lin_staged<T, true>(g, S, load_obs(g, o, f, j, aa, ci, cj), r0, r1, w, cst, J);
      l0 = J[0][24] * w;
      l1 = J[1][24] * w;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        sa[k] += (J[0][k] * w) * l0 + (J[1][k] * w) * l1;
        hpl[k] = (J[0][6 + k] * w) * l0 + (J[1][6 + k] * w) * l1;
      }
      hll += l0 * l0 + l1 * l1;
      bl += l0 * (r0 * w) + l1 * (r1 * w);
      if (tdf) stdl += (J[0][25] * w) * l0 + (J[1][25] * w) * l1;
    }
    if (j < W1) {
      g.cost[o] = cst;
      if (j != a)
#pragma unroll
        for (int k = 0; k < 6; ++k) g.H_pl[(size_t)(6 * j + k) * F + f] = hpl[k];
    }
    if (ex) {
      for (int e = 0; e < C; ++e) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          T v = T(0);
          if (kept) {
            const T xj0 = e == cj ? J[0][18 + k] * w : T(0);
            const T xi0 = e == ci ? J[0][12 + k] * w : T(0);
            const T xj1 = e == cj ? J[1][18 + k] * w : T(0);
            const T xi1 = e == ci ? J[1][12 + k] * w : T(0);
            v = (xj0 + xi0) * l0 + (xj1 + xi1) * l1;
          }
#pragma unroll
          for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_down_sync(0xffffffffu, v, sh);
          if (lane == 0) exs[6 * e + k] = j0 == 0 ? v : exs[6 * e + k] + v;
        }
      }
    }
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) sa[k] += __shfl_down_sync(0xffffffffu, sa[k], sh);
    hll += __shfl_down_sync(0xffffffffu, hll, sh);
    bl += __shfl_down_sync(0xffffffffu, bl, sh);
    stdl += __shfl_down_sync(0xffffffffu, stdl, sh);
  }
  if (lane == 0) {
    g.H_ll[f] = hll;
    g.b_l[f] = bl;
    g.H_pl[(size_t)(D - 1) * F + f] = tdf ? stdl : T(0);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T v = __shfl_sync(0xffffffffu, sa[k], 0);
    if (lane == k && a >= 0) g.H_pl[(size_t)(6 * a + k) * F + f] = v;
  }
  for (int d = 6 * W1 + lane; d < 15 * W1; d += 32) g.H_pl[(size_t)d * F + f] = T(0);
  __syncwarp();
  for (int d = lane; d < 6 * C; d += 32)
    g.H_pl[(size_t)(15 * W1 + d) * F + f] = ex ? exs[d] : T(0);
}

// H_pp rows d of a zero block: a row no projection reaches (speed-bias;
// extrinsic or td when its estimate is off) whole, and its b_p entry; any
// other row's columns of those.
template <typename T>
__device__ void zero_job(const NormalArgs<T>& g, int D, int z) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W1 = g.W1;
  const bool ex = g.ex != 0, tdf = g.tdf != 0;
  for (int r = 0; r < ZERO_ROWS; ++r) {
    const int d = (z * NRM_WARPS + warp) * ZERO_ROWS + r;
    if (d >= D) return;
    T* row = g.H_pp + (size_t)d * D;
    const bool off = (d >= 6 * W1 && d < 15 * W1) || (!ex && d >= 15 * W1 && d < D - 1) ||
                     (!tdf && d == D - 1);
    if (off) {
      for (int x = lane; x < D; x += 32) row[x] = T(0);
      if (lane == 0) g.b_p[d] = T(0);
    } else {
      for (int x = 6 * W1 + lane; x < 15 * W1; x += 32) row[x] = T(0);
      for (int x = 15 * W1 + lane; !ex && x < D - 1; x += 32) row[x] = T(0);
      if (!tdf && lane == 0) row[D - 1] = T(0);
    }
  }
}

template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(NRM_THREADS, sizeof(T) == 4 ? 3 : 2)
    proj_normal_kernel(const NormalArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T part[NRM_WARPS][NACC];
  __shared__ T bsum[NACC];
  __shared__ int wtot[NRM_WARPS];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* exs = sm + stage_values(g.W1, g.C);
  int* list = reinterpret_cast<int*>(smem_raw + list_offset<T>(g.W1, g.C));
  const Layout L = layout(g.F, g.W1, g.C, g.ex != 0, g.tdf != 0);
  const int b = blockIdx.x, W1 = g.W1;
  if (b < CLUSTER * L.heavy) {
    const int h = b / CLUSTER, rank = b - CLUSTER * h;
    int A = h, B = h;  // h < W1: the diagonal pose tile (h, h)
    if (h >= W1) {     // (A, B): B the live block lb, A a pose or a live block up to lb
      const bool ex = g.ex != 0;
      int r = h - W1, lb = 0;
      while (r >= W1 + lb + 1) {
        r -= W1 + lb + 1;
        ++lb;
      }
      B = live_block(lb, W1, g.C, ex);
      A = r < W1 ? r : live_block(r - W1, W1, g.C, ex);
    }
    tile_job<T, true>(g, L, A, B, rank, CLUSTER, sm, list, wtot, part, bsum);
    return;
  }
  int l = b - CLUSTER * L.heavy;
  if (l < L.light_tiles) {  // an off-diagonal pose tile, A < B
    int A = 0;
    while (l >= W1 - 1 - A) {
      l -= W1 - 1 - A;
      ++A;
    }
    tile_job<T, false>(g, L, A, A + 1 + l, 0, 1, sm, list, wtot, part, bsum);
    return;
  }
  l -= L.light_tiles;
  if (l < L.feat) {
    stage_issue<T, NRM_THREADS>(g, sm);
    const Stage<T> S = stage_finish<T, NRM_THREADS>(g, sm);
    const int f = l * NRM_WARPS + (threadIdx.x >> 5);
    if (f < g.F) feature_job(g, S, L.D, f, exs + (threadIdx.x >> 5) * 6 * g.C);
    return;
  }
  l -= L.feat;
  if (l < L.zero) zero_job(g, L.D, l);
}

// ------------------------------------------------------------ the relocalization rows

// What the relo kernels read beside ProjInputs (of which they use the frames,
// the cameras, the inverse depths, the anchor observations' bearings and the
// masks): the loop pose (relo_p [3], relo_q [4]), the loop frame's bearings
// [F, 3] (normalized here) and its match mask [F]; relo_normal adds into the
// augmented system [D6 = D + 6] in place, relo_cost writes cost [F].
template <typename T>
struct ReloArgs : ProjInputs<T> {
  const T* relo_p;
  const T* relo_q;
  const T* relo_bearing;
  const bool* relo_mask;
  int ex, D6;
  T* H6;
  T* b6;
  T* H_pl6;
  T* H_ll;
  T* b_l;
  T* cost;
};

// relo_normal: one cluster of RN_CLUSTER blocks of RN_THREADS threads;
// block b linearizes the slots [b CH, (b + 1) CH), CH = ceil(F /
// RN_CLUSTER), a thread a slot, so F <= RN_CLUSTER RN_THREADS.
constexpr int RN_CLUSTER = 8;
constexpr int RN_THREADS = 256;
// A tile's sums: a 6 x 6 block, or a diagonal tile's upper triangle (21)
// and its b6 block (6).
constexpr int RN_TILE_SUMS = 36;
constexpr int RELO_WB = 4;  // sums a thread adds at a time into H6 and b6
// relo_cost: a thread a feature, RC_THREADS a block (32, 64 and 128 timed
// alike on an H100).
constexpr int RC_THREADS = 64;

// Is feature f kept (matched, a used slot, anchor and its camera in range)?
// Gives its anchor frame and camera, each 0 where out of range, so that the
// loads of relo_obs stay in bounds for every feature.
template <typename T>
__device__ __forceinline__ bool relo_kept(const ReloArgs<T>& g, int f, int& a, int& ci) {
  const int64_t a64 = g.anchor[f];
  const bool matched = g.relo_mask[f], uf = g.used[f];
  const bool in = a64 >= 0 && a64 < g.W1;
  a = in ? (int)a64 : 0;
  const int c = g.cam ? (int)g.cam[(size_t)f * g.W1 + a] : 0;
  const bool cin = c >= 0 && c < g.C;
  ci = cin ? c : 0;
  return matched && uf && in && cin;
}

// What a relo row of feature f reads: its inverse depth, its anchor
// observation's bearing, the loop bearing normalized as backend/relo.py
// does (b / max(|b|, 1e-12)), and the rotations and positions of its anchor
// frame, its anchor camera, camera 0 and the loop pose. The thread forms the
// four rotations from the quaternions it loads: a feature reads a few of
// the window's frames, and no thread waits for another's staging.
template <typename T>
struct ReloObs {
  T lam;
  T bi[3], bl[3];
  T Ri[3][3], Rci[3][3], Rc0[3][3], Rl[3][3];
  T pa[3], tci[3], tc0[3], pl[3];
};

template <typename T>
__device__ __forceinline__ void relo_obs(const ReloArgs<T>& g, int f, int a, int ci,
                                         ReloObs<T>& x) {
  const size_t ia = (size_t)f * g.W1 + a;
  x.lam = g.inv_depth[f];
  T b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = g.relo_bearing[3 * f + k];
    x.bi[k] = g.bearing[3 * ia + k];
    x.pa[k] = g.p[3 * a + k];
    x.tci[k] = g.tic[3 * ci + k];
    x.tc0[k] = g.tic[k];
    x.pl[k] = g.relo_p[k];
  }
  quat_mat(g.q + 4 * a, x.Ri);
  quat_mat(g.qic + 4 * ci, x.Rci);
  quat_mat(g.qic, x.Rc0);
  quat_mat(g.relo_q, x.Rl);
  const T nb = sqrt_t(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
  const T nbc = nb >= T(1e-12) ? nb : T(1e-12);
#pragma unroll
  for (int k = 0; k < 3; ++k) x.bl[k] = b[k] / nbc;
}

// lin_obs of a relo residual: the observer is the loop pose seen through
// camera 0 (the loop image is the primary camera's), td = td_obs = 0 and
// zero velocities, the loop bearing in place of pts_j. J's first 25 columns
// are [δpose_i, δrelo, δex_anchor, δex_cam0, δλ]; its td column is 0.
template <typename T, bool JAC>
__device__ __forceinline__ void relo_lin(const ReloArgs<T>& g, ReloObs<T>& x, T& r0, T& r1, T& w,
                                         T& cost, T J[2][26]) {
  const T z3[3] = {T(0), T(0), T(0)};
  lin_obs<T, JAC>(x.Ri, x.Rl, x.Rci, x.Rc0, x.pa, x.pl, x.tci, x.tc0, T(0), x.lam, x.bi, z3,
                  T(0), x.bl, z3, T(0), g.s, g.c, g.ic2, r0, r1, w, cost, J);
}

// Residual row Jr (weight w) in extrinsic e's columns: the anchor side's
// block where e is the anchor camera ci plus the loop side's where e is
// camera 0 (added where they coincide, as backend/relo.py's layout adds
// them).
template <typename T>
__device__ __forceinline__ void relo_ex_row(int e, int ci, const T Jr[26], T w, T out[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
    out[k] = (e == ci ? Jr[12 + k] * w : T(0)) + (e == 0 ? Jr[18 + k] * w : T(0));
}

// The old values of what kept feature f owns (relo_owned's entries: its
// H_pl6 column at its anchor pose, the loop pose and, when estimated, the
// extrinsics of camera 0 and of its anchor camera ci; H_ll[f], b_l[f]), read
// as soon as f is known to be kept: its linearization hides their trip
// from device memory.
template <typename T>
struct ReloOwned {
  T pose[6], loop[6], ex0[6], exi[6], hll, bl;
};

template <typename T>
__device__ __forceinline__ void relo_owned_load(const ReloArgs<T>& g, int f, int a, int ci,
                                                ReloOwned<T>& o) {
  const int D = g.D6 - 6, F = g.F, W1 = g.W1;
  const T* col = g.H_pl6 + f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    o.pose[k] = col[(size_t)(6 * a + k) * F];
    o.loop[k] = col[(size_t)(D + k) * F];
    o.ex0[k] = g.ex ? col[(size_t)(15 * W1 + k) * F] : T(0);
    o.exi[k] = g.ex && ci ? col[(size_t)(15 * W1 + 6 * ci + k) * F] : T(0);
  }
  o.hll = g.H_ll[f];
  o.bl = g.b_l[f];
}

// What kept feature f owns, added in place (to the old values o) by the
// thread that linearized it.
template <typename T>
__device__ __forceinline__ void relo_owned(const ReloArgs<T>& g, int f, int a, int ci, T r0, T r1,
                                           T w, T J[2][26], const ReloOwned<T>& o) {
  const T l0 = J[0][24] * w, l1 = J[1][24] * w;
  const int D = g.D6 - 6, F = g.F, W1 = g.W1;
  T* col = g.H_pl6 + f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    col[(size_t)(6 * a + k) * F] = o.pose[k] + ((J[0][k] * w) * l0 + (J[1][k] * w) * l1);
    col[(size_t)(D + k) * F] = o.loop[k] + ((J[0][6 + k] * w) * l0 + (J[1][6 + k] * w) * l1);
  }
  if (g.ex) {
    T x0[6], x1[6];
    relo_ex_row(0, ci, J[0], w, x0);
    relo_ex_row(0, ci, J[1], w, x1);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      col[(size_t)(15 * W1 + k) * F] = o.ex0[k] + (x0[k] * l0 + x1[k] * l1);
    if (ci) {
      relo_ex_row(ci, ci, J[0], w, x0);
      relo_ex_row(ci, ci, J[1], w, x1);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        col[(size_t)(15 * W1 + 6 * ci + k) * F] = o.exi[k] + (x0[k] * l0 + x1[k] * l1);
    }
  }
  g.H_ll[f] = o.hll + (l0 * l0 + l1 * l1);
  g.b_l[f] = o.bl + (l0 * (r0 * w) + l1 * (r1 * w));
}

// relo_normal's dynamic shared memory, each block's: its kept slots'
// weighted rows, value-major with an odd stride (lanes reading one value of
// consecutive slots, or several values of one slot, hit distinct banks): nb
// blocks of 2 x 6 (block 0 the anchor pose, 1 the loop pose, 2 + e
// extrinsic e when estimated), then r w (2); each tile's sums over them
// (RN_TILE_SUMS a tile); the table of the tiles (relo_tile_info); each of
// its slots' key (its anchor where kept, else W1); the segments of its list
// (seg[a] the first slot anchored at a, seg[W1] the kept slots in all).
struct ReloSmem {
  int nb, nv, chunk, stride, n_tiles;
  size_t part, tiles, key, seg, total;
};

__host__ __device__ __forceinline__ ReloSmem relo_smem(int F, int W1, int C, bool ex,
                                                       size_t elem) {
  ReloSmem L;
  L.nb = 2 + (ex ? C : 0);
  L.nv = 12 * L.nb + 2;
  L.chunk = (F + RN_CLUSTER - 1) / RN_CLUSTER;
  L.stride = L.chunk | 1;
  // Each anchor's tiles with its pose, the loop pose and the extrinsics,
  // then the tiles of the loop pose and the extrinsics among themselves.
  L.n_tiles = W1 * L.nb + (L.nb - 1) * L.nb / 2;
  L.part = ((size_t)L.nv * L.stride * elem + 15) / 16 * 16;
  L.tiles = (L.part + (size_t)L.n_tiles * RN_TILE_SUMS * elem + 15) / 16 * 16;
  L.key = L.tiles + (size_t)L.n_tiles * sizeof(int4);
  L.seg = L.key + (size_t)L.chunk * sizeof(int);
  L.total = L.seg + (size_t)(W1 + 1) * sizeof(int);
  return L;
}

// A tile of H6 (and b6's block x where x == y): row blocks x <= y of the
// feature rows, their columns, and the features [s, e) of the list it sums.
struct ReloTile {
  int x, y, colx, coly, s, e;
};

__device__ __forceinline__ int relo_col(int k, int a, int W1, int D) {
  return k == 0 ? 6 * a : k == 1 ? D : 15 * W1 + 6 * (k - 2);
}

// Tile t's row blocks x <= y, and its anchor a (-1: every kept feature).
__device__ __forceinline__ void relo_tile_blocks(int t, int nb, int W1, int& a, int& x, int& y) {
  if (t < W1 * nb) {  // anchor a's pose against block y, over its segment
    a = t / nb;
    x = 0;
    y = t - nb * a;
    return;
  }
  int r = t - W1 * nb;  // blocks 1 <= x <= y < nb, over every kept feature
  a = -1;
  x = 1;
  while (r >= nb - x) {
    r -= nb - x;
    ++x;
  }
  y = x + r;
}

// Tile t's entry of the block's table, built once a launch: its anchor (-1:
// every kept feature), its row blocks (x << 8 | y) and their columns.
__device__ __forceinline__ int4 relo_tile_info(int t, int nb, int W1, int D) {
  int a, x, y;
  relo_tile_blocks(t, nb, W1, a, x, y);
  const int b = a < 0 ? 0 : a;
  return make_int4(a, x << 8 | y, relo_col(x, b, W1, D), relo_col(y, b, W1, D));
}

// The tile of a table entry, with its segment of the block's list.
__device__ __forceinline__ ReloTile relo_tile_of(int4 ti, int W1, const int* seg) {
  return {ti.y >> 8, ti.y & 255, ti.z, ti.w, ti.x < 0 ? 0 : seg[ti.x],
          ti.x < 0 ? seg[W1] : seg[ti.x + 1]};
}

// Sum idx of a tile: entry (i, j) of a 6 x 6 block, or on the diagonal
// (x == y) of its upper triangle (idx < 21) or b6's entry i (j = -1); false
// past a diagonal tile's 27.
__device__ __forceinline__ bool relo_entry(const ReloTile& t, int idx, int& i, int& j) {
  if (t.x != t.y) {
    i = idx / 6;
    j = idx - 6 * i;
    return true;
  }
  if (idx >= 27) return false;
  if (idx >= 21) {
    i = idx - 21;
    j = -1;
    return true;
  }
  // Row i of the upper triangle starts at 6 i - i (i - 1) / 2.
  i = (idx >= 6) + (idx >= 11) + (idx >= 15) + (idx >= 18) + (idx >= 20);
  j = idx - (6 * i - i * (i - 1) / 2) + i;
  return true;
}

// Sum idx of tile t over the block's kept slots [t.s, t.e) in list order,
// two residual rows each (0 past the tile's sums).
template <typename T>
__device__ __forceinline__ T relo_tile_sum(const ReloTile& t, int idx, const T* rows, int S,
                                           int nb) {
  int i, j;
  if (!relo_entry(t, idx, i, j)) return T(0);
  const T* x = rows + (size_t)(12 * t.x + i) * S;
  const T* y = j < 0 ? rows + (size_t)12 * nb * S : rows + (size_t)(12 * t.y + j) * S;
  const int yo = j < 0 ? S : 6 * S;  // the second residual row's value
  T acc = T(0);
#pragma unroll 4
  for (int f = t.s; f < t.e; ++f) {
    acc += x[f] * y[f];
    acc += x[6 * S + f] * y[yo + f];
  }
  return acc;
}

// Where sum idx of tile t is added: p, and m, its other place in H6 (null
// on H6's diagonal and in b6); both null past the tile's sums.
template <typename T>
__device__ __forceinline__ void relo_place(const ReloArgs<T>& g, const ReloTile& t, int idx,
                                           T*& p, T*& m) {
  p = m = nullptr;
  int i, j;
  if (!relo_entry(t, idx, i, j)) return;
  if (j < 0) {
    p = g.b6 + t.colx + i;
    return;
  }
  p = g.H6 + (size_t)(t.colx + i) * g.D6 + t.coly + j;
  if (t.x != t.y || i != j) m = g.H6 + (size_t)(t.coly + j) * g.D6 + t.colx + i;
}

// One linearization's relo rows added into the augmented normal equations
// by one cluster. Each block linearizes its slots once, a thread a slot,
// which adds what the feature owns (relo_owned) and puts its weighted rows
// at its place in the block's list of kept slots sorted by anchor; then
// every tile's sums over the block's list, a thread a sum; then, past the
// cluster's barrier, each sum of the tiles is added into H6 or b6 by one
// thread of one block, the blocks' partial sums taken in rank order. No
// atomics: a repeat is bit-identical.
template <typename T>
__global__ void __cluster_dims__(RN_CLUSTER, 1, 1) __launch_bounds__(RN_THREADS, 1)
    relo_normal_kernel(const ReloArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int W1 = g.W1, F = g.F, D = g.D6 - 6;
  const ReloSmem L = relo_smem(F, W1, g.C, g.ex != 0, sizeof(T));
  T* rows = reinterpret_cast<T*>(smem_raw);
  T* part = reinterpret_cast<T*>(smem_raw + L.part);
  int4* tiles = reinterpret_cast<int4*>(smem_raw + L.tiles);
  int* key = reinterpret_cast<int*>(smem_raw + L.key);
  int* seg = reinterpret_cast<int*>(smem_raw + L.seg);
  const int tid = threadIdx.x, rank = (int)cluster.block_rank(), S = L.stride;
  const int f = rank * L.chunk + tid;
  // The slot's key; where kept, the loads of what its row reads and of what
  // it owns go out before the list is built.
  int a = 0, ci = 0, k = W1;
  ReloObs<T> x;
  ReloOwned<T> own;
  if (tid < L.chunk && f < F && relo_kept(g, f, a, ci)) {
    k = a;
    relo_obs(g, f, a, ci, x);
    relo_owned_load(g, f, a, ci, own);
  }
  if (tid < L.chunk) key[tid] = k;
  for (int t = tid; t < L.n_tiles; t += RN_THREADS) tiles[t] = relo_tile_info(t, L.nb, W1, D);
  __syncthreads();  // every key and tile
  // The slot's place in the list (by anchor, then slot), and the segments.
  int place = 0;
  if (k < W1)
    for (int j = 0; j < L.chunk; ++j) {
      const int kj = key[j];
      place += kj < k || (kj == k && j < tid);
    }
  if (tid <= W1) {
    int n = 0;
    for (int j = 0; j < L.chunk; ++j) n += key[j] < tid;
    seg[tid] = n;
  }
  if (k < W1) {
    T r0, r1, w, cst, J[2][26];
    relo_lin<T, true>(g, x, r0, r1, w, cst, J);
    relo_owned(g, f, a, ci, r0, r1, w, J, own);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        rows[(6 * q + i) * S + place] = J[q][i] * w;
        rows[(12 + 6 * q + i) * S + place] = J[q][6 + i] * w;
      }
      if (g.ex)
        for (int e = 0; e < g.C; ++e) {
          T xr[6];
          relo_ex_row(e, ci, J[q], w, xr);
#pragma unroll
          for (int i = 0; i < 6; ++i) rows[(12 * (2 + e) + 6 * q + i) * S + place] = xr[i];
        }
    }
    rows[12 * L.nb * S + place] = r0 * w;
    rows[(12 * L.nb + 1) * S + place] = r1 * w;
  }
  __syncthreads();  // every row and segment
  const int n_sums = L.n_tiles * RN_TILE_SUMS;
  for (int q = tid; q < n_sums; q += RN_THREADS)
    part[q] = relo_tile_sum(relo_tile_of(tiles[q / RN_TILE_SUMS], W1, seg), q % RN_TILE_SUMS,
                            rows, S, L.nb);
  // Each sum into its place (and its other place) in H6 or b6: block rank
  // takes sums rank RN_THREADS + tid + u RN_CLUSTER RN_THREADS, RELO_WB at a
  // time, their old values read before the partial sums (the first ones'
  // before the cluster's barrier), each the blocks' partial sums in rank
  // order.
  const int step = RN_CLUSTER * RN_THREADS;
  for (int c0 = 0; c0 < n_sums; c0 += RELO_WB * step) {
    const int q0 = c0 + rank * RN_THREADS + tid;
    T *at[RELO_WB], *mir[RELO_WB], o[RELO_WB], om[RELO_WB];
#pragma unroll
    for (int u = 0; u < RELO_WB; ++u) {
      const int q = q0 + u * step;
      at[u] = mir[u] = nullptr;
      if (q < n_sums)
        relo_place(g, relo_tile_of(tiles[q / RN_TILE_SUMS], W1, seg), q % RN_TILE_SUMS, at[u],
                   mir[u]);
    }
#pragma unroll
    for (int u = 0; u < RELO_WB; ++u) {
      o[u] = at[u] ? *at[u] : T(0);
      om[u] = mir[u] ? *mir[u] : T(0);
    }
    if (c0 == 0) cluster.sync();  // every block's partial sums
#pragma unroll
    for (int u = 0; u < RELO_WB; ++u) {
      if (!at[u]) continue;
      const int q = q0 + u * step;
      T pr[RN_CLUSTER];
#pragma unroll
      for (int r = 0; r < RN_CLUSTER; ++r) pr[r] = cluster.map_shared_rank(part, r)[q];
      T v = pr[0];
#pragma unroll
      for (int r = 1; r < RN_CLUSTER; ++r) v += pr[r];
      *at[u] = o[u] + v;
      if (mir[u]) *mir[u] = om[u] + v;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The robust cost term of every feature, c² log1p(|r|² / c²) (0 where not
// kept): a thread a feature, RC_THREADS a block, no shared memory and no
// barrier. Every thread issues its loads before the kept test.
template <typename T>
__global__ void __launch_bounds__(RC_THREADS) relo_cost_kernel(const ReloArgs<T> g) {
  const int f = blockIdx.x * RC_THREADS + threadIdx.x;
  if (f >= g.F) return;
  int a, ci;
  const bool kept = relo_kept(g, f, a, ci);
  ReloObs<T> x;
  relo_obs(g, f, a, ci, x);
  T r0 = T(0), r1 = T(0), w = T(1), cost = T(0), J[2][26];
  if (kept) relo_lin<T, false>(g, x, r0, r1, w, cost, J);
  g.cost[f] = cost;
}

// The latency floor of a relo launch: nothing, with its grid, block (and
// for relo_normal its cluster), shared memory and arguments.
template <typename T>
__global__ void relo_empty_kernel(const ReloArgs<T> g) {}

template <typename T>
__global__ void __cluster_dims__(RN_CLUSTER, 1, 1) relo_empty_cluster_kernel(const ReloArgs<T> g) {}

#define PROJ_IN_PARAMS                                                                      \
  const void *p, const void *q, const void *tic, const void *qic, const void *td,           \
      const void *inv_depth, const void *bearing, const void *velocity, const void *td_obs, \
      const void *valid, const void *anchor, const void *used, const void *cam, int F, int W1, \
      int C, double sqrt_info, double cauchy_c
#define PROJ_IN_ARGS                                                                          \
  p, q, tic, qic, td, inv_depth, bearing, velocity, td_obs, valid, anchor, used, cam, F, W1, C, \
      sqrt_info, cauchy_c

template <typename T>
ProjInputs<T> proj_inputs(PROJ_IN_PARAMS) {
  return {(const T*)p, (const T*)q, (const T*)tic, (const T*)qic, (const T*)td,
          (const T*)inv_depth, (const T*)bearing, (const T*)velocity, (const T*)td_obs,
          (const bool*)valid, (const int64_t*)anchor, (const bool*)used, (const int64_t*)cam,
          F, W1, C, (T)sqrt_info, (T)cauchy_c, (T)(1.0 / (cauchy_c * cauchy_c))};
}

// One launch of proj_rows_kernel in rows mode (rows != 0) or cost mode, or
// (empty) of proj_empty_kernel with that launch's grid, block and shared
// memory. The rows mode's outputs must be 16-byte aligned (as every
// allocation of the caching allocator is).
template <typename T>
int launch_rows(PROJ_IN_PARAMS, int rows, bool empty, void* res, void* J26, void* w, void* cost,
                cudaStream_t stream) {
  const RowsArgs<T> g{proj_inputs<T>(PROJ_IN_ARGS), (T*)res, (T*)J26, (T*)w, (T*)cost};
  if (rows && ((uintptr_t)res | (uintptr_t)J26 | (uintptr_t)w | (uintptr_t)cost) % 16) return -1;
  const int grid = (F * W1 + ROWS_THREADS - 1) / ROWS_THREADS;
  const size_t smem = rows_smem<T>(W1, C, rows != 0);
  void (*kernel)(const RowsArgs<T>) =
      empty ? proj_empty_kernel<T> : rows ? proj_rows_kernel<T, true> : proj_rows_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, ROWS_THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_normal(PROJ_IN_PARAMS, int ex, int tdf, void* H_pp, void* b_p, void* H_pl, void* H_ll,
                  void* b_l, void* cost, cudaStream_t stream) {
  const NormalArgs<T> g{proj_inputs<T>(PROJ_IN_ARGS), ex, tdf, (T*)H_pp, (T*)b_p, (T*)H_pl,
                        (T*)H_ll, (T*)b_l, (T*)cost};
  const Layout L = layout(F, W1, C, ex != 0, tdf != 0);
  const size_t smem = normal_smem<T>(W1, C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        proj_normal_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  proj_normal_kernel<T><<<L.grid, NRM_THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

// One launch of relo_normal_kernel (normal != 0) or relo_cost_kernel, or
// (empty) of relo_empty_kernel with that launch's grid, block and shared
// memory.
template <typename T>
int launch_relo(PROJ_IN_PARAMS, const void* relo_p, const void* relo_q, const void* relo_bearing,
                const void* relo_mask, int ex, int normal, bool empty, void* H6, void* b6,
                void* H_pl6, void* H_ll, void* b_l, void* cost, cudaStream_t stream) {
  const int D6 = 15 * W1 + 6 * C + 1 + 6;
  const ReloArgs<T> g{proj_inputs<T>(PROJ_IN_ARGS), (const T*)relo_p, (const T*)relo_q,
                      (const T*)relo_bearing, (const bool*)relo_mask, ex, D6, (T*)H6, (T*)b6,
                      (T*)H_pl6, (T*)H_ll, (T*)b_l, (T*)cost};
  if (normal && (F > RN_CLUSTER * RN_THREADS || W1 >= RN_THREADS)) return -1;
  const size_t smem = normal ? relo_smem(F, W1, C, ex != 0, sizeof(T)).total : 0;
  const int threads = normal ? RN_THREADS : RC_THREADS;
  const int grid = normal ? RN_CLUSTER : (F + RC_THREADS - 1) / RC_THREADS;
  void (*kernel)(const ReloArgs<T>) =
      normal ? (empty ? relo_empty_cluster_kernel<T> : relo_normal_kernel<T>)
             : (empty ? relo_empty_kernel<T> : relo_cost_kernel<T>);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 1: rows (res [F, W1, 2], J26 [F, W1, 2, 26], w [F, W1], cost [F,
// W1]); mode 0: cost alone (res, J26 and w may be null). cam may be null
// (every observation from camera 0). dtype 0 float32, 1 float64.
extern "C" int proj_rows_launch(PROJ_IN_PARAMS, int mode, int dtype, void* res, void* J26,
                                void* w, void* cost, void* stream) {
  if (F < 0 || W1 < 1 || C < 1 || (mode != 0 && mode != 1) || (dtype != 0 && dtype != 1))
    return -1;
  if (F == 0) return 0;
  return dtype ? launch_rows<double>(PROJ_IN_ARGS, mode, false, res, J26, w, cost,
                                     (cudaStream_t)stream)
               : launch_rows<float>(PROJ_IN_ARGS, mode, false, res, J26, w, cost,
                                    (cudaStream_t)stream);
}

// proj_empty_kernel with the grid, block, shared memory and arguments of
// proj_rows_launch's launch in the same mode (the latency floor of that
// launch).
extern "C" int proj_empty_launch(PROJ_IN_PARAMS, int mode, int dtype, void* res, void* J26,
                                 void* w, void* cost, void* stream) {
  if (F < 0 || W1 < 1 || C < 1 || (mode != 0 && mode != 1) || (dtype != 0 && dtype != 1))
    return -1;
  if (F == 0) return 0;
  return dtype ? launch_rows<double>(PROJ_IN_ARGS, mode, true, res, J26, w, cost,
                                     (cudaStream_t)stream)
               : launch_rows<float>(PROJ_IN_ARGS, mode, true, res, J26, w, cost,
                                    (cudaStream_t)stream);
}

// The normal equations of one linearization: H_pp [D, D], b_p [D], H_pl [D,
// F], H_ll [F], b_l [F] and the cost terms [F, W1], every entry written; D =
// 15 W1 + 6 C + 1. Arguments as proj_rows_launch's.
extern "C" int proj_normal_launch(PROJ_IN_PARAMS, int estimate_ex, int estimate_td, int dtype,
                                  void* H_pp, void* b_p, void* H_pl, void* H_ll, void* b_l,
                                  void* cost, void* stream) {
  if (F < 0 || W1 < 1 || C < 1 || (dtype != 0 && dtype != 1)) return -1;
  if (F == 0) return 0;
  return dtype ? launch_normal<double>(PROJ_IN_ARGS, estimate_ex, estimate_td, H_pp, b_p, H_pl,
                                       H_ll, b_l, cost, (cudaStream_t)stream)
               : launch_normal<float>(PROJ_IN_ARGS, estimate_ex, estimate_td, H_pp, b_p, H_pl,
                                      H_ll, b_l, cost, (cudaStream_t)stream);
}

// The relocalization rows (backend/relo_cuda.py). mode 1: relo_normal, adding
// one linearization's relo rows into H6 [D6, D6], b6 [D6], H_pl6 [D6, F],
// H_ll [F] and b_l [F] in place (D6 = 15 W1 + 6 C + 7; the extrinsic terms
// only where estimate_ex); mode 0: relo_cost, the cost terms cost [F] (the
// sums may be null). empty != 0: relo_empty_kernel with that launch's grid,
// block and shared memory. The state's arguments as proj_rows_launch's;
// relo_p [3], relo_q [4], relo_bearing [F, 3] of the state's dtype,
// relo_mask [F] bool. Mode 1 takes F <= 2048 (-1 above) and needs
// relo_normal_smem's shared memory (about F (26 + 12 C) values with the
// extrinsics estimated), which bounds F further where it exceeds what a
// block may take.
extern "C" int relo_launch(PROJ_IN_PARAMS, const void* relo_p, const void* relo_q,
                           const void* relo_bearing, const void* relo_mask, int estimate_ex,
                           int mode, int empty, int dtype, void* H6, void* b6, void* H_pl6,
                           void* H_ll, void* b_l, void* cost, void* stream) {
  if (F < 0 || W1 < 1 || C < 1 || (mode != 0 && mode != 1) || (dtype != 0 && dtype != 1))
    return -1;
  if (F == 0) return 0;
  return dtype ? launch_relo<double>(PROJ_IN_ARGS, relo_p, relo_q, relo_bearing, relo_mask,
                                     estimate_ex, mode, empty != 0, H6, b6, H_pl6, H_ll, b_l,
                                     cost, (cudaStream_t)stream)
               : launch_relo<float>(PROJ_IN_ARGS, relo_p, relo_q, relo_bearing, relo_mask,
                                    estimate_ex, mode, empty != 0, H6, b6, H_pl6, H_ll, b_l,
                                    cost, (cudaStream_t)stream);
}

// relo_normal_kernel's dynamic shared memory at these sizes (need, bytes)
// and the most a block of the current device may take (limit, bytes).
extern "C" int relo_normal_smem(int F, int W1, int C, int estimate_ex, int dtype, long long* need,
                                long long* limit) {
  if (F < 0 || W1 < 1 || C < 1 || (dtype != 0 && dtype != 1)) return -1;
  *need = (long long)relo_smem(F, W1, C, estimate_ex != 0, dtype ? sizeof(double) : sizeof(float))
              .total;
  int dev = 0, v = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = v;
  return (int)err;
}
