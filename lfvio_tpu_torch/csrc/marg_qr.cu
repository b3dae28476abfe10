// The QR of the two marginalization programs on Hopper, float32 or float64,
// in two launches:
//
//  * marg_depth_kernel (stage 1): MARGIN_OLD's depth elimination, one
//    feature at a time. A feature anchored at frame 0 owns one inverse-depth
//    column, and only its own 2 W observation rows (frames 1..W, two rows an
//    observation; the anchor's own observation carries no row) touch it. One
//    Householder reflection of those rows, H = I - τ v vᵀ with H x = β e_0
//    for the depth column x, leaves the depth in the first row alone; that
//    row is the depth's pivot and is dropped, and the other 2 W - 1 rows,
//    over [pose0 | speed-bias0 | kept | r] (C = D + 1 columns), are written
//    into a static stack, 2 W rows a feature, the dropped row's slot zero.
//    Where the depth column is all zero (the feature is not anchored at
//    frame 0, is unused, or has no observation) no reflection is applied and
//    all 2 W rows are kept: the unit-row repair of the dense form
//    (backend/marginalize.py::_with_unit_rows), which the JAX package's QR
//    lacks. The reflection is a rank-1 update A - τ v (vᵀ A) of the few
//    columns the feature touches (pose 0, its observed frames, the
//    extrinsics, td, r); the dense rows are never formed in memory.
//  * marg_qr_kernel (stage 2): the R factor of a tall stack [M, C] (the
//    prior's and the IMU(0,1)'s rows, then stage 1's; SECOND_NEW: the
//    prior's rows alone), C <= 384, as a tree of Householder QRs
//    (TSQR). Each block (a leaf) takes a range of rows, skips its all-zero
//    rows and absorbs the others, a tile of up to TR rows at a time, into
//    its own C x C triangle R_b: for each column k, one reflection of
//    [R_b[k, k]; tile[:, k]] and its rank-1 update of R_b's row k and the
//    tile's later columns. Leaf 0 takes the dense head (the first rows);
//    the other leaves, once finished, merge up a binary tree: the second of
//    two siblings to finish absorbs the right one's triangle (its non-zero
//    rows, as tiles) into the left one's, always in that order whichever
//    block does it, so a repeat is bit-identical; the tree's root is
//    absorbed last into leaf 0's triangle, R_0, the result. A column whose
//    part to eliminate is zero
//    (or below the rounding unit of its pivot, or below the type's smallest
//    normal number) takes no reflection and consumes no row: where a dropped
//    column is empty its row of R stays zero and no information is lost, as
//    the unit rows of the dense form give, and a kept column without
//    information leaves the residual's rest in the last row (r0 is then the
//    minimum-norm one, as the eigh form's).
//
// Replaces what XLA computes inside the JAX package's MARGIN_OLD and
// SECOND_NEW programs: jnp.linalg.qr(A, mode="r") of the dense stacked
// matrix in lfvio_tpu/backend/marginalize.py:260 (marginalize_old_qr, :207;
// A = [pose0/sb0 | F anchored depths | kept | r], the depths an F x F
// expansion of J_lam with one non-zero a row) and :297
// (marginalize_second_new_qr, :276). There is no Pallas kernel behind them.
//
// What bounds it on an H100: the chain of dependent column steps. At the
// high-rate estimator's MARGIN_OLD (window 20, 384 slots, C = 323) the
// stack has M ≈ 15,700 rows, most of them zero rows that a leaf skips, and
// Householder QR of its non-zero ones is about 2 n C² operations
// (chip_smoke.marg_bound_ms): tens of microseconds of the card's float32
// rate. A column step is a reflection, a block-wide update and a barrier,
// each waiting on the one before; it costs about the same whatever the
// tile's rows, so a launch takes as long as its longest path of tiles
// times their steps: the dense head's leaf, then the merge of the
// projection rows' tree into it. Stage 1 writes the stack (20 MB at that
// size) and is bound by those bytes.
//
// Design:
//  * stage 1: a block of 128 threads a feature; its rows (the weighted
//    26-column Jacobians and residuals, 2 W of them) staged in shared
//    memory; warp 0 forms the reflection (scaled norm, the sign of β
//    opposite x_0's so that x_0 - β does not cancel), all threads form
//    u = vᵀ A over the C columns and write the stack's rows, a row at a time
//    across the block (coalesced).
//  * stage 2: a block of 512 threads a leaf. A tile is staged in shared
//    memory, then held in registers: a column a group of 4 threads (rows
//    split over them, 24 each in float32, 12 in float64), 3 columns a group
//    (C <= 384). R_b lives in global memory (L2); the entries of its
//    current and next row that a thread's columns need are in registers. A
//    step: the update of every later column by the step's reflection (a dot
//    over the group's rows, shuffles), the reflection of the next column
//    formed by the group that holds it right after its update (the scaled,
//    two-pass norm), one barrier. A leaf skips its all-zero rows (a warp
//    tests a row, a ballot gives a word of the tile's column mask); a tile
//    steps only over the columns from its first non-zero one where it or
//    the triangle has a non-zero entry (the projection rows touch the pose,
//    extrinsic, td and r columns, about 40% of them at (b)). The dense rows
//    (the prior's, the IMU's) come first in the stack and are a leaf of
//    their own, absorbed while the other leaves' tree merges, and merged
//    last. The merges use a counter a pair (zeroed by the wrapper),
//    __threadfence and L1-bypassing loads.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

template <typename T>
struct Lim;
template <>
struct Lim<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <>
struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
  for (int o = 16; o; o >>= 1) x = fmax(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// ---------------------------------------------------------------- stage 1
constexpr int DEP_THREADS = 128;
constexpr int ROW = 27;  // a staged row: 26 Jacobian columns, then the residual

template <typename T>
struct DepthArgs {
  const T* res;        // [F, W1, 2]
  const T* J26;        // [F, W1, 2, 26]
  const T* w;          // [F, W1] Cauchy weights
  const int64_t* cam;  // [F, W1] or null (camera 0)
  T* out;              // [F * 2 W, C]
  int F, W1, nc, ex, td;
};

// Entry `col` of staged row r (frame 1 + r / 2) in the stack's column
// order: pose0 [0, 6), speed-bias0 [6, 15), poses 1..W [15, 15 + 6 W),
// speed-biases 1..W up to 15 W1, the extrinsics (camera-major), td, r.
template <typename T>
__device__ __forceinline__ T row_entry(const T* row, int r, int cj, int ci, int col, int W1,
                                       int nc, int ex, int td) {
  if (col < 6) return row[col];
  if (col < 15) return T(0);
  const int ex0 = 15 * W1;
  if (col < ex0) {
    const int c = col - 15;
    if (c < 6 * (W1 - 1) && c / 6 == r / 2) return row[6 + c % 6];
    return T(0);
  }
  const int tdc = ex0 + 6 * nc;
  if (col < tdc) {
    if (!ex) return T(0);
    const int cam = (col - ex0) / 6, k = (col - ex0) % 6;
    T v = T(0);
    if (cam == cj) v += row[18 + k];
    if (cam == ci) v += row[12 + k];
    return v;
  }
  if (col == tdc) return td ? row[25] : T(0);
  return row[26];
}

template <typename T>
__global__ void __launch_bounds__(DEP_THREADS) marg_depth_kernel(const DepthArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = a.W1 - 1, R2 = 2 * W, C = 15 * a.W1 + 6 * a.nc + 2;
  T* rows = reinterpret_cast<T*>(smem_raw);  // [R2][ROW]
  T* v = rows + R2 * ROW;                     // [R2]
  T* u = v + R2;                              // [C]
  int* camj = reinterpret_cast<int*>(u + C);  // [R2]
  __shared__ T s_tau;
  __shared__ int s_refl;
  const int f = blockIdx.x, tid = threadIdx.x;
  const size_t obs1 = (size_t)f * a.W1 + 1;  // observation (f, frame 1)
  for (int i = tid; i < R2 * 26; i += DEP_THREADS) {
    const int r = i / 26, k = i % 26;
    rows[r * ROW + k] = a.J26[obs1 * 2 * 26 + i] * a.w[obs1 + r / 2];
  }
  for (int r = tid; r < R2; r += DEP_THREADS) {
    rows[r * ROW + 26] = a.res[obs1 * 2 + r] * a.w[obs1 + r / 2];
    camj[r] = a.cam ? (int)a.cam[obs1 + r / 2] : 0;
  }
  const int ci = a.cam ? (int)a.cam[(size_t)f * a.W1] : 0;
  __syncthreads();
  if (tid < 32) {
    T xmax = T(0);
    bool bad = false;
    for (int r = tid; r < R2; r += 32) {
      const T x = rows[r * ROW + 24];
      xmax = fmax(xmax, fabs(x));
      bad |= x != x;
    }
    xmax = warp_max(xmax);
    bad = __any_sync(FULL, bad);
    const bool refl = bad || xmax >= Lim<T>::tiny();
    if (refl) {
      const T inv = T(1) / xmax;
      T ss = T(0);
      for (int r = tid; r < R2; r += 32) {
        const T x = rows[r * ROW + 24] * inv;
        ss += x * x;
      }
      ss = warp_sum(ss);
      const T ah = rows[24] * inv;
      const T bh = -copysign(sqrt(ss), ah);
      const T scal = inv / (ah - bh);
      for (int r = tid; r < R2; r += 32) v[r] = r ? rows[r * ROW + 24] * scal : T(1);
      if (tid == 0) s_tau = (bh - ah) / bh;
    }
    if (tid == 0) s_refl = refl;
  }
  __syncthreads();
  const bool refl = s_refl;
  if (refl) {
    for (int col = tid; col < C; col += DEP_THREADS) {
      T s = T(0);
      for (int r = 0; r < R2; ++r)
        s += v[r] * row_entry(rows + r * ROW, r, camj[r], ci, col, a.W1, a.nc, a.ex, a.td);
      u[col] = s;
    }
  }
  __syncthreads();
  const T tau = s_tau;
  T* out = a.out + (size_t)f * R2 * C;
  for (int r = 0; r < R2; ++r) {
    const T tv = refl ? tau * v[r] : T(0);
    for (int col = tid; col < C; col += DEP_THREADS) {
      const T x = row_entry(rows + r * ROW, r, camj[r], ci, col, a.W1, a.nc, a.ex, a.td);
      out[(size_t)r * C + col] = refl ? (r ? x - tv * u[col] : T(0)) : x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(DEP_THREADS) marg_depth_empty_kernel(const DepthArgs<T> a) {}

template <typename T>
size_t depth_smem(int W1, int nc) {
  const int R2 = 2 * (W1 - 1), C = 15 * W1 + 6 * nc + 2;
  return (size_t)(R2 * ROW + R2 + C) * sizeof(T) + (size_t)R2 * sizeof(int);
}

// ---------------------------------------------------------------- stage 2
constexpr int QR_THREADS = 512;
constexpr int QR_GROUP = 4;                     // threads a column (rows split over them)
constexpr int QR_COLS = QR_THREADS / QR_GROUP;  // columns a block holds at once
constexpr int QR_NCOL = 3;                      // columns a group holds
constexpr int QR_MAXC = QR_COLS * QR_NCOL;      // the widest stack a launch takes
constexpr int QR_MASKW = QR_MAXC / 32;          // words of a column mask
constexpr int QR_WARPS = QR_THREADS / 32;
constexpr int QR_PASS = QR_WARPS;               // rows a gathering pass checks (one a warp)
constexpr int QR_LEAF_ROWS = 512;               // rows a leaf takes after the head

// Rows of the tile a lane holds in registers: the tile has QR_GROUP * RPL rows.
template <typename T>
struct Rpl;
template <>
struct Rpl<float> {
  static constexpr int value = 24;
};
template <>
struct Rpl<double> {
  static constexpr int value = 12;
};

template <typename T>
struct QrArgs {
  const T* A;         // [M, C]
  T* R;               // [NL, C, C] the leaves' triangles
  unsigned* mask;     // [NL, QR_MASKW] each triangle's non-zero columns
  int* count;         // [levels * NL + 1], zero
  int M, C, P, head, NL;
};

template <typename T>
struct Step {
  T tau, beta;
  int skip;
};

struct QrShared {
  int first[QR_PASS], pos[QR_PASS];
  unsigned tmask[QR_MASKW];  // the tile's non-zero columns
  unsigned rmask[QR_MASKW];  // the triangle's
  int cols[QR_MAXC];         // the columns a tile's absorption steps through
  int n, kmin, ncols, arrive;
};

// The pitch of a staged tile row: the least P >= C with P ≡ 8 (mod 32).
__host__ __device__ inline int tile_pitch(int C) { return C + ((8 - C % 32) + 32) % 32; }

template <typename T>
__host__ __device__ inline size_t qr_smem(int P) {
  constexpr int TR = QR_GROUP * Rpl<T>::value;
  return ((size_t)TR * P + 2 * TR + 2 * 3) * sizeof(T);
}

// One reflection from a group's column (its four lanes hold rows gl + 4 i)
// below the pivot a0: writes v (lane-major: the entry of row gl + 4 i at
// gl RPL + i, so that a lane reads its rows' entries with vector loads) and
// the step (skip, τ, β).
template <typename T, int RPL>
__device__ __forceinline__ void group_reflector(const T (&y)[RPL], T a0, Step<T>* st, T* v,
                                                unsigned gmask, int gl) {
  T ymax = T(0);
  int bad = 0;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    ymax = fmax(ymax, fabs(y[i]));
    bad |= y[i] != y[i];
  }
  ymax = fmax(ymax, __shfl_xor_sync(gmask, ymax, 1));
  ymax = fmax(ymax, __shfl_xor_sync(gmask, ymax, 2));
  bad |= __shfl_xor_sync(gmask, bad, 1);
  bad |= __shfl_xor_sync(gmask, bad, 2);
  const bool skip = !bad && (ymax < Lim<T>::tiny() || ymax <= Lim<T>::eps() * fabs(a0));
  if (!skip) {
    const T s = fmax(ymax, fabs(a0));
    const T inv = T(1) / s;
    T ss = T(0);
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const T x = y[i] * inv;
      ss += x * x;
    }
    ss += __shfl_xor_sync(gmask, ss, 1);
    ss += __shfl_xor_sync(gmask, ss, 2);
    const T ah = a0 * inv;
    const T bh = -copysign(sqrt(ah * ah + ss), ah);
    const T scal = inv / (ah - bh);
#pragma unroll
    for (int i = 0; i < RPL; ++i) v[gl * RPL + i] = y[i] * scal;
    if (gl == 0) {
      st->tau = (bh - ah) / bh;
      st->beta = bh * s;
    }
  }
  if (gl == 0) st->skip = skip;
}

// A lane's RPL entries of a reflection, with 16-byte loads.
template <int RPL>
__device__ __forceinline__ void load_lane(const float* p, float (&o)[RPL]) {
  static_assert(RPL % 4 == 0, "float4 loads");
#pragma unroll
  for (int j = 0; j < RPL / 4; ++j) {
    const float4 q = reinterpret_cast<const float4*>(p)[j];
    o[4 * j] = q.x;
    o[4 * j + 1] = q.y;
    o[4 * j + 2] = q.z;
    o[4 * j + 3] = q.w;
  }
}

template <int RPL>
__device__ __forceinline__ void load_lane(const double* p, double (&o)[RPL]) {
  static_assert(RPL % 2 == 0, "double2 loads");
#pragma unroll
  for (int j = 0; j < RPL / 2; ++j) {
    const double2 q = reinterpret_cast<const double2*>(p)[j];
    o[2 * j] = q.x;
    o[2 * j + 1] = q.y;
  }
}

// Absorb the tile staged in Y (n rows) into the triangle R (global), one
// reflection a column of sh.cols: [R[k, k]; tile[:, k]], applied to R's row
// k and the tile's later columns. The tile lives in registers, column j in
// group j mod QR_COLS; the group that holds the next column forms its
// reflection right after its update, so a step ends in one barrier.
template <typename T>
__device__ void absorb(T* R, const T* Y, T* vbuf, Step<T>* st, const QrShared& sh, int n, int C,
                       int P) {
  constexpr int RPL = Rpl<T>::value, TR = QR_GROUP * RPL;
  const int tid = threadIdx.x, lane = tid & 31, g = tid / QR_GROUP, gl = tid % QR_GROUP;
  const unsigned gmask = 0xfu << (lane & ~(QR_GROUP - 1));
  const int nlist = sh.ncols;
  if (!nlist) return;
  int jc[QR_NCOL];
  bool on[QR_NCOL];
  T y[QR_NCOL][RPL], rcur[QR_NCOL], rnext[QR_NCOL];
  int k = sh.cols[0];
#pragma unroll
  for (int c = 0; c < QR_NCOL; ++c) {
    jc[c] = g + QR_COLS * c;
    on[c] = jc[c] < C && ((sh.rmask[jc[c] / 32] | sh.tmask[jc[c] / 32]) >> (jc[c] % 32) & 1u);
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int t = gl + QR_GROUP * i;
      y[c][i] = on[c] && t < n ? Y[(size_t)t * P + jc[c]] : T(0);
    }
    rcur[c] = on[c] && jc[c] >= k ? __ldcg(R + (size_t)k * C + jc[c]) : T(0);
  }
#pragma unroll
  for (int c = 0; c < QR_NCOL; ++c)
    if (jc[c] == k) group_reflector<T, RPL>(y[c], rcur[c], st, vbuf, gmask, gl);
  __syncthreads();
  for (int s = 0; s < nlist; ++s) {
    const int p = s & 1;
    k = sh.cols[s];
    const int kn = s + 1 < nlist ? sh.cols[s + 1] : C;
#pragma unroll
    for (int c = 0; c < QR_NCOL; ++c)
      rnext[c] = on[c] && kn < C && jc[c] >= kn ? __ldcg(R + (size_t)kn * C + jc[c]) : T(0);
    const Step<T> sk = st[p];
    const T* v = vbuf + p * TR;
    if (!sk.skip) {
      if (tid == 0) R[(size_t)k * C + k] = sk.beta;
#pragma unroll
      for (int c = 0; c < QR_NCOL; ++c) {
        if (on[c] && jc[c] > k) {
          T vv[RPL];
          load_lane<RPL>(v + gl * RPL, vv);
          T d4[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
          for (int i = 0; i < RPL; ++i) d4[i % 4] += vv[i] * y[c][i];
          T dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
          dot += __shfl_xor_sync(gmask, dot, 1);
          dot += __shfl_xor_sync(gmask, dot, 2);
          const T tw = sk.tau * (rcur[c] + dot);
          if (gl == 0) R[(size_t)k * C + jc[c]] = rcur[c] - tw;
#pragma unroll
          for (int i = 0; i < RPL; ++i) y[c][i] -= vv[i] * tw;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < QR_NCOL; ++c)
      if (jc[c] == kn && kn < C)
        group_reflector<T, RPL>(y[c], rnext[c], st + (p ^ 1), vbuf + (p ^ 1) * TR, gmask, gl);
#pragma unroll
    for (int c = 0; c < QR_NCOL; ++c) rcur[c] = rnext[c];
    __syncthreads();
  }
}

// The columns a tile's absorption steps through: those >= the tile's first
// non-zero column where the tile or the triangle has a non-zero entry
// (elsewhere a reflection is the identity and an update adds zero).
__device__ void column_list(QrShared& sh, int C) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    unsigned word = 0;
    if (tid < QR_MASKW) {
      word = sh.rmask[tid] | sh.tmask[tid];
      const int lo = sh.kmin - 32 * tid;
      if (lo >= 32) word = 0;
      else if (lo > 0) word &= ~0u << lo;
    }
    const int cnt = __popc(word);
    int before = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL, before, o);
      if (tid >= o) before += x;
    }
    before -= cnt;
    while (word) {
      const int b = __ffs(word) - 1;
      sh.cols[before++] = 32 * tid + b;
      word &= word - 1;
    }
    if (tid == 31) sh.ncols = before;
  }
  __syncthreads();
}

// Absorb the non-zero rows of src [r0, r1) (pitch C) into R, a tile of up
// to TR rows at a time, the rows in their order; sh.rmask is R's column mask
// before and after.
template <typename T>
__device__ void gather_absorb(const T* src, int r0, int r1, T* R, T* Y, T* vbuf, Step<T>* st,
                              QrShared& sh, int C, int P) {
  constexpr int TR = QR_GROUP * Rpl<T>::value;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  auto start_tile = [&] {
    if (tid == 0) {
      sh.n = 0;
      sh.kmin = C;
    }
    if (tid < QR_MASKW) sh.tmask[tid] = 0;
  };
  auto flush = [&] {
    column_list(sh, C);
    absorb(R, Y, vbuf, st, sh, sh.n, C, P);
    if (tid < QR_MASKW) sh.rmask[tid] |= sh.tmask[tid];
    __syncthreads();
    start_tile();
    __syncthreads();
  };
  start_tile();
  __syncthreads();
  for (int cur = r0; cur < r1; cur += QR_PASS) {
    if (sh.n + QR_PASS > TR) flush();
    {
      const int r = cur + warp;
      const T* row = src + (size_t)r * C;
      int first = C;
      for (int m = 0; m < (C + 31) / 32; ++m) {
        const int j = 32 * m + lane;
        const T x = r < r1 && j < C ? __ldcg(row + j) : T(0);
        const unsigned bits = __ballot_sync(FULL, x != T(0));
        if (bits) {
          if (first == C) first = 32 * m + __ffs(bits) - 1;
          if (lane == 0) atomicOr(sh.tmask + m, bits);
        }
      }
      if (lane == 0) sh.first[warp] = first;
    }
    __syncthreads();
    if (tid == 0) {
      int n = sh.n, kmin = sh.kmin;
      for (int i = 0; i < QR_PASS; ++i) {
        sh.pos[i] = sh.first[i] < C ? n++ : -1;
        kmin = min(kmin, sh.first[i]);
      }
      sh.n = n;
      sh.kmin = kmin;
    }
    __syncthreads();
    if (sh.pos[warp] >= 0) {
      const T* row = src + (size_t)(cur + warp) * C;
      T* y = Y + (size_t)sh.pos[warp] * P;
      for (int j = lane; j < C; j += 32) y[j] = __ldcg(row + j);
    }
    __syncthreads();
  }
  if (sh.n > 0) flush();
}

// Wait for the sibling at `slot`: the second of the two to arrive goes on
// (true) and reads the other's triangle.
__device__ bool second_to_arrive(int* count, QrShared& sh) {
  __threadfence();  // this block's triangle and mask, before the count
  __syncthreads();
  if (threadIdx.x == 0) sh.arrive = atomicAdd(count, 1);
  __syncthreads();
  if (sh.arrive == 0) return false;
  __threadfence();  // the sibling's, after its count
  return true;
}

// Absorb triangle `from` into triangle `into` (their masks in global), then
// write the merged mask.
template <typename T>
__device__ void merge(const QrArgs<T>& a, int into, int from, T* Y, T* vbuf, Step<T>* st,
                      QrShared& sh) {
  const size_t CC = (size_t)a.C * a.C;
  if (threadIdx.x < QR_MASKW) sh.rmask[threadIdx.x] = __ldcg(a.mask + into * QR_MASKW + threadIdx.x);
  __syncthreads();
  gather_absorb(a.R + from * CC, 0, a.C, a.R + into * CC, Y, vbuf, st, sh, a.C, a.P);
  if (threadIdx.x < QR_MASKW) a.mask[into * QR_MASKW + threadIdx.x] = sh.rmask[threadIdx.x];
}

// Leaf 0 takes the first `head` rows (the dense prior's), leaves 1.. the
// rest, QR_LEAF_ROWS each; leaves 1.. merge up a binary tree (the right
// child absorbed into the left), and its root last into leaf 0.
template <typename T>
__global__ void __launch_bounds__(QR_THREADS) marg_qr_kernel(const QrArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TR = QR_GROUP * Rpl<T>::value;
  T* Y = reinterpret_cast<T*>(smem_raw);  // [TR][P] the staged tile
  T* vbuf = Y + (size_t)TR * a.P;         // [2][TR] reflections
  Step<T>* st = reinterpret_cast<Step<T>*>(vbuf + 2 * TR);  // [2]
  __shared__ QrShared sh;
  const int tid = threadIdx.x, C = a.C;
  const size_t CC = (size_t)C * C;
  const int node = blockIdx.x;
  T* Rb = a.R + node * CC;
  for (size_t i = tid; i < CC; i += QR_THREADS) Rb[i] = T(0);
  if (tid < QR_MASKW) sh.rmask[tid] = 0;
  __syncthreads();
  const int r0 = node ? a.head + (node - 1) * QR_LEAF_ROWS : 0;
  const int r1 = node ? min(a.M, r0 + QR_LEAF_ROWS) : a.head;
  gather_absorb(a.A, r0, r1, Rb, Y, vbuf, st, sh, C, a.P);
  if (tid < QR_MASKW) a.mask[node * QR_MASKW + tid] = sh.rmask[tid];
  if (a.NL == 1) return;
  if (node) {
    const int nsub = a.NL - 1;
    int v = node - 1;
    for (int step = 1, level = 0; step < nsub; step <<= 1, ++level) {
      const int parent = v & ~(2 * step - 1);
      if ((v ^ step) >= nsub) continue;  // a left child without a sibling
      if (!second_to_arrive(a.count + level * a.NL + parent, sh)) return;
      merge(a, 1 + parent, 1 + parent + step, Y, vbuf, st, sh);
      v = parent;
    }
  }
  int levels = 0;
  while ((1 << levels) < a.NL - 1) ++levels;
  if (!second_to_arrive(a.count + levels * a.NL, sh)) return;
  merge(a, 0, 1, Y, vbuf, st, sh);
}

template <typename T>
__global__ void __launch_bounds__(QR_THREADS) marg_qr_empty_kernel(const QrArgs<T> a) {}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_depth(const void* res, const void* J26, const void* w, const void* cam, int F, int W1,
                 int nc, int ex, int td, void* out, bool empty, cudaStream_t stream) {
  const DepthArgs<T> g{(const T*)res, (const T*)J26, (const T*)w, (const int64_t*)cam, (T*)out,
                       F, W1, nc, ex, td};
  const size_t smem = depth_smem<T>(W1, nc);
  void (*kernel)(const DepthArgs<T>) = empty ? marg_depth_empty_kernel<T> : marg_depth_kernel<T>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<F, DEP_THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_qr(const void* A, int M, int C, int head, int NL, void* R,
              void* mask, void* count, bool empty, cudaStream_t stream) {
  const int P = tile_pitch(C);
  const QrArgs<T> g{(const T*)A, (T*)R, (unsigned*)mask, (int*)count, M, C, P, head, NL};
  const size_t smem = qr_smem<T>(P);
  void (*kernel)(const QrArgs<T>) = empty ? marg_qr_empty_kernel<T> : marg_qr_kernel<T>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<NL, QR_THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// Stage 1 at F slots over W1 frames and nc cameras: the compact rows of
// proj_rows (res [F, W1, 2], J26 [F, W1, 2, 26], w [F, W1]; cam [F, W1]
// int64 or null) of a grid whose used features are anchored at frame 0,
// into out [F * 2 (W1 - 1), 15 W1 + 6 nc + 2]; ex, td: whether the
// extrinsic and td columns are estimated. empty: marg_depth_empty_kernel
// with the same grid, block and shared memory. dtype 0 float32, 1 float64.
extern "C" int marg_depth_launch(const void* res, const void* J26, const void* w,
                                 const void* cam, int F, int W1, int nc, int ex, int td,
                                 int dtype, int empty, void* out, void* stream) {
  if (F < 1 || W1 < 2 || nc < 1 || (dtype != 0 && dtype != 1)) return -1;
  return dtype ? launch_depth<double>(res, J26, w, cam, F, W1, nc, ex, td, out, empty != 0,
                                      (cudaStream_t)stream)
               : launch_depth<float>(res, J26, w, cam, F, W1, nc, ex, td, out, empty != 0,
                                     (cudaStream_t)stream);
}

// The widest stack marg_qr_launch takes, the words of a column mask, the
// rows of a tile (float32: dtype 0, float64: 1) and the rows of a leaf
// after the head.
extern "C" int marg_qr_limits(int dtype, int* max_cols, int* mask_words, int* tile_rows,
                              int* leaf_rows) {
  *max_cols = QR_MAXC;
  *mask_words = QR_MASKW;
  *tile_rows = QR_GROUP * (dtype ? Rpl<double>::value : Rpl<float>::value);
  *leaf_rows = QR_LEAF_ROWS;
  return 0;
}

// Stage 2: the R factor of A [M, C] (C <= QR_MAXC) into R[0] of the
// workspace R [NL, C, C] (its lower triangle zero): leaf 0 takes rows
// [0, head), leaves 1.. QR_LEAF_ROWS rows each, NL = 1 + ceil((M - head) /
// QR_LEAF_ROWS); mask [NL, QR_MASKW] uint32 scratch; count [levels * NL +
// 1] int32, zero (levels = ceil(log2(NL - 1))). empty: marg_qr_empty_kernel
// with the same grid, block and shared memory.
extern "C" int marg_qr_launch(const void* A, int M, int C, int head, int NL, int dtype,
                              int empty, void* R, void* mask, void* count, void* stream) {
  if (M < 1 || C < 1 || C > QR_MAXC || head < 0 || head > M ||
      NL != 1 + (M - head + QR_LEAF_ROWS - 1) / QR_LEAF_ROWS || (dtype != 0 && dtype != 1))
    return -1;
  return dtype ? launch_qr<double>(A, M, C, head, NL, R, mask, count, empty != 0,
                                   (cudaStream_t)stream)
               : launch_qr<float>(A, M, C, head, NL, R, mask, count, empty != 0,
                                  (cudaStream_t)stream);
}
