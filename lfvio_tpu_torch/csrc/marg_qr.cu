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
//    prior's rows alone), C <= 384, as a tree of blocked Householder QRs
//    (TSQR). Each block (a leaf) takes a range of rows, lists its non-zero
//    rows and absorbs them, a tile of up to TR rows at a time, into its own
//    C x C triangle R_b. A tile is swept in panels of NB columns: one warp
//    factors the panel ([R_b's panel rows; the tile's panel columns], one
//    reflection a column) and forms its compact WY factor T, then the whole
//    block applies I - V T Vᵀ to the later columns of the tile and of the
//    panel's rows of R_b. Leaf 0 takes the dense head (the first rows),
//    ordered by their first non-zero column; the other leaves' triangles
//    merge up a binary tree, the right one's non-zero rows absorbed into
//    the left one's in place, and the tree's root last into leaf 0's
//    triangle, R_0, the result. Each merge is a block of its own that runs
//    beside the blocks it reads: it sweeps a panel once both triangles have
//    finished that panel's rows (a tiled QR's DAG), so the tree's levels
//    overlap instead of following each other. The order of every sum is
//    fixed, so a repeat is bit-identical. A column whose part to eliminate
//    is zero (or below the rounding unit of its pivot, or below the type's
//    smallest normal number) takes no reflection and consumes no row (its τ
//    and its column of T are zero): where a dropped column is empty its row
//    of R stays zero and no information is lost, as the unit rows of the
//    dense form give, and a kept column without information leaves the
//    residual's rest in the last row (r0 is then the minimum-norm one, as
//    the eigh form's, up to the rounding-level pivots of such columns).
//
// Replaces what XLA computes inside the JAX package's MARGIN_OLD and
// SECOND_NEW programs: jnp.linalg.qr(A, mode="r") of the dense stacked
// matrix in lfvio_tpu/backend/marginalize.py:260 (marginalize_old_qr, :207;
// A = [pose0/sb0 | F anchored depths | kept | r], the depths an F x F
// expansion of J_lam with one non-zero a row) and :297
// (marginalize_second_new_qr, :276). There is no Pallas kernel behind them.
//
// What bounds it on an H100: the longest chain of dependent column
// reflections. At the high-rate estimator's MARGIN_OLD (window 20, 384
// slots, C = 323) the stack has M ≈ 15,700 rows, about 10,800 of them
// non-zero, and Householder QR of those is about 2 n C² operations
// (chip_smoke.marg_bound_ms): tens of microseconds of the card's float32
// rate. A reflection needs the column's norm and its dot products with the
// later columns, each a reduction over the tile's rows, so each column is a
// few dependent shuffle levels, a square root and two reciprocals: ~1,200
// SM cycles a column step inside a panel (marg_stamps.py), where the first
// design of this kernel took ~1,900 a column and a block barrier. The chain
// at that size is a leaf's three sweeps of ~134 columns, then the tree's
// merges (pipelined behind it) and the final merge's 323 columns. Stage 1
// writes the stack (20 MB at that size) and is bound by those bytes.
//
// Design:
//  * stage 1: a block of 256 threads a feature (DEP_THREADS), two
//    block barriers. The block copies the slot's inputs into shared memory
//    (16-byte cp.async, one round of loads in flight: a loop of loads that
//    each wait before the next was the first cost found by clock64 stamps,
//    marg_stamps.py) and builds a table of the C columns (each one's
//    compact column, the rows that carry it, the end of its run of empty
//    columns). Then every warp forms the reflection in registers from the
//    staged depth column (two rows a lane; one butterfly for the largest
//    entry and the sum of squares; the sign of β opposite x_0's so that
//    x_0 - β does not cancel), so that no warp waits for another's;
//    u = vᵀA is summed only where the rows are non-zero (a frame's pose
//    over its two rows, pose0, the extrinsics, td and r over all), each
//    kind of column in a loop of its own, and the compact rows (the 14 +
//    6 nc columns a row can touch, weighted) are staged, every entry by
//    the same arithmetic. The slot's 2 W C entries are one flat run
//    written with 16-byte stores across the block from the first 16-byte
//    boundary (out needs no alignment); the speed-bias columns, more than
//    half of the stack's, are stores without arithmetic.
//  * stage 2: a block of 256 threads a leaf, one block an SM (its tile takes
//    most of the shared memory). A leaf first scans its rows (each row's
//    first non-zero column, four rows a warp in flight), lists the non-zero
//    ones (leaf 0 sorted by that column, so that each tile's sweep starts as
//    late as it can) and stages them, TR at a time, in shared memory. A
//    sweep steps over the columns from the tile's first non-zero one where
//    the tile or the triangle has a non-zero entry (masks), NB at a time.
//    The panel: warp 0 holds its NB columns in registers, a row a lane
//    (TR / 32 rows each); a column's step is one transposed butterfly that
//    gives every lane the sum for one column (the norm, the dot products
//    with the later columns and with the earlier reflectors, which fill T's
//    column), a redux for the largest entry, a shuffle to broadcast each
//    update, no barrier; the norm is unscaled when the column's largest
//    entry lies in a safe range, else taken again scaled by it. The update:
//    four threads a later column (the rows split over them), W = Vᵀ A from
//    the compact reflectors (a row of NB values read with 16-byte loads),
//    W' = Tᵀ W, then R -= W' and A -= V W'. Look-ahead: while warps 1..7
//    apply panel p's update (the next panel's columns first, then a named
//    barrier that warp 0 waits at), warp 0 factors panel p + 1 into a
//    second buffer; one block barrier a panel. R_b lives in global memory
//    (L2): a panel's rows of it are read once and written once a sweep, the
//    next panel's diagonal block read by warp 0 while it waits.
//  * the tree: 2 NL - 1 blocks, NL leaves and NL - 1 merges. A block takes
//    a ticket as it starts (leaves first, then the merges level by level,
//    the root into leaf 0 last) and waits only for smaller tickets, blocks
//    that have started: no block waits for one that cannot run. A node
//    publishes its mask (leaves: the OR of their rows', before absorbing
//    them; merges: the OR of their two) and its progress (the column below
//    which its triangle's rows are final: along its last tile's sweep, after
//    each panel's barrier, every thread's writes fenced; a merge never past
//    what its triangle's writer has published, and after its sweeps it
//    forwards that writer's progress), in flags the wrapper zeroes. A merge
//    waits for both masks (its column list), then
//    before each panel for both triangles' progress past it; it stages the
//    absorbed triangle's rows as the sweep reaches their columns (a row k
//    is zero before column k, so no earlier reflection reads or changes
//    it), TR of them, and takes any more in a second sweep. Reads of another
//    block's triangle bypass L1.

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
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fc00000); }
};
template <>
struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
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
constexpr int DEP_THREADS = 256;  // a slot's block
constexpr int DEP_MAXR = 64;  // a slot's rows a warp holds to form the reflection, two a lane
constexpr int DEP_GROUP = 8;  // lanes that sum one column over all of a slot's rows
static_assert(DEP_THREADS % 32 == 0, "whole warps");

template <typename T>
struct DepthArgs {
  const T* res;        // [F, W1, 2]
  const T* J26;        // [F, W1, 2, 26]
  const T* w;          // [F, W1] Cauchy weights
  const int64_t* cam;  // [F, W1] or null (camera 0)
  T* out;              // [F * 2 W, C]
  int F, W1, nc, ex, td;
};

// A column of the stack in a slot's table: vᵀA of the column (0 where the
// slot takes no reflection) and its code, q | g << 10 | zrun << 17: q the
// column of the slot's compact rows that holds its entries (pose0 [0, 6),
// the observing frame's pose [6, 12), the extrinsic blocks camera-major
// [12, 12 + 6 nc), td, r), g the rows that carry it (0 none: an empty
// column; 1 all; 2 + p rows 2 p and 2 p + 1 alone, the observations of
// frame p + 1), zrun the first column at or after it that is not empty.
template <typename T>
struct alignas(2 * sizeof(T) > 8 ? 16 : 8) DepCol {
  T u;
  int code;
};

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<double> {
  static __device__ __forceinline__ void store(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// The range of a depth column's largest entry in which its norm is summed
// unscaled (the squares of 2 W entries neither overflow nor lose a digit to
// underflow); outside it the entries are scaled by the largest, as
// depth_plain does.
template <typename T>
struct DepRange;
template <>
struct DepRange<float> {
  static constexpr float LO = 0x1p-40f, HI = 0x1p40f;
};
template <>
struct DepRange<double> {
  static constexpr double LO = 0x1p-400, HI = 0x1p400;
};

// Column `col`'s code in the stack's column order: pose0 [0, 6),
// speed-bias0 [6, 15), poses 1..W [15, 15 + 6 W), speed-biases 1..W up to
// 15 W1, the extrinsics (camera-major), td, r.
__device__ __forceinline__ int depth_code(int col, int W1, int nc, int ex, int td) {
  const int W = W1 - 1, e0 = 15 * W1, tdc = e0 + 6 * nc, C = tdc + 2;
  int q = 0, g = 0;
  if (col < 6) {
    q = col, g = 1;
  } else if (col >= 15 && col < 15 + 6 * W) {
    q = 6 + (col - 15) % 6, g = 2 + (col - 15) / 6;
  } else if (col >= e0 && col < tdc) {
    q = 12 + col - e0, g = ex;
  } else if (col == tdc) {
    q = 12 + 6 * nc, g = td;
  } else if (col == C - 1) {
    q = 13 + 6 * nc, g = 1;
  }
  int zrun = col;
  if (!g) zrun = col < 15 ? 15 : (ex && col < e0 ? e0 : (td && col < tdc ? tdc : C - 1));
  return q | g << 10 | zrun << 17;
}

// Where column col sits in the table: VEC interleaved runs, so that the
// lanes of a warp, VEC columns apart, read consecutive entries.
template <int VEC>
__device__ __forceinline__ int depth_slot(int col, int CV) {
  return (col % VEC) * CV + col / VEC;
}

// One asynchronous copy of N bytes (4, 8 or 16) from global into shared
// memory, and the wait for all of a thread's copies.
template <int N>
__device__ __forceinline__ void copy_async(void* dst_shared, const void* src_global) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src_global) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src_global), "n"(N)
                 : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Where the compact column q of a row comes from (depth_source): s1 | s2 <<
// 5 | c << 10, s1 and s2 entries of the row's raw Jacobian (26: its
// residual; 31: none), s1 taken where the row's camera is c (255: any), s2
// where the anchor's is; compact columns pose0 [0, 6), the observing
// frame's pose [6, 12), the extrinsic blocks [12, 12 + 6 nc) (the row's
// camera's block, then the anchor's, added), td, r.
__device__ __forceinline__ int depth_source(int q, int nc, int ex, int td) {
  constexpr int NONE = 31, ANY = 255;
  if (q < 12) return q | NONE << 5 | ANY << 10;
  if (q < 12 + 6 * nc) {
    const int c = (q - 12) / 6, k = (q - 12) % 6;
    return ex ? (18 + k) | (12 + k) << 5 | c << 10 : NONE | NONE << 5 | ANY << 10;
  }
  if (q == 12 + 6 * nc) return (td ? 25 : NONE) | NONE << 5 | ANY << 10;
  return 26 | NONE << 5 | ANY << 10;
}

// A slot's inputs in shared memory: its rows' raw Jacobians and residuals
// (unweighted, as proj_rows wrote them), the weights and cameras of its
// observations, and each compact column's depth_source.
template <typename T>
struct DepthRows {
  const T* J;          // [2 W][26]
  const T* res;        // [2 W]
  const T* w;          // [W] frames 1..W
  const int64_t* cam;  // [W1] frames 0..W, or null (camera 0)
  const int* src;      // [14 + 6 nc]

  // Entry q of the compact row r (weighted), the same arithmetic for every
  // column (no branch on its kind).
  __device__ __forceinline__ T at(int r, int q) const {
    const int k = src[q], s1 = k & 31, s2 = (k >> 5) & 31, c = k >> 10;
    const T* row = J + r * 26;
    const T wr = w[r >> 1];
    const int cj = cam ? (int)cam[1 + (r >> 1)] : 0, ci = cam ? (int)cam[0] : 0;
    T x = T(0);
    if (s1 != 31 && (c == 255 || cj == c)) x = (s1 == 26 ? res[r] : row[s1]) * wr;
    if (s2 != 31 && ci == c) x += row[s2] * wr;
    return x;
  }
  // The depth column's entry of row r (weighted).
  __device__ __forceinline__ T depth(int r) const { return J[r * 26 + 24] * w[r >> 1]; }
};

// The reflection of a slot's depth column x (R2 <= DEP_MAXR rows), formed
// by every lane of a warp from the rows in shared memory, two a lane: one
// butterfly for the largest magnitude and the sum of squares together,
// the norm taken again scaled by the largest where it lies outside
// DepRange (depth_plain's form). v_r = scal x_r (r >= 1), v_0 = 1, H = I -
// τ v vᵀ; refl: a reflection is applied (the column is not all zero);
// zval: what an empty column's u is, scal Σ x_r 0 (NaN where the
// reflection is not finite). Each lane also keeps its own two x_r.
template <typename T>
struct DepthRefl {
  T x[2], scal, tau, zval;
  bool refl;

  __device__ __forceinline__ DepthRefl(const DepthRows<T>& rows, int R2, int lane) {
    T mx = T(0), ss = T(0);
    bool bad = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      x[h] = r < R2 ? rows.depth(r) : T(0);
      bad |= !isfinite(x[h]);
      mx = fmax(mx, fabs(x[h]));
      ss += x[h] * x[h];
    }
    for (int o = 16; o; o >>= 1) {
      mx = fmax(mx, __shfl_xor_sync(FULL, mx, o));
      ss += __shfl_xor_sync(FULL, ss, o);
    }
    bad = __any_sync(FULL, bad);
    const T x0 = __shfl_sync(FULL, x[0], 0);
    refl = bad || mx >= Lim<T>::tiny();
    scal = tau = T(0);
    if (refl) {
      if (mx >= DepRange<T>::LO && mx <= DepRange<T>::HI) {
        const T b = -copysign(sqrt(ss), x0);
        scal = T(1) / (x0 - b);
        tau = (b - x0) / b;
      } else {
        const T inv = T(1) / mx;
        T sh = T(0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const T y = x[h] * inv;
          sh += y * y;
        }
        sh = warp_sum(sh);
        const T ah = x0 * inv, bh = -copysign(sqrt(sh), ah);
        scal = inv / (ah - bh);
        tau = (bh - ah) / bh;
      }
    }
    const bool finite = !bad && isfinite(scal) && isfinite(tau);
    zval = refl && !finite ? Lim<T>::nan() : T(0);
  }
};

// A block a slot. (1) All threads copy the slot's inputs into shared
// memory (16-byte cp.async for its Jacobian rows), one round of loads in
// flight, and build the column table. (2) Every warp forms the slot's
// reflection in registers from the staged depth column (DepthRefl: no
// warp waits for another's); u = vᵀA = A[0] + scal Σ_{r >= 1} x_r A[r] a
// column, where v_r = scal x_r: pose0, the extrinsics, td and r over all
// rows (eight lanes a column), a frame's pose over its two rows, an empty
// column zval, each kind in a loop of its own (a warp's lanes take one
// path); the compact rows [2 W][14 + 6 nc] staged beside the sums, every
// entry by the same arithmetic from its column's depth_source.
// (3) The slot's 2 W rows are one flat range of 2 W C entries, written from
// the first 16-byte boundary on with 16-byte stores across the block (the
// entries before it and after the last whole chunk one at a time); a chunk
// of VEC empty columns of one row stores its value without arithmetic, any
// other entry is A[r, col] - τ v_r u_col (the pivot row 0), or A[r, col]
// where the slot takes no reflection (an all-zero depth column).
template <typename T>
__global__ void __launch_bounds__(DEP_THREADS) marg_depth_kernel(const DepthArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int VEC = 16 / sizeof(T);
  const int W1 = a.W1, W = W1 - 1, nc = a.nc, R2 = 2 * W, Q = 14 + 6 * nc;
  const int C = 15 * W1 + 6 * nc + 2, CV = (C + VEC - 1) / VEC;
  DepCol<T>* tab = reinterpret_cast<DepCol<T>*>(smem_raw);      // [VEC][CV]
  T* J = reinterpret_cast<T*>(tab + VEC * CV);                    // [R2][26]
  int64_t* cam = reinterpret_cast<int64_t*>(J + R2 * 26);        // [W1]
  T* res = reinterpret_cast<T*>(cam + W1);                        // [R2]
  T* wt = res + R2;                                               // [W]
  T* cr = wt + W;                                                 // [R2][Q] the compact rows
  T* tv = cr + R2 * Q;                                            // [R2] τ v_r
  int* src = reinterpret_cast<int*>(tv + R2);                     // [Q] depth_source
  const int f = blockIdx.x, tid = threadIdx.x;
  const size_t obs1 = (size_t)f * W1 + 1;  // observation (f, frame 1)
  const T* __restrict__ Jg = a.J26 + obs1 * 52;
  if ((reinterpret_cast<uintptr_t>(Jg) & 15) == 0) {
    for (int i = tid; i < R2 * 26 / VEC; i += DEP_THREADS) copy_async<16>(J + i * VEC, Jg + i * VEC);
  } else {
    for (int i = tid; i < R2 * 26; i += DEP_THREADS) copy_async<sizeof(T)>(J + i, Jg + i);
  }
  for (int i = tid; i < R2; i += DEP_THREADS) copy_async<sizeof(T)>(res + i, a.res + obs1 * 2 + i);
  for (int i = tid; i < W; i += DEP_THREADS) copy_async<sizeof(T)>(wt + i, a.w + obs1 + i);
  if (a.cam)
    for (int i = tid; i < W1; i += DEP_THREADS) copy_async<8>(cam + i, a.cam + obs1 - 1 + i);
  for (int col = tid; col < C; col += DEP_THREADS)
    tab[depth_slot<VEC>(col, CV)].code = depth_code(col, W1, nc, a.ex, a.td);
  for (int q = tid; q < Q; q += DEP_THREADS) src[q] = depth_source(q, nc, a.ex, a.td);
  copy_async_wait();
  __syncthreads();
  const DepthRows<T> rows{J, res, wt, a.cam ? cam : nullptr, src};
  const DepthRefl<T> hh(rows, R2, tid & 31);
  const bool refl = hh.refl;
  const T scal = hh.scal, zval = hh.zval;
  if (tid < 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tid + 32 * h;
      if (r < R2) tv[r] = refl ? hh.tau * (r ? hh.x[h] * scal : T(1)) : T(0);
    }
  }
  if (refl) {  // pose0, the extrinsics, td and r: DEP_GROUP lanes a column
    const int nA = 7 + (a.ex ? 6 * nc : 0) + a.td;
    for (int base = 0; base < nA * DEP_GROUP; base += DEP_THREADS) {
      if (base + (tid & ~31) >= nA * DEP_GROUP) break;  // whole warps take part
      const int g = (base + tid) / DEP_GROUP, l = tid % DEP_GROUP;
      int q = 0, col = 0;
      if (g < 6) {
        q = col = g;
      } else if (a.ex && g < 6 + 6 * nc) {
        q = 12 + g - 6, col = 15 * W1 + g - 6;
      } else {
        const int k = g - 6 - (a.ex ? 6 * nc : 0) + (a.td ? 0 : 1);  // 0 td, 1 r
        q = 12 + 6 * nc + k, col = 15 * W1 + 6 * nc + k;
      }
      T s = T(0);
      if (g < nA)
        for (int r = 1 + l; r < R2; r += DEP_GROUP) s += rows.depth(r) * rows.at(r, q);
      for (int o = DEP_GROUP / 2; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (g < nA && l == 0) tab[depth_slot<VEC>(col, CV)].u = rows.at(0, q) + scal * s;
    }
  }
  if (refl) {  // the frames' poses: frame 1 + p over its rows 2 p, 2 p + 1
    for (int i = tid; i < 6 * W; i += DEP_THREADS) {
      const int p = i / 6, q = 6 + i % 6, r0 = 2 * p, r1 = r0 + 1;
      const T s1 = rows.depth(r1) * rows.at(r1, q);
      const T s = r0 ? rows.depth(r0) * rows.at(r0, q) + s1 : s1;
      tab[depth_slot<VEC>(15 + i, CV)].u = (r0 ? T(0) : rows.at(0, q)) + scal * s;
    }
  }
  for (int col = tid; col < C; col += DEP_THREADS) {  // the empty columns; all without one
    DepCol<T>& e = tab[depth_slot<VEC>(col, CV)];
    if (!refl || !((e.code >> 10) & 127)) e.u = refl ? zval : T(0);
  }
  for (int i = tid; i < R2 * Q; i += DEP_THREADS) {
    const int r = i / Q;
    cr[i] = rows.at(r, i - r * Q);
  }
  __syncthreads();
  const int E = R2 * C;
  T* out = a.out + (size_t)f * E;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(out);
  const int h = min(E, addr % sizeof(T) ? E : (int)(((16 - (addr & 15)) & 15) / sizeof(T)));
  const int nch = (E - h) / VEC, t0 = h + nch * VEC;
  auto value = [&](int r, int col, const DepCol<T>& e) {
    const int g = (e.code >> 10) & 127;
    const bool on = g == 1 || g == (r >> 1) + 2;
    const T x = on ? cr[r * Q + (e.code & 1023)] : T(0);
    return refl && r == 0 ? T(0) : x - tv[r] * e.u;
  };
  for (int i = tid; i < h; i += DEP_THREADS) {  // before the first 16-byte boundary
    const int r = i / C, col = i - r * C;
    out[i] = value(r, col, tab[depth_slot<VEC>(col, CV)]);
  }
  for (int i = t0 + tid; i < E; i += DEP_THREADS) {  // after the last whole chunk
    const int r = i / C, col = i - r * C;
    out[i] = value(r, col, tab[depth_slot<VEC>(col, CV)]);
  }
  constexpr int STEP = DEP_THREADS * VEC;
  const int dq = STEP / C, dm = STEP % C;
  int rb = (h + tid * VEC) / C, cb = h + tid * VEC - rb * C;
  for (int i = tid; i < nch; i += DEP_THREADS) {
    T vals[VEC];
    const DepCol<T> e0 = tab[depth_slot<VEC>(cb, CV)];
    if ((e0.code >> 17) >= cb + VEC) {  // VEC empty columns of one row
      const T z = refl && rb == 0 ? T(0) : zval;
#pragma unroll
      for (int k = 0; k < VEC; ++k) vals[k] = z;
    } else {
      int r = rb, col = cb;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        vals[k] = value(r, col, k ? tab[depth_slot<VEC>(col, CV)] : e0);
        if (++col == C) col = 0, ++r;
      }
    }
    Vec16<T>::store(out + h + (size_t)i * VEC, vals);
    cb += dm, rb += dq;
    if (cb >= C) cb -= C, ++rb;
  }
}

template <typename T>
__global__ void __launch_bounds__(DEP_THREADS) marg_depth_empty_kernel(const DepthArgs<T> a) {}

template <typename T>
size_t depth_smem(int W1, int nc) {
  constexpr int VEC = 16 / sizeof(T);
  const int W = W1 - 1, R2 = 2 * W, C = 15 * W1 + 6 * nc + 2, Q = 14 + 6 * nc;
  return (size_t)VEC * ((C + VEC - 1) / VEC) * sizeof(DepCol<T>) + (size_t)W1 * sizeof(int64_t) +
         (size_t)(R2 * 26 + R2 + W + R2 * Q + R2) * sizeof(T) + (size_t)Q * sizeof(int);
}


// ---------------------------------------------------------------- stage 2
constexpr int QR_THREADS = 256;
constexpr int QR_WARPS = QR_THREADS / 32;
constexpr int QR_MAXC = 384;               // the widest stack a launch takes
constexpr int QR_MASKW = QR_MAXC / 32;     // words of a column mask
constexpr int QR_LEAF_ROWS = 256;          // rows a leaf takes after the head
constexpr int QR_LIST = 512;               // rows a leaf lists at once (the head in chunks)
constexpr int NB = 16;                     // columns of a panel
constexpr int GROUP = 4;                   // threads a later column of an update
constexpr int SCAN_ROWS = 4;               // rows a warp loads at once
static_assert(GROUP == 4 && NB % GROUP == 0 && QR_LIST % QR_THREADS == 0, "layout");

// A tile's rows (a panel row a lane holds TR / 32 of them), the pitch of
// the compact reflectors (16-byte rows whose starts fall on distinct banks
// for the four rows an update group reads), and the range of a column's
// largest entry in which its norm is summed unscaled (the squares neither
// overflow nor lose a digit to underflow).
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int TR = 128;
  static constexpr int YP = NB + 4;
  static constexpr float LO = 0x1p-40f, HI = 0x1p40f;
};
template <>
struct Tile<double> {
  static constexpr int TR = 64;
  static constexpr int YP = NB + 2;
  static constexpr double LO = 0x1p-400, HI = 0x1p400;
};

template <typename T>
struct QrArgs {
  const T* A;         // [M, C]
  T* R;               // [NL, C, C] the leaves' triangles, merged in place into the left ones
  unsigned* mask;     // [NL, QR_MASKW] each triangle's non-zero columns
  int* sync;          // [1 + 2 (2 NL - 1)], zero: a ticket, then each node's ready flag and
                      // progress (rows of its triangle below that column are final)
  int M, C, P, head, NL;
};

struct QrShared {
  unsigned tmask[QR_MASKW];  // the tile's non-zero columns
  unsigned rmask[QR_MASKW];  // the triangle's
  unsigned fmask[QR_MASKW];  // a leaf: all its rows'; a merge: the absorbed triangle's
  int cols[QR_MAXC];         // the columns a sweep steps through
  int list[QR_LIST];         // the rows to absorb, in order
  int first[QR_LIST];        // a scanned row's first non-zero column (C: none)
  int wsum[QR_WARPS];
  int nf[2];                 // the tile's rows when each buffer's panel was factored
  int ncols, kmin, nlist, staged, ticket;
};

// The pitch of a staged tile row: the least P >= C with P sizeof(T) ≡ 32
// (mod 128), so that an update group's four rows (4 t + r) and eight
// neighbouring columns fall on distinct banks.
template <typename T>
__host__ __device__ inline int tile_pitch(int C) {
  constexpr int m = 128 / (int)sizeof(T), r = 32 / (int)sizeof(T);
  return C + ((r - C % m) + m) % m;
}

// The dynamic shared memory: the tile [TR][P], two panels' compact
// reflectors [2][TR][YP] and Tᵀ [2][NB][NB] (one panel's update reads one
// while warp 0 factors the next into the other).
template <typename T>
__host__ __device__ inline size_t qr_smem(int P) {
  return ((size_t)Tile<T>::TR * (P + 2 * Tile<T>::YP) + 2 * NB * NB) * sizeof(T);
}

// The barrier between warp 0 and the threads that update the next panel's
// columns (warps 1 and 2): they arrive, warp 0 waits, then factors it.
constexpr int AHEAD_THREADS = 96;
__device__ __forceinline__ void ahead_wait() {
  asm volatile("bar.sync 1, %0;" ::"n"(AHEAD_THREADS) : "memory");
}
__device__ __forceinline__ void ahead_arrive() {
  asm volatile("bar.arrive 1, %0;" ::"n"(AHEAD_THREADS) : "memory");
}

// NB values of a row, with 16-byte loads.
__device__ __forceinline__ void load16(const float* p, float (&o)[NB]) {
#pragma unroll
  for (int j = 0; j < NB / 4; ++j) {
    const float4 q = reinterpret_cast<const float4*>(p)[j];
    o[4 * j] = q.x;
    o[4 * j + 1] = q.y;
    o[4 * j + 2] = q.z;
    o[4 * j + 3] = q.w;
  }
}

__device__ __forceinline__ void load16(const double* p, double (&o)[NB]) {
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    const double2 q = reinterpret_cast<const double2*>(p)[j];
    o[2 * j] = q.x;
    o[2 * j + 1] = q.y;
  }
}

// The largest of the lanes' m >= 0 (or NaN, which wins): float32 in one
// redux on the bit patterns (non-negative floats order as their bits).
__device__ __forceinline__ float col_max(float m) {
  return __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(m)));
}
__device__ __forceinline__ double col_max(double m) { return warp_max(m); }

// The correctly rounded reciprocal (faster than a division's sequence).
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// One level of transpose_sum: lanes with bit H keep the upper H of their
// first 2 H values and send the lower ones to their partner, which keeps
// the lower ones. H is a template argument so that every index into a is a
// constant (a level loop that the compiler leaves rolled indexes the
// registers at run time, with a branch around each shuffle: ~5 times the
// step's time on an H100).
template <int H, typename T>
__device__ __forceinline__ void halve(T (&a)[NB], int lane) {
  const bool hi = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T send = hi ? a[i] : a[i + H];
    const T keep = hi ? a[i + H] : a[i];
    a[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// The sums over the warp of a[c], c < 16, each lane's own values: lane l
// (and l + 16) returns the one of column l & 15. Four levels that halve the
// values a lane holds, then one plain level (16 shuffles in all, where 16
// butterflies would take 80).
template <typename T>
__device__ __forceinline__ T transpose_sum(T (&a)[NB], int lane) {
  static_assert(NB == 16, "four halving levels");
  halve<8>(a, lane);
  halve<4>(a, lane);
  halve<2>(a, lane);
  halve<1>(a, lane);
  return a[0] + __shfl_xor_sync(FULL, a[0], 16);
}

// Warp 0's lanes c and c + 16: R[k_i, k_c] of the panel's diagonal block
// (its columns pc[0 .. cnt)), i <= c; zero elsewhere.
template <typename T>
__device__ __forceinline__ void load_diag(const T* R, const int* pc, int cnt, int C, T (&rp)[NB]) {
  const int c = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < NB; ++i)
    rp[i] = i <= c && c < cnt ? __ldcg(R + (size_t)pc[i] * C + pc[c]) : T(0);
}

// Warp 0: factor the panel of columns pc[0 .. cnt) of the tile X (n rows)
// below R's diagonal block rp (load_diag), one reflection a column of
// [R[k_j, k_j]; X[:, k_j]]; writes the reflectors' tile parts into Yc
// (zero for a skipped column), Tᵀ into Tt and the block back into R. The
// step's loop is not unrolled (its column j picked out of the registers by
// selects): unrolled, the kernel measured slower on an H100 (MARGIN_OLD at
// (b) 1.824 against 1.732 ms, turns.py marg), its code ~16 times larger.
template <typename T>
__device__ void panel_factor(T* R, const T* X, int P, int n, const int* pc, int cnt, int C,
                             T (&rp)[NB], T* Yc, T* Tt) {
  constexpr int RPL = Tile<T>::TR / 32, YP = Tile<T>::YP;
  const int lane = threadIdx.x & 31, cl = lane & 15;
  T y[RPL][NB];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int t = lane + 32 * i;
#pragma unroll
    for (int c = 0; c < NB; ++c) y[i][c] = t < n && c < cnt ? X[(size_t)t * P + pc[c]] : T(0);
  }
  T trow[NB];  // row cl of T
#pragma unroll
  for (int c = 0; c < NB; ++c) trow[c] = T(0);
#pragma unroll 1
  for (int j = 0; j < cnt; ++j) {
    T rj = T(0), x[RPL];  // this lane's R[k_j, k_cl]; column j's rows
#pragma unroll
    for (int c = 0; c < NB; ++c) rj = c == j ? rp[c] : rj;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      x[i] = T(0);
#pragma unroll
      for (int c = 0; c < NB; ++c) x[i] = c == j ? y[i][c] : x[i];
    }
    const T a0 = __shfl_sync(FULL, rj, j);
    // One pass: column j's largest entry, its sum of squares, its dot
    // products with the later columns and with the earlier reflectors.
    T part[NB], mx = T(0);
    int bad = 0;
#pragma unroll
    for (int c = 0; c < NB; ++c) part[c] = T(0);
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      mx = fmax(mx, fabs(x[i]));
      bad |= x[i] != x[i];
#pragma unroll
      for (int c = 0; c < NB; ++c) part[c] += x[i] * y[i][c];
    }
    T tot = transpose_sum(part, lane);
    mx = col_max(mx);
    bad = __any_sync(FULL, bad);
    T ss = __shfl_sync(FULL, tot, j);
    const bool skip = !bad && (mx < Lim<T>::tiny() || mx <= Lim<T>::eps() * fabs(a0));
    T scal = T(0), u = T(0), tau = T(0);  // u: lane cl's update of column cl (> j), or
                                          // G[cl][j] = v_clᵀ v_j (< j)
    if (!skip) {
      const T s = fmax(mx, fabs(a0));
      T f = T(1);
      if (!(s >= Tile<T>::LO && s <= Tile<T>::HI)) {  // the sums again, scaled by 1 / s
        f = T(1) / s;
#pragma unroll
        for (int c = 0; c < NB; ++c) part[c] = T(0);
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          const T xs = x[i] * f;
#pragma unroll
          for (int c = 0; c < NB; ++c) part[c] += xs * y[i][c];
        }
        tot = transpose_sum(part, lane);
        ss = f * __shfl_sync(FULL, tot, j);
      }
      const T ah = a0 * f;
      const T bh = -copysign(sqrt(ah * ah + ss), ah);
      const T coef = rcp(ah - bh);  // v = f coef x: vᵀ y_c = coef tot_c
      scal = f * coef;
      tau = (bh - ah) * rcp(bh);
      const T g = coef * tot;
      if (cl > j) {
        u = tau * (rj + g);
        rj -= u;
      } else if (cl < j) {
        u = g;
      } else {
        rj = f == T(1) ? bh : bh * s;
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) rp[c] = c == j ? rj : rp[c];
    }
    T v[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) v[i] = x[i] * scal;
    T acc = T(0);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const T uc = __shfl_sync(FULL, u, c);
      const T w = c > j ? uc : T(0);
      acc += c < j ? trow[c] * uc : T(0);
#pragma unroll
      for (int i = 0; i < RPL; ++i) y[i][c] = c == j ? v[i] : y[i][c] - v[i] * w;
    }
    const T tj = cl < j ? -tau * acc : (cl == j ? tau : T(0));
#pragma unroll
    for (int c = 0; c < NB; ++c) trow[c] = c == j ? tj : trow[c];
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int t = lane + 32 * i;
    if (t < n) {
#pragma unroll
      for (int c = 0; c < NB; ++c) Yc[t * YP + c] = y[i][c];
    }
  }
  if (lane < NB) {
#pragma unroll
    for (int c = 0; c < NB; ++c) Tt[c * NB + lane] = trow[c];
  }
  if (lane < cnt) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i <= lane) R[(size_t)pc[i] * C + pc[lane]] = rp[i];
  }
}

// Apply the panel's I - V T Vᵀ (V = [the panel's rows of R; Yc]) to
// column c of those rows of R and of the tile: W = R_p + Ycᵀ X, W' = Tᵀ W,
// R_p -= W', X -= Yc W'. A group of four threads (lanes gmask), rows
// 4 t + r4 to thread r4.
template <typename T>
__device__ __forceinline__ void update_column(T* R, T* X, const T* Yc, const T* Tt, const int* pc,
                                              int cnt, int c, int n, int C, int P, int r4,
                                              unsigned gmask) {
  constexpr int YP = Tile<T>::YP;
  T r[NB / GROUP];  // R[k_j, c], j = 4 m + r4
#pragma unroll
  for (int m = 0; m < NB / GROUP; ++m) {
    const int j = GROUP * m + r4;
    r[m] = j < cnt ? __ldcg(R + (size_t)pc[j] * C + c) : T(0);
  }
  T w[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) w[j] = T(0);
#pragma unroll 2
  for (int t = r4; t < n; t += GROUP) {
    const T x = X[(size_t)t * P + c];
    T yr[NB];
    load16(Yc + t * YP, yr);
#pragma unroll
    for (int j = 0; j < NB; ++j) w[j] += yr[j] * x;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if ((j & 3) == r4) w[j] += r[j / GROUP];
    w[j] += __shfl_xor_sync(gmask, w[j], 1);
    w[j] += __shfl_xor_sync(gmask, w[j], 2);
  }
#pragma unroll
  for (int j = NB - 1; j >= 0; --j) {  // W' = Tᵀ W, from the last row up
    T tt[NB];
    load16(Tt + j * NB, tt);
    T acc = T(0);
#pragma unroll
    for (int i = 0; i <= j; ++i) acc += tt[i] * w[i];
    w[j] = acc;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if ((j & 3) == r4 && j < cnt) R[(size_t)pc[j] * C + c] = r[j / GROUP] - w[j];
#pragma unroll 2
  for (int t = r4; t < n; t += GROUP) {
    T yr[NB];
    load16(Yc + t * YP, yr);
    T x = X[(size_t)t * P + c];
#pragma unroll
    for (int j = 0; j < NB; ++j) x -= yr[j] * w[j];
    X[(size_t)t * P + c] = x;
  }
}

// Warps 1..: the panel's update of the later columns tc[0 .. ntrail), a
// group of four threads a column. With ``ahead`` the first 16 of them (the
// next panel's, groups 0..15: warps 1 and 2) go first, and those warps
// then arrive at the barrier warp 0 waits at before it factors that panel.
template <typename T>
__device__ void panel_update(T* R, T* X, const T* Yc, const T* Tt, const int* pc, int cnt,
                             const int* tc, int ntrail, int n, int C, int P, bool ahead) {
  constexpr int GROUPS = (QR_THREADS - 32) / GROUP;
  static_assert(AHEAD_THREADS == 32 + NB * GROUP, "the next panel's columns are warps 1 and 2's");
  const int tid = threadIdx.x - 32, warp = threadIdx.x / 32, g = tid / GROUP, r4 = tid % GROUP;
  const unsigned gmask = 0xfu << (threadIdx.x & 28);
  if (g < ntrail) update_column(R, X, Yc, Tt, pc, cnt, tc[g], n, C, P, r4, gmask);
  if (ahead && warp <= 2) {
    __syncwarp();
    ahead_arrive();
  }
  for (int q = g + GROUPS; q < ntrail; q += GROUPS)
    update_column(R, X, Yc, Tt, pc, cnt, tc[q], n, C, P, r4, gmask);
}

// out[0 .. *count): the set bits >= lo of a | b (b may be null) over
// QR_MASKW words, ascending (warp 0), then a barrier.
__device__ void bit_list(const unsigned* a, const unsigned* b, int lo, int* out, int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned word = 0;
    if (lane < QR_MASKW) {
      word = a[lane] | (b ? b[lane] : 0u);
      const int s = lo - 32 * lane;
      if (s >= 32) word = 0;
      else if (s > 0) word &= ~0u << s;
    }
    const int cnt = __popc(word);
    int before = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL, before, o);
      if (lane >= o) before += x;
    }
    before -= cnt;
    while (word) {
      out[before++] = 32 * lane + __ffs(word) - 1;
      word &= word - 1;
    }
    if (lane == 31) *count = before;
  }
  __syncthreads();
}

// Publish a node's progress: every row of its triangle below column v is
// final (thread 0, after a barrier at which every thread fenced its
// writes).
__device__ __forceinline__ void publish(int* prog, int v) {
  __threadfence();
  atomicExch(prog, v);
}

// Wait until *flag >= v (thread 0), then fence: what its writer wrote
// before it is visible.
__device__ __forceinline__ void wait_for(const int* flag, int v) {
  while (*(const volatile int*)flag < v) __nanosleep(64);
  __threadfence();
}

// What warp 0 does before it factors a panel whose last column is upto,
// the tile holding n rows; returns the tile's rows. A leaf's tile is staged
// whole (wait null, nrows 0: nothing); a merge waits until the two
// triangles it reads (their progress at wait[0], wait[1]) have finished
// the rows up to upto, then stages the other triangle's rows list[ns ..]
// that start by upto, while the tile has room. One type for both, so that
// the sweep is compiled once.
template <typename T>
struct Stager {
  const T* F;          // the other triangle (pitch C)
  T* X;                // the tile (pitch P)
  const int* list;     // its non-zero rows, ascending
  const int* wait[2];  // progress flags (this triangle's writer, the other's), or null
  int nrows, ns, C, P;
  int seen;            // this triangle's writer has finished the rows below it (lane 0)
  __device__ int operator()(int upto, int n) {
    const int lane = threadIdx.x & 31;
    if (wait[0] && lane == 0) {
      wait_for(wait[0], upto + 1);
      wait_for(wait[1], upto + 1);
      seen = upto + 1;
    }
    __syncwarp();
    for (; ns < nrows && list[ns] <= upto && n < Tile<T>::TR; ++ns, ++n) {
      const T* row = F + (size_t)list[ns] * C;
      T* dst = X + (size_t)n * P;
      for (int c = lane; c < C; c += 32) dst[c] = __ldcg(row + c);
    }
    __syncwarp();
    return n;
  }
};

// Sweep the staged tile X (n rows) into the triangle R (global) over the
// columns sh.cols[0 .. sh.ncols), NB at a time. Iteration p: warps 1..
// apply panel p's update (the next panel's columns first) while warp 0
// factors panel p + 1 into the other buffer; one block barrier an
// iteration. Before warp 0 factors a panel, stage(last column of the
// panel, n) (warp 0) may wait for the triangles it reads and stage more
// rows (a merge: those of the other triangle that start by that column;
// they have zeros in the earlier panels' columns, which no reflection of
// those panels reads or changes) and returns the tile's rows. With prog,
// the node's progress is published after each panel: the rows below the
// next panel's first column, below hold and below stage.seen (a merge
// claims no row its triangle's writer has not finished) are final.
template <typename T>
__device__ void sweep(T* R, T* X, T* Yc, T* Tt, QrShared& sh, int n, int C, int P, int* prog,
                      int hold, Stager<T>& stage) {
  constexpr int YS = Tile<T>::TR * Tile<T>::YP, TS = NB * NB;
  const int nlist = sh.ncols, warp = threadIdx.x / 32;
  if (prog && threadIdx.x == 0) publish(prog, min(min(nlist ? sh.cols[0] : C, hold), stage.seen));
  T rp[NB];
  for (int p = -1; p * NB < nlist; ++p) {
    const int p0 = p * NB, f0 = p0 + NB, b = p & 1;  // f0: the panel warp 0 factors
    const bool factor = f0 < nlist;
    if (warp == 0) {
      if (factor) {  // its diagonal block is in rows no update of panel p writes
        const int cnt = min(NB, nlist - f0);
        n = stage(sh.cols[f0 + cnt - 1], n);
        load_diag(R, sh.cols + f0, cnt, C, rp);
        if (p >= 0) ahead_wait();
        panel_factor(R, X, P, n, sh.cols + f0, cnt, C, rp, Yc + (b ^ 1) * YS, Tt + (b ^ 1) * TS);
        if (threadIdx.x == 0) sh.nf[b ^ 1] = n;
      }
    } else if (p >= 0) {
      panel_update(R, X, Yc + b * YS, Tt + b * TS, sh.cols + p0, min(NB, nlist - p0),
                   sh.cols + f0, nlist - f0, sh.nf[b], C, P, factor);
    }
    if (prog) __threadfence();  // this iteration's rows of R, before the progress
    __syncthreads();
    if (prog && threadIdx.x == 0 && p >= 0)
      publish(prog, min(min(factor ? sh.cols[f0] : C, hold), stage.seen));
  }
}

// Stage rows list[0 .. nt) of src (pitch C) as the tile's rows (pitch P);
// sh.tmask and sh.kmin: their non-zero columns and first non-zero column.
template <typename T>
__device__ void stage_tile(const T* src, const int* list, int nt, T* X, int C, int P,
                           QrShared& sh) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  if (tid < QR_MASKW) sh.tmask[tid] = 0;
  if (tid == 0) sh.kmin = C;
  __syncthreads();
  unsigned acc[QR_MASKW];
#pragma unroll
  for (int m = 0; m < QR_MASKW; ++m) acc[m] = 0;
  int kmin = C;
  for (int base = SCAN_ROWS * warp; base < nt; base += SCAN_ROWS * QR_WARPS) {
    T x[SCAN_ROWS][QR_MASKW];
#pragma unroll
    for (int k = 0; k < SCAN_ROWS; ++k) {
      const T* row = src + (size_t)(base + k < nt ? list[base + k] : 0) * C;
#pragma unroll
      for (int m = 0; m < QR_MASKW; ++m) {
        const int j = 32 * m + lane;
        x[k][m] = base + k < nt && j < C ? __ldcg(row + j) : T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < SCAN_ROWS; ++k) {
      if (base + k >= nt) break;
      T* dst = X + (size_t)(base + k) * P;
#pragma unroll
      for (int m = 0; m < QR_MASKW; ++m) {
        const int j = 32 * m + lane;
        if (j < C) dst[j] = x[k][m];
        const unsigned bits = __ballot_sync(FULL, x[k][m] != T(0));
        acc[m] |= bits;
        if (bits && 32 * m + __ffs(bits) - 1 < kmin) kmin = 32 * m + __ffs(bits) - 1;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < QR_MASKW; ++m)
      if (acc[m]) atomicOr(sh.tmask + m, acc[m]);
    if (kmin < C) atomicMin(&sh.kmin, kmin);
  }
  __syncthreads();
}

// Absorb rows list[0 .. nlist) of src (pitch C) into R, TR at a time; the
// last tile's sweep publishes the node's progress (prog, if any).
template <typename T>
__device__ void absorb_rows(const T* src, int nlist, T* R, T* X, T* Yc, T* Tt, QrShared& sh,
                            int C, int P, int* prog) {
  constexpr int TR = Tile<T>::TR;
  for (int t0 = 0; t0 < nlist; t0 += TR) {
    const int nt = min(TR, nlist - t0);
    stage_tile(src, sh.list + t0, nt, X, C, P, sh);
    bit_list(sh.rmask, sh.tmask, sh.kmin, sh.cols, &sh.ncols);
    Stager<T> none{nullptr, X, nullptr, {nullptr, nullptr}, 0, 0, C, P, C};
    sweep(R, X, Yc, Tt, sh, nt, C, P, t0 + TR >= nlist ? prog : nullptr, C, none);
    if (threadIdx.x < QR_MASKW) sh.rmask[threadIdx.x] |= sh.tmask[threadIdx.x];
    __syncthreads();
  }
}

// sh.first[i]: the first non-zero column of row r0 + i of src (pitch C),
// i < n <= QR_LIST (C where the row is zero); sh.fmask |= the rows'
// non-zero columns.
template <typename T>
__device__ void scan_rows(const T* src, int r0, int n, int C, QrShared& sh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  unsigned acc[QR_MASKW];
#pragma unroll
  for (int m = 0; m < QR_MASKW; ++m) acc[m] = 0;
  for (int base = SCAN_ROWS * warp; base < n; base += SCAN_ROWS * QR_WARPS) {
    T x[SCAN_ROWS][QR_MASKW];
#pragma unroll
    for (int k = 0; k < SCAN_ROWS; ++k) {
      const T* row = src + (size_t)(r0 + (base + k < n ? base + k : 0)) * C;
#pragma unroll
      for (int m = 0; m < QR_MASKW; ++m) {
        const int j = 32 * m + lane;
        x[k][m] = base + k < n && j < C ? __ldcg(row + j) : T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < SCAN_ROWS; ++k) {
      int first = C;
#pragma unroll
      for (int m = QR_MASKW - 1; m >= 0; --m) {
        const unsigned bits = __ballot_sync(FULL, x[k][m] != T(0));
        acc[m] |= bits;
        if (bits) first = 32 * m + __ffs(bits) - 1;
      }
      if (lane == 0 && base + k < n) sh.first[base + k] = first;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < QR_MASKW; ++m)
      if (acc[m]) atomicOr(sh.fmask + m, acc[m]);
  }
  __syncthreads();
}

// sh.list[0 .. sh.nlist): the non-zero rows r0 + i (i < n) that scan_rows
// found, in order, or (sorted) by first non-zero column, ties in order.
__device__ void list_rows(int r0, int n, int C, bool sorted, QrShared& sh) {
  constexpr int PER = QR_LIST / QR_THREADS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) cnt += PER * tid + k < n && sh.first[PER * tid + k] < C;
  int incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) sh.wsum[warp] = incl;
  __syncthreads();
  int before = incl - cnt, total = 0;
  for (int w = 0; w < QR_WARPS; ++w) {
    before += w < warp ? sh.wsum[w] : 0;
    total += sh.wsum[w];
  }
  if (!sorted) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = PER * tid + k;
      if (i < n && sh.first[i] < C) sh.list[before++] = r0 + i;
    }
  } else {
    for (int i = tid; i < n; i += QR_THREADS) {
      const int fi = sh.first[i];
      if (fi >= C) continue;
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const int fj = sh.first[j];
        rank += fj < fi || (fj == fi && j < i);
      }
      sh.list[rank] = r0 + i;
    }
  }
  if (tid == 0) sh.nlist = total;
  __syncthreads();
}

// The tree over leaves 1 .. nsub (nsub = NL - 1), level by level: at step s
// = 1, 2, 4, ... the triangle of leaf 1 + q (q a multiple of 2 s) absorbs
// that of leaf 1 + q + s where q + s < nsub (in place: buffer 1 + q holds
// the left subtree's triangle); then the root (buffer 1) into leaf 0's. A
// node is a leaf (0 .. NL - 1) or a merge (NL + its place in that order).
__device__ __forceinline__ int merges_at(int s, int nsub) {
  return nsub > s ? (nsub - s + 2 * s - 1) / (2 * s) : 0;
}

__device__ int merge_node(int s, int q, int nsub, int NL) {
  int m = 0;
  for (int t = 1; t < s; t <<= 1) m += merges_at(t, nsub);
  return NL + m + q / (2 * s);
}

// The node whose output buffer 1 + q holds before the merges of level s.
__device__ int last_writer(int q, int s, int nsub, int NL) {
  int w = 1 + q;
  for (int t = 1; t < s; t <<= 1)
    if (q % (2 * t) == 0 && q + t < nsub) w = merge_node(t, q, nsub, NL);
  return w;
}

// A leaf: its rows (leaf 0 the first `head`, sorted by first non-zero
// column; leaf i > 0 the QR_LEAF_ROWS after the head's and the earlier
// leaves'), absorbed into its own zeroed triangle. Its mask (the OR of its
// rows') is published before its rows are absorbed; its progress along its
// last tile's sweep.
template <typename T>
__device__ void leaf(const QrArgs<T>& a, int node, T* X, T* Yc, T* Tt, QrShared& sh, int* ready,
                     int* prog) {
  const int tid = threadIdx.x, C = a.C;
  const size_t CC = (size_t)C * C;
  T* Rb = a.R + node * CC;
  for (size_t i = tid; i < CC; i += QR_THREADS) Rb[i] = T(0);
  if (tid < QR_MASKW) sh.rmask[tid] = sh.fmask[tid] = 0;
  __syncthreads();
  const int r0 = node ? a.head + (node - 1) * QR_LEAF_ROWS : 0;
  const int r1 = node ? min(a.M, r0 + QR_LEAF_ROWS) : a.head;
  if (r0 >= r1 && tid < QR_MASKW) a.mask[node * QR_MASKW + tid] = 0;
  for (int c0 = r0; c0 < r1; c0 += QR_LIST) {
    const int n = min(QR_LIST, r1 - c0);
    const bool last = c0 + QR_LIST >= r1;
    scan_rows(a.A, c0, n, C, sh);
    if (last && tid < QR_MASKW) a.mask[node * QR_MASKW + tid] = sh.fmask[tid];
    __threadfence();
    __syncthreads();
    if (last && tid == 0) atomicExch(ready + node, 1);
    list_rows(c0, n, C, node == 0, sh);
    absorb_rows(a.A, sh.nlist, Rb, X, Yc, Tt, sh, C, a.P,
                last && a.NL > 1 ? prog + node : nullptr);  // NL 1: no merge reads it
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicExch(ready + node, 1);
    publish(prog + node, C);
  }
}

// A merge: wait for the masks of the two triangles' last writers, publish
// the merged mask, then absorb the other triangle's rows (those its mask
// names) into this one's in place, each staged when the sweep reaches its
// column and its writer has finished it; rows beyond a tile take a second
// sweep once the first is done.
template <typename T>
__device__ void merge(const QrArgs<T>& a, int node, int into, int from, int into_w, int from_w,
                      T* X, T* Yc, T* Tt, QrShared& sh, int* ready, int* prog) {
  constexpr int TR = Tile<T>::TR;
  const int tid = threadIdx.x, C = a.C;
  const size_t CC = (size_t)C * C;
  T* R = a.R + into * CC;
  const T* F = a.R + from * CC;
  if (tid == 0) {
    wait_for(ready + into_w, 1);
    wait_for(ready + from_w, 1);
  }
  __syncthreads();
  if (tid < QR_MASKW) {
    sh.rmask[tid] = __ldcg(a.mask + into * QR_MASKW + tid);
    sh.fmask[tid] = __ldcg(a.mask + from * QR_MASKW + tid);
    a.mask[into * QR_MASKW + tid] = sh.rmask[tid] | sh.fmask[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicExch(ready + node, 1);
  bit_list(sh.fmask, nullptr, 0, sh.list, &sh.nlist);
  const int nrows = sh.nlist;
  bit_list(sh.rmask, sh.fmask, nrows ? sh.list[0] : C, sh.cols, &sh.ncols);
  const int hold = nrows > TR ? sh.list[TR] : C;  // the first row a second sweep takes
  Stager<T> stage{F, X, sh.list, {prog + into_w, prog + from_w}, nrows, 0, C, a.P, 0};
  int* out = node < 2 * a.NL - 2 ? prog + node : nullptr;  // no merge reads the last one's
  sweep(R, X, Yc, Tt, sh, 0, C, a.P, out, hold, stage);
  if (tid == 0) sh.staged = stage.ns;  // warp 0's count
  __syncthreads();
  const int done = sh.staged;
  if (tid < QR_MASKW) sh.rmask[tid] |= sh.fmask[tid];
  __syncthreads();
  if (done < nrows) {  // the rest of the list to its front (read all, then write)
    static_assert(2 * QR_THREADS >= QR_MAXC, "two rows a thread");
    const int rest = nrows - done;
    const int v0 = tid < rest ? sh.list[done + tid] : 0;
    const int v1 = tid + QR_THREADS < rest ? sh.list[done + tid + QR_THREADS] : 0;
    __syncthreads();
    if (tid < rest) sh.list[tid] = v0;
    if (tid + QR_THREADS < rest) sh.list[tid + QR_THREADS] = v1;
    __syncthreads();
    absorb_rows(F, rest, R, X, Yc, Tt, sh, C, a.P, out);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {  // the rest of its triangle is its writer's: forward that writer's progress
    for (int v = 0; v < C;) {
      const int w = *(const volatile int*)(prog + into_w);
      if (w > v) {
        v = w;
        if (out) publish(out, v);
      } else {
        __nanosleep(64);
      }
    }
  }
}

// A block takes a ticket as it starts: tickets 0 .. NL - 1 are the leaves,
// the others the merges in the tree's order, then the root into leaf 0. A
// node waits only for nodes with smaller tickets, which started before it.
template <typename T>
__global__ void __launch_bounds__(QR_THREADS, 1) marg_qr_kernel(const QrArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TR = Tile<T>::TR;
  T* X = reinterpret_cast<T*>(smem_raw);  // [TR][P] the staged tile
  T* Yc = X + (size_t)TR * a.P;           // [2][TR][YP] two panels' reflectors
  T* Tt = Yc + 2 * TR * Tile<T>::YP;      // [2][NB][NB] their Tᵀ
  __shared__ QrShared sh;
  const int nodes = 2 * a.NL - 1, nsub = a.NL - 1;
  int* ready = a.sync + 1;
  int* prog = ready + nodes;
  if (threadIdx.x == 0) sh.ticket = atomicAdd(a.sync, 1);
  __syncthreads();
  const int node = sh.ticket;
  if (node < a.NL) {
    leaf(a, node, X, Yc, Tt, sh, ready, prog);
    return;
  }
  int m = node - a.NL, s = 1;
  for (; s < nsub && m >= merges_at(s, nsub); s <<= 1) m -= merges_at(s, nsub);
  if (s < nsub) {  // level s, parent 2 s m
    const int q = 2 * s * m;
    merge(a, node, 1 + q, 1 + q + s, last_writer(q, s, nsub, a.NL),
          last_writer(q + s, s, nsub, a.NL), X, Yc, Tt, sh, ready, prog);
  } else {  // the root into leaf 0's triangle
    merge(a, node, 0, 1, 0, last_writer(0, s, nsub, a.NL), X, Yc, Tt, sh, ready, prog);
  }
}

template <typename T>
__global__ void __launch_bounds__(QR_THREADS, 1) marg_qr_empty_kernel(const QrArgs<T> a) {}

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
              void* mask, void* sync, bool empty, cudaStream_t stream) {
  const int P = tile_pitch<T>(C);
  const QrArgs<T> g{(const T*)A, (T*)R, (unsigned*)mask, (int*)sync, M, C, P, head, NL};
  const size_t smem = qr_smem<T>(P);
  void (*kernel)(const QrArgs<T>) = empty ? marg_qr_empty_kernel<T> : marg_qr_kernel<T>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<2 * NL - 1, QR_THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// Stage 1 at F slots over W1 frames and nc cameras: the compact rows of
// proj_rows (res [F, W1, 2], J26 [F, W1, 2, 26], w [F, W1]; cam [F, W1]
// int64 or null) of a grid whose used features are anchored at frame 0,
// into out [F * 2 (W1 - 1), C], C = 15 W1 + 6 nc + 2 <= QR_MAXC (the
// widest stack marg_qr_launch takes; out needs no alignment beyond its
// type's); ex, td: whether the extrinsic and td columns are estimated (0
// or 1). empty: marg_depth_empty_kernel with the same grid, block and
// shared memory. dtype 0 float32, 1 float64.
extern "C" int marg_depth_launch(const void* res, const void* J26, const void* w,
                                 const void* cam, int F, int W1, int nc, int ex, int td,
                                 int dtype, int empty, void* out, void* stream) {
  if (F < 1 || W1 < 2 || nc < 1 || 15 * W1 + 6 * nc + 2 > QR_MAXC || 2 * (W1 - 1) > DEP_MAXR ||
      (ex != 0 && ex != 1) || (td != 0 && td != 1) || (dtype != 0 && dtype != 1))
    return -1;
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
  *tile_rows = dtype ? Tile<double>::TR : Tile<float>::TR;
  *leaf_rows = QR_LEAF_ROWS;
  return 0;
}

// Stage 2: the R factor of A [M, C] (C <= QR_MAXC) into R[0] of the
// workspace R [NL, C, C] (its lower triangle zero): leaf 0 takes rows
// [0, head), leaves 1.. QR_LEAF_ROWS rows each, NL = 1 + ceil((M - head) /
// QR_LEAF_ROWS), and 2 NL - 1 blocks (the leaves and the merges); mask
// [NL, QR_MASKW] uint32 scratch; sync [1 + 2 (2 NL - 1)] int32, zero.
// empty: marg_qr_empty_kernel with the same grid, block and shared memory.
extern "C" int marg_qr_launch(const void* A, int M, int C, int head, int NL, int dtype,
                              int empty, void* R, void* mask, void* sync, void* stream) {
  if (M < 1 || C < 1 || C > QR_MAXC || head < 0 || head > M ||
      NL != 1 + (M - head + QR_LEAF_ROWS - 1) / QR_LEAF_ROWS || (dtype != 0 && dtype != 1))
    return -1;
  return dtype ? launch_qr<double>(A, M, C, head, NL, R, mask, sync, empty != 0,
                                   (cudaStream_t)stream)
               : launch_qr<float>(A, M, C, head, NL, R, mask, sync, empty != 0,
                                  (cudaStream_t)stream);
}
