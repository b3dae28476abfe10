// Batched eigendecomposition of small symmetric matrices (n <= 9) by cyclic
// Jacobi, float32 or float64, on Hopper. Same contract as torch.linalg.eigh
// with UPLO='L': the lower triangle is read, the eigenvalues come out in
// ascending order and the eigenvectors as unit columns; their signs are
// arbitrary, as JAX's are.
//
// Replaces what XLA's jnp.linalg.eigh / svd compute inside the JAX package's
// jitted programs (lfvio_tpu/backend/triangulate.py:69, the [F, 4, 4] DLT
// null vectors; lfvio_tpu/frontend/ransac.py:36, :40, the [n_hyp, 9, 9]
// 8-point null vectors and the rank-2 projection of each E). There is no
// Pallas kernel behind them: on the card torch.linalg.eigh and svd read their
// error flags on the host, so a frame's front end and its solve waited for
// the card at each call and no CUDA graph could hold them. This kernel
// reads nothing back and allocates nothing, and launches on the caller's
// stream.
//
// What bounds it on an H100: latency. The inputs are a few hundred small
// matrices (256 x 4 x 4 and 101 x 9 x 9: tens of KB), so bytes and
// arithmetic are both far below a microsecond of the card; each matrix is a
// dependent chain of rotations, and a launch is its latency floor
// (sym_eig_empty_kernel) and that chain. The design keeps the chain short
// and in registers, and spreads the matrices over many SMs:
//
//  * One group of G lanes per matrix: G = 4 for n <= 4 (eight matrices a
//    warp, one warp a block, so [256, 4, 4] runs on 32 SMs), G = 16 for
//    5 <= n <= 9 (two a warp, four warps a block). The matrix is padded to
//    an even order M (4; 6, 8 or 10); the padding rows and columns are zero,
//    so their rotations are skipped. Lane j holds column j of A and of V in
//    registers. A sweep is M - 1 rounds of the round-robin ordering, each
//    rotating M/2 disjoint pairs at once; the rounds unroll, so every
//    register index is a compile-time constant. The column rotation A J
//    and V J takes the partner lane's column by __shfl_sync, and the row
//    rotation J^T (A J) is local once the lane has the round's (c, s)
//    pairs: no shared memory and no barrier inside a sweep. Each rotation
//    is Rutishauser's (t = sgn(theta) / (|theta| + sqrt(theta^2 + 1)),
//    theta = (a_qq - a_pp) / (2 a_pq)); in float through the hardware's
//    reciprocal and rsqrt, never on a zero, subnormal, infinite or NaN
//    operand, which IEEE division and square root take a slow path for;
//    in double IEEE. The matrix is first scaled by a power of two to
//    |a| <= 1 (exact), so that the squared tests below cannot overflow.
//  * A round's chain of dependent steps is the latency of a matrix. On the
//    16-lane path the lower lane of each pair computes its rotation and
//    the pairs are broadcast (three shuffles deep). On the 4-lane path
//    every lane fetches both pairs' pivots with the partner's column, in
//    one set of shuffles, and computes both rotations itself (the same
//    operations on the same values in every lane, so the lanes agree bit
//    for bit) in a form with no division and two rsqrt: one shuffle deep.
//    n = 3 leaves one real pair a round (the other holds the padding): its
//    three rotations a sweep stay in series, as in any 3 x 3 Jacobi.
//  * n <= 4 (the triangulation's 4 x 4 and RANSAC's 3 x 3; also 1 x 1 and
//    2 x 2, which no caller of the main path hands it) stops as the
//    classic cyclic Jacobi does, which keeps its sweep counts and rounding
//    close to a one-thread-a-matrix solver's: a sweep starts while the
//    off-diagonal mass exceeds eps^2 of the diagonal's (the group's sums by
//    two xor-shuffles), and rotates every nonzero a_pq but those whose
//    pivots are negligible (d^2 + e^2 below the type's tiny, d = a_qq -
//    a_pp and e = 2 a_pq: far below eps of the scaled matrix). A warp runs
//    sweeps while one of its groups needs one; a group that does not is
//    left exactly as it is.
//  * 5 <= n <= 9 skips a rotation when |a_pq| <= eps sqrt(|a_pp a_qq|)
//    (Demmel and Veselic's relative test) and starts a sweep only while
//    some pair fails it, found by one __any_sync over the warp (the
//    matrices of a warp's two groups run the same number of sweeps).
//  * Both stop at MAX_SWEEPS at the latest, and report each matrix's count
//    of sweeps when asked (n <= 4: the sweeps it started; 5..9: those in
//    which it rotated).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SWEEPS = 16;
constexpr int QUAD = 4;    // lanes a matrix of order <= 4, and its padded order
constexpr int GROUP = 16;  // lanes a matrix of the 5..9 path
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T eps_of();
template <> __device__ __forceinline__ float eps_of<float>() { return 1.1920929e-07f; }
template <> __device__ __forceinline__ double eps_of<double>() { return 2.220446049250313e-16; }

// The hardware's 1 / sqrt(x) estimate for a normal x (rsqrtf also rescales
// subnormal operands, which no caller here passes).
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / sqrt(x) to about an ulp: the hardware estimate and one Newton step
// (a rotation's c and s must stay orthogonal to the type's rounding).
__device__ __forceinline__ float rsqrt_of(float x) {
  const float y = rsqrt_approx(x);
  return y * (1.5f - 0.5f * x * y * y);
}

// The exponent e of x (x = m 2^e, m in [0.5, 1), for a normal x; 0 and the
// subnormals take the least), clamped so that 2^e and 2^-e are normal; and
// 2^k for such a k. Scaling by them is exact where ldexp is, without
// ldexp's and frexp's library code (hundreds of cycles a matrix).
__device__ __forceinline__ int exponent_of(float x) {
  return min(max(((__float_as_int(x) >> 23) & 0xff) - 126, -125), 126);
}
__device__ __forceinline__ int exponent_of(double x) {
  return min(max((int)((__double_as_longlong(x) >> 52) & 0x7ff) - 1022, -1021), 1022);
}
template <typename T> __device__ __forceinline__ T pow2(int k);
template <> __device__ __forceinline__ float pow2<float>(int k) {
  return __int_as_float((k + 127) << 23);
}
template <> __device__ __forceinline__ double pow2<double>(int k) {
  return __longlong_as_double((long long)(k + 1023) << 52);
}

// Index i's partner in round r of the round-robin (circle) ordering of m
// indices: position 0 holds index 0, positions 1..m-1 hold the others
// rotated by r, and position k plays position m-1-k.
__device__ __forceinline__ int partner(int i, int r, int m) {
  const int pos = i == 0 ? 0 : ((i - 1 - r) % (m - 1) + (m - 1)) % (m - 1) + 1;
  const int pp = m - 1 - pos;
  return pp == 0 ? 0 : (pp - 1 + r) % (m - 1) + 1;
}

// The rotation (c, s) that zeroes a_pq, Rutishauser's form: theta = (a_qq -
// a_pp) / (2 a_pq), t = sgn(theta) / (|theta| + sqrt(theta^2 + 1)), or
// 1 / (2 theta) where theta^2 would swamp the 1; c = 1 / sqrt(1 + t^2).
// Called with a_pq != 0 only (a skipped pair passes 0, 0, 1), so no
// operand is a zero, an infinity or a NaN, which IEEE division and square
// root serve on a slow path. float: the hardware's approximate reciprocal
// and rsqrt (t needs no more than a few ulps: a_pq is set to zero
// afterwards, and c, s come from t whatever its error); double: IEEE.
__device__ __forceinline__ void rotation_fast(float app, float aqq, float apq, float& c,
                                              float& s) {
  const float theta = __fdividef(aqq - app, 2.0f * apq);
  const float at = fabsf(theta);
  const float big = 1.0f / 1.1920929e-07f;
  const float u = fminf(at, big);
  const float h = u * u + 1.0f;
  float t = at > big ? __fdividef(0.5f, at) : __fdividef(1.0f, u + h * rsqrt_approx(h));
  t = copysignf(t, theta);
  c = rsqrt_of(t * t + 1.0f);
  s = t * c;
}
__device__ __forceinline__ void rotation_fast(double app, double aqq, double apq, double& c,
                                              double& s) {
  const double theta = (aqq - app) / (2.0 * apq);
  const double at = fabs(theta);
  const double big = 1.0 / 2.220446049250313e-16;
  const double u = fmin(at, big);
  double t = at > big ? 0.5 / at : 1.0 / (u + sqrt(u * u + 1.0));
  t = copysign(t, theta);
  c = 1.0 / sqrt(t * t + 1.0);
  s = t * c;
}

// NaN sorts last; the ranks of the group's n eigenvalues are a permutation.
// Bitwise, not short-circuit, operators: no branch around the tests.
template <typename T>
__device__ __forceinline__ bool before(T x, T y) { return (x < y) | (isnan(y) & !isnan(x)); }

// Lane j's diagonal element a_jj.
template <typename T, int M>
__device__ __forceinline__ T diagonal(const T (&a)[M], int j) {
  T d = a[0];
#pragma unroll
  for (int i = 1; i < M; ++i) d = i == j ? a[i] : d;
  return d;
}

// One round r of the round-robin ordering on this lane's column j of A and
// of V (lanes j >= M hold nothing and pair with themselves); a pair rotates
// where it fails the relative test.
template <typename T, int M, int G>
__device__ __forceinline__ void group_round(T (&a)[M], T (&v)[M], int j, int r, T tol,
                                            bool& rotated) {
  const int k = j < M ? partner(j, r, M) : j;
  T ak[M], vk[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {  // the partner's columns, before the rotation
    ak[i] = __shfl_sync(FULL, a[i], k, G);
    vk[i] = __shfl_sync(FULL, v[i], k, G);
  }
  const T ajj = diagonal<T, M>(a, j);
  T ajk = a[0];
#pragma unroll
  for (int i = 1; i < M; ++i) ajk = i == k ? a[i] : ajk;
  const T akk = __shfl_sync(FULL, ajj, k, G);
  // The lower lane of each pair (p = j < q = k) decides and computes:
  // |a_pq| > eps sqrt(|a_pp a_qq|), squared (the matrix is scaled to
  // |a| <= 1, so no square overflows; one that underflows is far below eps
  // of the matrix and is left).
  const bool rot = j < k && ajk * ajk > tol * tol * fabs(ajj * akk);
  T c, s;
  rotation_fast(rot ? ajj : T(0), rot ? akk : T(0), rot ? ajk : T(1), c, s);
  c = rot ? c : T(1);
  s = rot ? s : T(0);
  rotated |= rot;
  const int p = min(j, k);
  const T cj = __shfl_sync(FULL, c, p, G);
  const T sj = __shfl_sync(FULL, s, p, G);
  const bool rot_pair = __shfl_sync(FULL, (int)rot, p, G);
  const T oj = j == p ? -sj : sj;  // J[q][p] = -s, J[p][q] = s
#pragma unroll
  for (int i = 0; i < M; ++i) {  // A J and V J: this lane's column
    a[i] = cj * a[i] + oj * ak[i];
    v[i] = cj * v[i] + oj * vk[i];
  }
#pragma unroll
  for (int pp = 0; pp < M; ++pp) {  // J^T (A J): rows pp and its partner
    const int qq = partner(pp, r, M);
    if (pp < qq) {
      const T cp = __shfl_sync(FULL, c, pp, G);
      const T sp = __shfl_sync(FULL, s, pp, G);
      const T xp = a[pp], xq = a[qq];
      a[pp] = cp * xp - sp * xq;
      a[qq] = sp * xp + cp * xq;
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] = (rot_pair && i == k) ? T(0) : a[i];  // the zeroed a_pq
}

template <typename T> __device__ __forceinline__ T tiny_of();
template <> __device__ __forceinline__ float tiny_of<float>() { return 1e-30f; }
template <> __device__ __forceinline__ double tiny_of<double>() { return 1e-300; }

// sqrt(x) and 1 / sqrt(x), x normal and finite: float the hardware's rsqrt
// (the second refined to about an ulp), double IEEE.
__device__ __forceinline__ float sqrt_q(float x) { return x * rsqrt_approx(x); }
__device__ __forceinline__ double sqrt_q(double x) { return sqrt(x); }
__device__ __forceinline__ float rsqrt_q(float x) { return rsqrt_of(x); }
__device__ __forceinline__ double rsqrt_q(double x) { return 1.0 / sqrt(x); }

// The rotation (c, s) of the 4-lane path from d = a_qq - a_pp, e = 2 a_pq
// and x = d^2 + e^2, Rutishauser's written without a division: with r =
// sqrt(x) and g = |d| + r, t = sgn(d) e / g, so c = g w and s = sgn(d) e w
// for w = 1 / sqrt(g^2 + e^2). Called with x >= tiny_of<T>() (a skipped
// pair passes 1, 0, 1), so no operand is zero, subnormal, infinite or NaN.
template <typename T>
__device__ __forceinline__ void rotation_quad(T d, T e, T x, T& c, T& s) {
  const T g = fabs(d) + sqrt_q(x);
  const T w = rsqrt_q(g * g + e * e);
  c = g * w;
  s = copysign(T(1), d) * e * w;
}

// In round r lane j pairs with j ^ quad_mask(r): (0 3)(1 2), (0 1)(2 3),
// (0 2)(1 3), the round-robin ordering of four (partner).
__host__ __device__ constexpr int quad_mask(int r) { return r == 0 ? 3 : r; }

// One round r of the 4-lane path on this lane's column j of A and of V:
// every lane takes both pairs' pivots (a_pp, a_qq, a_pq) and its partner's
// columns in one set of shuffles and computes both rotations (the note at
// the top). A pair rotates while its group is ``active`` and a_pq != 0,
// unless its pivots are negligible.
template <typename T>
__device__ __forceinline__ void quad_round(T (&a)[QUAD], T (&v)[QUAD], int j, int r,
                                           bool active) {
  constexpr int M = QUAD;
  const int m = quad_mask(r), k = j ^ m;
  T ak[M], vk[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {  // the partner's columns, before the rotation
    ak[i] = __shfl_xor_sync(FULL, a[i], m, QUAD);
    vk[i] = __shfl_xor_sync(FULL, v[i], m, QUAD);
  }
  const T ajj = diagonal<T, M>(a, j);
  T c[M], s[M];  // the rotation of pair (pp, pp ^ m), at its lower index pp
  bool rot[M];
#pragma unroll
  for (int pp = 0; pp < M; ++pp) {
    const int qq = pp ^ m;
    c[pp] = T(1);
    s[pp] = T(0);
    rot[pp] = false;
    if (pp < qq) {
      const T app = __shfl_sync(FULL, ajj, pp, QUAD);
      const T aqq = __shfl_sync(FULL, ajj, qq, QUAD);
      const T apq = __shfl_sync(FULL, a[qq], pp, QUAD);  // lane pp's a[qq]: a_qp
      const T d = aqq - app, e = T(2) * apq, x = d * d + e * e;
      rot[pp] = active & (apq != T(0)) & (x >= tiny_of<T>());
      T cc, ss;
      rotation_quad(rot[pp] ? d : T(1), rot[pp] ? e : T(0), rot[pp] ? x : T(1), cc, ss);
      c[pp] = rot[pp] ? cc : T(1);
      s[pp] = rot[pp] ? ss : T(0);
    }
  }
  T cj = T(1), sj = T(0);  // this lane's pair
  bool rj = false;
#pragma unroll
  for (int pp = 0; pp < M; ++pp) {
    const int qq = pp ^ m;
    if (pp < qq && (pp == j || qq == j)) {
      cj = c[pp];
      sj = s[pp];
      rj = rot[pp];
    }
  }
  const T oj = j < k ? -sj : sj;  // J[q][p] = -s, J[p][q] = s
#pragma unroll
  for (int i = 0; i < M; ++i) {  // A J and V J: this lane's column
    a[i] = cj * a[i] + oj * ak[i];
    v[i] = cj * v[i] + oj * vk[i];
  }
#pragma unroll
  for (int pp = 0; pp < M; ++pp) {  // J^T (A J): rows pp and its partner
    const int qq = pp ^ m;
    if (pp < qq) {
      const T xp = a[pp], xq = a[qq];
      a[pp] = c[pp] * xp - s[pp] * xq;
      a[qq] = s[pp] * xp + c[pp] * xq;
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] = (rj && i == k) ? T(0) : a[i];  // the zeroed a_pq
}

// Whether some element of lane j's column fails the relative test
// |a_ij| <= eps sqrt(|a_ii a_jj|), squared as in group_round.
template <typename T, int M, int G>
__device__ __forceinline__ bool above_tolerance(const T (&a)[M], int j, T tol) {
  const T ajj = diagonal<T, M>(a, j);
  bool above = false;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const T aii = __shfl_sync(FULL, ajj, i, G);
    above |= i != j && a[i] * a[i] > tol * tol * fabs(aii * ajj);
  }
  return above;
}

// Whether the group's off-diagonal mass exceeds eps^2 of its diagonal's
// (false on a NaN): lane j sums its column's squares above the diagonal
// and its diagonal's square, and xor-shuffles give every lane of the group
// the same two sums.
template <typename T, int M, int G>
__device__ __forceinline__ bool mass_above(const T (&a)[M], int j, T tol) {
  const T ajj = diagonal<T, M>(a, j);
  T off = T(0), dg = ajj * ajj;
#pragma unroll
  for (int i = 0; i < M; ++i) off += i < j ? a[i] * a[i] : T(0);
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) {
    off += __shfl_xor_sync(FULL, off, o, G);
    dg += __shfl_xor_sync(FULL, dg, o, G);
  }
  return off > tol * tol * dg;
}

// The main path's launches have at most 48 blocks (384 matrices of order
// 4, eight a block), so asking for one block a multiprocessor costs nothing
// and lets the compiler spend registers rather than spill.
template <typename T, int M, int G>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, 1)
sym_eig_group_kernel(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
                     int* __restrict__ sweeps, int batch, int n) {
  constexpr bool MASS = G == QUAD;
  const int lane = threadIdx.x % 32;
  const int j = lane % G;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool live = b < batch;  // a dead group runs on zeros: every warp stays whole
  const T* a_in = A + (size_t)(live ? b : 0) * n * n;
  T a[M], v[M];
  T amax = T(0);
#pragma unroll
  for (int i = 0; i < M; ++i) {  // every load issued, none behind a branch
    const bool in = live & (i < n) & (j < n);
    const T x = a_in[in ? (i >= j ? i * n + j : j * n + i) : 0];
    a[i] = in ? x : T(0);
    v[i] = T(i == j);
    amax = fmax(amax, fabs(a[i]));
  }
  // Scale by a power of two (exact) so that the largest |a| lies in
  // [0.5, 1); the eigenvalues are scaled back at the end.
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) amax = fmax(amax, __shfl_xor_sync(FULL, amax, o, G));
  const int e = exponent_of(amax);
  const T down = pow2<T>(-e);
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] *= down;
  const T tol = eps_of<T>();
  int swept = 0;
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    // n <= 4: a sweep runs while the group's mass test fails. 5..9: while
    // some pair fails the relative test (the test every round applies
    // before it rotates; a sweep that rotated nothing would only repeat it).
    const bool active = MASS ? mass_above<T, M, G>(a, j, tol)
                             : above_tolerance<T, M, G>(a, j, tol);
    if (!__any_sync(FULL, active)) break;
    if constexpr (MASS) {
#pragma unroll
      for (int r = 0; r < M - 1; ++r) quad_round<T>(a, v, j, r, active);
      swept += active;
    } else {
      bool rotated = false;
#pragma unroll
      for (int r = 0; r < M - 1; ++r) group_round<T, M, G>(a, v, j, r, tol, rotated);
      swept += ((__ballot_sync(FULL, rotated) >> (lane & GROUP)) & 0xffffu) != 0;
    }
  }
  // Ascending order: each lane's eigenvalue is its diagonal element; its
  // rank among the group's first n lanes says where it and its column go.
  const T d = diagonal<T, M>(a, j) * pow2<T>(e);
  T di[M];
#pragma unroll
  for (int i = 0; i < M; ++i) di[i] = __shfl_sync(FULL, d, i, G);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < M; ++i)
    rank += (i < n) & (i != j) & (before(di[i], d) | (!before(d, di[i]) & (i < j)));
  if (!live || j >= n) return;
  if (sweeps && j == 0) sweeps[b] = swept;
  w[(size_t)b * n + rank] = d;
  T* v_out = V + (size_t)b * n * n;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < n) v_out[i * n + rank] = v[i];
}

// The latency floor of a launch: nothing, with sym_eig_launch's grid, block
// and arguments for the same input.
template <typename T>
__global__ void sym_eig_empty_kernel(const T* A, T* w, T* V, int* sweeps, int batch, int n) {}

template <typename T>
int launch(const void* A, void* w, void* V, int* sw, int batch, int n, bool empty,
           cudaStream_t stream) {
  const T* a = (const T*)A;
  T* wo = (T*)w;
  T* vo = (T*)V;
  // One warp of 4-lane groups a block for n <= 4; four warps of 16-lane
  // groups above.
  const int block = n <= QUAD ? 32 : WARPS_PER_BLOCK * 32;
  const int per_block = block / (n <= QUAD ? QUAD : GROUP);
  const int grid = (batch + per_block - 1) / per_block;
  if (empty)
    sym_eig_empty_kernel<T><<<grid, block, 0, stream>>>(a, wo, vo, sw, batch, n);
  else if (n <= QUAD)
    sym_eig_group_kernel<T, QUAD, QUAD><<<grid, block, 0, stream>>>(a, wo, vo, sw, batch, n);
  else if (n <= 6)
    sym_eig_group_kernel<T, 6, GROUP><<<grid, block, 0, stream>>>(a, wo, vo, sw, batch, n);
  else if (n <= 8)
    sym_eig_group_kernel<T, 8, GROUP><<<grid, block, 0, stream>>>(a, wo, vo, sw, batch, n);
  else
    sym_eig_group_kernel<T, 10, GROUP><<<grid, block, 0, stream>>>(a, wo, vo, sw, batch, n);
  return (int)cudaGetLastError();
}

int launch_checked(const void* A, void* w, void* V, void* sweeps, int batch, int n, int dtype,
                   bool empty, void* stream) {
  if (n < 1 || n > 9 || batch < 0 || (dtype != 0 && dtype != 1)) return -1;
  if (batch == 0) return 0;
  int* sw = (int*)sweeps;
  return dtype ? launch<double>(A, w, V, sw, batch, n, empty, (cudaStream_t)stream)
               : launch<float>(A, w, V, sw, batch, n, empty, (cudaStream_t)stream);
}

}  // namespace

// A: batch contiguous n x n matrices (the lower triangle is read); w: batch x n
// eigenvalues, ascending; V: batch x n x n, eigenvector k in column k;
// sweeps: null, or batch ints that receive each matrix's count of sweeps.
// dtype 0 = float32, 1 = float64. Returns the CUDA error of the launch, or -1
// for arguments the kernel does not take.
extern "C" int sym_eig_launch(const void* A, void* w, void* V, void* sweeps, int batch, int n,
                              int dtype, void* stream) {
  return launch_checked(A, w, V, sweeps, batch, n, dtype, false, stream);
}

// sym_eig_empty_kernel with the grid, block and arguments of sym_eig_launch's
// launch for the same arguments (the latency floor of that launch).
extern "C" int sym_eig_empty_launch(const void* A, void* w, void* V, void* sweeps, int batch,
                                    int n, int dtype, void* stream) {
  return launch_checked(A, w, V, sweeps, batch, n, dtype, true, stream);
}
