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
// dependent chain of rotations. The design keeps that chain short and in
// registers:
//
//  * n <= 4: one thread per matrix, the matrix and its eigenvectors in
//    registers (every index is a compile-time constant: N is a template
//    argument and all loops unroll), the classic cyclic-by-row sweep; a
//    sweep starts while the off-diagonal mass exceeds eps^2 of the
//    diagonal's.
//  * 5 <= n <= 9: one 16-lane group per matrix, two matrices a warp, the
//    matrix padded to an even order M (6, 8 or 10; the padding rows and
//    columns are zero, so their rotations are skipped). Lane j holds column
//    j of A and of V in registers. A sweep is M - 1 rounds of the
//    round-robin ordering, each rotating M/2 disjoint pairs at once; the
//    rounds unroll, so every register index is a compile-time constant.
//    In a round the lower lane of each pair computes its rotation
//    (Rutishauser's form; in float the hardware's reciprocal and rsqrt,
//    never on a zero, infinite or NaN operand, which IEEE division and
//    square root take a slow path for), the column rotation A J and V J
//    takes the partner lane's column by __shfl_sync, and the row rotation
//    J^T (A J) is local once the round's (c, s) pairs are broadcast by
//    shuffles: no shared memory and no barrier inside a sweep. The matrix
//    is first scaled by a power of two to |a| <= 1 (exact), so that the
//    squared tests below cannot overflow.
//  * The 5..9 path skips a rotation when |a_pq| <= eps sqrt(|a_pp a_qq|)
//    (Demmel and Veselic's relative test) and starts a sweep only while
//    some pair fails it, found by one __any_sync over the warp (the
//    matrices of a warp's two groups run the same number of sweeps). Both
//    paths stop at MAX_SWEEPS at the latest, and report each matrix's
//    count of sweeps that rotated when asked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SWEEPS = 16;
// The thread path starts a sweep only while the off-diagonal norm exceeds
// TOL_SCALE * eps of the diagonal's: below that the eigenvectors are as
// exact as the type's rounding of the matrix allows (an error of about
// eps |A| / gap, as any backward-stable solver's), and a rank-deficient
// matrix's rounding noise keeps the norm from falling much further in
// float32.
constexpr double TOL_SCALE = 1.0;
constexpr int GROUP = 16;  // lanes a matrix of the 5..9 path
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREAD_BLOCK = 128;

template <typename T> __device__ __forceinline__ T eps_of();
template <> __device__ __forceinline__ float eps_of<float>() { return 1.1920929e-07f; }
template <> __device__ __forceinline__ double eps_of<double>() { return 2.220446049250313e-16; }

// 1 / sqrt(x) to about an ulp: the hardware estimate and one Newton step
// (a rotation's c and s must stay orthogonal to the type's rounding).
__device__ __forceinline__ float rsqrt_of(float x) {
  const float y = rsqrtf(x);
  return y * (1.5f - 0.5f * x * y * y);
}

// The Jacobi rotation (c, s) that zeroes a_pq (Numerical Recipes' jacobi:
// t = sgn(theta) / (|theta| + sqrt(theta^2 + 1)), theta = (a_qq - a_pp) /
// (2 a_pq)); with J_pp = J_qq = c, J_pq = s, J_qp = -s the update is
// A' = J^T A J and V' = V J.
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  if (apq == T(0)) {
    c = T(1);
    s = T(0);
    return;
  }
  const T theta = (aqq - app) / (T(2) * apq);
  T t = T(1) / (fabs(theta) + sqrt(theta * theta + T(1)));
  if (theta < T(0)) t = -t;
  c = T(1) / sqrt(t * t + T(1));
  s = t * c;
}

// ---------------------------------------------------------------- n <= 4
template <typename T, int N>
__global__ void __launch_bounds__(THREAD_BLOCK)
sym_eig_thread_kernel(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
                      int* __restrict__ sweeps, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const T* a_in = A + (size_t)b * N * N;
  T a[N][N], v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const T x = a_in[i * N + j];  // the lower triangle
      a[i][j] = x;
      a[j][i] = x;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = T(i == j);
  }
  const T tol = TOL_SCALE * eps_of<T>();
  int sweep = 0;
  for (; sweep < MAX_SWEEPS; ++sweep) {
    T off = T(0), diag = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      diag += a[i][i] * a[i][i];
#pragma unroll
      for (int j = i + 1; j < N; ++j) off += a[i][j] * a[i][j];
    }
    if (!(off > tol * tol * diag)) break;  // also stops on NaN
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        T c, s;
        rotation(a[p][p], a[q][q], a[p][q], c, s);
#pragma unroll
        for (int r = 0; r < N; ++r) {  // columns: A J
          const T arp = a[r][p], arq = a[r][q];
          a[r][p] = c * arp - s * arq;
          a[r][q] = s * arp + c * arq;
        }
#pragma unroll
        for (int r = 0; r < N; ++r) {  // rows: J^T (A J)
          const T apr = a[p][r], aqr = a[q][r];
          a[p][r] = c * apr - s * aqr;
          a[q][r] = s * apr + c * aqr;
        }
        a[p][q] = T(0);
        a[q][p] = T(0);
#pragma unroll
        for (int r = 0; r < N; ++r) {  // V J
          const T vrp = v[r][p], vrq = v[r][q];
          v[r][p] = c * vrp - s * vrq;
          v[r][q] = s * vrp + c * vrq;
        }
      }
    }
  }
  // Ascending order: a selection sort of N values, swapping the columns
  // of V with them (all indices stay compile-time constants).
  T d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = a[i][i];
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      if (d[j] < d[i]) {
        const T t = d[i];
        d[i] = d[j];
        d[j] = t;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const T u = v[r][i];
          v[r][i] = v[r][j];
          v[r][j] = u;
        }
      }
    }
  }
  if (sweeps) sweeps[b] = sweep;
  T* w_out = w + (size_t)b * N;
  T* v_out = V + (size_t)b * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    w_out[i] = d[i];
#pragma unroll
    for (int j = 0; j < N; ++j) v_out[i * N + j] = v[i][j];
  }
}

// ---------------------------------------------------------------- 5..9
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
  float t = at > big ? __fdividef(0.5f, at) : __fdividef(1.0f, u + h * rsqrtf(h));
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
template <typename T>
__device__ __forceinline__ bool before(T x, T y) { return x < y || (isnan(y) && !isnan(x)); }

// Lane j's diagonal element a_jj.
template <typename T, int M>
__device__ __forceinline__ T diagonal(const T (&a)[M], int j) {
  T d = a[0];
#pragma unroll
  for (int i = 1; i < M; ++i) d = i == j ? a[i] : d;
  return d;
}

// One round r of the round-robin ordering on this lane's column j of A and
// of V (lanes j >= M hold nothing and pair with themselves).
template <typename T, int M>
__device__ __forceinline__ void group_round(T (&a)[M], T (&v)[M], int j, int r, T tol,
                                            bool& rotated) {
  const int k = j < M ? partner(j, r, M) : j;
  T ak[M], vk[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {  // the partner's columns, before the rotation
    ak[i] = __shfl_sync(FULL, a[i], k, GROUP);
    vk[i] = __shfl_sync(FULL, v[i], k, GROUP);
  }
  const T ajj = diagonal<T, M>(a, j);
  T ajk = a[0];
#pragma unroll
  for (int i = 1; i < M; ++i) ajk = i == k ? a[i] : ajk;
  const T akk = __shfl_sync(FULL, ajj, k, GROUP);
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
  const T cj = __shfl_sync(FULL, c, p, GROUP);
  const T sj = __shfl_sync(FULL, s, p, GROUP);
  const bool rot_pair = __shfl_sync(FULL, (int)rot, p, GROUP);
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
      const T cp = __shfl_sync(FULL, c, pp, GROUP);
      const T sp = __shfl_sync(FULL, s, pp, GROUP);
      const T xp = a[pp], xq = a[qq];
      a[pp] = cp * xp - sp * xq;
      a[qq] = sp * xp + cp * xq;
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] = (rot_pair && i == k) ? T(0) : a[i];  // the zeroed a_pq
}

// Whether some element of lane j's column fails the relative test
// |a_ij| <= eps sqrt(|a_ii a_jj|), squared as in group_round.
template <typename T, int M>
__device__ __forceinline__ bool above_tolerance(const T (&a)[M], int j, T tol) {
  const T ajj = diagonal<T, M>(a, j);
  bool above = false;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const T aii = __shfl_sync(FULL, ajj, i, GROUP);
    above |= i != j && a[i] * a[i] > tol * tol * fabs(aii * ajj);
  }
  return above;
}

// The main path's launches have at most 13 blocks (100 matrices, 8 a
// block), so asking for one block a multiprocessor costs nothing and lets
// the compiler spend registers rather than spill.
template <typename T, int M>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, 1)
sym_eig_group_kernel(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
                     int* __restrict__ sweeps, int batch, int n) {
  const int lane = threadIdx.x % 32;
  const int j = lane % GROUP;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / GROUP;
  const bool live = b < batch;  // a dead group runs on zeros: every warp stays whole
  const T* a_in = A + (size_t)(live ? b : 0) * n * n;
  T a[M], v[M];
  T amax = T(0);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T x = T(0);
    if (live && i < n && j < n) x = i >= j ? a_in[i * n + j] : a_in[j * n + i];
    a[i] = x;
    v[i] = T(i == j);
    amax = fmax(amax, fabs(x));
  }
  // Scale by a power of two (exact) so that the largest |a| lies in
  // [0.5, 1); the eigenvalues are scaled back at the end.
#pragma unroll
  for (int o = GROUP / 2; o > 0; o /= 2) amax = fmax(amax, __shfl_xor_sync(FULL, amax, o, GROUP));
  int e = 0;
  frexp(amax, &e);
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] = ldexp(a[i], -e);
  const T tol = eps_of<T>();
  int swept = 0;  // sweeps in which this group rotated
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    // A sweep runs while some pair fails the relative test (the test every
    // round applies before it rotates; a sweep that rotated nothing would
    // only repeat it).
    if (!__any_sync(FULL, above_tolerance<T, M>(a, j, tol))) break;
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) group_round<T, M>(a, v, j, r, tol, rotated);
    swept += ((__ballot_sync(FULL, rotated) >> (lane & GROUP)) & 0xffffu) != 0;
  }
  // Ascending order: each lane's eigenvalue is its diagonal element; its
  // rank among the group's first n lanes says where it and its column go.
  const T d = ldexp(diagonal<T, M>(a, j), e);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const T di = __shfl_sync(FULL, d, i, GROUP);
    rank += i < n && i != j && (before(di, d) || (!before(d, di) && i < j));
  }
  if (!live || j >= n) return;
  if (sweeps && j == 0) sweeps[b] = swept;
  w[(size_t)b * n + rank] = d;
  T* v_out = V + (size_t)b * n * n;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < n) v_out[i * n + rank] = v[i];
}

template <typename T>
int launch(const void* A, void* w, void* V, int* sw, int batch, int n, cudaStream_t stream) {
  const T* a = (const T*)A;
  T* wo = (T*)w;
  T* vo = (T*)V;
  const int thread_grid = (batch + THREAD_BLOCK - 1) / THREAD_BLOCK;
  switch (n) {
    case 1: sym_eig_thread_kernel<T, 1><<<thread_grid, THREAD_BLOCK, 0, stream>>>(a, wo, vo, sw, batch); break;
    case 2: sym_eig_thread_kernel<T, 2><<<thread_grid, THREAD_BLOCK, 0, stream>>>(a, wo, vo, sw, batch); break;
    case 3: sym_eig_thread_kernel<T, 3><<<thread_grid, THREAD_BLOCK, 0, stream>>>(a, wo, vo, sw, batch); break;
    case 4: sym_eig_thread_kernel<T, 4><<<thread_grid, THREAD_BLOCK, 0, stream>>>(a, wo, vo, sw, batch); break;
    default: {
      const int per_block = WARPS_PER_BLOCK * 32 / GROUP;
      const int grid = (batch + per_block - 1) / per_block;
      if (n <= 6)
        sym_eig_group_kernel<T, 6><<<grid, WARPS_PER_BLOCK * 32, 0, stream>>>(a, wo, vo, sw, batch, n);
      else if (n <= 8)
        sym_eig_group_kernel<T, 8><<<grid, WARPS_PER_BLOCK * 32, 0, stream>>>(a, wo, vo, sw, batch, n);
      else
        sym_eig_group_kernel<T, 10><<<grid, WARPS_PER_BLOCK * 32, 0, stream>>>(a, wo, vo, sw, batch, n);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// A: batch contiguous n x n matrices (the lower triangle is read); w: batch x n
// eigenvalues, ascending; V: batch x n x n, eigenvector k in column k;
// sweeps: null, or batch ints that receive each matrix's count of sweeps.
// dtype 0 = float32, 1 = float64. Returns the CUDA error of the launch, or -1
// for arguments the kernel does not take.
extern "C" int sym_eig_launch(const void* A, void* w, void* V, void* sweeps, int batch, int n,
                              int dtype, void* stream) {
  if (n < 1 || n > 9 || batch < 0 || (dtype != 0 && dtype != 1)) return -1;
  if (batch == 0) return 0;
  int* sw = (int*)sweeps;
  return dtype ? launch<double>(A, w, V, sw, batch, n, (cudaStream_t)stream)
               : launch<float>(A, w, V, sw, batch, n, (cudaStream_t)stream);
}
