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
// the fastest memory:
//
//  * n <= 4: one thread per matrix, the matrix and its eigenvectors in
//    registers (every index is a compile-time constant: N is a template
//    argument and all loops unroll), the classic cyclic-by-row sweep.
//  * 5 <= n <= 9: one warp per matrix, padded to m = 10 (an even order; the
//    padding row and column are zero, so their rotations are identities).
//    Each round of the round-robin ordering rotates m/2 disjoint pairs at
//    once: lanes 0..m-1 each compute the rotation of their index's pair,
//    then the 32 lanes rewrite the m x m matrix and the eigenvector matrix
//    from shared memory in one pass (A' = J^T A J with J a product of
//    disjoint rotations: each new element reads four old ones), two
//    __syncwarp()s a round, m - 1 rounds a sweep.
//  * Each sweep starts with the off-diagonal mass; the loop stops when it
//    falls below the type's rounding of the diagonal (the test runs on the
//    card, so the host never waits), or after MAX_SWEEPS (quadratic
//    convergence needs 5-8 at these orders).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SWEEPS = 16;
// A sweep starts only while the off-diagonal norm exceeds TOL_SCALE * eps
// of the diagonal's: below that the eigenvectors are as exact as the type's
// rounding of the matrix allows (an error of about eps |A| / gap, as any
// backward-stable solver's), and a rank-deficient matrix's rounding noise
// keeps the norm from falling much further in float32.
constexpr double TOL_SCALE = 1.0;
constexpr int WARP_M = 10;        // the warp path's padded order
constexpr int WARPS_PER_BLOCK = 4;
constexpr int THREAD_BLOCK = 128;

template <typename T> __device__ __forceinline__ T eps_of();
template <> __device__ __forceinline__ float eps_of<float>() { return 1.1920929e-07f; }
template <> __device__ __forceinline__ double eps_of<double>() { return 2.220446049250313e-16; }

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
                      int batch) {
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
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
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

template <typename T>
struct WarpScratch {
  T a[2][WARP_M * WARP_M];  // the matrix, in turns
  T v[2][WARP_M * WARP_M];  // the eigenvectors, in turns
  T jd[WARP_M];             // J[i][i] for each index
  T jo[WARP_M];             // J[k][i], k the partner of i
  int pk[WARP_M];           // the partner of each index this round
  T d[WARP_M];
};

template <typename T>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sym_eig_warp_kernel(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
                    int batch, int n) {
  __shared__ WarpScratch<T> scratch[WARPS_PER_BLOCK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS_PER_BLOCK + warp;
  if (b >= batch) return;  // whole warps leave together
  constexpr int m = WARP_M, mm = WARP_M * WARP_M;
  WarpScratch<T>& S = scratch[warp];
  const T* a_in = A + (size_t)b * n * n;
  for (int e = lane; e < mm; e += 32) {
    const int i = e / m, j = e % m;
    T x = T(0);
    if (i < n && j < n) x = i >= j ? a_in[i * n + j] : a_in[j * n + i];
    S.a[0][e] = x;
    S.v[0][e] = T(i == j);
  }
  __syncwarp();
  int cur = 0;
  const T tol = TOL_SCALE * eps_of<T>();
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    T off = T(0), diag = T(0);
    for (int e = lane; e < mm; e += 32) {
      const int i = e / m, j = e % m;
      const T x = S.a[cur][e];
      if (i == j) diag += x * x;
      else if (i < j) off += x * x;
    }
    for (int k = 16; k > 0; k >>= 1) {
      off += __shfl_xor_sync(0xffffffffu, off, k);
      diag += __shfl_xor_sync(0xffffffffu, diag, k);
    }
    if (!(off > tol * tol * diag)) break;  // the same on every lane
    for (int r = 0; r < m - 1; ++r) {
      const T* a = S.a[cur];
      if (lane < m) {
        const int k = partner(lane, r, m);
        const int p = min(lane, k), q = max(lane, k);
        T c, s;
        rotation(a[p * m + p], a[q * m + q], a[p * m + q], c, s);
        S.jd[lane] = c;
        S.jo[lane] = lane == p ? -s : s;  // J[q][p] = -s, J[p][q] = s
        S.pk[lane] = k;
      }
      __syncwarp();
      T* a2 = S.a[cur ^ 1];
      const T* v = S.v[cur];
      T* v2 = S.v[cur ^ 1];
      for (int e = lane; e < mm; e += 32) {
        const int i = e / m, j = e % m;
        const int ki = S.pk[i], kj = S.pk[j];
        const T di = S.jd[i], oi = S.jo[i], dj = S.jd[j], oj = S.jo[j];
        // (J^T A J)[i][j] over the two indices of each pair; the pair's own
        // off-diagonal element is the one the rotation zeroes.
        a2[e] = (ki == j) ? T(0)
                          : di * (dj * a[i * m + j] + oj * a[i * m + kj])
                                + oi * (dj * a[ki * m + j] + oj * a[ki * m + kj]);
        v2[e] = dj * v[i * m + j] + oj * v[i * m + kj];
      }
      __syncwarp();
      cur ^= 1;
    }
  }
  // Ascending order: lane 0 sorts the indices (a selection sort of n
  // values; with a NaN the order is some permutation all the same), then
  // each lane writes one eigenvalue and its column.
  if (lane == 0) {
    for (int i = 0; i < n; ++i) {
      S.d[i] = S.a[cur][i * m + i];
      S.pk[i] = i;
    }
    for (int i = 0; i < n - 1; ++i) {
      int best = i;
      for (int j = i + 1; j < n; ++j)
        if (S.d[S.pk[j]] < S.d[S.pk[best]]) best = j;
      const int t = S.pk[i];
      S.pk[i] = S.pk[best];
      S.pk[best] = t;
    }
  }
  __syncwarp();
  T* w_out = w + (size_t)b * n;
  T* v_out = V + (size_t)b * n * n;
  if (lane < n) {
    const int src = S.pk[lane];
    w_out[lane] = S.d[src];
    for (int r = 0; r < n; ++r) v_out[r * n + lane] = S.v[cur][r * m + src];
  }
}

template <typename T>
int launch(const void* A, void* w, void* V, int batch, int n, cudaStream_t stream) {
  const T* a = (const T*)A;
  T* wo = (T*)w;
  T* vo = (T*)V;
  const int thread_grid = (batch + THREAD_BLOCK - 1) / THREAD_BLOCK;
  switch (n) {
    case 1: sym_eig_thread_kernel<T, 1><<<thread_grid, THREAD_BLOCK, 0, stream>>>(a, wo, vo, batch); break;
    case 2: sym_eig_thread_kernel<T, 2><<<thread_grid, THREAD_BLOCK, 0, stream>>>(a, wo, vo, batch); break;
    case 3: sym_eig_thread_kernel<T, 3><<<thread_grid, THREAD_BLOCK, 0, stream>>>(a, wo, vo, batch); break;
    case 4: sym_eig_thread_kernel<T, 4><<<thread_grid, THREAD_BLOCK, 0, stream>>>(a, wo, vo, batch); break;
    default: {
      const int grid = (batch + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
      sym_eig_warp_kernel<T><<<grid, WARPS_PER_BLOCK * 32, 0, stream>>>(a, wo, vo, batch, n);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// A: batch contiguous n x n matrices (the lower triangle is read); w: batch x n
// eigenvalues, ascending; V: batch x n x n, eigenvector k in column k.
// dtype 0 = float32, 1 = float64. Returns the CUDA error of the launch, or -1
// for arguments the kernel does not take.
extern "C" int sym_eig_launch(const void* A, void* w, void* V, int batch, int n, int dtype,
                              void* stream) {
  if (n < 1 || n > 9 || batch < 0 || (dtype != 0 && dtype != 1)) return -1;
  if (batch == 0) return 0;
  return dtype ? launch<double>(A, w, V, batch, n, (cudaStream_t)stream)
               : launch<float>(A, w, V, batch, n, (cudaStream_t)stream);
}
