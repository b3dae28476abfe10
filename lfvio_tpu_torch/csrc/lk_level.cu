// One pyramid level of Lucas-Kanade optical flow for N features, on Hopper.
//
// Replaces the TPU kernel lfvio_tpu/frontend/klt_pallas.py::_lk_level_kernel
// (launched by _lk_level_pallas, driven by pyramidal_lk_pallas). The
// semantics follow lfvio_tpu/frontend/klt.py::_track_level, the JAX main
// path, not the Pallas kernel's search geometry: template side win+4, search
// patch win+1+2*SEARCH_MARGIN (54 at win 41), in-patch offsets clamped to
// [0, patch-win-1], the off_ok containment test and the real-image border
// test. Taps that fall outside a staged patch read 0, as the JAX one-hot
// shift-matrix products give.
//
// Design: one thread block per feature. The template patch (win+4)^2 and the
// search patch (win+13)^2 are staged once in shared memory, the (win+2)^2
// template sample with them; T, Tx and Ty are recomputed from that sample
// inside each sum instead of being stored (27 KB of shared memory at win 41,
// under the 48 KB static limit). Bilinear taps are computed directly (rows
// first, then columns, as the JAX form). Block-wide sums use warp shuffles
// plus one shared-memory pass in a fixed order. Thread 0 takes the
// Gauss-Newton step and the block leaves its loop when its own feature
// converges; the result equals klt.py's set-wide loop because a converged
// feature's guess is frozen there.
//
// What bounds it on an H100: latency. A frame is 256 blocks of tiny work
// (about 2 per SM over 132 SMs), each iteration a dependent chain of a
// 1681-tap sample, two block reductions and a scalar step. Neither memory
// bandwidth nor arithmetic is near its roof; fusing all levels into one
// launch per feature is the next step.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -o liblk_level.so lk_level.cu
// and bound with ctypes (lfvio_tpu_torch/frontend/klt_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define SEARCH_MARGIN 6
#define MIN_EIG_THR 1e-4f
#define THREADS 256
#define NWARPS (THREADS / 32)

// Bilinear sample of a [n x n] shared-memory patch at (oy + r, ox + c) for
// integer r, c: rows interpolated first, then columns; out-of-patch taps
// contribute 0.
__device__ __forceinline__ float tap(const float* P, int n, int y, int x) {
  return (y >= 0 && y < n && x >= 0 && x < n) ? P[y * n + x] : 0.0f;
}

__device__ __forceinline__ float sample(const float* P, int n, int iy, float fy,
                                        int ix, float fx, int r, int c) {
  const int y = iy + r, x = ix + c;
  const float v0 = (1.0f - fy) * tap(P, n, y, x) + fy * tap(P, n, y + 1, x);
  const float v1 = (1.0f - fy) * tap(P, n, y, x + 1) + fy * tap(P, n, y + 1, x + 1);
  return (1.0f - fx) * v0 + fx * v1;
}

// Sum of up to three values over the block, in a fixed order; every thread
// gets the totals.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*scratch)[NWARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += scratch[k][w];
    v[k] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                int Hp, int Wp, const float* __restrict__ pos,
                const float* __restrict__ guess, const uint8_t* __restrict__ valid,
                int pad, int win, int n_iters, float* __restrict__ g_out,
                uint8_t* __restrict__ ok_out, float* __restrict__ min_eig_out) {
  extern __shared__ float smem[];
  __shared__ float scratch[3][NWARPS];
  __shared__ float s_step[2];
  __shared__ int s_live;

  const int f = blockIdx.x;
  const int t = threadIdx.x;
  const int half = win / 2;
  const int tp = win + 4;
  const int patch = win + 1 + 2 * SEARCH_MARGIN;
  const int te = win + 2;
  float* tpatch = smem;                 // [tp * tp]
  float* spatch = tpatch + tp * tp;     // [patch * patch]
  float* text = spatch + patch * patch; // [te * te] template sample

  const float px = pos[2 * f] + (float)pad;
  const float py = pos[2 * f + 1] + (float)pad;
  float gx = guess[2 * f];
  float gy = guess[2 * f + 1];

  // Stage the template (prev) and search (next) patches.
  const int tly = min(max((int)floorf(py) - half - 2, 0), Hp - tp);
  const int tlx = min(max((int)floorf(px) - half - 2, 0), Wp - tp);
  const int sly = min(max((int)floorf(py + gy) - half - SEARCH_MARGIN, 0), Hp - patch);
  const int slx = min(max((int)floorf(px + gx) - half - SEARCH_MARGIN, 0), Wp - patch);
  for (int i = t; i < tp * tp; i += THREADS)
    tpatch[i] = prev[(size_t)(tly + i / tp) * Wp + tlx + i % tp];
  for (int i = t; i < patch * patch; i += THREADS)
    spatch[i] = next[(size_t)(sly + i / patch) * Wp + slx + i % patch];
  __syncthreads();

  // Template sample over (win+2)^2, offset one pixel up-left.
  {
    const float oy = py - (float)tly - (float)half - 1.0f;
    const float ox = px - (float)tlx - (float)half - 1.0f;
    const float fy0 = floorf(oy), fx0 = floorf(ox);
    const int iy = (int)fy0, ix = (int)fx0;
    const float fy = oy - fy0, fx = ox - fx0;
    for (int i = t; i < te * te; i += THREADS)
      text[i] = sample(tpatch, tp, iy, fy, ix, fx, i / te, i % te);
  }
  __syncthreads();

  // Structure tensor from central-difference gradients.
  float G[3] = {0.0f, 0.0f, 0.0f};
  for (int i = t; i < win * win; i += THREADS) {
    const int r = i / win, c = i % win;
    const float tx = 0.5f * (text[(r + 1) * te + c + 2] - text[(r + 1) * te + c]);
    const float ty = 0.5f * (text[(r + 2) * te + c + 1] - text[r * te + c + 1]);
    G[0] += tx * tx;
    G[1] += tx * ty;
    G[2] += ty * ty;
  }
  block_sum<3>(G, scratch);
  const float Gxx = G[0], Gxy = G[1], Gyy = G[2];
  const float det = Gxx * Gyy - Gxy * Gxy;
  const float tr = Gxx + Gyy;
  const float min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
  const bool good_G = min_eig / (float)(win * win) > MIN_EIG_THR;
  const float inv_det = det > 1e-12f ? 1.0f / fmaxf(det, 1e-12f) : 0.0f;
  const bool is_valid = valid[f] != 0;

  const float base_sy = (float)sly, base_sx = (float)slx;
  const float hi = (float)(patch - win - 1);
  bool live = good_G && is_valid;
  for (int k = 0; k < n_iters && live; ++k) {
    const float oy = fminf(fmaxf(py + gy - base_sy - (float)half, 0.0f), hi);
    const float ox = fminf(fmaxf(px + gx - base_sx - (float)half, 0.0f), hi);
    const float fy0 = floorf(oy), fx0 = floorf(ox);
    const int iy = (int)fy0, ix = (int)fx0;
    const float fy = oy - fy0, fx = ox - fx0;
    float b[2] = {0.0f, 0.0f};
    for (int i = t; i < win * win; i += THREADS) {
      const int r = i / win, c = i % win;
      const float T = text[(r + 1) * te + c + 1];
      const float tx = 0.5f * (text[(r + 1) * te + c + 2] - text[(r + 1) * te + c]);
      const float ty = 0.5f * (text[(r + 2) * te + c + 1] - text[r * te + c + 1]);
      const float res = sample(spatch, patch, iy, fy, ix, fx, r, c) - T;
      b[0] += tx * res;
      b[1] += ty * res;
    }
    block_sum<2>(b, scratch);
    if (t == 0) {
      const float dx = fminf(fmaxf(-(Gyy * b[0] - Gxy * b[1]) * inv_det, -2.0f), 2.0f);
      const float dy = fminf(fmaxf(-(Gxx * b[1] - Gxy * b[0]) * inv_det, -2.0f), 2.0f);
      s_step[0] = dx;
      s_step[1] = dy;
      s_live = dx * dx + dy * dy > 1e-4f;
    }
    __syncthreads();
    gx += s_step[0];
    gy += s_step[1];
    live = s_live != 0;
    __syncthreads();
  }

  if (t == 0) {
    const float W0 = (float)(Wp - 2 * pad), H0 = (float)(Hp - 2 * pad);
    const float fx = px + gx, fy = py + gy;
    const bool inb = fx >= (float)pad + 1.0f && fx < (float)pad + W0 - 1.0f &&
                     fy >= (float)pad + 1.0f && fy < (float)pad + H0 - 1.0f;
    const float offy = fy - base_sy - (float)half, offx = fx - base_sx - (float)half;
    const bool off_ok = offy >= 0.0f && offy <= hi && offx >= 0.0f && offx <= hi;
    g_out[2 * f] = gx;
    g_out[2 * f + 1] = gy;
    ok_out[f] = (is_valid && good_G && inb && off_ok) ? 1 : 0;
    min_eig_out[f] = min_eig;
  }
}

extern "C" int lk_level_launch(const float* prev, const float* next, int Hp, int Wp,
                               const float* pos, const float* guess,
                               const uint8_t* valid, int n, int pad, int win,
                               int n_iters, float* g_out, uint8_t* ok_out,
                               float* min_eig_out, void* stream) {
  if (n == 0) return 0;
  const int tp = win + 4, patch = win + 1 + 2 * SEARCH_MARGIN, te = win + 2;
  const size_t smem = sizeof(float) * (size_t)(tp * tp + patch * patch + te * te);
  lk_level_kernel<<<n, THREADS, smem, (cudaStream_t)stream>>>(
      prev, next, Hp, Wp, pos, guess, valid, pad, win, n_iters, g_out, ok_out,
      min_eig_out);
  return (int)cudaGetLastError();
}
