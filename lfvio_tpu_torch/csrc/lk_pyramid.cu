// Pyramidal Lucas-Kanade optical flow for N features in one launch per frame,
// on Hopper: every pyramid level, coarse to fine, and the small-window refine
// pass run inside one thread block per feature. A single level step from a
// given guess (klt.py::track_level) is a launch of the same kernel with a
// one-row pass table.
//
// Replaces the TPU kernel lfvio_tpu/frontend/klt_pallas.py::_lk_level_kernel
// together with its launcher _lk_level_pallas and the host level loop
// pyramidal_lk_pallas. It computes klt.py::pyramidal_lk (the plain PyTorch
// version in lfvio_tpu_torch/frontend/klt.py, itself the JAX main path's
// _track_level geometry): per level a (win+4)^2 template patch, a
// (win+13)^2 search patch cut around the incoming guess, in-patch offsets
// clamped to [0, 12], at most n_iters Gauss-Newton steps with a per-feature
// exit, the off_ok containment test and the real-image border test; the
// guess doubles between levels, ok is ANDed across levels, and the refine
// result is kept only where it converged within refine_max_move px.
//
// What bounds it on an H100: latency, not bytes or arithmetic. The inputs
// are two pyramids (13 MB at 1280x960, a few microseconds of device
// memory) and the arithmetic is under half a GFLOP, but each feature is a
// dependent chain of up to 90 Gauss-Newton iterations, each a window
// sample, a block-wide sum and a 2x2 step. The design therefore removes
// everything from that chain that does not belong to it:
//
//  * One launch per frame. The level loop, the doubling of the guess, the
//    ANDing of ok and the refine rule run in the block, so a frame's LK is
//    one kernel and no other device work (the per-level version took five
//    launches, ten padded image copies and some twenty small tensor ops).
//  * No padded copies. klt.py pads every level by 30 px with edge
//    replication; here all geometry is computed in those padded
//    coordinates and the pad exists only as an index clamp where the two
//    patches are staged from device memory.
//  * The template is fixed during the iterations, so each thread owns a
//    fixed run of taps in one window row for the whole pass and holds
//    their T, Tx, Ty in registers; the loop reads only the search patch,
//    two shared-memory loads per tap instead of four (neighbouring taps of
//    a run share theirs), with no division and no bounds test (offsets
//    clamped to [0, 12] keep every tap inside the staged patch).
//  * One barrier per iteration. Sums go through warp shuffles and two
//    scratch rows used in turn; every thread then holds the totals and
//    takes the 2x2 step and the convergence test itself, bit for bit alike.
//    All sums have a fixed order (no atomics), so a run repeats bit for bit.
//  * Loads overlap what does not need them. The search patch (which depends
//    on the guess) is fetched with cp.async while the template sample and
//    the structure tensor are computed; the next pass's template patch
//    (which depends only on the feature position) is fetched into a second
//    buffer while the current pass iterates.
//
// Not used, and why. TMA: its out-of-range fill is zero, not the edge
// value, so it could serve only patches wholly inside the image, and klt.py's
// 54-float box at an arbitrary column is 216 B wide and not 16-byte aligned;
// the Pallas geometry's band (below) is aligned, but 16-byte cp.async copies
// already make its staging one instruction per 16 bytes, and a TMA copy
// would still need the clamped path at the image's edges: not tried.
// Tensor cores: with one fractional offset per window a bilinear sample is
// a 4-tap stencil (about 8 operations per tap); the banded shift-matrix
// products that fed the TPU's matrix unit cost about 50 times that
// arithmetic.
//
// Block shape: THREADS = 256 threads, one block per feature. A window row
// is cut into ceil(win / run) runs of run = ceil(win / (256 / win)) taps:
// at win 41 six runs of 7 (the last of 6), 246 of 256 threads busy, 6.2%
// of tap slots idle; at win 15 fifteen runs of 1, 225 threads busy, 12%
// idle. Dynamic shared memory at win 41 / refine 15: two template buffers
// of 45^2 floats, the search patch 54^2, the template sample 43^2 =
// 35,260 B, under the 48 KB that needs no opt-in; 80 registers, no spills;
// 256 blocks on 132 SMs are all resident at once, two to an SM (six would
// fit by shared memory, three by registers).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (1280x960, 256 features,
// CUDA events behind a queue kept full): 37 us per frame. Of the 37 us, 4 are
// launch and exit, 22 the five passes' set-up (staging, template sample,
// structure tensor) and 11 the iterations, 0.6 us each in the longest
// chain (chip_smoke.py phase 3). The set-up makes about 160 warp-wide 4-byte
// cp.async copies per block and pass; the Pallas geometry below stages
// with 16-byte copies, which this geometry's 54-column patches do not yet.
//
// The Pallas geometry (klt.py::pyramidal_lk_pallas, the function of the JAX
// package's Pallas kernel klt_pallas.py::pyramidal_lk_pallas) is a second
// kernel, lk_pallas_kernel, over the same body (lk_pyramid_body<true>),
// launched by the same entry, with no refine pass. Per level it differs
// from klt.py's in where its patches lie: the template patch is 56 x 256
// and the search patch 64 x 256 of the level padded by 30 and then
// edge-padded to whole (8, 128) tiles (Ht x Wt, which the wrapper computes
// per level and passes in LkLevels), both from origins aligned down to 8
// rows and 128 columns; in-patch offsets are clamped to [0, 22] x [0, 214]
// (rows and columns apart), so a feature may move much further within a
// level; a template tap outside its patch reads 0, where klt.py's mode
// reads the edge value.
//
// That search window is 64 KB of float32 per feature and pass, over the 48
// KB of dynamic shared memory a block has without opt-in, and an iteration
// at offset (iy, ix) reads only the (win+1)^2 = 42 x 42 taps of rows
// iy .. iy + win and columns ix .. ix + win. Since 22 + win + 1 = 64 = SROWS
// at win 41 every row is reachable, but only the columns around the
// offset. So this geometry stages a band: all SROWS rows and band_cols(win)
// = 60 columns (win + 1, SEARCH_MARGIN on either side and 3 for the
// alignment, rounded up to whole 16-byte chunks), 15,360 B at win 41,
// around the pass's first column offset. An iteration whose window leaves
// the band restages it around its own offset: every thread holds the same
// guess bit for bit, so the test is uniform over the block, and a restage
// costs one copy and one barrier. The band holds the floats the padded
// level holds (the pad and the tile-aligned pad both replicate the edge,
// so both are the same index clamp), and an iteration reads two
// shared-memory rows with no test and no clamp, klt.py's mode's loop. The
// template buffer holds the (win+3)^2 taps the (win+2)^2 sample reads, 0
// where a tap lies outside the 56 x 256 patch and the clamped level
// elsewhere, so the sample has no test either. Both start on an image
// column that is a multiple of 4, so 4 columns that lie inside the image
// (and the patch) go as one 16-byte cp.async (the levels' rows are 16-byte
// aligned where W % 4 == 0, as at 1280/640/320/160 and 512/256/128/64),
// the rest tap by tap. As in klt.py's mode, the band is fetched while the
// template sample and the structure tensor are computed, and the next
// pass's template while this pass iterates. Dynamic shared memory at win
// 41: the band, two template buffers of 44 x 48 floats and the 43^2 sample
// = 39,652 B. Left free, the compiler took 124 registers for this body;
// lk_pallas_kernel's launch bounds (three blocks an SM) hold it to 80 with
// no spills (with 4-byte template copies it spilled 24 B at that cap).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, same frame, 4 levels
// (chip_smoke.py phase 3): 31.5 us per frame, 16% under the 37.6 us of the
// design it replaced, which staged nothing and read every tap from the
// level images through L1 with the clamps. 3.5 us launch and exit, 21 us
// set-up (4.3 us a pass, as klt.py's mode; 17.8 us before), 0.62 us an
// iteration over the longest chain of 17 (1.16 before; klt.py's mode 0.59
// in the same run); at 9.7% of the bytes bound. No PyTorch call computes it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC
// and bound with ctypes (lfvio_tpu_torch/frontend/klt_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define SEARCH_MARGIN 6
#define MIN_EIG_THR 1e-4f
#define THREADS 256
#define MAX_RUN 7      // taps of one window row a thread owns: windows up to 42
#define NWARPS (THREADS / 32)
#define MAX_LEVELS 8   // pyramid levels, level 0 included: n_levels up to 7
#define MAX_PASSES (MAX_LEVELS + 1)
// The Pallas geometry's patches (klt_pallas.py:42-44): LANES columns, the
// template TROWS and the search SROWS rows.
#define LANES 256
#define TROWS 56
#define SROWS 64

struct LkLevels {
  const float* prev[MAX_LEVELS];
  const float* next[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int stride[MAX_LEVELS];  // floats between rows
  int Ht[MAX_LEVELS];      // Pallas geometry: the tile-aligned padded level's
  int Wt[MAX_LEVELS];      // rows and columns
};

// The passes in the order they run: levels coarse to fine, then the refine
// pass at level 0 (the last entry when has_refine is set).
struct LkPasses {
  int n;
  int lvl[MAX_PASSES];
  int win[MAX_PASSES];
  int iters[MAX_PASSES];
  int run[MAX_PASSES];  // 0: the level is skipped (smaller side under 8 px)
};

__device__ __forceinline__ void cp_async4(float* dst_shared, const float* src_global) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src_global));
}
__device__ __forceinline__ void cp_async16(float* dst_shared, const float* src_global) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src_global));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage an n x n patch whose top-left is (top, left) in the coordinates of
// the image padded by pad with edge replication: the pad is an index clamp.
__device__ __forceinline__ void stage_patch(float* dst, const float* img, int H, int W,
                                            int stride, int pad, int top, int left, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += NWARPS) {  // a warp per row: no division, one row clamp
    const float* src = img + (size_t)min(max(top + r - pad, 0), H - 1) * stride;
    float* d = dst + r * n;
    for (int c = lane; c < n; c += 32) cp_async4(d + c, src + min(max(left + c - pad, 0), W - 1));
  }
}

// Top-left of the template patch of a pass, in padded coordinates.
template <bool PALLAS>
__device__ __forceinline__ void template_corner(const LkLevels& L, int lvl, int win, int pad,
                                                float px, float py, int* tly, int* tlx) {
  const int half = win / 2, tp = win + 4;
  if constexpr (PALLAS) {  // tile-aligned, in the tile-aligned padded level
    *tly = min(max((int)floorf(py) - half - 2, 0), L.Ht[lvl] - TROWS) / 8 * 8;
    *tlx = min(max((int)floorf(px) - half - 2, 0), L.Wt[lvl] - LANES) / 128 * 128;
  } else {
    *tly = min(max((int)floorf(py) - half - 2, 0), L.H[lvl] + 2 * pad - tp);
    *tlx = min(max((int)floorf(px) - half - 2, 0), L.W[lvl] + 2 * pad - tp);
  }
}

// Copy image columns x .. x + 3 of the row at src, clamped into [0, W), to
// the 16-byte aligned d: one 16-byte cp.async where the four lie inside the
// image and the row is 16-byte aligned (x is a multiple of 4), else one
// 4-byte cp.async per tap.
__device__ __forceinline__ void stage_chunk(float* d, const float* src, int x, int W) {
  if (((uintptr_t)src & 15) == 0 && x >= 0 && x + 3 < W) {
    cp_async16(d, src + x);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) cp_async4(d + j, src + min(max(x + j, 0), W - 1));
  }
}

// The Pallas geometry's template buffer: win + 3 rows (the taps of the
// (win+2)^2 sample) of template_cols floats, a multiple of 4 that holds the
// win + 3 taps of a row from a column up to 3 left of the first; and that
// shift, which puts the buffer's column 0 on an image column that is a
// multiple of 4. (tlx, ix): the template patch's first padded column and
// the sample's first patch column.
__host__ __device__ __forceinline__ int template_cols(int win) { return (win + 9) / 4 * 4; }
__device__ __forceinline__ int template_shift(int tlx, int ix, int pad) {
  return (tlx + ix - pad) & 3;
}

// The Pallas geometry's template: patch top-left (tly, tlx) in the padded
// level and the patch position (iy, ix) of the (win+2)^2 sample's first tap,
// offset one pixel up-left, as the pass computes them.
__device__ __forceinline__ void pallas_template_origin(const LkLevels& L, int lvl, int win,
                                                       int pad, float px, float py, int* tly,
                                                       int* tlx, int* iy, int* ix) {
  template_corner<true>(L, lvl, win, pad, px, py, tly, tlx);
  *iy = (int)floorf(py - (float)*tly - (float)(win / 2) - 1.0f);
  *ix = (int)floorf(px - (float)*tlx - (float)(win / 2) - 1.0f);
}

// Stage the template taps of a pass into dst. klt.py's geometry: the
// (win+4)^2 patch. The Pallas geometry: the taps its sample reads, 0 where a
// patch position lies outside the TROWS x LANES patch (its banded shift
// matrices give no weight there), the padded level elsewhere; a half-warp
// per row, 16 bytes at a time where the four taps lie inside the patch.
template <bool PALLAS>
__device__ __forceinline__ void stage_template(float* dst, const LkLevels& L, int lvl, int win,
                                               int pad, float px, float py) {
  const int H = L.H[lvl], W = L.W[lvl], stride = L.stride[lvl];
  int tly, tlx;
  if constexpr (PALLAS) {
    int iy, ix;
    pallas_template_origin(L, lvl, win, pad, px, py, &tly, &tlx, &iy, &ix);
    const int ld = template_cols(win), sh = template_shift(tlx, ix, pad);
    const int x0 = tlx + ix - pad - sh, xx0 = ix - sh;  // image and patch column of column 0
    for (int r = threadIdx.x >> 4; r < win + 3; r += THREADS / 16) {
      const int yy = iy + r;
      const bool row_in = yy >= 0 && yy < TROWS;
      const float* src = L.prev[lvl] + (size_t)min(max(tly + yy - pad, 0), H - 1) * stride;
      for (int q = (threadIdx.x & 15) * 4; q < ld; q += 64) {
        float* d = dst + r * ld + q;
        const int xx = xx0 + q;
        if (row_in && xx >= 0 && xx + 3 < LANES) {
          stage_chunk(d, src, x0 + q, W);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (row_in && xx + j >= 0 && xx + j < LANES)
              cp_async4(d + j, src + min(max(x0 + q + j, 0), W - 1));
            else
              d[j] = 0.0f;
          }
        }
      }
    }
  } else {
    template_corner<false>(L, lvl, win, pad, px, py, &tly, &tlx);
    stage_patch(dst, L.prev[lvl], H, W, stride, pad, tly, tlx, win + 4);
  }
}

// The Pallas geometry's band: columns of one row (a multiple of 4, so that
// every row starts on a 16-byte boundary), and the image column of its
// column 0 for a window whose first tap is at image column x: x - m aligned
// down to 4, m = (band_cols - win - 4) / 2 >= SEARCH_MARGIN, which leaves
// the window m to m + 3 columns of band on its left and as many, give or
// take one, on its right (7..10 and 8..11 at win 41).
__host__ __device__ __forceinline__ int band_cols(int win) {
  return (win + 2 * SEARCH_MARGIN + 7) / 4 * 4;
}
__device__ __forceinline__ int band_origin(int x, int win) {
  return (x - (band_cols(win) - win - 4) / 2) & ~3;
}

// Stage the SROWS x bw band whose row 0 is padded row sly and whose column 0
// is image column c0 (a multiple of 4, maybe outside the image): the floats
// the padded level holds there, a half-warp per row.
__device__ __forceinline__ void stage_band(float* dst, const float* img, int H, int W, int stride,
                                           int pad, int sly, int c0, int bw) {
  for (int r = threadIdx.x >> 4; r < SROWS; r += THREADS / 16) {
    const float* src = img + (size_t)min(max(sly + r - pad, 0), H - 1) * stride;
    for (int q = (threadIdx.x & 15) * 4; q < bw; q += 64)
      stage_chunk(dst + r * bw + q, src, c0 + q, W);
  }
}

// Floats of one template buffer of a launch whose largest window is wmax.
__host__ __device__ __forceinline__ int template_floats(int wmax, bool pallas) {
  return pallas ? (wmax + 3) * template_cols(wmax) : (wmax + 4) * (wmax + 4);
}

__device__ __forceinline__ float tap(const float* P, int n, int y, int x) {
  return (y >= 0 && y < n && x >= 0 && x < n) ? P[y * n + x] : 0.0f;
}

// Sum of K values over the block in a fixed order; every thread gets the
// totals. Two scratch rows are used in turn, so one barrier is enough: a
// row is written again only after the barrier of the sum in between.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*scratch)[3][NWARPS], int& row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[row][k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += scratch[row][k][w];
    v[k] = s;
  }
  row ^= 1;
}

// The kernel's body, one instance per geometry; the two kernels below
// differ only in their launch bounds.
template <bool PALLAS>
__device__ __forceinline__ void
lk_pyramid_body(const LkLevels& L, const LkPasses& P, const float* __restrict__ pts,
                const uint8_t* __restrict__ valid, const float* __restrict__ guess_in,
                int pad, int has_refine, float refine_max_move,
                float* __restrict__ pts_out, uint8_t* __restrict__ ok_out,
                float* __restrict__ guess_out, int* __restrict__ iters_out,
                int* __restrict__ restages_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float scratch[2][3][NWARPS];

  const int f = blockIdx.x;
  const int t = threadIdx.x;

  int wmax = 1;
  for (int p = 0; p < P.n; ++p) wmax = max(wmax, P.win[p]);
  const int tp_max = template_floats(wmax, PALLAS);
  const int patch_max = PALLAS ? SROWS * band_cols(wmax)
                               : (wmax + 1 + 2 * SEARCH_MARGIN) * (wmax + 1 + 2 * SEARCH_MARGIN);
  // Two template patches, used in turn, and the search patch; the Pallas
  // geometry's band comes first, 16-byte aligned for its copies.
  float* tbuf = PALLAS ? smem + patch_max : smem;
  float* spatch = PALLAS ? smem : smem + 2 * tp_max;
  float* text = PALLAS ? tbuf + 2 * tp_max : spatch + patch_max;  // the (win+2)^2 template sample

  const float px0 = pts[2 * f], py0 = pts[2 * f + 1];
  bool ok = valid[f] != 0;
  // The guess at the scale of the first pass that runs: 0 unless given.
  float gx = guess_in ? guess_in[2 * f] : 0.0f;
  float gy = guess_in ? guess_in[2 * f + 1] : 0.0f;
  int row = 0;  // scratch row of the next block_sum
  int cur = 0;  // template buffer of the current pass

  int p = 0;
  while (p < P.n && !P.run[p]) ++p;
  int lvl_prev = p < P.n ? P.lvl[p] : 0;
  if (ok && p < P.n) {
    const int lvl = P.lvl[p];
    const float inv = 1.0f / (float)(1 << lvl);
    stage_template<PALLAS>(tbuf, L, lvl, P.win[p], pad, px0 * inv + (float)pad,
                           py0 * inv + (float)pad);
  }
  cp_async_commit();

  for (int nxt; p < P.n; p = nxt) {
    nxt = p + 1;
    while (nxt < P.n && !P.run[nxt]) ++nxt;
    const int lvl = P.lvl[p];
    for (int d = lvl_prev - lvl; d > 0; --d) {  // the guess doubles between levels
      gx *= 2.0f;
      gy *= 2.0f;
    }
    lvl_prev = lvl;
    if (!ok) continue;  // a lost feature takes no more iterations (uniform over the block)

    const int win = P.win[p], n_iters = P.iters[p];
    const int half = win / 2;
    const int tp = win + 4;
    const int patch = win + 1 + 2 * SEARCH_MARGIN;
    const int te = win + 2;
    const int H = L.H[lvl], W = L.W[lvl];
    const int Hp = H + 2 * pad, Wp = W + 2 * pad;
    const float inv = 1.0f / (float)(1 << lvl);
    const float px = px0 * inv + (float)pad;  // padded coordinates, as klt.py
    const float py = py0 * inv + (float)pad;
    const float gx_in = gx, gy_in = gy;
    const float hi_y = (float)((PALLAS ? SROWS : patch) - win - 1);
    const float hi_x = (float)((PALLAS ? LANES : patch) - win - 1);

    // The search patch depends on the guess: fetch it now, use it after the
    // template work below. The Pallas geometry fetches the band around the
    // first iteration's column offset; bc is the band's first image column.
    int sly, slx, bc = 0;
    const int bw = band_cols(win);
    if constexpr (PALLAS) {
      sly = min(max((int)floorf(py + gy) - half - SEARCH_MARGIN, 0), L.Ht[lvl] - SROWS) / 8 * 8;
      slx = min(max((int)floorf(px + gx) - half - SEARCH_MARGIN, 0), L.Wt[lvl] - LANES) / 128 *
            128;
      const float ox = fminf(fmaxf(px + gx - (float)slx - (float)half, 0.0f), hi_x);
      bc = band_origin(slx - pad + (int)floorf(ox), win);
      stage_band(spatch, L.next[lvl], H, W, L.stride[lvl], pad, sly, bc, bw);
    } else {
      sly = min(max((int)floorf(py + gy) - half - SEARCH_MARGIN, 0), Hp - patch);
      slx = min(max((int)floorf(px + gx) - half - SEARCH_MARGIN, 0), Wp - patch);
      stage_patch(spatch, L.next[lvl], H, W, L.stride[lvl], pad, sly, slx, patch);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this pass's template patch has arrived
    __syncthreads();

    // Template sample over (win+2)^2, offset one pixel up-left.
    {
      int tly, tlx;
      template_corner<PALLAS>(L, lvl, win, pad, px, py, &tly, &tlx);
      const float oy = py - (float)tly - (float)half - 1.0f;
      const float ox = px - (float)tlx - (float)half - 1.0f;
      const float fy0 = floorf(oy), fx0 = floorf(ox);
      const int iy = (int)fy0, ix = (int)fx0;
      const float fy = oy - fy0, fx = ox - fx0;
      const float wy = 1.0f - fy, wx = 1.0f - fx;
      const float* T0 = tbuf + cur * tp_max;
      // A thread samples a run of columns in one row, so neighbouring
      // samples share their row interpolation.
      const int per_row = THREADS / te;
      const int trun = (te + per_row - 1) / per_row;
      const int tseg = (te + trun - 1) / trun;
      const int tr = t / tseg;
      const int tc0 = (t - tr * tseg) * trun;
      if (tr < te) {
        const int n_out = min(trun, te - tc0);
        const int y = iy + tr, x = ix + tc0;
        float* __restrict__ out = text + tr * te + tc0;
        if (PALLAS || (iy >= 0 && ix >= 0 && iy + te < tp && ix + te < tp)) {  // all taps staged
          // The Pallas geometry staged the sample's own taps from (iy, ix),
          // shifted right by template_shift.
          const int ld = PALLAS ? template_cols(win) : tp;
          const float* __restrict__ q0 =
              T0 + (PALLAS ? tr * ld + template_shift(tlx, ix, pad) + tc0 : y * tp + x);
          const float* __restrict__ q1 = q0 + ld;
          float v0 = wy * q0[0] + fy * q1[0];
#pragma unroll 4
          for (int c = 0; c < n_out; ++c) {
            const float v1 = wy * q0[c + 1] + fy * q1[c + 1];
            out[c] = wx * v0 + fx * v1;
            v0 = v1;
          }
        } else {  // a clamped corner: taps outside the patch read 0
          float v0 = wy * tap(T0, tp, y, x) + fy * tap(T0, tp, y + 1, x);
          for (int c = 0; c < n_out; ++c) {
            const float v1 = wy * tap(T0, tp, y, x + c + 1) + fy * tap(T0, tp, y + 1, x + c + 1);
            out[c] = wx * v0 + fx * v1;
            v0 = v1;
          }
        }
      }
    }
    __syncthreads();

    // This thread's taps for the whole pass: cnt columns from c0 in row r.
    const int run = P.run[p];
    const int nseg = (win + run - 1) / run;
    const int r = t / nseg;
    const int c0 = (t - r * nseg) * run;
    const int cnt = r < win ? min(run, win - c0) : 0;
    float T[MAX_RUN], Tx[MAX_RUN], Ty[MAX_RUN];
    float G[3] = {0.0f, 0.0f, 0.0f};
    {
      // Row r+1 of the sample slides through (left, mid, right); rows r and
      // r+2 give the vertical difference.
      const float* e = text + (r + 1) * te + c0 + 1;
      float left = 0.0f, mid = 0.0f;
      if (cnt > 0) {
        left = e[-1];
        mid = e[0];
      }
#pragma unroll
      for (int c = 0; c < MAX_RUN; ++c) {
        T[c] = Tx[c] = Ty[c] = 0.0f;
        if (c < cnt) {
          const float right = e[c + 1];
          T[c] = mid;
          Tx[c] = 0.5f * (right - left);
          Ty[c] = 0.5f * (e[c + te] - e[c - te]);
          G[0] += Tx[c] * Tx[c];
          G[1] += Tx[c] * Ty[c];
          G[2] += Ty[c] * Ty[c];
          left = mid;
          mid = right;
        }
      }
    }
    block_sum<3>(G, scratch, row);
    const float Gxx = G[0], Gxy = G[1], Gyy = G[2];
    const float det = Gxx * Gyy - Gxy * Gxy;
    const float tr = Gxx + Gyy;
    const float min_eig = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    const bool good_G = min_eig / (float)(win * win) > MIN_EIG_THR;
    const float inv_det = det > 1e-12f ? 1.0f / fmaxf(det, 1e-12f) : 0.0f;

    // The next pass's template patch depends only on the feature position:
    // fetch it into the other buffer while this pass iterates.
    if (nxt < P.n && good_G) {
      const int nl = P.lvl[nxt];
      const float ninv = 1.0f / (float)(1 << nl);
      stage_template<PALLAS>(tbuf + (cur ^ 1) * tp_max, L, nl, P.win[nxt], pad,
                             px0 * ninv + (float)pad, py0 * ninv + (float)pad);
    }
    cp_async_commit();
    cp_async_wait<1>();  // the search patch has arrived
    __syncthreads();

    const float base_sy = (float)sly, base_sx = (float)slx;
    bool live = good_G;
    int k = 0, restages = 0;
    for (; k < n_iters && live; ++k) {
      // Offsets in [0, hi_y] x [0, hi_x] keep every tap, the +1 ones
      // included, inside the search patch: no bounds test in this loop.
      const float oy = fminf(fmaxf(py + gy - base_sy - (float)half, 0.0f), hi_y);
      const float ox = fminf(fmaxf(px + gx - base_sx - (float)half, 0.0f), hi_x);
      const float fy0 = floorf(oy), fx0 = floorf(ox);
      const float fy = oy - fy0, fx = ox - fx0;
      const float wy = 1.0f - fy, wx = 1.0f - fx;
      // The staged patch's column of the window's first tap. The Pallas
      // geometry's window must lie inside the band, or the band is staged
      // again around it: every thread holds the same guess, so all of them
      // take this branch or none, after the last iteration's reads (they
      // came before the barrier of its sums).
      int col = (int)fx0;
      if constexpr (PALLAS) {
        col = slx - pad + (int)fx0 - bc;
        if (col < 0 || col > bw - 1 - win) {
          bc = band_origin(slx - pad + (int)fx0, win);
          stage_band(spatch, L.next[lvl], H, W, L.stride[lvl], pad, sly, bc, bw);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          col = slx - pad + (int)fx0 - bc;
          ++restages;
        }
      }
      float b[2] = {0.0f, 0.0f};
      if (cnt > 0) {
        const int ld = PALLAS ? bw : patch;
        const float* q0 = spatch + ((int)fy0 + r) * ld + col + c0;  // two rows of taps
        const float* q1 = q0 + ld;
        float v0 = wy * q0[0] + fy * q1[0];  // rows first, then columns
#pragma unroll
        for (int c = 0; c < MAX_RUN; ++c) {
          if (c < cnt) {
            const float v1 = wy * q0[c + 1] + fy * q1[c + 1];
            const float res = (wx * v0 + fx * v1) - T[c];
            b[0] += Tx[c] * res;
            b[1] += Ty[c] * res;
            v0 = v1;
          }
        }
      }
      block_sum<2>(b, scratch, row);
      const float dx = fminf(fmaxf(-(Gyy * b[0] - Gxy * b[1]) * inv_det, -2.0f), 2.0f);
      const float dy = fminf(fmaxf(-(Gxx * b[1] - Gxy * b[0]) * inv_det, -2.0f), 2.0f);
      gx += dx;
      gy += dy;
      live = dx * dx + dy * dy > 1e-4f;
    }
    if (t == 0 && iters_out != nullptr) iters_out[f * P.n + p] = k;
    if (PALLAS && t == 0 && restages_out != nullptr) restages_out[f * P.n + p] = restages;

    // Border validity in real-image coordinates, and the sample window must
    // have stayed inside the search patch.
    const float fx = px + gx, fy = py + gy;
    const bool inb = fx >= (float)pad + 1.0f && fx < (float)pad + (float)W - 1.0f &&
                     fy >= (float)pad + 1.0f && fy < (float)pad + (float)H - 1.0f;
    const float offy = fy - base_sy - (float)half, offx = fx - base_sx - (float)half;
    const bool off_ok = offy >= 0.0f && offy <= hi_y && offx >= 0.0f && offx <= hi_x;
    const bool ok_l = good_G && inb && off_ok;
    if (has_refine && p == P.n - 1) {
      // The refine result is kept only where it converged close by; ok is
      // not ANDed with it.
      const float mx = gx - gx_in, my = gy - gy_in;
      if (!(ok_l && mx * mx + my * my < refine_max_move * refine_max_move)) {
        gx = gx_in;
        gy = gy_in;
      }
    } else {
      ok = ok_l;
    }
    cur ^= 1;
  }
  cp_async_wait<0>();  // nothing of this block is in flight when it ends

  if (t == 0) {
    if (pts_out != nullptr) {
      pts_out[2 * f] = px0 + gx;
      pts_out[2 * f + 1] = py0 + gy;
    }
    if (guess_out != nullptr) {
      guess_out[2 * f] = gx;
      guess_out[2 * f + 1] = gy;
    }
    ok_out[f] = ok ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
lk_pyramid_kernel(const __grid_constant__ LkLevels L, const __grid_constant__ LkPasses P,
                  const float* __restrict__ pts,
                  const uint8_t* __restrict__ valid, const float* __restrict__ guess_in,
                  int pad, int has_refine, float refine_max_move,
                  float* __restrict__ pts_out, uint8_t* __restrict__ ok_out,
                  float* __restrict__ guess_out, int* __restrict__ iters_out) {
  lk_pyramid_body<false>(L, P, pts, valid, guess_in, pad, has_refine, refine_max_move, pts_out,
                         ok_out, guess_out, iters_out, nullptr);
}

// Three blocks an SM hold the Pallas geometry to 80 registers: left free,
// the compiler takes 124 for the same loop and buys nothing with them.
__global__ void __launch_bounds__(THREADS, 3)
lk_pallas_kernel(const __grid_constant__ LkLevels L, const __grid_constant__ LkPasses P,
                 const float* __restrict__ pts,
                 const uint8_t* __restrict__ valid, const float* __restrict__ guess_in,
                 int pad, float* __restrict__ pts_out, uint8_t* __restrict__ ok_out,
                 float* __restrict__ guess_out, int* __restrict__ iters_out,
                 int* __restrict__ restages_out) {
  lk_pyramid_body<true>(L, P, pts, valid, guess_in, pad, 0, 0.0f, pts_out, ok_out, guess_out,
                        iters_out, restages_out);
}

// Dynamic shared memory of a launch whose largest window is wmax.
static size_t lk_pyramid_smem(int wmax, bool pallas) {
  const int patch = wmax + 1 + 2 * SEARCH_MARGIN, te = wmax + 2;
  const int search = pallas ? SROWS * band_cols(wmax) : patch * patch;
  return sizeof(float) * (size_t)(2 * template_floats(wmax, pallas) + search + te * te);
}

// MAX_LEVELS, which the wrapper names when it refuses a deeper pyramid.
extern "C" int lk_pyramid_max_levels(void) { return MAX_LEVELS; }

// prev/next: n_levels device pointers each (level 0 first); H, W, stride,
// and for the Pallas geometry (pallas != 0) Ht, Wt: n_levels ints; pass_*:
// n_passes ints in the order the passes run.
// guess_in (the flow to start from, at the first pass's scale), pts_out,
// guess_out (the flow found, at the last pass's scale) and
// iters_out may be null; so may restages_out, which the Pallas geometry
// fills with the times each feature's band was staged again in each pass.
// Returns the CUDA error code of the launch, or -1
// for arguments the kernel does not take.
extern "C" int lk_pyramid_launch(const void* const* prev, const void* const* next,
                                 const int* H, const int* W, const int* stride, const int* Ht,
                                 const int* Wt, int pallas, int n_levels,
                                 const int* pass_lvl, const int* pass_win,
                                 const int* pass_iters, const int* pass_skip, int n_passes,
                                 int has_refine, float refine_max_move, const float* pts,
                                 const uint8_t* valid, const float* guess_in, int n, int pad,
                                 float* pts_out, uint8_t* ok_out, float* guess_out,
                                 int* iters_out, int* restages_out, void* stream) {
  if (n == 0) return 0;
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_passes < 0 || n_passes > MAX_PASSES) return -1;
  LkLevels L = {};
  LkPasses P = {};
  for (int l = 0; l < n_levels; ++l) {
    L.prev[l] = (const float*)prev[l];
    L.next[l] = (const float*)next[l];
    L.H[l] = H[l];
    L.W[l] = W[l];
    L.stride[l] = stride[l];
    if (pallas) {
      // The patches must fit the tile-aligned level, their origins align.
      if (Ht[l] < SROWS || Wt[l] < LANES || Ht[l] % 8 || Wt[l] % 128) return -1;
      L.Ht[l] = Ht[l];
      L.Wt[l] = Wt[l];
    }
  }
  if (pallas && has_refine) return -1;
  P.n = n_passes;
  int wmax = 1;
  for (int p = 0; p < n_passes; ++p) {
    const int win = pass_win[p];
    if (win < 1 || win > THREADS || pass_lvl[p] < 0 || pass_lvl[p] >= n_levels) return -1;
    if (pallas && win >= SROWS) return -1;  // offsets in [0, SROWS - win - 1]
    const int per_row = THREADS / win;            // threads a window row can have
    const int run = (win + per_row - 1) / per_row;   // taps each of them owns
    if (run > MAX_RUN) return -1;
    P.lvl[p] = pass_lvl[p];
    P.win[p] = win;
    P.iters[p] = pass_iters[p];
    P.run[p] = pass_skip[p] ? 0 : run;
    wmax = max(wmax, win);
  }
  // MAX_RUN bounds the window at 42, so this stays under the 48 KB that
  // dynamic shared memory may take without opt-in.
  const size_t smem = lk_pyramid_smem(wmax, pallas != 0);
  if (smem > 48 * 1024) return -1;
  if (pallas)
    lk_pallas_kernel<<<n, THREADS, smem, (cudaStream_t)stream>>>(
        L, P, pts, valid, guess_in, pad, pts_out, ok_out, guess_out, iters_out, restages_out);
  else
    lk_pyramid_kernel<<<n, THREADS, smem, (cudaStream_t)stream>>>(
        L, P, pts, valid, guess_in, pad, has_refine, refine_max_move, pts_out, ok_out,
        guess_out, iters_out);
  return (int)cudaGetLastError();
}
