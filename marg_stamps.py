"""Where the time of one marg_qr launch goes, on one CUDA card: clock64
stamps in the block of leaf 0 (the dense head's leaf) and in the block of
the final merge (the tree's root absorbed into leaf 0's triangle, the end
of the launch's chain). With ``depth``, where the time of one marg_depth
launch goes.

    python3 marg_stamps.py [MARG_QR_CU]        (beside chip_smoke.py)
    python3 marg_stamps.py depth [MARG_QR_CU]

MARG_QR_CU defaults to this tree's ``lfvio_tpu_torch/csrc/marg_qr.cu``; an
earlier one (for example ``git show affed1d:lfvio_tpu_torch/csrc/marg_qr.cu
> _archive/marg_qr_first.cu``) is stamped as its design allows:

* a column-step design (a block-wide step and barrier a column, as the first
  ``marg_qr_kernel``): the group that forms the next column's reflection
  stamps each step's phases, summed over the block's steps: its update of
  its own columns (dot products, shuffles, the R row written), the rest of
  the wait for the next pivot row of R from L2, the reflection (norm,
  shuffles, square root, divisions, v into shared memory), the barrier;
* the panel design (this tree): thread 0 stamps each panel's factorization
  (warp 0) and its wait for the next panel's columns, thread 32 the update
  of the later columns that runs beside it (warp 1), thread 0 the block
  barrier that ends an iteration and each tile's staging; and lane 0 of
  warp 0 the phases of each column step inside a panel (each stamp waits
  for a value the phase computes).

``depth``: thread 0 of every block of ``marg_depth_kernel`` stamps its
phases, summed over the blocks: in the first design (a 128-thread block
a slot, three block barriers) the staging of the slot's rows, warp 0's
reflection, u = vᵀA, the write; in this tree's design the copies (up to
the first barrier), the reflection with u and the compact rows, the
write; and, apart, the reflection in warp 0 after the first barrier, the
landing of thread 32's copies from the block's start, thread 32's start
after thread 0's (thread 0 stamps the phases), and the parts of the
second phase in thread 0 (a warp that sums the all-row columns) and
thread 64 (one that does not). A block barrier is added after the write so that its stamp waits
for every thread. The launch's span is the earliest block start to the
latest block end on the card's global timer (%globaltimer, ns). Run at (a)
and (b)'s MARGIN_OLD inputs (f32), the rows written into the stack's view
after the head, as the MARGIN_OLD program writes them.

Builds the stamped copy with this tree's nvcc flags into a library of its
own, binds it behind ``marg_cuda.MargQrKernel``, launches it behind
``chip_smoke.make_blocker`` (the L2 emptied, as the ``[14m]`` times are
taken) on ``chip_smoke.marg_stacks``' f32 stacks ((a) and (b) MARGIN_OLD,
(b) SECOND_NEW), and prints the card's line and, for each stack, the median
over five launches of each phase's SM cycles, its share of the block's
cycles and the cycles a step (or panel); the block's cycles are leaf 0's
own rows (its start to its triangle done) and the final merge's (in the
panel design a block of its own, from its start, waits for the rows it
reads included). Stamps
read the clock with a memory clobber, so that none moves across the loads,
stores or barriers around it; each SM has its own clock, so each interval
is taken on one.
"""

import ctypes
import re
import sys

STAMP_DEFS = ('__device__ unsigned long long marg_stamps[16];\n'
              '__shared__ int st_track;  // this block is on the chain stamped\n'
              '__shared__ long long st_t0;  // its start\n'
              '__device__ __forceinline__ long long stamp() {\n'
              '  long long t;\n'
              '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");\n'
              '  return t;\n'
              '}\n'
              '// A stamp that waits for v: the clock is read after v is computed.\n'
              '__device__ __forceinline__ long long stamp_after(float v) {\n'
              '  long long t;\n'
              '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "f"(v) : "memory");\n'
              '  return t;\n'
              '}\n'
              '__device__ __forceinline__ long long stamp_after(double v) {\n'
              '  long long t;\n'
              '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "d"(v) : "memory");\n'
              '  return t;\n'
              '}\n')
READ = ('\nextern "C" int marg_stamps_read(unsigned long long* out) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, marg_stamps, sizeof(marg_stamps));\n}\n'
        'extern "C" int marg_stamps_zero() {\n'
        '  static const unsigned long long z[16] = {};\n'
        '  return (int)cudaMemcpyToSymbol(marg_stamps, z, sizeof(z));\n}\n')
ACC = "atomicAdd(&marg_stamps[{}], (unsigned long long)({}));"

# The column-step design: (text in the kernel, what replaces it).
STEP_EDITS = [
    ("    const int kn = s + 1 < nlist ? sh.cols[s + 1] : C;\n",
     "    const int kn = s + 1 < nlist ? sh.cols[s + 1] : C;\n"
     "    bool st_own = false;\n"
     "#pragma unroll\n"
     "    for (int c = 0; c < QR_NCOL; ++c) st_own |= jc[c] == kn && kn < C;\n"
     "    st_own = st_own && gl == 0 && st_track;\n"
     "    const long long st0 = stamp();\n"),
    ("#pragma unroll\n    for (int c = 0; c < QR_NCOL; ++c)\n      if (jc[c] == kn && kn < C)\n",
     "    const long long st1 = stamp();\n"
     "#pragma unroll\n"
     "    for (int c = 0; c < QR_NCOL; ++c)\n"
     "      if (jc[c] == kn && kn < C) { volatile T sink = rnext[c]; (void)sink; }\n"
     "    const long long st2 = stamp();\n"
     "#pragma unroll\n    for (int c = 0; c < QR_NCOL; ++c)\n      if (jc[c] == kn && kn < C)\n"),
    ("    for (int c = 0; c < QR_NCOL; ++c) rcur[c] = rnext[c];\n    __syncthreads();\n",
     "    for (int c = 0; c < QR_NCOL; ++c) rcur[c] = rnext[c];\n"
     "    const long long st3 = stamp();\n"
     "    __syncthreads();\n"
     "    const long long st4 = stamp();\n"
     "    if (st_own) {\n      " + " ".join(ACC.format(i, d) for i, d in enumerate(
         ("st1 - st0", "st2 - st1", "st3 - st2", "st4 - st3", "1"))) + "\n    }\n"),
]
STEP_PHASES = ("update (dots, shuffles, R row)", "next pivot row's L2 wait",
               "reflection", "barrier", None)

# The panel design: thread 0 (warp 0) stamps its factorizations and its
# wait for the next panel's columns, thread 32 (warp 1) the update of an
# iteration, thread 0 the block barrier that ends it; lane 0 of warp 0 the
# phases of each column step inside a panel.
PANEL_EDITS = [
    ("        if (p >= 0) ahead_wait();\n"
     "        panel_factor(R, X, P, n, sh.cols + f0, cnt, C, rp, Yc + (b ^ 1) * YS, Tt + (b ^ 1) * TS);\n",
     "        const long long sa0 = stamp();\n"
     "        if (p >= 0) ahead_wait();\n"
     "        const long long sa1 = stamp();\n"
     "        panel_factor(R, X, P, n, sh.cols + f0, cnt, C, rp, Yc + (b ^ 1) * YS, Tt + (b ^ 1) * TS);\n"
     "        if (st_track && threadIdx.x == 0) {\n          "
     + ACC.format(1, "sa1 - sa0") + " " + ACC.format(0, "stamp() - sa1") + " "
     + ACC.format(4, "1") + "\n        }\n"),
    ("      panel_update(R, X, Yc + b * YS, Tt + b * TS, sh.cols + p0, min(NB, nlist - p0),\n"
     "                   sh.cols + f0, nlist - f0, sh.nf[b], C, P, factor);\n",
     "      const long long su0 = stamp();\n"
     "      panel_update(R, X, Yc + b * YS, Tt + b * TS, sh.cols + p0, min(NB, nlist - p0),\n"
     "                   sh.cols + f0, nlist - f0, sh.nf[b], C, P, factor);\n"
     "      if (st_track && threadIdx.x == 32) " + ACC.format(3, "stamp() - su0") + "\n"),
    ("    if (prog) __threadfence();  // this iteration's rows of R, before the progress\n    __syncthreads();\n",
     "    if (prog) __threadfence();  // this iteration's rows of R, before the progress\n"
     "    const long long sb0 = stamp();\n    __syncthreads();\n"
     "    if (st_track && threadIdx.x == 0) " + ACC.format(2, "stamp() - sb0") + "\n"),
    # the column step inside a panel (lane 0 of warp 0): its partial sums,
    # the butterflies, the reflection's arithmetic, the broadcast and the
    # panel's update in registers
    ("    const T a0 = __shfl_sync(FULL, rj, j);\n",
     "    const bool sp_on = st_track && threadIdx.x == 0;\n"
     "    const long long sp0 = stamp_after(x[0]);\n"
     "    const T a0 = __shfl_sync(FULL, rj, j);\n"),
    ("    T tot = transpose_sum(part, lane);\n",
     "    const long long sp1 = stamp_after(part[NB - 1]);\n"
     "    T tot = transpose_sum(part, lane);\n"),
    ("    T ss = __shfl_sync(FULL, tot, j);\n",
     "    T ss = __shfl_sync(FULL, tot, j);\n"
     "    const long long sp2 = stamp_after(ss + mx);\n"
     "    long long sp3 = sp2;\n"),
    ("      const T g = coef * tot;\n",
     "      const T g = coef * tot;\n"
     "      sp3 = stamp_after(g);\n"),
    ("    const T tj = cl < j ? -tau * acc : (cl == j ? tau : T(0));\n",
     "    if (sp_on) {\n      const long long sp4 = stamp_after(acc + y[0][NB - 1]);\n      "
     + ACC.format(9, "sp1 - sp0") + " " + ACC.format(10, "sp2 - sp1") + " "
     + ACC.format(11, "sp3 - sp2") + " " + ACC.format(12, "sp4 - sp3") + " "
     + ACC.format(13, "1") + "\n    }\n"
     "    const T tj = cl < j ? -tau * acc : (cl == j ? tau : T(0));\n"),
    ("    stage_tile(src, sh.list + t0, nt, X, C, P, sh);\n",
     "    const long long sg0 = stamp();\n"
     "    stage_tile(src, sh.list + t0, nt, X, C, P, sh);\n"
     "    if (st_track && threadIdx.x == 0) {\n      "
     + ACC.format(5, "stamp() - sg0") + " " + ACC.format(6, "1") + "\n    }\n"),
]
PANEL_PHASES = ("panel factorization (warp 0)", "warp 0's wait for the next panel's columns",
                "the block barrier after an iteration", "the update (warp 1)", None,
                "staging a tile", None)
STEP_SPLIT = ("partial sums", "butterflies (sums, max, any)",
              "reflection's arithmetic", "broadcast, panel update in registers")
STEP_KERNEL = [  # leaf 0 and the final merge, whichever block runs it
    ("  const int node = blockIdx.x;\n",
     "  const int node = blockIdx.x;\n  const long long st_start = stamp();\n"
     "  if (threadIdx.x == 0) st_track = node == 0;\n"),
    ("  if (tid < QR_MASKW) a.mask[node * QR_MASKW + tid] = sh.rmask[tid];\n  if (a.NL == 1) return;\n",
     "  if (node == 0 && tid == 0) " + ACC.format(7, "stamp() - st_start") + "\n"
     "  if (tid < QR_MASKW) a.mask[node * QR_MASKW + tid] = sh.rmask[tid];\n  if (a.NL == 1) return;\n"),
    ("  if (!second_to_arrive(a.count + levels * a.NL, sh)) return;\n",
     "  if (!second_to_arrive(a.count + levels * a.NL, sh)) return;\n"
     "  if (tid == 0) st_track = 1;\n  const long long st_fm = stamp();\n"),
]
STEP_FINAL = (re.compile(r"(  merge\(a, 0, 1, [^;]*\);\n)"), "  if (tid == 0) " + ACC.format(8, "stamp() - st_fm") + "\n")
PANEL_KERNEL = [  # leaf 0's block and the final merge's (its start to its end, waits included)
    ("  const int node = sh.ticket;\n",
     "  const int node = sh.ticket;\n"
     "  if (threadIdx.x == 0) {\n    st_t0 = stamp();\n"
     "    st_track = node == 0 || node == 2 * a.NL - 2;\n  }\n  __syncthreads();\n"),
    ("  if (tid == 0) {\n    atomicExch(ready + node, 1);\n    publish(prog + node, C);\n  }\n}\n",
     "  if (tid == 0) {\n    atomicExch(ready + node, 1);\n    publish(prog + node, C);\n"
     "    if (node == 0) " + ACC.format(7, "stamp() - st_t0") + "\n  }\n}\n"),
    ("        __nanosleep(64);\n      }\n    }\n  }\n}\n",
     "        __nanosleep(64);\n      }\n    }\n"
     "    if (st_track) " + ACC.format(8, "stamp() - st_t0") + "\n  }\n}\n"),
    ("    if (wait[0] && lane == 0) {\n      wait_for(wait[0], upto + 1);\n      wait_for(wait[1], upto + 1);\n"
     "      seen = upto + 1;\n    }\n",
     "    const long long sw0 = stamp();\n"
     "    if (wait[0] && lane == 0) {\n      wait_for(wait[0], upto + 1);\n      wait_for(wait[1], upto + 1);\n"
     "      seen = upto + 1;\n    }\n"
     "    if (wait[0] && lane == 0 && st_track) " + ACC.format(14, "stamp() - sw0") + "\n"),
]


GTIME = ('__device__ __forceinline__ unsigned long long gtime() {\n'
         '  unsigned long long t;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");\n'
         '  return t;\n'
         '}\n')
DEPTH_READ = ('\nextern "C" int marg_stamps_read(unsigned long long* out) {\n'
              '  return (int)cudaMemcpyFromSymbol(out, marg_stamps, sizeof(marg_stamps));\n}\n'
              'extern "C" int marg_stamps_zero() {\n'
              '  unsigned long long z[16] = {};\n'
              '  z[8] = ~0ull;  // the earliest block start\n'
              '  return (int)cudaMemcpyToSymbol(marg_stamps, z, sizeof(z));\n}\n')
DEPTH_START = ("  const int f = blockIdx.x, tid = threadIdx.x;\n",
               "  const int f = blockIdx.x, tid = threadIdx.x;\n"
               "  const long long sd0 = stamp();\n"
               "  if (tid == 0) atomicMin(&marg_stamps[8], gtime());\n")


def depth_end(slots):
    """The stamps after a block barrier at the kernel's end: each phase
    (start stamp, end stamp) into its slot, a block counted, the latest
    end."""
    return ("  __syncthreads();\n  if (tid == 0) {\n    const long long sdn = stamp();\n    "
            + " ".join(ACC.format(i, f"{b} - {a}") for i, (a, b) in enumerate(slots))
            + " " + ACC.format(7, "1") + "\n    atomicMax(&marg_stamps[9], gtime());\n  }\n}\n")


# The first design (a 128-thread block a slot, three barriers): staging,
# warp 0's reflection, u, the write.
DEPTH_FIRST = [
    DEPTH_START,
    ("  const int ci = a.cam ? (int)a.cam[(size_t)f * a.W1] : 0;\n  __syncthreads();\n",
     "  const int ci = a.cam ? (int)a.cam[(size_t)f * a.W1] : 0;\n  __syncthreads();\n"
     "  const long long sd1 = stamp();\n"),
    ("    if (tid == 0) s_refl = refl;\n  }\n  __syncthreads();\n",
     "    if (tid == 0) s_refl = refl;\n  }\n  __syncthreads();\n  const long long sd2 = stamp();\n"),
    ("      u[col] = s;\n    }\n  }\n  __syncthreads();\n",
     "      u[col] = s;\n    }\n  }\n  __syncthreads();\n  const long long sd3 = stamp();\n"),
    ("      out[(size_t)r * C + col] = refl ? (r ? x - tv * u[col] : T(0)) : x;\n    }\n  }\n}\n",
     "      out[(size_t)r * C + col] = refl ? (r ? x - tv * u[col] : T(0)) : x;\n    }\n  }\n"
     + depth_end((("sd0", "sd1"), ("sd1", "sd2"), ("sd2", "sd3"), ("sd3", "sdn")))),
]
DEPTH_FIRST_PHASES = ("staging the slot's rows", "warp 0's reflection", "u = vᵀA", "the write")
# This tree's design (two barriers): staging beside the reflection, u, the
# write; and warp 0's reflection and thread 32's staging from the start.
DEPTH_FLAT = [
    (DEPTH_START[0], DEPTH_START[1] + "  if (tid == 0) st_t0 = sd0;\n"),
    ("  copy_async_wait();\n  __syncthreads();\n",
     "  copy_async_wait();\n  if (tid == 32) " + ACC.format(5, "stamp() - sd0") + "\n"
     "  __syncthreads();\n  const long long sd1 = stamp();\n"
     "  if (tid == 32) " + ACC.format(6, "sd0 - st_t0") + "\n"),
    ("  const bool refl = hh.refl;\n",
     "  if (tid == 0) " + ACC.format(4, "stamp_after(hh.scal) - sd1") + "\n"
     "  const bool refl = hh.refl;\n"),
    ("      if (g < nA && l == 0) tab[depth_slot<VEC>(col, CV)].u = rows.at(0, q) + scal * s;\n"
     "    }\n  }\n",
     "      if (g < nA && l == 0) tab[depth_slot<VEC>(col, CV)].u = rows.at(0, q) + scal * s;\n"
     "    }\n  }\n  if (tid == 0) " + ACC.format(10, "stamp() - sd1") + "\n"),
    ("    if (!refl || !((e.code >> 10) & 127)) e.u = refl ? zval : T(0);\n  }\n",
     "    if (!refl || !((e.code >> 10) & 127)) e.u = refl ? zval : T(0);\n  }\n"
     "  if (tid == 0) " + ACC.format(11, "stamp() - sd1") + "\n"
     "  if (tid == 64) " + ACC.format(13, "stamp() - sd1") + "\n"),
    ("    cr[i] = rows.at(r, i - r * Q);\n  }\n  __syncthreads();\n",
     "    cr[i] = rows.at(r, i - r * Q);\n  }\n"
     "  if (tid == 0) " + ACC.format(12, "stamp() - sd1") + "\n"
     "  if (tid == 64) " + ACC.format(14, "stamp() - sd1") + "\n"
     "  __syncthreads();\n  const long long sd2 = stamp();\n"),
    ("    cb += dm, rb += dq;\n    if (cb >= C) cb -= C, ++rb;\n  }\n}\n",
     "    cb += dm, rb += dq;\n    if (cb >= C) cb -= C, ++rb;\n  }\n"
     + depth_end((("sd0", "sd1"), ("sd1", "sd2"), ("sd2", "sdn")))),
]
DEPTH_FLAT_PHASES = ("the copies and the column table (to the first barrier)",
                     "the reflection, u = vᵀA and the compact rows", "the write", None,
                     "the reflection in warp 0, after the first barrier",
                     "thread 32's copies landed, from the start",
                     "thread 32's start after thread 0's", None, None, None,
                     "thread 0 (a summing warp) after its sums, from the first barrier",
                     "thread 0 after the other columns' u", "thread 0 after its compact rows",
                     "thread 64 after the other columns' u", "thread 64 after its compact rows")


def depth_stamped(text):
    """(the source with marg_depth_kernel's stamps, its phases by slot, the
    design's name)."""
    design = "flat" if "depth_code(" in text else "first"
    edits, phases = ((DEPTH_FLAT, DEPTH_FLAT_PHASES) if design == "flat"
                     else (DEPTH_FIRST, DEPTH_FIRST_PHASES))
    text = text.replace("namespace {\n", STAMP_DEFS + GTIME + "\nnamespace {\n", 1)
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f"marg_stamps.py: the {design} depth kernel no longer has {anchor!r}")
        text = text.replace(anchor, new)
    return text + DEPTH_READ, phases, design


def stamped(text):
    """(the source with the stamps, its phases by stamp slot, the name of a
    stamped interval)."""
    design = "panel" if "panel_factor(R, X, P, n," in text else "step"
    edits, phases, per = ((PANEL_EDITS + PANEL_KERNEL, PANEL_PHASES, "panel")
                          if design == "panel" else
                          (STEP_EDITS + STEP_KERNEL, STEP_PHASES, "column step"))
    text = text.replace("namespace {\n", STAMP_DEFS + "\nnamespace {\n", 1)
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f"marg_stamps.py: the {design} kernel no longer has {anchor!r}")
        text = text.replace(anchor, new)
    if design == "step":
        text, n = STEP_FINAL[0].subn(lambda m: m.group(1) + STEP_FINAL[1], text)
        if n != 1:
            raise RuntimeError("marg_stamps.py: the kernel's final merge is not where it was")
    return text + READ, phases, per


def depth_main(argv):
    """``depth [MARG_QR_CU]``: marg_depth_kernel's stamps at (a) and (b)."""
    import numpy as np
    import torch

    import chip_smoke
    import turns
    from lfvio_tpu_torch.backend import marg_cuda as mc
    from lfvio_tpu_torch.frontend import klt_cuda

    if len(argv) > 1:
        print(f"usage: {sys.argv[0]} depth [MARG_QR_CU]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("marg_stamps.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.smi_line(), flush=True)
    path = argv[0] if argv else mc.__file__.replace("backend/marg_cuda.py", "csrc/marg_qr.cu")
    text, phases, design = depth_stamped(open(path).read())
    src = klt_cuda.BUILD_DIR / "marg_depth_stamped.cu"
    klt_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    so = turns.build_earlier_lib(src, "marg_qr", "depth_stamped")
    kernel = turns.bind_marg_depth(so)
    so.marg_stamps_read.argtypes, so.marg_stamps_read.restype = [ctypes.c_void_p], ctypes.c_int
    so.marg_stamps_zero.restype = ctypes.c_int
    block = chip_smoke.make_blocker(dev)
    for label, (depth_args, view) in chip_smoke.depth_inputs(dev).items():
        runs = []
        for _ in range(5):
            block()
            if so.marg_stamps_zero() != 0:
                raise RuntimeError("marg_stamps.py: zeroing the stamps failed")
            kernel(*depth_args, out=view)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            if so.marg_stamps_read(ctypes.addressof(buf)) != 0:
                raise RuntimeError("marg_stamps.py: reading the stamps failed")
            runs.append(np.asarray(list(buf), dtype=np.uint64).view(np.int64).astype(np.float64))
        med = np.median(np.stack(runs), axis=0)
        blocks = max(med[7], 1.0)
        n = 4 if design == "first" else 3
        total = sum(med[:n])
        print(f"{label} {design} design: {blocks:.0f} blocks, the launch's span "
              f"{(med[9] - med[8]) / 1e3:.3f} µs on the global timer (median of 5); SM cycles "
              "a block: " + "; ".join(
                  f"{name} {med[i] / blocks:.0f}" + (f" ({100 * med[i] / max(total, 1.0):.1f}%)"
                                                     if i < n else "")
                  for i, name in enumerate(phases) if name), flush=True)
    return 0


def main(argv):
    import numpy as np
    import torch

    import chip_smoke
    import turns
    from lfvio_tpu_torch.backend import marg_cuda as mc
    from lfvio_tpu_torch.frontend import klt_cuda

    if argv and argv[0] == "depth":
        return depth_main(argv[1:])
    if len(argv) > 1:
        print(f"usage: {sys.argv[0]} [MARG_QR_CU] | depth [MARG_QR_CU]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("marg_stamps.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.smi_line(), flush=True)
    path = argv[0] if argv else mc.__file__.replace("backend/marg_cuda.py", "csrc/marg_qr.cu")
    text, phases, per = stamped(open(path).read())
    src = klt_cuda.BUILD_DIR / "marg_qr_stamped.cu"
    klt_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    so = turns.build_earlier_lib(src, "marg_qr", "stamped")
    kernel = turns.bind_marg_qr(so)
    so.marg_stamps_read.argtypes, so.marg_stamps_read.restype = [ctypes.c_void_p], ctypes.c_int
    so.marg_stamps_zero.restype = ctypes.c_int
    block = chip_smoke.make_blocker(dev)
    for label, (A, head, _) in chip_smoke.marg_stacks(dev).items():
        runs = []
        for _ in range(5):
            block()
            if so.marg_stamps_zero() != 0:
                raise RuntimeError("marg_stamps.py: zeroing the stamps failed")
            kernel(A, head=head)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            if so.marg_stamps_read(ctypes.addressof(buf)) != 0:
                raise RuntimeError("marg_stamps.py: reading the stamps failed")
            runs.append(np.asarray(list(buf), dtype=np.float64))
        med = np.median(np.stack(runs), axis=0)
        total, count = med[7] + med[8], max(med[4], 1.0)
        share = lambda v: f"{100 * v / max(total, 1.0):.1f}%"
        print(f"{label} {tuple(A.shape)} head {head}: leaf 0's own rows {med[7]:.0f} SM cycles, "
              f"the final merge {med[8]:.0f}"
              + (f" (its block's start to its end, {med[14]:.0f} of it waiting for the rows it "
                 "reads)" if per == "panel" else "")
              + f" (median of 5), {count:.0f} {per}s in them; "
              + "; ".join(f"{name} {med[i]:.0f} ({share(med[i])}, {med[i] / count:.0f} a {per})"
                          for i, name in enumerate(phases) if name and i < 5)
              + ("" if per != "panel" else
                 f"; {phases[5]} {med[5]:.0f} ({share(med[5])}, {med[6]:.0f} tiles); a column "
                 f"step of a panel ({med[13]:.0f}): " + ", ".join(
                     f"{name} {med[9 + i] / max(med[13], 1.0):.0f}"
                     for i, name in enumerate(STEP_SPLIT)) + " cycles"),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
