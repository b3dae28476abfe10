"""Where the port's entry points put their tensors, how results come back
to the host (``Fetch``), how a function of tensors runs as one CUDA graph
(``DeviceProgram``), and how a block of it runs only when a device
predicate holds (``cond``, a CUDA-graph conditional node under a capture)."""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import time
import weakref

import torch

from .tracing import span


def resolve_device(device=None) -> torch.device:
    """The device an entry point (``FrontEnd``, ``Estimator``,
    ``SyntheticWorld``) runs on: the current CUDA card unless the caller
    names a device. Without a card ``None`` raises; the CPU is used only
    when asked for by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


class Fetch:
    """Device→host copies started now and waited for later.

    On a CUDA device each tensor is copied with ``non_blocking=True`` into a
    pinned host buffer and one event is recorded behind the copies on the
    current stream; :meth:`numpy` waits on that event only (never on the
    whole device). CPU tensors are kept as they are. ``None`` entries pass
    through."""

    def __init__(self, tensors):
        self.event = None
        self._host = []
        on_card = False
        for x in tensors:
            if x is not None and x.is_cuda:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                x, on_card = buf, True
            self._host.append(x)
        if on_card:
            self.event = torch.cuda.Event()
            self.event.record()

    def numpy(self):
        """The fetched values as numpy arrays, once the copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return [None if x is None else x.numpy() for x in self._host]


# Kernel wrappers whose ``launches`` counts a DeviceProgram keeps true: a
# launch recorded in a graph is counted at each replay, not at the capture.
KERNELS = []


def register_kernel(wrapper):
    """Add a kernel wrapper (an object with a ``launches`` count) to the ones
    DeviceProgram counts at replay; returns it."""
    KERNELS.append(wrapper)
    return wrapper


# The programs whose graphs hold conditional bodies (their launches are
# counted by collect_launches), the captures under way ((memory pool,
# program or None), innermost last), and the predicates of the masked
# blocks the code runs inside.
_PROGRAMS = weakref.WeakSet()
_CAPTURES = []
_MASKS = []
_HOST_PREDICATES = [False]
# torch's calls that route this thread's allocations to a memory pool and
# end that: a conditional body's, captured on a stream of its own.
POOL_ROUTING = ("_cuda_beginAllocateCurrentThreadToPool", "_cuda_endAllocateToPool")
# Each IF node captured (its handle) -> its body graph, for the census of a
# graph's nodes (CUDA 12.8 offers no call that reads a conditional node's
# body back).
IF_BODIES = {}
_BODY_STREAMS = {}  # (device index, nesting depth) -> the stream bodies are captured on
# (capture's pool, nesting depth) -> the pool of the bodies captured there.
# torch routes one capture to a pool at a time, so a body's allocations go
# to a pool of their own, shared by the graphs that share the capture's
# pool (they replay one at a time) and never released: a graph's bodies use
# that memory at every replay.
_BODY_POOLS = {}
_OPEN_BODIES = []  # the IF bodies being captured, innermost last
MAX_BODIES = 256  # the conditional blocks a DeviceProgram counts the runs of
_cond_fns = None


@contextlib.contextmanager
def capture(graph, pool=None, program=None):
    """``torch.cuda.graph(graph, pool=pool)`` with what ``cond`` needs to
    capture IF nodes: the capture's memory pool (a new one where ``pool``
    is None: torch cannot tell a graph's pool before its capture ends) and
    the DeviceProgram it belongs to (None: no launch accounting)."""
    if pool is None:
        pool = torch.cuda.graph_pool_handle()
    _CAPTURES.append((pool, program))
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        _CAPTURES.pop()


def collect_launches():
    """Add the launches that the captured conditional bodies executed since
    the last call to their wrappers' ``launches``: one read of each
    program's body counters from the card (it waits for the card). Call it
    where a count is read or reset, never per frame: a body runs 0 or 1
    times a replay, which only the card knows."""
    for prog in list(_PROGRAMS):
        prog._collect_bodies()


@contextlib.contextmanager
def host_predicates():
    """Outside a capture, run each ``cond`` block as an ``if`` on the host
    (``bool(pred)``: a read of the device) instead of masked: the form the
    CPU tests hold the masked form and the JAX package against."""
    _HOST_PREDICATES.append(True)
    try:
        yield
    finally:
        _HOST_PREDICATES.pop()


def cond(pred, body, carries, counters=()):
    """``body()`` where the device bool ``pred`` holds, as ``lax.cond`` runs
    a branch: ``body`` returns new values for ``carries`` (a structure of
    tensors made before the block; the same structure), which are written
    into them in place; each tensor of ``counters`` (int64 scalars) gains
    one where the body ran. Three forms:

      * under a CUDA-graph capture (started by ``capture``), an IF node on
        ``pred`` (``csrc/graph_cond.cu``): the body is captured into the
        node's graph, so a replay runs its launches only where ``pred``
        holds; a DeviceProgram's capture gives each body a counter of its
        runs, to which it attributes the body's launches
        (``collect_launches``). Where conditional nodes cannot be had the
        capture raises;
      * otherwise (the CPU, the card run op by op, a DeviceProgram's
        warm-up) masked: the body runs and its writes are selected with
        ``torch.where(pred, new, old)`` (nested blocks with the predicates
        of those around them too), so nothing is read back;
      * inside ``host_predicates()``: ``if bool(pred)``.

    A tensor the body makes lives only for the body: what a later block
    reads must be a carry."""
    carries = _leaves(carries, [])
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        _if_node(pred, body, carries, counters)
        return
    if _HOST_PREDICATES[-1]:
        if bool(pred):
            _write(carries, body(), counters)
        return
    if _MASKS:
        pred = _MASKS[-1] & pred
    _MASKS.append(pred)
    try:
        new = body()
    finally:
        _MASKS.pop()
    for c, x in zip(carries, _leaves(new, []), strict=True):
        c.copy_(torch.where(pred, x, c))
    for k in counters:
        k.add_(pred)


def _write(carries, new, counters):
    """The body's results into the carries and one more run on the counters:
    one multi-tensor launch a dtype (a graph node each, not one a tensor)."""
    groups = {}
    for c, x in zip(carries, _leaves(new, []), strict=True):
        dst, src = groups.setdefault(c.dtype, ([], []))
        dst.append(c)
        src.append(x)
    for dst, src in groups.values():
        torch._foreach_copy_(dst, src)
    if counters:
        torch._foreach_add_(list(counters), 1)


def _cond_library():
    """``csrc/graph_cond.cu``'s cond_begin / cond_end, built at first use,
    and torch's pool routing calls (begin, end); raises where torch cannot
    route a body's allocations to a pool."""
    global _cond_fns
    missing = [n for n in POOL_ROUTING if not hasattr(torch._C, n)]
    if missing:
        raise RuntimeError(f"no CUDA-graph conditional nodes: torch {torch.__version__} lacks "
                           f"{', '.join(missing)}, which a body's allocations need")
    if _cond_fns is None:
        from .frontend.klt_cuda import library

        lib = library("graph_cond")
        P, U = ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)
        lib.cond_begin.argtypes, lib.cond_begin.restype = [P, P, P, U, U], ctypes.c_int
        lib.cond_end.argtypes, lib.cond_end.restype = [P], ctypes.c_int
        _cond_fns = lib.cond_begin, lib.cond_end
    return (*_cond_fns, *(getattr(torch._C, n) for n in POOL_ROUTING))


def _if_node(pred, body, carries, counters):
    """``cond``'s form under a capture: an IF node on ``pred`` whose body is
    captured on a stream of its own (one for each nesting depth), that
    thread's allocations in a pool kept for such bodies (``_BODY_POOLS``)."""
    if not _CAPTURES:
        raise RuntimeError("cond: a capture that device.capture did not start cannot hold "
                           "conditional nodes")
    pool, prog = _CAPTURES[-1]
    begin, end, to_pool, end_pool = _cond_library()
    dev = pred.device
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"cond: the predicate must be one bool, got {pred.dtype} "
                         f"{tuple(pred.shape)}")
    if prog is not None:
        slot = len(prog._bodies)
        if slot == MAX_BODIES:
            raise RuntimeError(f"DeviceProgram {prog.name}: more than {MAX_BODIES} conditional "
                               f"blocks")
        prog._bodies.append([])
        counters = (*counters, prog._body_runs[slot])
    key = (dev.index, len(_OPEN_BODIES))
    if key not in _BODY_STREAMS:
        _BODY_STREAMS[key] = torch.cuda.Stream(dev)
    stream = _BODY_STREAMS[key]
    if (pool, key) not in _BODY_POOLS:
        _BODY_POOLS[pool, key] = torch.cuda.graph_pool_handle()
    body_pool = _BODY_POOLS[pool, key]
    node, body_graph = ctypes.c_ulonglong(0), ctypes.c_ulonglong(0)
    err = begin(torch.cuda.current_stream(dev).cuda_stream, stream.cuda_stream,
                pred.data_ptr(), ctypes.byref(node), ctypes.byref(body_graph))
    if err != 0:
        raise RuntimeError(f"cond: a conditional node could not be captured: cudaError {err}")
    IF_BODIES[node.value] = body_graph.value
    before = [k.launches for k in KERNELS]
    _OPEN_BODIES.append(key)
    ok = False
    try:
        with torch.cuda.stream(stream):
            to_pool(dev.index, body_pool)
            try:
                _write(carries, body(), counters)
            finally:
                end_pool(dev.index, body_pool)
        ok = True
    finally:
        _OPEN_BODIES.pop()
        err = end(stream.cuda_stream)
    if ok and err != 0:
        raise RuntimeError(f"cond: a conditional body's capture failed: cudaError {err}")
    if prog is not None:
        # The body's launches run where it runs: counted from its counter.
        inside = [(k, k.launches - b) for k, b in zip(KERNELS, before) if k.launches != b]
        for k, n in inside:
            k.launches -= n
        prog._bodies[slot] = inside


def _leaves(x, out):
    """The tensors of a structure of tensors, tuples, lists, dicts,
    dataclasses and None, in a fixed order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _leaves(x[k], out)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _leaves(getattr(x, f.name), out)
    elif x is not None:
        raise TypeError(f"DeviceProgram: unsupported argument leaf {type(x).__name__}")
    return out


def clone_tree(x):
    """A copy of a structure of tensors with every tensor cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(y) for y in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: clone_tree(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


class DeviceProgram:
    """A function of tensors run as one CUDA graph on the card: the port's
    counterpart of ``jax.jit``.

    On the first call with CUDA tensors the arguments are cloned into static
    input buffers, the function runs once on a side stream (a warm-up, which
    builds the kernels' libraries and the cached index tensors its code
    needs) and is then captured into a ``torch.cuda.CUDAGraph`` in ``pool``
    (one pool may serve several programs: their captures then reuse one
    another's freed memory). Later calls copy their arguments into the static
    inputs (device to device; an argument that is the static input itself is
    not copied) and replay the graph; each returns the same static output
    tensors, which the next replay of any program sharing the pool may
    overwrite: read or copy what must survive before that. A capture that
    fails raises; there is no eager fallback on the card. The capture is
    set-up, not steady state: it runs with the sync debug mode off. The
    kernel launches a capture records are added to their wrappers' counts
    (``register_kernel``) at every replay; those inside a ``cond`` body each
    time the body runs, read from the card by ``collect_launches``.

    ``warmup_result``: the first call returns the warm-up's outputs and does
    not replay the graph it has just captured, so its work runs once, as a
    later call's does (each kernel launch of that call is counted once);
    the outputs are fresh tensors, not the static ones.

    On the CPU the function is called as it is, op for op.

    Under a recording profile a call opens the spans
    ``prog.<name>.capture`` (the first call's set-up), ``.copy_in`` (the
    arguments into the static inputs), ``.replay`` (the launch and its
    accounting) and, on the CPU, ``.eager``."""

    def __init__(self, fn, pool=None, name=None, warmup_result=False):
        self.fn = fn
        self.pool = pool
        self.name = name or getattr(fn, "__name__", "program")
        self.warmup_result = warmup_result
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.capture_s = 0.0  # the first call's set-up: cloning, warm-up and capture
        self.warmup_s = 0.0  # its part up to the warm-up's end
        self.replays = 0
        self._launches = []
        self._bodies = []  # each conditional body's [(wrapper, launches)]
        self._body_runs = None  # their runs on the card, a count a body
        self._spans = {k: f"prog.{self.name}.{k}" for k in ("capture", "copy_in", "replay",
                                                            "eager")}

    def __call__(self, *args):
        leaves = _leaves(args, [])
        if not leaves or not leaves[0].is_cuda:
            with span(self._spans["eager"]):
                return self.fn(*args)
        if self.graph is None:
            with span(self._spans["capture"]):
                out = self._capture(args)
            if self.warmup_result:
                return out
        else:
            with span(self._spans["copy_in"]):
                for dst, src in zip(self._in_leaves, leaves):
                    if src.data_ptr() != dst.data_ptr():
                        dst.copy_(src)
        with span(self._spans["replay"]):
            self.graph.replay()
            self.replays += 1
            for k, n in self._launches:
                k.launches += n
        return self.static_out

    def _capture(self, args):
        t0 = time.perf_counter()
        self.static_in = clone_tree(args)
        self._in_leaves = _leaves(self.static_in, [])
        side, current = torch.cuda.Stream(), torch.cuda.current_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = self.fn(*self.static_in)
        current.wait_stream(side)
        if self.warmup_result:  # made on the side stream, used on this one
            for x in _leaves(warm, []):
                x.record_stream(current)
        graph = torch.cuda.CUDAGraph()
        before = [k.launches for k in KERNELS]
        debug = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        # No garbage collection inside the capture: a collected cycle that
        # held another program's graph would destroy that graph mid-capture,
        # a call the capture forbids, and the capture fails (torch's graph
        # context collects nothing first unless asked to).
        gc_on = gc.isenabled()
        gc.disable()
        try:
            side.synchronize()  # the warm-up's end (the capture synchronizes anyway)
            self.warmup_s = time.perf_counter() - t0
            self._body_runs = torch.zeros(MAX_BODIES, dtype=torch.int64,
                                          device=self._in_leaves[0].device)
            with capture(graph, pool=self.pool, program=self):
                self.static_out = self.fn(*self.static_in)
        except Exception as e:
            raise RuntimeError(f"DeviceProgram {self.name}: the CUDA graph capture "
                               f"failed: {e}") from e
        finally:
            if gc_on:
                gc.enable()
            torch.cuda.set_sync_debug_mode(debug)
        if self._bodies:
            _PROGRAMS.add(self)
        # The capture's launches run at the replays: count them there.
        self._launches = [(k, k.launches - b) for k, b in zip(KERNELS, before)
                          if k.launches != b]
        for k, n in self._launches:
            k.launches -= n
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return warm

    def _collect_bodies(self):
        """collect_launches for this program's bodies."""
        counts = self._body_runs.tolist()
        self._body_runs.zero_()
        for n, inside in zip(counts, self._bodies):
            for k, per_run in inside:
                k.launches += n * per_run
