"""Where the port's entry points put their tensors, how results come back
to the host (``Fetch``), and how a function of tensors runs as one CUDA
graph (``DeviceProgram``)."""

from __future__ import annotations

import dataclasses
import gc
import time

import torch


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
    (``register_kernel``) at every replay.

    ``warmup_result``: the first call returns the warm-up's outputs and does
    not replay the graph it has just captured, so its work runs once, as a
    later call's does (each kernel launch of that call is counted once);
    the outputs are fresh tensors, not the static ones.

    On the CPU the function is called as it is, op for op."""

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

    def __call__(self, *args):
        leaves = _leaves(args, [])
        if not leaves or not leaves[0].is_cuda:
            return self.fn(*args)
        if self.graph is None:
            out = self._capture(args)
            if self.warmup_result:
                return out
        else:
            for dst, src in zip(self._in_leaves, leaves):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
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
            with torch.cuda.graph(graph, pool=self.pool):
                self.static_out = self.fn(*self.static_in)
        except Exception as e:
            raise RuntimeError(f"DeviceProgram {self.name}: the CUDA graph capture "
                               f"failed: {e}") from e
        finally:
            if gc_on:
                gc.enable()
            torch.cuda.set_sync_debug_mode(debug)
        # The capture's launches run at the replays: count them there.
        self._launches = [(k, k.launches - b) for k, b in zip(KERNELS, before)
                          if k.launches != b]
        for k, n in self._launches:
            k.launches -= n
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return warm
