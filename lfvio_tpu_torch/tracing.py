"""The port's ranges on the profiler's timeline.

``span(name, frame)`` opens the range ``vio::<name>`` around one step of the
frame loop while a ``torch.profiler`` profile is recording, and returns one
shared no-op context otherwise. The profiler is the switch and its Chrome
trace (``export_chrome_trace``) the export, so the spans lie on the clock of
the card's kernels and copies. A span's name starts with the layer whose
code runs inside it: ``pipe.`` (``runtime/pipeline.py``), ``fe.``
(``runtime/tracker.py``), ``est.`` (``runtime/estimator.py`` and its feature
manager) or ``prog.`` (``device.py``'s programs); a wait belongs to the
layer that waits. PERF.md §3 lists every span with the metric that reads
it.

A span carries the stream time of its frame as the argument ``frame`` (in
the trace's ``args`` when the profile records shapes); a span given no
frame takes the frame of the span around it. Parents are the spans around
a span on the one host thread that runs the frame loop.

``region(name)`` opens the kernel wrappers' and MARGIN_OLD's ranges
(``proj_factor::``, ``marg_old::``, ...) under their own names, on the same
condition.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "vio::"
_OFF = contextlib.nullcontext()
_FRAMES = [None]  # the frame of each open span, innermost last
_recording = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("_frame", "_range")

    def __init__(self, name, frame):
        self._frame = _FRAMES[-1] if frame is None else float(frame)
        args = {} if self._frame is None else {"frame": self._frame}
        # record_function's string argument never reaches the Chrome trace;
        # this range's keyword values do, and it costs a tenth as much.
        self._range = torch._C._profiler._RecordFunctionFast(PREFIX + name, [], args)

    def __enter__(self):
        _FRAMES.append(self._frame)
        self._range.__enter__()

    def __exit__(self, *exc):
        try:
            self._range.__exit__(*exc)
        finally:
            _FRAMES.pop()


def span(name, frame=None):
    """The range ``vio::<name>`` carrying ``frame`` while a profile is
    recording, else a shared no-op context."""
    if not _recording():
        return _OFF
    return _Span(name, frame)


def region(name):
    """``torch.profiler.record_function(name)`` while a profile is
    recording, else a shared no-op context."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)
