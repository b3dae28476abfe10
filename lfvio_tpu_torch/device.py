"""Where the port's entry points put their tensors."""

from __future__ import annotations

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
