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
