"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Where CUDA
is absent the call raises; it never moves to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"``/``"cpu"``/``torch.device`` → ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for (the default)
    and this process has none, naming ``device="cpu"`` as the way to run
    the plain PyTorch versions instead.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available in this process; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
