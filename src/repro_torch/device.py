"""Device resolution for the port's entry points, and the divisor form
that the card divides by."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for and missing.

    The entry points default to ``"cuda"`` and never carry on silently
    on the CPU: a CPU run is asked for with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


def scalar_like(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c`` as a 0-dim float32 tensor on ``t``'s device.

    Dividing by it divides on the card as on the CPU, as the reference
    divides: PyTorch multiplies a CUDA tensor by the float32 reciprocal
    of a Python-number divisor, which misses the quotient by an ulp for
    a few percent of dividends (and ``number / tensor`` is a reciprocal
    times the number on every device)."""
    return torch.full((), c, dtype=torch.float32, device=t.device)
