"""Device resolution for every entry point of the port.

``"cuda"`` is the default everywhere: the port exists to run on the card, so
a missing card is an error, never a silent move to the CPU. ``"cpu"`` runs
the plain PyTorch versions of the kernels and must be asked for explicitly
(the CPU tests do).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (default, any ``cuda:i``) or ``"cpu"`` as a ``torch.device``.

    Raises ``RuntimeError`` when CUDA is requested and
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for any other
    device type.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")
