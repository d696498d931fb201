"""Device selection for the port's entry points."""

import torch


def resolve_device(device=None):
    """`device` as a torch.device. None means the CUDA card, and raises
    when CUDA is absent: entry points run on the card unless the caller
    asks for the CPU (device="cpu")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (device,))
    return dev
