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


def free_bytes(dev):
    """Device bytes a call may allocate on `dev`: the CUDA runtime's free
    memory and what the caching allocator holds unused, less a tenth."""
    free, _ = torch.cuda.mem_get_info(dev)
    held = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(0.9 * (free + held))
