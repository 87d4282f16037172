"""The device rule of the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device="cuda"`` (the default) raises when CUDA is absent instead of
quietly running somewhere else.  Below the entry points, each op runs on the
device of the tensors it is given: a CUDA tensor goes to the op's CUDA
kernel (or the call raises), a CPU tensor to the op's plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises unless it is the CPU or an
    available CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def cuda_launch_args(t: torch.Tensor) -> tuple[int, int]:
    """(device index, raw stream handle) for launching a kernel on ``t``'s
    device, on PyTorch's current stream there."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


def count_args(count, limit: int, device) -> tuple:
    """A valid-row count for a kernel, which clamps it to [0, limit]:
    (tensor to keep alive or None, device pointer or None, host value).  A
    tensor stays on the device and travels by pointer (no host sync); an
    int travels by value."""
    if isinstance(count, torch.Tensor):
        c = count.to(device=device, dtype=torch.int32).reshape(1)
        return c, c.data_ptr(), 0
    return None, None, max(0, min(int(count), limit))


def to_host(tensors: list) -> list:
    """Bring tensors to the host as numpy arrays behind ONE wait: every
    copy from the card is queued before the stream is synchronised.  CPU
    tensors come back as views, with no copy."""
    cuda = [t for t in tensors if t.is_cuda]
    if not cuda:
        return [t.numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(cuda[0].device).synchronize()
    return [h.numpy() for h in host]
