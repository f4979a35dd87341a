"""ray_tpu_torch: the compute side of ray_tpu in PyTorch, for NVIDIA Hopper.

The package mirrors ``ray_tpu``'s layout (``ops/``, ``models/``,
``serve/engine/``) and keeps its parameter names and layouts, so weights
convert one to one.  Every TPU kernel that ``ray_tpu`` wrote in Pallas is a
CUDA kernel here, written by hand for ``sm_90a`` (sources in ``csrc/``,
built with nvcc at first use and loaded through ctypes).

Entry points run on the card unless the caller passes ``device="cpu"``:
with no card and no explicit CPU request they raise.  On the CPU each
kernel's wrapper runs its plain PyTorch version, which follows the same
blockwise recurrence as the kernel.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the first CUDA card and raises when there is none: the
    port never carries on quietly on the CPU.  ``"cpu"`` (or any explicit
    device) is taken as given, after checking that a CUDA device exists.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the "
                "CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
