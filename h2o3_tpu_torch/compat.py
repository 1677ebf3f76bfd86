"""Device selection for the port (counterpart of h2o3_tpu/compat.py).

The port runs on one CUDA device. The CPU is used only when the caller
asks for it (``device="cpu"``), which is how the tests run the plain
PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def torch_export():
    """The ``torch.export`` module, imported on first use: its save/load
    format and passes are version-mobile, so the port reaches it only
    here (the invariant analyzer's compat-routing pass)."""
    import torch.export

    return torch.export


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device.
    Raises RuntimeError when CUDA is asked for (or defaulted to) and there
    is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "h2o3_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"h2o3_tpu_torch runs on cuda or cpu, not {dev}")
    return dev
