"""Device choice for the port (counterpart of ray_tpu/_private/jax_utils.py).

Entry points run on CUDA unless the caller asks for the CPU; with no CUDA
and no explicit CPU request they raise instead of running on the CPU.

Importing this module turns TF32 off for float32 matrix products and
convolutions (`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`): the port's float32 paths are
compared with the JAX package at float32 precision, and TF32 keeps only
about three decimal digits.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means the current CUDA device; `"cpu"` (or any torch device)
    is taken as given.  Raises when CUDA is asked for, explicitly or by
    default, and there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ray_tpu_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
