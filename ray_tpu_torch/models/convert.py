"""Parameters from the JAX package's layout to the port's."""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device


def gpt_params_from_numpy(tree, device=None) -> dict:
    """The JAX package's GPT parameter pytree, given as (nested dicts of)
    numpy arrays -> the port's parameter dict on `device` (CUDA unless the
    caller passes "cpu").  Keys, shapes, layouts and dtypes are kept as
    they are: the two packages share one layout."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x)).to(device)

    return conv(tree)
