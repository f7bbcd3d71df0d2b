"""Parameters and optimizer state from the JAX package's layout to the
port's."""

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


def adamw_state_from_numpy(count, mu, nu, params: dict,
                           optimizer: torch.optim.Optimizer) -> None:
    """Load optax's Adam state (`ScaleByAdamState`: the step count and the
    first and second moments, given as numpy trees shaped like the params)
    into a torch AdamW over `params`' leaves, in place: `step`, `exp_avg`
    and `exp_avg_sq` of each parameter.  A JAX run can then go on in the
    port from the same point of its trajectory."""
    def walk(p, m, v):
        if isinstance(p, dict):
            if not (set(p) == set(m) == set(v)):
                raise ValueError(f"moment trees do not match the params: "
                                 f"{sorted(p)} vs {sorted(m)}, {sorted(v)}")
            for k in p:
                walk(p[k], m[k], v[k])
            return
        m, v = np.array(m), np.array(v)
        if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
            raise ValueError(f"moment shapes {m.shape}, {v.shape} do not "
                             f"match a parameter of shape {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(m).to(p),
            "exp_avg_sq": torch.from_numpy(v).to(p)}

    walk(params, mu, nu)
