"""Dense attention oracle (counterpart of the single-device
`reference_attention` in ray_tpu/parallel/ring_attention.py; the ring
itself is not ported yet)."""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def reference_attention(q, k, v, causal: bool = True, scale=None):
    """Dense single-device attention.  q, k, v: [B, T, H, D] (the JAX
    package's layout); scores and softmax in the input dtype, masked
    entries set to -1e30 as the reference does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).to(q.dtype)
