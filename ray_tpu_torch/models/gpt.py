"""The flagship decoder-only transformer, single device (counterpart of
ray_tpu/models/gpt.py with `mesh=None`).

Same parameter dictionary as the JAX package (keys, shapes, layouts and
init scales; block leaves stacked over layers with a leading L), same
arithmetic: bf16 compute on fp32 parameters, RMSNorm in fp32, tanh-GELU
FFN, fp32 logits from bf16 operands.  Causal attention goes through the
Hopper flash kernel (ops/flash_attention.py) for CUDA inputs whose shape
and dtype it takes, else through the dense `reference_attention`.

Only the inference forward is ported: the mesh (dp/fsdp/tp/pp/sp/ep),
MoE, remat and the loss/train step are later slices.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel.ring_attention import reference_attention


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 8
    d_ff: int = 2048
    max_seq: int = 2048
    n_experts: int = 0          # only 0 (dense ffn) is ported
    dtype: torch.dtype = torch.bfloat16
    # Flash kernel for causal attention on CUDA (shapes it takes).
    use_flash: bool = True
    # False = bidirectional attention (encoder models).
    causal: bool = True

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def _check_supported(cfg: GPTConfig, mesh=None) -> None:
    if mesh is not None:
        raise NotImplementedError("ray_tpu_torch's GPT runs on one device "
                                  "(mesh=None); the mesh is not ported yet")
    if cfg.n_experts:
        raise NotImplementedError("MoE (n_experts > 0) is not ported yet")


# ---------------------------------------------------------------------------
# Parameters


def init_params(cfg: GPTConfig, generator: torch.Generator,
                device=None) -> dict:
    """fp32 parameter dict; block leaves stacked over layers (leading L).
    Draws from `generator` (on its own device), then moves to `device`
    (CUDA unless the caller passes "cpu")."""
    _check_supported(cfg)
    device = resolve_device(device)
    L, D, H, Dh, Fh = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
                       cfg.d_ff)
    s = 0.02
    so = s / math.sqrt(2 * L)  # residual-output scaling (GPT-2 style)

    def nrm(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (scale * x).to(device)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    blocks = {
        "ln1": ones((L, D)),
        "wqkv": nrm((L, D, 3, H, Dh), s),
        "wo": nrm((L, H, Dh, D), so),
        "ln2": ones((L, D)),
        "w1": nrm((L, D, Fh), s),
        "w2": nrm((L, Fh, D), so),
    }
    return {
        "wte": nrm((cfg.vocab_size, D), s),
        "wpe": nrm((cfg.max_seq, D), s),
        "blocks": blocks,
        "ln_f": ones((D,)),
        "wlm": nrm((D, cfg.vocab_size), s),
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked block parameters."""
    return {k: w[i] for k, w in params["blocks"].items()}


# ---------------------------------------------------------------------------
# Block body


def _rmsnorm(x, scale):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _qkv(x, lp, cfg: GPTConfig):
    """x [B, t, D] -> q, k, v [B, t, H, Dh] (views of one fused product)."""
    b, t, d = x.shape
    w = lp["wqkv"].to(cfg.dtype).reshape(d, -1)
    qkv = (x @ w).view(b, t, 3, cfg.n_heads, cfg.head_dim)
    return qkv.unbind(2)


def _attn_out(out, lp, cfg: GPTConfig):
    """out [B, t, H, Dh] -> [B, t, D] through wo."""
    b, t, h, dh = out.shape
    return out.reshape(b, t, h * dh) @ lp["wo"].to(cfg.dtype).reshape(
        h * dh, -1)


def _attention(x, lp, cfg: GPTConfig):
    q, k, v = _qkv(x, lp, cfg)
    t = q.shape[1]
    scale = cfg.head_dim ** -0.5
    if (q.is_cuda and cfg.use_flash and cfg.causal
            and fa.supports(t, cfg.head_dim, q.dtype)):
        # [b,t,h,k] -> [b,h,t,k] views for the kernel, which writes its
        # output in [b,t,h,k] order, so the transpose back is free.
        out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), scale).transpose(1, 2)
    else:
        out = reference_attention(q, k, v, causal=cfg.causal, scale=scale)
    return _attn_out(out, lp, cfg)


def _dense_ffn(x, lp, cfg: GPTConfig):
    dt = cfg.dtype
    h = F.gelu(x @ lp["w1"].to(dt), approximate="tanh")  # = jax.nn.gelu
    return h @ lp["w2"].to(dt)


def _lm_head(x, wlm, cfg: GPTConfig):
    """Logits in fp32 from cfg.dtype operands with fp32 accumulation."""
    a = x.to(cfg.dtype).reshape(-1, x.shape[-1])
    w = wlm.to(cfg.dtype)
    if a.is_cuda and a.dtype != torch.float32:
        logits = torch.mm(a, w, out_dtype=torch.float32)
    else:
        # Products of two bf16 values are exact in fp32, so this is the
        # same sum as the fused bf16 product with fp32 accumulation.
        logits = a.float() @ w.float()
    return logits.reshape(*x.shape[:-1], -1)


# ---------------------------------------------------------------------------
# Forward


def hidden_states(params: dict, tokens, cfg: GPTConfig, mesh=None):
    """tokens: [B, T] int -> final-norm hidden states [B, T, d]."""
    _check_supported(cfg, mesh)
    tokens = torch.as_tensor(tokens, device=params["wte"].device)
    t = tokens.shape[1]
    x = (params["wte"][tokens] + params["wpe"][:t]).to(cfg.dtype)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        x = x + _attention(_rmsnorm(x, lp["ln1"]), lp, cfg)
        x = x + _dense_ffn(_rmsnorm(x, lp["ln2"]), lp, cfg)
    return _rmsnorm(x, params["ln_f"])


def forward(params: dict, tokens, cfg: GPTConfig, mesh=None):
    """tokens: [B, T] int -> logits [B, T, vocab] (fp32)."""
    return _lm_head(hidden_states(params, tokens, cfg, mesh), params["wlm"],
                    cfg)
