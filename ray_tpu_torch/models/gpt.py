"""The flagship decoder-only transformer, single device (counterpart of
ray_tpu/models/gpt.py with `mesh=None`).

Same parameter dictionary as the JAX package (keys, shapes, layouts and
init scales; block leaves stacked over layers with a leading L), same
arithmetic: bf16 compute on fp32 parameters, RMSNorm in fp32, tanh-GELU
FFN, fp32 logits from bf16 operands.  Causal attention goes through the
Hopper flash kernels (ops/flash_attention.py: forward, and dq and dk/dv in
the backward) for CUDA inputs whose shape and dtype they take, else
through the dense `reference_attention`.

Training: `loss_fn` (next-token cross entropy, optionally a token-chunk
at a time), remat through `torch.utils.checkpoint`, and `make_train_state`
/ `train_step` / `make_train_step` with AdamW at optax's defaults.  Unlike
the JAX package, a step updates the parameters and the optimizer state in
place.

Not ported yet (they raise NotImplementedError): the mesh
(dp/fsdp/tp/pp/sp/ep), MoE, and `remat_save_attn`.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    # The reference's MoE expert capacity (read only with n_experts > 0)
    # and pipeline microbatches (read only under pipeline parallelism,
    # pp > 1).  The single-device path reads neither, as the reference
    # ignores both at pp = 1 without experts.
    capacity_factor: float = 2.0
    num_microbatches: int = 1
    dtype: torch.dtype = torch.bfloat16
    # Recompute activations in the backward (torch.utils.checkpoint).
    # "full": checkpoint the whole layer; the backward re-runs the layer's
    # forward, the flash forward kernel included.  "ffn": checkpoint the ffn
    # branch and the pre-attention norm and store the attention's residuals
    # (q, k, v, out, lse), so the flash forward runs once.
    remat: bool = True
    remat_mode: str = "full"
    # Pin the attention output across a "full" checkpoint: not ported yet.
    remat_save_attn: bool = False
    # Flash kernels for causal attention on CUDA (shapes they take).
    use_flash: bool = True
    # Blockwise LM-head loss: the [chunk, vocab] logits and their cross
    # entropy a token-chunk at a time, checkpointed, instead of the full
    # [B*T, vocab] f32 logits.  0 = off.
    loss_chunk: int = 0
    # False = bidirectional attention (encoder models).
    causal: bool = True

    def __post_init__(self):
        if self.remat_mode not in ("full", "ffn"):
            raise ValueError(f"remat_mode must be 'full' or 'ffn', "
                             f"got {self.remat_mode!r}")

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
    if cfg.remat_save_attn:
        raise NotImplementedError(
            "remat_save_attn (pinning the attention output across the layer "
            "checkpoint) is not ported yet")


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


def layer_slices(params: dict) -> list:
    """Each layer's slice of the stacked block parameters, taken once per
    call: one `unbind` per stacked [L, ...] leaf, whose backward is one
    `stack`, so each layer's gradient slice is written once (as the
    reference's scan over the stacked leaves does).  Indexing w[i] per
    layer would build and add a zero tensor the size of the whole leaf
    in each layer's backward."""
    blocks = params["blocks"]
    per_leaf = {k: w.unbind(0) for k, w in blocks.items()}
    return [dict(zip(per_leaf, ws)) for ws in zip(*per_leaf.values())]


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


def _uses_kernel(x, cfg: GPTConfig) -> bool:
    """Whether attention over x [B, t, D] runs the flash kernels."""
    return (x.is_cuda and cfg.use_flash and cfg.causal
            and fa.supports(x.shape[1], cfg.head_dim, x.dtype))


def _attention(x, lp, cfg: GPTConfig):
    q, k, v = _qkv(x, lp, cfg)
    scale = cfg.head_dim ** -0.5
    if _uses_kernel(x, cfg):
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


def _mm_f32(a, b):
    """a @ b with fp32 accumulation and an fp32 result.  bf16 CUDA operands
    stay bf16 (the fast tensor-core product); elsewhere the operands are
    upcast, which for bf16 gives the same sum, since products of two bf16
    values are exact in fp32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LMHead(torch.autograd.Function):
    """fp32 logits from operands in cfg.dtype, with a backward.

    The backward matches what the JAX package's transpose of its
    `preferred_element_type=f32` product computes: the fp32 cotangent g is
    rounded to the operands' dtype, dx = g w^T and dw = x^T g accumulate in
    fp32, and each is cast back to its operand's dtype.  For bf16 that is
    bf16 operands with fp32 accumulation; for fp32 operands it is the plain
    fp32 product, the same as autograd through `a.float() @ w.float()`.
    (torch's own `mm(out_dtype=float32)` has no derivative.)"""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _mm_f32(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return (_mm_f32(g, w.t()).to(a.dtype),
                _mm_f32(a.t(), g).to(w.dtype))


def _lm_head(x, wlm, cfg: GPTConfig):
    """Logits in fp32 from cfg.dtype operands with fp32 accumulation."""
    a = x.to(cfg.dtype).reshape(-1, x.shape[-1])
    logits = _LMHead.apply(a, wlm.to(cfg.dtype))
    return logits.reshape(*x.shape[:-1], -1)


def _checkpointed(fn):
    """fn under non-reentrant activation checkpointing (its saved tensors
    are recomputed in the backward).  The layers draw no random numbers,
    so no RNG state is stashed."""
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def _make_layer_fn(cfg: GPTConfig):
    """One transformer layer x -> x, with the JAX package's remat
    structure (gpt.py `_make_layer_fn`)."""

    def ffn_branch(x, lp):
        return x + _dense_ffn(_rmsnorm(x, lp["ln2"]), lp, cfg)

    if cfg.remat and cfg.remat_mode == "ffn":
        ffn_ckpt = _checkpointed(ffn_branch)
        norm_ckpt = _checkpointed(_rmsnorm)

        def attn_branch(x, lp):
            return x + _attention(norm_ckpt(x, lp["ln1"]), lp, cfg)

        attn_ckpt = _checkpointed(attn_branch)

        def layer(x, lp):
            # With the kernels, attention's residuals are O(B*T*D) and are
            # stored; the dense attention would store O(T^2) probabilities,
            # so it is checkpointed too.
            attn = attn_branch if _uses_kernel(x, cfg) else attn_ckpt
            return ffn_ckpt(attn(x, lp), lp)
        return layer

    def layer(x, lp):
        x = x + _attention(_rmsnorm(x, lp["ln1"]), lp, cfg)
        return ffn_branch(x, lp)
    return _checkpointed(layer) if cfg.remat else layer


# ---------------------------------------------------------------------------
# Forward


def hidden_states(params: dict, tokens, cfg: GPTConfig, mesh=None):
    """tokens: [B, T] int -> final-norm hidden states [B, T, d]."""
    _check_supported(cfg, mesh)
    tokens = torch.as_tensor(tokens, device=params["wte"].device)
    t = tokens.shape[1]
    x = (params["wte"][tokens] + params["wpe"][:t]).to(cfg.dtype)
    layer = _make_layer_fn(cfg)
    for lp in layer_slices(params):
        x = layer(x, lp)
    return _rmsnorm(x, params["ln_f"])


def forward(params: dict, tokens, cfg: GPTConfig, mesh=None):
    """tokens: [B, T] int -> logits [B, T, vocab] (fp32)."""
    return _lm_head(hidden_states(params, tokens, cfg, mesh), params["wlm"],
                    cfg)


# ---------------------------------------------------------------------------
# Loss / train step


def _cross_entropy(logits, targets):
    """Per-token softmax cross entropy with integer labels, in fp32:
    logsumexp(logits) - logits[target]."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="none")


def _chunk_ce(xc, tc, wlm, cfg):
    return _cross_entropy(_lm_head(xc, wlm, cfg), tc)


def loss_fn(params, tokens, cfg: GPTConfig, mesh=None):
    """Next-token cross entropy (mean over B*T tokens); tokens [B, T+1]."""
    _check_supported(cfg, mesh)
    tokens = torch.as_tensor(tokens, device=params["wte"].device).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    B, T = inputs.shape
    chunk = cfg.loss_chunk
    if chunk and (B * T) % chunk != 0:
        # As the reference: round down to the largest divisor <= chunk
        # rather than fall back to the full logits.
        chunk = next(c for c in range(min(chunk, B * T), 0, -1)
                     if (B * T) % c == 0)
    if chunk:
        # One chunk's [chunk, vocab] logits live at a time; the checkpoint
        # recomputes them in the backward.
        x = hidden_states(params, inputs, cfg, mesh)
        xf = x.reshape(B * T, -1).to(cfg.dtype)
        wlm = params["wlm"].to(cfg.dtype)
        ce = _checkpointed(_chunk_ce)
        losses = [ce(xc, tc, wlm, cfg) for xc, tc in
                  zip(xf.split(chunk), targets.reshape(B * T).split(chunk))]
        return torch.cat(losses).mean()
    return _cross_entropy(forward(params, inputs, cfg, mesh), targets).mean()


def _named_leaves(tree, prefix: str = "") -> list:
    """(dotted name, tensor) of each leaf of a nested parameter dict, in
    key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _named_leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _leaves(tree) -> list:
    """The tensors of a nested parameter dict, in key order."""
    return [t for _, t in _named_leaves(tree)]


def _adamw(params, learning_rate: float = 3e-4) -> torch.optim.AdamW:
    """AdamW at optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8, weight
    decay 1e-4 on every leaf, norms and embeddings included; torch's own
    default decay is 1e-2)."""
    return torch.optim.AdamW(_leaves(params), lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_state(cfg: GPTConfig, generator: torch.Generator,
                     device=None, optimizer=None,
                     learning_rate: float = 3e-4):
    """Init params (leaf tensors that require grad) and the optimizer ->
    (state, optimizer).

    `optimizer` is a function from the parameter dict to a
    torch.optim.Optimizer over its leaves (default: AdamW at optax.adamw's
    defaults and `learning_rate`).  state = {"params", "opt_state", "step"}, where
    "opt_state" is the optimizer's per-parameter state, which its `step`
    updates in place."""
    params = init_params(cfg, generator, device)
    for p in _leaves(params):
        p.requires_grad_(True)
    opt = (optimizer or functools.partial(
        _adamw, learning_rate=learning_rate))(params)
    return {"params": params, "opt_state": opt.state, "step": 0}, opt


def train_step(state, tokens, cfg: GPTConfig, mesh=None, optimizer=None):
    """One optimizer step on tokens [B, T+1] -> (state, {"loss": loss}).

    The parameters, their gradients and `optimizer`'s state (which must be
    the optimizer make_train_state returned, since a torch optimizer holds
    its parameters) are updated in place; the returned state is `state`
    with its step counted."""
    if optimizer is None:
        raise ValueError("pass the optimizer that make_train_state returned: "
                         "it holds the parameters it updates")
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state["params"], tokens, cfg, mesh)
    loss.backward()
    optimizer.step()
    state["step"] += 1
    return state, {"loss": loss.detach()}


def make_train_step(cfg: GPTConfig, mesh=None, optimizer=None,
                    donate: bool = True):
    """train_step bound to cfg and the optimizer, as a callable
    (state, tokens) -> (state, metrics).

    `donate` is accepted for the JAX package's signature and has no
    counterpart: PyTorch runs eagerly and the step updates the parameters
    and optimizer state in place, so no buffers are copied to donate."""
    _check_supported(cfg, mesh)
    if optimizer is None:
        raise ValueError("pass the optimizer that make_train_state returned")
    return functools.partial(train_step, cfg=cfg, mesh=mesh,
                             optimizer=optimizer)
