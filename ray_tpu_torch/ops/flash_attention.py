"""Causal flash attention on Hopper: hand-written CUDA kernels for the
forward (csrc/flash_fwd.cu) and the backward (csrc/flash_bwd.cu: dq, and
dk/dv), their plain PyTorch versions, and the autograd wiring.

Counterpart of ray_tpu/ops/flash_attention.py.  The kernels replace the
Pallas TPU kernels there: `flash_fwd` replaces `_fwd_kernel` and returns
the same (out, lse) pair as its `_flash_fwd`; `flash_dq` and `flash_dkdv`
replace `_dq_kernel` and `_dkdv_kernel`.  `flash_attention` is a
`torch.autograd.Function` whose backward always runs the two backward
kernels.  The reference's `_vjp_bwd` falls back to its plain-XLA
`_blockwise_bwd` when block_q != block_k, because its Pallas dk/dv kernel
needs equal blocks; the Hopper kernels use their own tiles and take every
shape supports() accepts, and both compute the same gradient.

Layout: q, k, v are [batch, heads, seq, head_dim].  A CUDA tensor goes to
the kernel, or the call raises; a CPU tensor goes to the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
# The gate on block_q and block_k, kept from the reference's signature:
# each fits to a tile of 64 or 128 rows that divides seq_len.  The kernels
# pick their own tiles (128 query rows a block, a ragged last one where
# 128 does not divide seq_len), for head dims 64 and 128, in bf16 (the
# wgmma instructions they use are bf16).
KERNEL_TILES = (64, 128)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16,)
# The backward's streamed tile (csrc/flash_bwd.cu), which every sequence
# supports() takes divides.
BWD_TILE = 64

# Kernel launches since the counts were last set to 0, by kernel (only the
# CUDA path adds to them, once per launch).
launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkdv": 0}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


def _fit_block(seq_len: int, block: int) -> int:
    """The tile a requested block fits to, for the gate of supports(): the
    largest tile <= `block`, halving from 128 down to 64, that divides
    seq_len.  Returns 64 when none divides (supports() then refuses the
    shape)."""
    b = min(block, KERNEL_TILES[-1])
    while b > KERNEL_TILES[0] and seq_len % b != 0:
        b //= 2
    return b


def supports(seq_len: int, head_dim: int, dtype=torch.bfloat16,
             block_q: int = DEFAULT_BLOCK_Q,
             block_k: int = DEFAULT_BLOCK_K) -> bool:
    """Shape and dtype gate of the Hopper kernels: bf16, head_dim 64 or
    128, and q and k/v tiles (fit from block_q, block_k) of 64 or 128 rows
    that divide seq_len, so seq_len % 64 == 0.  The backward kernels take
    every shape the forward takes."""
    bq, bk = _fit_block(seq_len, block_q), _fit_block(seq_len, block_k)
    return (dtype in KERNEL_DTYPES and head_dim in KERNEL_HEAD_DIMS
            and bq in KERNEL_TILES and bk in KERNEL_TILES
            and seq_len % bq == 0 and seq_len % bk == 0)


# ---------------------------------------------------------------------------
# Plain versions


def _causal_mask(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


def flash_attention_reference(q, k, v, scale=None):
    """Plain PyTorch version of the forward kernel: causal attention in
    float32.  Returns (out in q's dtype [B, H, S, D], lse float32
    [B, H, S])."""
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~_causal_mask(q.shape[2], q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, lse


def _delta(out, g):
    """delta_i = dO_i . out_i in f32 [B, H, S], the rowwise correction of
    the flash backward (the reference computes it outside its kernels)."""
    return (g.float() * out.float()).sum(-1)


def _probs_and_ds(q, k, v, lse, delta, g, scale):
    """Dense f32 P = exp(s - lse) under the causal mask and
    dS = P * (dO V^T - delta), both [B, H, S, S]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.where(_causal_mask(q.shape[2], q.device),
                    torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_dq_reference(q, k, v, g, lse, delta, scale):
    """Plain PyTorch version of the dq kernel: dense f32,
    dq = scale * dS K, in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, lse, delta, g, scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(
        q.dtype)


def flash_dkdv_reference(q, k, v, g, lse, delta, scale):
    """Plain PyTorch version of the dk/dv kernel: dense f32,
    dk = scale * dS^T Q and dv = P^T dO, in k's and v's dtypes."""
    p, ds = _probs_and_ds(q, k, v, lse, delta, g, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, g, scale=None):
    """Plain PyTorch version of the two backward kernels (with delta
    computed as the wrapper does) -> (dq, dk, dv)."""
    scale = scale or q.shape[-1] ** -0.5
    delta = _delta(out, g)
    return (flash_dq_reference(q, k, v, g, lse, delta, scale),
            *flash_dkdv_reference(q, k, v, g, lse, delta, scale))


# ---------------------------------------------------------------------------
# Kernel wrappers


def _bind(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int,
          n_strides: int):
    """The ctypes entry point `fn_name` of csrc/<lib_name>.cu: n_ptrs
    pointers, n_ints ints, the scale, n_strides element strides and the
    stream, returning a cudaError_t."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _fits_kernel_layout(t) -> bool:
    # TMA moves 16-byte rows (8 bf16 elements, 16-byte aligned) and steps
    # every dimension longer than one by a positive stride.
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 and (st > 0 or n == 1)
                    for st, n in zip(t.stride()[:3], t.shape[:3])))


def _kernel_layout(t):
    """t itself when the kernels' TMA loads take its layout, else a
    contiguous copy (an expanded input has zero strides, autograd may hand
    over odd ones)."""
    return t if _fits_kernel_layout(t) else t.contiguous()


def _check_kernel_inputs(block_q, block_k, **tensors):
    """Raise unless the named [B, H, S, D] tensors lie on one CUDA device,
    share one shape and dtype that the kernels take, and each has a
    contiguous head dim, 16-byte aligned rows and positive strides."""
    ts = list(tensors.values())
    q = ts[0]
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"{', '.join(tensors)} must lie on one CUDA device")
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{', '.join(tensors)} must share one [B, H, S, D] "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{', '.join(tensors)} must share one dtype")
    _, _, s, d = q.shape
    if not supports(s, d, q.dtype, block_q, block_k):
        raise ValueError(
            f"the Hopper flash kernels do not take seq_len={s}, "
            f"head_dim={d}, dtype={q.dtype} (see supports())")
    for name, t in tensors.items():
        if not _fits_kernel_layout(t):
            raise ValueError(f"{name} needs a contiguous head dim and "
                             f"16-byte aligned rows, with positive strides, "
                             f"got strides {t.stride()}")


def _check_rowwise(lse, delta, q):
    """lse and delta: contiguous f32 [B, H, S], 16-byte aligned."""
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(q.shape[:3])} tensor on {q.device}")


def _empty_like_out(q):
    """A [B, H, S, D] view of a [B, S, H, D] buffer, so that its transpose
    back to the model's layout is contiguous."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _strides(*tensors):
    return [st for t in tensors for st in t.stride()[:3]]


def _launch(lib, fn, name, *args):
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream(args[0].device).cuda_stream
        err = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                 stream)
    _build.check(lib, err, f"{name} launch")
    launches[name] += 1


def flash_attention_fwd(q, k, v, scale=None, block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K):
    """Causal attention forward -> (out [B, H, S, D] in q's dtype, lse
    float32 [B, H, S]).

    On CUDA tensors this launches the Hopper kernel (raising on a shape or
    dtype it does not take, see supports()); a q, k or v whose strides its
    TMA loads do not take (e.g. expanded, with zero strides) is first
    copied into a contiguous layout.  `out` is then a [B, H, S, D] view of
    a [B, S, H, D] buffer, so `out.transpose(1, 2)` is contiguous (the
    model's layout).  On CPU tensors it runs the plain version."""
    scale = scale or q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, scale)
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    _check_kernel_inputs(block_q, block_k, q=q, k=k, v=v)
    b, h, s, d = q.shape
    out = _empty_like_out(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib, fn = _bind("flash_fwd", "flash_fwd_bf16", 5, 4, 12)
    _launch(lib, fn, "flash_fwd", q, k, v, out, lse, b, h, s, d,
            float(scale), *_strides(q, k, v, out))
    return out, lse


def flash_dq(q, k, v, g, lse, delta, scale):
    """dq of causal attention from the forward's lse and delta =
    rowsum(dO * out) -> [B, H, S, D] in q's dtype.  CUDA: the Hopper dq
    kernel (g must have a contiguous head dim and 16-byte aligned rows);
    CPU: its plain version."""
    if not q.is_cuda:
        return flash_dq_reference(q, k, v, g, lse, delta, scale)
    _check_kernel_inputs(BWD_TILE, BWD_TILE, q=q, k=k, v=v, g=g)
    _check_rowwise(lse, delta, q)
    b, h, s, d = q.shape
    dq = _empty_like_out(q)
    lib, fn = _bind("flash_bwd", "flash_dq_bf16", 7, 4, 15)
    _launch(lib, fn, "flash_dq", q, k, v, g, lse, delta, dq, b, h, s, d,
            float(scale), *_strides(q, k, v, g, dq))
    return dq


def flash_dkdv(q, k, v, g, lse, delta, scale):
    """(dk, dv) of causal attention from the forward's lse and delta ->
    [B, H, S, D] each, in k's and v's dtypes.  CUDA: the Hopper dk/dv
    kernel (g as for flash_dq); CPU: its plain version."""
    if not q.is_cuda:
        return flash_dkdv_reference(q, k, v, g, lse, delta, scale)
    _check_kernel_inputs(BWD_TILE, BWD_TILE, q=q, k=k, v=v, g=g)
    _check_rowwise(lse, delta, q)
    b, h, s, d = q.shape
    dk, dv = _empty_like_out(k), _empty_like_out(v)
    lib, fn = _bind("flash_bwd", "flash_dkdv_bf16", 8, 4, 15)
    _launch(lib, fn, "flash_dkdv", q, k, v, g, lse, delta, dk, dv, b, h, s,
            d, float(scale), *_strides(q, k, v, g, dk))
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, g, scale=None):
    """Causal flash-attention backward from the forward's residuals ->
    (dq, dk, dv) in the input dtype, [B, H, S, D].

    delta = rowsum(dO * out) is taken in f32 with torch ops, outside the
    kernels, as the reference does.  On CUDA this launches the dq kernel,
    then the dk/dv kernel; an input whose strides the kernels do not take
    (autograd may hand over a `g` with zero or odd strides, and the
    forward takes an expanded q, k or v) is first copied into a contiguous
    layout.  On CPU it runs their plain versions."""
    scale = scale or q.shape[-1] ** -0.5
    if q.is_cuda:
        q, k, v, g = (_kernel_layout(t) for t in (q, k, v, g))
    delta = _delta(out, g)
    dq = flash_dq(q, k, v, g, lse, delta, scale)
    return (dq, *flash_dkdv(q, k, v, g, lse, delta, scale))


class _FlashAttention(torch.autograd.Function):
    """Causal flash attention with the reference's custom_vjp: the forward
    saves (q, k, v, out, lse) as `_vjp_fwd` does; the backward is
    flash_attention_bwd for every block_q, block_k (see the module note)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, block_q, block_k):
        out, lse = flash_attention_fwd(q, k, v, scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, out, lse, g, ctx.scale)
        return (*grads, None, None, None)


def flash_attention(q, k, v, scale=None, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Causal flash attention. q, k, v: [batch, heads, seq, head_dim].
    Differentiable: the backward runs the flash backward kernels on CUDA,
    their plain versions on CPU.  block_q and block_k pick the forward's
    tiles (see supports()); the backward uses its own."""
    scale = scale or q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, scale, block_q, block_k)
