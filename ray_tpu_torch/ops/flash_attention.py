"""Causal flash attention on Hopper: a hand-written CUDA kernel
(csrc/flash_fwd.cu) and its plain PyTorch version.

Counterpart of ray_tpu/ops/flash_attention.py, forward only: the kernel
replaces the Pallas TPU kernel `_fwd_kernel` there and returns the same
(out, lse) pair as its `_flash_fwd`.  The backward kernels (`_dq_kernel`,
`_dkdv_kernel`) are not ported yet, so nothing here takes a gradient.

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
# The kernel is compiled for q and k/v tiles of 64 or 128 rows and head
# dims 64 and 128, in bf16 (the mma.sync instruction it uses is bf16).
KERNEL_TILES = (64, 128)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16,)

# Kernel launches since the count was last set to 0 (only the CUDA path
# adds to it, once per launch).
launches = 0


def _fit_block(seq_len: int, block: int) -> int:
    """The kernel tile for a requested block: the largest tile <= `block`,
    halving from 128 down to 64, that divides seq_len.  Returns 64 when
    none divides (supports() then refuses the shape)."""
    b = min(block, KERNEL_TILES[-1])
    while b > KERNEL_TILES[0] and seq_len % b != 0:
        b //= 2
    return b


def supports(seq_len: int, head_dim: int, dtype=torch.bfloat16,
             block_q: int = DEFAULT_BLOCK_Q,
             block_k: int = DEFAULT_BLOCK_K) -> bool:
    """Shape and dtype gate of the Hopper kernel: bf16, head_dim 64 or
    128, and q and k/v tiles (fit from block_q, block_k) of 64 or 128 rows
    that divide seq_len, so seq_len % 64 == 0."""
    bq, bk = _fit_block(seq_len, block_q), _fit_block(seq_len, block_k)
    return (dtype in KERNEL_DTYPES and head_dim in KERNEL_HEAD_DIMS
            and bq in KERNEL_TILES and bk in KERNEL_TILES
            and seq_len % bq == 0 and seq_len % bk == 0)


def flash_attention_reference(q, k, v, scale=None):
    """Plain PyTorch version of the kernel: causal attention in float32.
    Returns (out in q's dtype [B, H, S, D], lse float32 [B, H, S])."""
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    n = q.shape[2]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, lse


def _kernel():
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_longlong] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _check_kernel_inputs(q, k, v, block_q, block_k):
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k and v must share one dtype")
    _, _, s, d = q.shape
    if not supports(s, d, q.dtype, block_q, block_k):
        raise ValueError(
            f"the Hopper flash kernel does not take seq_len={s}, "
            f"head_dim={d}, dtype={q.dtype} (see supports())")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # cp.async moves 16-byte rows: 8 bf16 elements.
        if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous head dim and "
                             f"16-byte aligned rows, got strides "
                             f"{t.stride()}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError("the flash backward kernels are not "
                                  "ported yet; call under torch.no_grad()")


def flash_attention_fwd(q, k, v, scale=None, block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K):
    """Causal attention forward -> (out [B, H, S, D] in q's dtype, lse
    float32 [B, H, S]).

    On CUDA tensors this launches the Hopper kernel (raising on a shape or
    dtype it does not take, see supports()).  `out` is then a [B, H, S, D]
    view of a [B, S, H, D] buffer, so `out.transpose(1, 2)` is contiguous
    (the model's layout).  On CPU tensors it runs the plain version."""
    scale = scale or q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, scale)
    _check_kernel_inputs(q, k, v, block_q, block_k)
    b, h, s, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib, fn = _kernel()
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, s, d, _fit_block(s, block_q),
                 _fit_block(s, block_k), float(scale), *strides,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_fwd launch")
    global launches
    launches += 1
    return out, lse


def flash_attention(q, k, v, scale=None, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Causal flash attention. q, k, v: [batch, heads, seq, head_dim]."""
    return flash_attention_fwd(q, k, v, scale, block_q, block_k)[0]
