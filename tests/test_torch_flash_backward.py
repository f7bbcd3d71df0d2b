"""The backward of ray_tpu_torch.ops.flash_attention on the CPU: gradients
through the port's autograd Function against jax.vjp of the JAX package's
flash_attention (its Pallas dq and dk/dv kernels in interpret mode when
block_q == block_k, its `_blockwise_bwd` otherwise; the port's backward is
the same plain versions of its kernels for both), and the plain backward
against autograd through the dense forward.  The Hopper kernels themselves
run only on a GPU; chip_smoke.py holds them against the plain versions
there."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

SHAPE = (1, 2, 256, 128)
# fp32 on both sides; the sums differ only in order and blocking, so, as
# tests/test_flash_attention.py holds the Pallas backward against dense
# attention: max |err| <= 1e-4 * max |ref|, per gradient.
REL = 1e-4


def _inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(4)]


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), (what, err)


def test_backward_matches_jax():
    before = dict(tfa.launches)
    # (128, 128) reaches the Pallas dq/dk/dv kernels, (128, 64) JAX's
    # `_blockwise_bwd`; the port takes its kernels' plain versions for
    # both.
    for block_q, block_k in ((128, 128), (128, 64)):
        _check_vjp_against_jax(block_q, block_k)
    assert tfa.launches == before  # CPU tensors never reach a kernel


def _check_vjp_against_jax(block_q, block_k):
    q, k, v, g = _inputs()
    scale = SHAPE[-1] ** -0.5
    out, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, scale, block_q,
                                            block_k, True),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    t_out = tfa.flash_attention(tq, tk, tv, scale, block_q, block_k)
    t_out.backward(torch.from_numpy(g))
    _assert_close(t_out.detach().numpy(), out, "out")
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        assert t.grad.shape == SHAPE
        _assert_close(t.grad.numpy(), w, f"d{name} at {block_q}x{block_k}")


def test_plain_backward_matches_autograd():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs())
    scale = SHAPE[-1] ** -0.5
    before = dict(tfa.launches)
    out, lse = tfa.flash_attention_fwd(q, k, v, scale)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, g, scale)
    assert tfa.launches == before
    ref_got = tfa.flash_attention_bwd_reference(q, k, v, out, lse, g, scale)
    for a, b in zip(got, ref_got):
        assert torch.equal(a, b)  # on the CPU the wrapper is the plain version

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    dense, _ = tfa.flash_attention_reference(*leaves, scale)
    want = torch.autograd.grad(dense, leaves, g)
    for name, a, w in zip("qkv", got, want):
        _assert_close(a.numpy(), w.numpy(), f"d{name} vs autograd")
