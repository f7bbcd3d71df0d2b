"""Training in ray_tpu_torch.models.gpt against ray_tpu.models.gpt on the
CPU, on the same weights (converted with gpt_params_from_numpy), at the
tiny fp32 config of tests/test_models.py: loss and gradients, the remat
settings, an AdamW trajectory, a run carried over from JAX mid-trajectory;
plus the port's own rules (unported options raise, serving records no
graph, the LM head's backward)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import decode as tdecode
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import (adamw_state_from_numpy,
                                          gpt_params_from_numpy)

DIMS = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=64)
KEY = jax.random.PRNGKey(0)
LR = 1e-2
# fp32 on both sides; XLA and torch sum in other orders.  Loss and every
# gradient leaf: max |err| <= 1e-4 * max |ref| (as the flash tests).
REL = 1e-4
# AdamW's normalised update m / (sqrt(v) + eps) turns the fp32 noise of a
# gradient element near 0 into an update of up to lr, so params are held by
# the relative norm error of each leaf's update (params - init), which a
# different algorithm (bias correction, eps placement, decay) moves by
# O(1); losses to 1e-5 relative.
UPDATE_REL, LOSS_RTOL = 1e-3, 1e-5


def _cfgs(**kw):
    return (jgpt.GPTConfig(**DIMS, dtype=jnp.float32, **kw),
            tgpt.GPTConfig(**DIMS, dtype=torch.float32, **kw))


def _tokens(b=2, t=17):
    return np.random.RandomState(1).randint(0, 128, (b, t)).astype(np.int32)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """{path: leaf} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        return {(k, *p): v for k in tree for p, v in _flat(tree[k]).items()}
    return {(): tree}


def _assert_rel(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), (what, err)


def _leaf_params(tree):
    params = gpt_params_from_numpy(tree, device="cpu")
    for p in _flat(params).values():
        p.requires_grad_(True)
    return params


def _port_value_and_grad(params, tokens, cfg):
    loss = tgpt.loss_fn(params, torch.from_numpy(tokens), cfg)
    leaves = _flat(params)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def test_loss_grads_and_remat_match_jax():
    jparams = jgpt.init_params(_cfgs()[0], KEY)
    tree = _tree_np(jparams)
    tokens = _tokens()  # [2, 17]: B*T = 32 tokens, which 7 does not divide
    for kw in (dict(remat=False, loss_chunk=0),
               dict(remat=True, remat_mode="full", loss_chunk=7)):
        _check_loss_and_grads(jparams, tree, tokens, **kw)
    _check_remat_modes_agree(tree, tokens)
    _check_lm_head_backward_bf16()


def _check_loss_and_grads(jparams, tree, tokens, **kw):
    jcfg, tcfg = _cfgs(**kw)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, jnp.asarray(tokens), jcfg)))(jparams)
    t_loss, t_grads = _port_value_and_grad(_leaf_params(tree), tokens, tcfg)
    _assert_rel(t_loss.numpy(), j_loss, f"loss {kw}")
    j_flat = _flat(_tree_np(j_grads))
    assert set(j_flat) == set(t_grads)
    for path, g in t_grads.items():
        _assert_rel(g.numpy(), j_flat[path], f"grad {path} {kw}")


def _check_remat_modes_agree(tree, tokens):
    """remat off, "full" and "ffn" are the same math (as
    tests/test_models.py::test_remat_modes_agree holds the JAX package)."""
    runs = [_port_value_and_grad(
        _leaf_params(tree), tokens,
        _cfgs(remat=remat, remat_mode=mode)[1])
        for remat, mode in ((False, "full"), (True, "full"), (True, "ffn"))]
    (loss0, grads0), rest = runs[0], runs[1:]
    for loss, grads in rest:
        assert float(loss) == pytest.approx(float(loss0), rel=1e-6)
        for path, g in grads.items():
            np.testing.assert_allclose(g.numpy(), grads0[path].numpy(),
                                       rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="remat_mode"):
        _cfgs(remat_mode="fnn")


def _check_lm_head_backward_bf16():
    """The LM head's own backward on bf16 operands (the card's dtype) gives
    autograd's gradients through the fp32 product, within bf16 rounding:
    the cotangent and each result are rounded to bf16 (2^-9 relative
    each), so max |err| <= 2^-7 * max |ref|."""
    rng = np.random.RandomState(2)
    a, w, g = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((24, 64), (64, 96), (24, 96)))
    ab, wb = (t.bfloat16().requires_grad_() for t in (a, w))
    cfg = _cfgs()[1]
    logits = tgpt._lm_head(ab, wb,
                           dataclasses.replace(cfg, dtype=torch.bfloat16))
    assert logits.dtype == torch.float32
    da, dw = torch.autograd.grad(logits, (ab, wb), g)
    assert da.dtype == dw.dtype == torch.bfloat16
    af, wf = (t.detach().float().requires_grad_() for t in (ab, wb))
    want = torch.autograd.grad(af @ wf, (af, wf), g)
    for got, ref in zip((da, dw), want):
        err = float((got.float() - ref).abs().max())
        assert err <= 2.0 ** -7 * float(ref.abs().max()), err


def test_train_steps_match_jax_and_rules():
    jcfg, tcfg = _cfgs()
    tokens = _tokens()
    jstate, _ = jgpt.make_train_state(jcfg, KEY, learning_rate=LR)
    jstep = jgpt.make_train_step(jcfg, learning_rate=LR, donate=False)
    tree = _tree_np(jstate["params"])
    j_states, j_losses = [jstate], []
    for _ in range(3):
        jstate, m = jstep(jstate, jnp.asarray(tokens))
        j_states.append(jstate)
        j_losses.append(float(m["loss"]))

    # Three steps from the same init.
    state, opt = tgpt.make_train_state(
        tcfg, torch.Generator().manual_seed(0), device="cpu",
        learning_rate=LR)
    _load_params(state["params"], tree)
    step = tgpt.make_train_step(tcfg, optimizer=opt, donate=False)
    losses = []
    for _ in range(3):
        state, m = step(state, torch.from_numpy(tokens))
        losses.append(float(m["loss"]))
    assert state["step"] == 3
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    _assert_params(state["params"], j_states[3]["params"], tree)
    assert opt.defaults["weight_decay"] == 1e-4  # optax.adamw's defaults
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8 and opt.defaults["lr"] == LR

    # The third step again, carried over from JAX's state after two.
    state, opt = tgpt.make_train_state(
        tcfg, torch.Generator().manual_seed(0), device="cpu",
        learning_rate=LR)
    j2 = j_states[2]
    _load_params(state["params"], _tree_np(j2["params"]))
    adam = j2["opt_state"][0]
    adamw_state_from_numpy(int(adam.count), _tree_np(adam.mu),
                           _tree_np(adam.nu), state["params"], opt)
    state, m = tgpt.train_step(state, torch.from_numpy(tokens), tcfg,
                               optimizer=opt)
    np.testing.assert_allclose(float(m["loss"]), j_losses[2],
                               rtol=LOSS_RTOL)
    _assert_params(state["params"], j_states[3]["params"],
                   _tree_np(j2["params"]))

    _check_rules(state, tcfg, tokens)


def _load_params(params, tree):
    with torch.no_grad():
        for path, p in _flat(params).items():
            p.copy_(torch.from_numpy(np.array(_flat(tree)[path])))


def _assert_params(params, jparams, init):
    """Each leaf's update from `init` agrees with JAX's to UPDATE_REL in
    relative norm."""
    j_flat, init = _flat(_tree_np(jparams)), _flat(init)
    for path, p in _flat(params).items():
        want = j_flat[path] - init[path]
        got = p.detach().numpy() - init[path]
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= UPDATE_REL, (path, err)


def _check_rules(state, cfg, tokens):
    params = state["params"]
    t = torch.from_numpy(tokens)
    with pytest.raises(NotImplementedError, match="remat_save_attn"):
        tgpt.loss_fn(params, t, _cfgs(remat_save_attn=True)[1])
    with pytest.raises(NotImplementedError, match="mesh"):
        tgpt.loss_fn(params, t, cfg, mesh=object())
    with pytest.raises(ValueError, match="optimizer"):
        tgpt.train_step(state, t, cfg)
    # Serving with a train state's params (which require grad) records no
    # graph: neither the logits nor the cache written in place carry one.
    cache = tdecode.init_cache(cfg, 2, max_seq=32, device="cpu")
    logits, cache = tdecode.prefill(params, t[:, :9], cfg, cache)
    assert logits.grad_fn is None and not logits.requires_grad
    assert cache["k"].grad_fn is None and cache["v"].grad_fn is None
    step_logits, _ = tdecode.decode_step(params, t[:, 9], 9, cache, cfg)
    assert step_logits.grad_fn is None
    out = tdecode.generate(params, t[:, :9], cfg, max_new_tokens=2)
    assert out.shape == (2, 2)
