"""ray_tpu_torch.models.gpt against ray_tpu.models.gpt on the CPU, on the
same weights (converted with gpt_params_from_numpy), at the reference
tests' tiny fp32 config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import gpt_params_from_numpy

J_CFG = jgpt.GPTConfig(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq=64, dtype=jnp.float32, remat=False,
                       use_flash=False)
T_CFG = tgpt.GPTConfig(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq=64, dtype=torch.float32)
# fp32 on both sides; matmul summation order differs between XLA and torch.
ATOL = RTOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    jparams = jgpt.init_params(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, gpt_params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(1).randint(0, 97, (2, 9)).astype(np.int32)


def test_matches_jax(weights, tokens):
    _check_convert_keeps_keys_shapes_dtypes(weights)
    for fn in ("forward", "hidden_states"):
        _check_entry_point(weights, tokens, fn)
    for piece in ("rmsnorm", "dense_ffn", "attention"):
        _check_block_piece_at_unit_scale(piece)
    _check_init_params_layout()


def test_entry_point_rules(weights, tokens, monkeypatch):
    _check_unported_options_raise(weights, tokens)
    _check_cuda_unless_cpu_is_asked(monkeypatch)


def _check_convert_keeps_keys_shapes_dtypes(weights):
    jparams, tparams = weights
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jparams))
    flat_t = {path: tparams[path[0].key] if len(path) == 1
              else tparams[path[0].key][path[1].key] for path in flat_j}
    for path, leaf in flat_j.items():
        t = flat_t[path]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def _check_entry_point(weights, tokens, fn):
    jparams, tparams = weights
    ref = getattr(jgpt, fn)(jparams, jnp.asarray(tokens), J_CFG)
    out = getattr(tgpt, fn)(tparams, torch.from_numpy(tokens).long(), T_CFG)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _check_init_params_layout():
    jparams = jgpt.init_params(J_CFG, jax.random.PRNGKey(0))
    tparams = tgpt.init_params(T_CFG, torch.Generator().manual_seed(0),
                               device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_t = jax.tree_util.tree_leaves_with_path(tparams)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, j), (_, t) in zip(flat_j, flat_t):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        j, t = np.asarray(j), t.numpy()
        # same init scale: ones stay ones, normals share their std (to
        # the sampling error of the smaller leaves)
        np.testing.assert_allclose(t.std(), j.std(), rtol=0.25, atol=1e-7)
        np.testing.assert_allclose(t.mean(), j.mean(), atol=0.01)
    # a seeded generator reproduces its draw
    again = tgpt.init_params(T_CFG, torch.Generator().manual_seed(0),
                             device="cpu")
    assert torch.equal(again["blocks"]["wqkv"], tparams["blocks"]["wqkv"])


def _check_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.init_params(T_CFG, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_params_from_numpy({"wte": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="not available"):
        tgpt.init_params(T_CFG, torch.Generator().manual_seed(0),
                         device="cuda")


def _check_unported_options_raise(weights, tokens):
    _, tparams = weights
    with pytest.raises(NotImplementedError):
        tgpt.forward(tparams, torch.from_numpy(tokens).long(), T_CFG,
                     mesh=object())
    moe = tgpt.GPTConfig(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_seq=64, n_experts=2,
                         dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        tgpt.init_params(moe, torch.Generator().manual_seed(0), device="cpu")


def _check_block_piece_at_unit_scale(fn):
    """The block's pieces on O(1) activations and weights, where the
    parity hazards show (tanh-GELU, fp32 RMSNorm, the -1e30 causal mask);
    the init's 0.02-scale weights keep activations too small for them."""
    rng = np.random.RandomState(7)
    D, H, Dh, Fh = 32, 4, 8, 64
    x = rng.randn(2, 9, D).astype(np.float32)
    lp = {"ln1": 1 + 0.1 * rng.randn(D).astype(np.float32),
          "wqkv": rng.randn(D, 3, H, Dh).astype(np.float32) / D ** 0.5,
          "wo": rng.randn(H, Dh, D).astype(np.float32) / D ** 0.5,
          "w1": rng.randn(D, Fh).astype(np.float32) / D ** 0.5,
          "w2": rng.randn(Fh, D).astype(np.float32) / Fh ** 0.5}
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if fn == "rmsnorm":
        ref = jgpt._rmsnorm(jx, jlp["ln1"])
        out = tgpt._rmsnorm(tx, tlp["ln1"])
    elif fn == "dense_ffn":
        ref = jgpt._dense_ffn(jx, jlp, J_CFG, frozenset())
        out = tgpt._dense_ffn(tx, tlp, T_CFG)
    else:
        ref = jgpt._attention(jx, jlp, J_CFG, frozenset(), {})
        out = tgpt._attention(tx, tlp, T_CFG)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
