"""Calls that the JAX package accepts, made the same way on the port, on the
CPU at the reference tests' tiny fp32 config: GPTConfig's
`capacity_factor` and `num_microbatches` (the reference reads them only
with experts or under pipeline parallelism, so one device ignores them)
and generate's `return_stats` (None without speculation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode as jdecode
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import decode as tdecode
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import gpt_params_from_numpy

SIZE = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=64)
J_CFG = jgpt.GPTConfig(**SIZE, dtype=jnp.float32, remat=False,
                       use_flash=False)
T_CFG = tgpt.GPTConfig(**SIZE, dtype=torch.float32)
# Set away from their defaults; neither changes a single-device dense run.
FIELDS = dict(capacity_factor=1.25, num_microbatches=4)
# fp32 on both sides, as tests/test_torch_gpt.py and test_torch_decode.py.
ATOL = RTOL = 2e-4
LENS = np.array([7, 3, 5], np.int32)


@pytest.fixture(scope="module")
def weights():
    jparams = jgpt.init_params(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, gpt_params_from_numpy(tree, device="cpu")


def test_config_fields_as_in_jax(weights):
    jparams, tparams = weights
    tokens = np.random.RandomState(1).randint(0, 97, (2, 9)).astype(np.int32)
    # The reference's defaults.
    for name in FIELDS:
        assert (getattr(tgpt.GPTConfig(), name)
                == getattr(jgpt.GPTConfig(), name))
    jcfg = jgpt.GPTConfig(**SIZE, **FIELDS, dtype=jnp.float32, remat=False,
                          use_flash=False)
    tcfg = tgpt.GPTConfig(**SIZE, **FIELDS, dtype=torch.float32)
    # Both ignore the fields on one device: the same logits and loss as
    # the defaults, on each side and across the two.
    jlogits = np.asarray(jgpt.forward(jparams, jnp.asarray(tokens), jcfg))
    np.testing.assert_array_equal(
        jlogits, np.asarray(jgpt.forward(jparams, jnp.asarray(tokens), J_CFG)))
    t_tokens = torch.from_numpy(tokens).long()
    tlogits = tgpt.forward(tparams, t_tokens, tcfg)
    assert torch.equal(tlogits, tgpt.forward(tparams, t_tokens, T_CFG))
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=RTOL,
                               atol=ATOL)
    jloss = float(jgpt.loss_fn(jparams, jnp.asarray(tokens), jcfg))
    tloss = float(tgpt.loss_fn(tparams, t_tokens, tcfg))
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL, atol=ATOL)
    # With experts the fields would be read: the port raises for the path
    # it has not ported, as for n_experts alone.
    with pytest.raises(NotImplementedError, match="MoE"):
        tgpt.forward(tparams, t_tokens, tgpt.GPTConfig(
            **SIZE, **FIELDS, n_experts=2, dtype=torch.float32))


def test_generate_return_stats_as_in_jax(weights):
    jparams, tparams = weights
    rng = np.random.RandomState(3)
    width = int(LENS.max())
    prompt = np.asarray([[0] * (width - n) + list(rng.randint(1, 97, n))
                         for n in LENS], np.int32)
    plain = tdecode.generate(tparams, torch.from_numpy(prompt), T_CFG,
                             max_new_tokens=6,
                             prompt_lens=torch.from_numpy(LENS))
    eos = int(plain[0, 2])
    for eos_token in (None, eos):
        jout, jstats = jdecode.generate(
            jparams, jnp.asarray(prompt), J_CFG, max_new_tokens=6,
            prompt_lens=LENS, eos_token=eos_token, return_stats=True)
        tout, tstats = tdecode.generate(
            tparams, torch.from_numpy(prompt), T_CFG, max_new_tokens=6,
            prompt_lens=torch.from_numpy(LENS), eos_token=eos_token,
            return_stats=True)
        assert jstats is None and tstats is None  # no speculation
        if eos_token is None:
            assert torch.equal(tout, plain)
            np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        else:
            assert len(tout) == len(jout) == len(LENS)
            for t_row, j_row in zip(tout, jout):
                np.testing.assert_array_equal(t_row.numpy(),
                                              np.asarray(j_row))
