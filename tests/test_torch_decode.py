"""ray_tpu_torch.models.decode against ray_tpu.models.decode on the CPU,
on the same weights, at the reference tests' tiny fp32 GPT config; plus
the port's own invariants (greedy generate = argmax of the growing
forward, top_k=1 = greedy, a seeded generator reproduces its samples)."""

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

J_CFG = jgpt.GPTConfig(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq=64, dtype=jnp.float32, remat=False,
                       use_flash=False)
T_CFG = tgpt.GPTConfig(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq=64, dtype=torch.float32)
# fp32 both sides, as tests/test_decode.py compares prefill with forward.
ATOL = RTOL = 2e-4
# Left-padded mixed batch: rows of 7, 3 and 5 real tokens, width 7.
LENS = np.array([7, 3, 5], np.int32)


@pytest.fixture(scope="module")
def weights():
    jparams = jgpt.init_params(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, gpt_params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def padded_prompt():
    rng = np.random.RandomState(3)
    width = int(LENS.max())
    rows = [[0] * (width - n) + list(rng.randint(1, 97, n)) for n in LENS]
    return np.asarray(rows, np.int32)


def test_matches_jax(weights, padded_prompt):
    for padded in (False, True):
        _check_prefill(weights, padded_prompt, padded)
    for per_row in (False, True):
        _check_decode_step(weights, padded_prompt, per_row)
    _check_greedy_generate_same_tokens_as_jax(weights, padded_prompt)


def test_port_invariants(weights, padded_prompt):
    _check_greedy_generate_matches_growing_forward(weights, padded_prompt)
    _check_sampling_top_k_and_generator(weights, padded_prompt)
    _check_eos_truncates_rows(weights, padded_prompt)
    _check_unported_paths_raise(weights, padded_prompt)


def _check_prefill(weights, padded_prompt, padded):
    jparams, tparams = weights
    lens = LENS if padded else None
    B, T = padded_prompt.shape
    jlogits, jcache = jdecode.prefill(
        jparams, jnp.asarray(padded_prompt), J_CFG,
        jdecode.init_cache(J_CFG, B, max_seq=12), prompt_lens=lens)
    cache = tdecode.init_cache(T_CFG, B, max_seq=12, device="cpu")
    tlogits, tcache = tdecode.prefill(
        tparams, torch.from_numpy(padded_prompt).long(), T_CFG, cache,
        prompt_lens=None if lens is None else torch.from_numpy(lens))
    assert tcache is cache  # updated in place
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=RTOL, atol=ATOL)
    assert tcache["v"][:, :, T:].abs().max() == 0


def _check_decode_step(weights, padded_prompt, per_row):
    jparams, tparams = weights
    B, T = padded_prompt.shape
    token = np.array([5, 6, 7], np.int32)
    pad_lo = T - LENS
    # per-row: each row writes (and attends up to) its own column
    pos = np.array([T, T + 2, T + 1]) if per_row else T
    jcache = jdecode.init_cache(J_CFG, B, max_seq=12)
    _, jcache = jdecode.prefill(jparams, jnp.asarray(padded_prompt), J_CFG,
                                jcache, prompt_lens=LENS)
    jlogits, jcache = jdecode.decode_step(
        jparams, jnp.asarray(token), jnp.asarray(pos, jnp.int32), jcache,
        J_CFG, pad_lo=jnp.asarray(pad_lo))
    cache = tdecode.init_cache(T_CFG, B, max_seq=12, device="cpu")
    tdecode.prefill(tparams, torch.from_numpy(padded_prompt).long(), T_CFG,
                    cache, prompt_lens=torch.from_numpy(LENS))
    tlogits, cache = tdecode.decode_step(
        tparams, torch.from_numpy(token).long(),
        torch.from_numpy(pos) if per_row else pos, cache, T_CFG,
        pad_lo=torch.from_numpy(pad_lo).long())
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=RTOL, atol=ATOL)


def _check_greedy_generate_same_tokens_as_jax(weights, padded_prompt):
    jparams, tparams = weights
    jout = jdecode.generate(jparams, jnp.asarray(padded_prompt), J_CFG,
                            max_new_tokens=6, prompt_lens=LENS)
    tout = tdecode.generate(tparams, torch.from_numpy(padded_prompt), T_CFG,
                            max_new_tokens=6,
                            prompt_lens=torch.from_numpy(LENS))
    assert tout.shape == (3, 6)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def _check_greedy_generate_matches_growing_forward(weights, padded_prompt):
    _, tparams = weights
    out = tdecode.generate(tparams, torch.from_numpy(padded_prompt), T_CFG,
                           max_new_tokens=5,
                           prompt_lens=torch.from_numpy(LENS))
    for row, n in enumerate(LENS):
        seq = torch.from_numpy(padded_prompt[row, -n:]).long()[None]
        for i in range(5):
            nxt = tgpt.forward(tparams, seq, T_CFG)[:, -1].argmax(-1)
            assert int(nxt) == int(out[row, i])
            seq = torch.cat([seq, nxt[:, None]], dim=1)


def _check_sampling_top_k_and_generator(weights, padded_prompt):
    _, tparams = weights
    prompt = torch.from_numpy(padded_prompt)
    lens = torch.from_numpy(LENS)
    greedy = tdecode.generate(tparams, prompt, T_CFG, max_new_tokens=4,
                              prompt_lens=lens)
    top1 = tdecode.generate(tparams, prompt, T_CFG, max_new_tokens=4,
                            prompt_lens=lens, temperature=0.8, top_k=1,
                            generator=torch.Generator().manual_seed(5))
    assert torch.equal(top1, greedy)

    def sample(seed):
        return tdecode.generate(tparams, prompt, T_CFG, max_new_tokens=8,
                                prompt_lens=lens, temperature=1.5, top_k=20,
                                generator=torch.Generator().manual_seed(seed))
    assert torch.equal(sample(11), sample(11))
    assert not torch.equal(sample(11), sample(12))


def _check_eos_truncates_rows(weights, padded_prompt):
    _, tparams = weights
    prompt = torch.from_numpy(padded_prompt)
    lens = torch.from_numpy(LENS)
    full = tdecode.generate(tparams, prompt, T_CFG, max_new_tokens=6,
                            prompt_lens=lens)
    eos = int(full[0, 2])
    rows = tdecode.generate(tparams, prompt, T_CFG, max_new_tokens=6,
                            prompt_lens=lens, eos_token=eos)
    for row, got in zip(full, rows):
        hits = (row == eos).nonzero()
        n = int(hits[0]) if len(hits) else len(row)
        assert torch.equal(got, row[:n])


def _check_unported_paths_raise(weights, padded_prompt):
    _, tparams = weights
    prompt = torch.from_numpy(padded_prompt)
    with pytest.raises(NotImplementedError):
        tdecode.generate(tparams, prompt, T_CFG, max_new_tokens=4,
                         speculate_ngram=2, speculate_k=3)
    with pytest.raises(NotImplementedError):
        tdecode.generate(tparams, prompt, J_CFG, max_new_tokens=4)
    for fn in (tdecode.chunk_step, tdecode.paged_chunk_step,
               tdecode.paged_decode_step, tdecode.init_paged_cache):
        with pytest.raises(NotImplementedError):
            fn()
    with pytest.raises(ValueError, match="max_seq"):
        tdecode.generate(tparams, prompt, T_CFG, max_new_tokens=60)
