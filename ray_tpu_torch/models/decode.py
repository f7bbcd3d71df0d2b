"""Autoregressive decoding with a KV cache for the GPT (counterpart of
ray_tpu/models/decode.py, GPT only).

The cache is a fixed [L, B, S, H, Dh] buffer as in the JAX package, but it
is a torch tensor updated IN PLACE: `prefill` and `decode_step` write the
new keys and values into the cache they are given and return that same
dict.  Attention over the cache masks columns past `pos` and left-padding
columns, with fp32 scores, exactly as the reference does.

Generation is a Python loop over `decode_step` (PyTorch runs eagerly; the
JAX package's whole-loop `lax.scan` has no counterpart here).  Randomness
comes from an explicit `torch.Generator`.  `prefill`, `decode_step` and
`generate` run under `torch.no_grad()`: with parameters that require grad
(a train state's), they record no autograd graph and keep no activations.

Not ported yet (they raise NotImplementedError): LLaMA configs,
speculative decoding (`speculate_k > 0`), `chunk_step` and the paged-cache
functions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import _rmsnorm


def _check_cfg(cfg) -> None:
    if not isinstance(cfg, gpt.GPTConfig):
        raise NotImplementedError(f"decode supports the GPT only; "
                                  f"{type(cfg).__name__} is not ported yet")
    if cfg.n_experts:
        raise NotImplementedError("decode supports dense models (MoE "
                                  "routing caches are not implemented)")


# ---------------------------------------------------------------------------
# Model pieces at per-row logical positions (q/k/v and the attention output
# projection are gpt.py's own)


def _embed(params, tokens, positions, cfg):
    """tokens [B, t] at per-row logical positions [B, t]."""
    x = params["wte"][tokens] + params["wpe"][positions]
    return x.to(cfg.dtype)


def _ffn(lp, x, cfg):
    return x + gpt._dense_ffn(_rmsnorm(x, lp["ln2"]), lp, cfg)


def _final_logits(params, x, cfg):
    return gpt._lm_head(_rmsnorm(x, params["ln_f"]), params["wlm"], cfg)


# ---------------------------------------------------------------------------
# Cache


def init_cache(cfg, batch: int, max_seq: Optional[int] = None,
               device=None) -> Dict:
    """Fixed-shape KV cache: k/v [L, B, S, H, Dh] in cfg.dtype, zeros, on
    `device` (CUDA unless the caller passes "cpu")."""
    _check_cfg(cfg)
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, S, cfg.n_heads, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _scores_f32(q, ck):
    """q [B,1,H,Dh] . ck [B,S,H,Dh] -> fp32 scores [B,H,1,S].  On CUDA the
    operands stay in the cache's dtype, with fp32 accumulation and output:
    products of two bf16 values are exact in fp32, so these are the
    reference's fp32 scores without an fp32 copy of the cache.  (CPU
    torch has no such product; there the operands are upcast.)"""
    if not q.is_cuda or q.dtype == torch.float32 or q.dtype != ck.dtype:
        return torch.einsum("bqhk,bshk->bhqs", q.float(), ck.float())
    b, s, h, dh = ck.shape
    qm = q.permute(0, 2, 1, 3).reshape(b * h, 1, dh)
    km = ck.permute(0, 2, 1, 3).reshape(b * h, s, dh).transpose(1, 2)
    return torch.bmm(qm, km, out_dtype=torch.float32).view(b, h, 1, s)


def _cached_attention(q, ck, cv, pos, pad_lo, cfg):
    """q [B,1,H,Dh] against the cache's columns pad_lo[b]..pos (fp32
    scores; columns past pos and left-padding are masked, not sliced).
    `pos` is an int (whole batch at one column) or a [B] tensor (each row
    at its own depth)."""
    S = ck.shape[1]
    scale = cfg.head_dim ** -0.5
    scores = _scores_f32(q, ck) * scale
    cols = torch.arange(S, device=ck.device)
    pos_col = torch.as_tensor(pos, device=ck.device).reshape(-1, 1)
    mask = (cols[None, :] <= pos_col) & (cols[None, :] >= pad_lo[:, None])
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", probs.to(cv.dtype), cv)


# ---------------------------------------------------------------------------
# Prefill + single-step decode


@torch.no_grad()
def prefill(params: Dict, tokens, cfg, cache: Dict, prompt_lens=None):
    """Run the prompt [B, T] through the model, writing cache[:, :, :T] in
    place.

    With `prompt_lens` [B], rows are treated as LEFT-padded to width T:
    row b's real tokens occupy columns T-len..T-1, get logical positions
    0..len-1, and its padding columns are masked out of every attention.

    Returns (logits [B, T, V] fp32, cache)."""
    _check_cfg(cfg)
    dev = params["wte"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, T = tokens.shape
    cols = torch.arange(T, device=dev)
    if prompt_lens is None:
        pad_lo = torch.zeros(B, dtype=torch.long, device=dev)
        positions = cols.expand(B, T)
    else:
        pad_lo = T - torch.as_tensor(prompt_lens, device=dev).long()
        positions = (cols[None, :] - pad_lo[:, None]).clamp_min(0)
    x = _embed(params, tokens, positions, cfg)
    # causal AND not-padding: [B, q, k].  Pad queries also attend to
    # THEMSELVES: a query with no valid key would softmax an all--inf row
    # into NaNs, which reach real columns through 0 * NaN in the next
    # layer's value product; self-attention keeps pad lanes finite.
    mask = (cols[None, None, :] <= cols[None, :, None]) \
        & ((cols[None, None, :] >= pad_lo[:, None, None])
           | (cols[None, None, :] == cols[None, :, None]))
    scale = cfg.head_dim ** -0.5
    for i, lp in enumerate(gpt.layer_slices(params)):
        h = _rmsnorm(x, lp["ln1"])
        q, k, v = gpt._qkv(h, lp, cfg)
        cache["k"][i, :, :T] = k
        cache["v"][i, :, :T] = v
        scores = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
        scores = scores.masked_fill(~mask[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqs,bshk->bqhk", probs.to(v.dtype), v)
        x = x + gpt._attn_out(out, lp, cfg)
        x = _ffn(lp, x, cfg)
    return _final_logits(params, x, cfg), cache


@torch.no_grad()
def decode_step(params: Dict, token, pos, cache: Dict, cfg, pad_lo=None):
    """One token [B] at cache column `pos` -> (logits [B, V], cache with
    the token's K/V written in place).  `pos` is an int (every row writes
    the same column, as in generate) or a [B] int tensor (each row writes
    its own column, as in continuous batching).  pad_lo [B] marks each
    row's first real cache column (0 without left-padding)."""
    _check_cfg(cfg)
    dev = params["wte"].device
    token = torch.as_tensor(token, device=dev)
    B = token.shape[0]
    per_row = torch.is_tensor(pos) and pos.dim() == 1
    if per_row:
        pos = pos.to(dev)
    if pad_lo is None:
        pad_lo = torch.zeros(B, dtype=torch.long, device=dev)
    positions = (pos - pad_lo)[:, None]  # logical position per row
    rows = torch.arange(B, device=dev)
    x = _embed(params, token[:, None], positions, cfg)
    for i, lp in enumerate(gpt.layer_slices(params)):
        h = _rmsnorm(x, lp["ln1"])
        q, k, v = gpt._qkv(h, lp, cfg)
        if per_row:
            cache["k"][i, rows, pos] = k[:, 0]
            cache["v"][i, rows, pos] = v[:, 0]
        else:
            cache["k"][i, :, int(pos)] = k[:, 0]
            cache["v"][i, :, int(pos)] = v[:, 0]
        out = _cached_attention(q, cache["k"][i], cache["v"][i], pos, pad_lo,
                                cfg)
        x = x + gpt._attn_out(out, lp, cfg)
        x = _ffn(lp, x, cfg)
    return _final_logits(params, x, cfg)[:, 0], cache


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"decode.{name} is not ported to "
                                  f"ray_tpu_torch yet (see ROADMAP.md)")
    fn.__name__ = name
    return fn


chunk_step = _not_ported("chunk_step")
init_paged_cache = _not_ported("init_paged_cache")
paged_chunk_step = _not_ported("paged_chunk_step")
paged_decode_step = _not_ported("paged_decode_step")


# ---------------------------------------------------------------------------
# Generation


def _sample(logits, generator, temperature: float, top_k: int):
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _matmul_weights_in(params: Dict, dtype) -> Dict:
    """params with the block and LM-head matrices cast to `dtype` once:
    every use casts them to that dtype anyway, so the numbers are the same
    and the decode loop stops re-reading the fp32 copies.  Norm scales and
    the embeddings stay fp32 (the embedding sum is taken in fp32)."""
    cast = ("wqkv", "wo", "w1", "w2")
    blocks = {k: (w.to(dtype) if k in cast else w)
              for k, w in params["blocks"].items()}
    return {**params, "blocks": blocks, "wlm": params["wlm"].to(dtype)}


@torch.no_grad()
def generate(params: Dict, prompt, cfg, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             eos_token: Optional[int] = None, prompt_lens=None,
             speculate_ngram: int = 0, speculate_k: int = 0,
             return_stats: bool = False):
    """prompt [B, T] -> generated tokens [B, max_new_tokens] (int64, on
    the params' device); with `return_stats`, (tokens, stats), where stats
    is None without speculation, as in the reference.

    temperature 0 = greedy; top_k > 0 restricts sampling; sampling draws
    from `generator` (default: a generator seeded with 0 on the params'
    device).  Mixed-length batches: LEFT-pad each row to a common width
    and pass `prompt_lens` [B]; pad columns are masked out of attention
    and logical positions start at each row's first real token, so
    results match per-row unbatched generation.

    WITH eos_token the result is a ragged list of per-row 1-D tensors,
    each cut before its first EOS."""
    _check_cfg(cfg)
    if speculate_k > 0:
        raise NotImplementedError("speculative decoding (speculate_k > 0) "
                                  "is not ported to ray_tpu_torch yet")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    dev = params["wte"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, T = prompt.shape
    S = T + max_new_tokens
    if S > cfg.max_seq:
        raise ValueError(f"prompt + max_new_tokens = {S} exceeds "
                         f"max_seq={cfg.max_seq} (learned positions)")
    if prompt_lens is None:
        prompt_lens = torch.full((B,), T, dtype=torch.long, device=dev)
    else:
        prompt_lens = torch.as_tensor(prompt_lens, device=dev).long()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = _matmul_weights_in(params, cfg.dtype)
    cache = init_cache(cfg, B, max_seq=S, device=dev)
    pad_lo = T - prompt_lens
    logits, cache = prefill(params, prompt, cfg, cache,
                            prompt_lens=prompt_lens)
    token = _sample(logits[:, -1], generator, temperature, top_k)
    out = [token]
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(params, token, T + i, cache, cfg,
                                    pad_lo=pad_lo)
        token = _sample(logits, generator, temperature, top_k)
        out.append(token)
    out = torch.stack(out, dim=1)
    if eos_token is not None:
        hit = out == eos_token
        cut = torch.where(hit.any(dim=1), hit.int().argmax(dim=1),
                          out.shape[1]).tolist()
        out = [row[:n] for row, n in zip(out, cut)]
    return (out, None) if return_stats else out
