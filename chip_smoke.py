"""Drive the PyTorch/H100 port (ray_tpu_torch) on one GPU.

Run from the repository root, on a machine with one Hopper GPU and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (the script then exits non-zero):

1. build   -- compile every kernel of the port from csrc/ with nvcc (sm_90a).
2. kernel  -- hold the flash-attention forward kernel against its plain
              PyTorch version (out and lse) at the main path's shapes, time
              it beside its bound, the plain version and one PyTorch call
              computing the same function (the yardstick, never used by
              the port).
3. forward -- the long-sequence GPT of bench.py (vocab 32000, d_model 2048,
              16 heads of 128, 12 layers, d_ff 8192, max_seq 4096, bf16 on
              fp32 params, random weights from --seed) at B=2, T=4096: one
              kernel launch per layer, finite logits that agree with the
              plain-attention `prefill` on the same tokens.
4. serve   -- `generate` answers 4 left-padded requests of 128..1024
              tokens with 64 greedy tokens each; the first tokens agree
              with the forward's argmax on each unpadded prompt.
5. profile -- device time by kernel (torch.profiler) of one forward and of
              8 decode steps, against the host clock.

Launch counts are set to 0 just before phase 3 and read after phase 4.
The second-to-last lines are the card's name and power limit (from
nvidia-smi) and a JSON `kernels` line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import decode, gpt
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

# bench.py's long-sequence GPT (_bench_long_seq), the width at which the
# JAX package runs its Pallas flash kernel.
LONG_SEQ_GPT = dict(vocab_size=32000, d_model=2048, n_heads=16, n_layers=12,
                    d_ff=8192, max_seq=4096)
FWD_BATCH, FWD_SEQ = 2, 4096
SERVE_LENS, SERVE_WIDTH, SERVE_NEW = (128, 384, 640, 1024), 1024, 64

# H100 SXM published peaks (dense bf16 tensor-core rate, HBM3 rate).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Tolerances.  Kernel vs plain version, bf16 inputs ~N(0, 1): the kernel
# rounds P to bf16 before P.V (as the TPU kernel does) and rounds out to
# bf16, each up to 2^-9 relative, so |out - ref| <= OUT_ATOL +
# OUT_RTOL * |ref| (one bf16 ulp of |ref| plus an absolute floor).
OUT_ATOL, OUT_RTOL = 1e-2, 2.0 ** -7
# lse is f32 in both from the same bf16 q, k: only summation order differs.
LSE_ATOL = 1e-4
# Model logits (std ~0.9 at this init) after 12 bf16 layers, flash vs the
# plain attention of prefill: bf16 rounding of activations differs.
LOGIT_ATOL = 0.1


class SmokeFailure(RuntimeError):
    """A phase found the port wrong."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def _ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters`
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wall_ms(fn, iters: int = 3):
    """Host time of fn() in ms, each call ended by a synchronize; returns
    (mean ms, last result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters, out


def _flash_bound(b, h, s, d):
    """(least ms, what bounds it) for one causal forward on an H100: the
    larger of its tensor-core work (QK^T and PV over the s(s+1)/2 visible
    pairs) at the bf16 peak and its bytes (q, k, v, out in bf16, lse in
    f32, each moved once) at the HBM peak."""
    flops = 4 * b * h * d * s * (s + 1) / 2
    nbytes = 4 * b * h * s * d * 2 + b * h * s * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _qkv_views(gen, b, h, s, d):
    """q, k, v [B, H, S, D] bf16 as the model hands them to the kernel:
    strided views of one fused [B, S, 3, H, D] projection."""
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
    return tuple(x.transpose(1, 2) for x in qkv.bfloat16().unbind(2))


def _check_tokens(what, tokens, logits):
    """tokens [B] are the argmax of logits [B, V], row by row."""
    want = logits.argmax(-1)
    gaps = [float(logits[i].max() - logits[i, t])
            for i, t in enumerate(tokens.tolist())]
    _require(torch.equal(tokens, want), f"{what}: tokens {tokens.tolist()} "
             f"vs argmax {want.tolist()} (logit gaps {gaps})")
    print(f"[{what}] tokens equal the argmax in all {len(gaps)} rows")


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {sorted(logs)} built in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    # ptxas -v, per compiled kernel: registers per thread and spills; the
    # template arguments in source order (<D, BM, BN> for flash_fwd).
    for name, log in logs.items():
        for fn, spill, regs in re.findall(
                r"Compiling entry function '([^']+)'.*?"
                r"(\d+) bytes spill stores.*?Used (\d+) registers", log,
                re.S):
            args = ",".join(re.findall(r"Li(\d+)E", fn))
            print(f"[build] {name}<{args}>: {regs} registers, "
                  f"{spill} bytes spilled")


def _flash_errors(what, q, k, v, block_q, block_k):
    """Run the kernel and its plain version on q, k, v; raise unless they
    agree within tolerance.  Returns (max |out err|, max |lse err|)."""
    out, lse = fa.flash_attention_fwd(q, k, v, None, block_q, block_k)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
    diff = (out.float() - ref_out.float()).abs()
    e_out, e_lse = float(diff.max()), float((lse - ref_lse).abs().max())
    print(f"[kernel] {what}: max |out| err {e_out:.3e}, max |lse| err "
          f"{e_lse:.3e}")
    _require(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
             f"{what}: non-finite kernel output")
    _require(bool((diff <= OUT_ATOL + OUT_RTOL * ref_out.float().abs()).all())
             and e_lse <= LSE_ATOL,
             f"{what}: kernel disagrees with the plain version (tolerance "
             f"{OUT_ATOL} + {OUT_RTOL}|ref| on out, {LSE_ATOL} on lse)")
    return e_out, e_lse


def phase_kernel(gen):
    # Every compiled tile shape and head dim against the plain version.
    for d in fa.KERNEL_HEAD_DIMS:
        q, k, v = _qkv_views(gen, 1, 4, 1024, d)
        for bq in fa.KERNEL_TILES:
            for bk in fa.KERNEL_TILES:
                _flash_errors(f"(1, 4, 1024, {d}) tiles {bq}x{bk}", q, k, v,
                              bq, bk)
    # The kernel takes bf16 only: an fp32 CUDA input raises, it never
    # falls back to the plain version.
    try:
        fa.flash_attention(q.float(), k.float(), v.float())
    except ValueError:
        pass
    else:
        raise SmokeFailure("fp32 CUDA input did not raise")

    # The main path's shapes (T = 4096 and 1024), and one (2880) where
    # _fit_block steps the 512 default down to 64-row tiles.
    rows = {}
    for shape in ((2, 16, 4096, 128), (1, 16, 1024, 128),
                  (1, 16, 2880, 128)):
        b, h, s, d = shape
        q, k, v = _qkv_views(gen, *shape)
        e_out, e_lse = _flash_errors(f"{shape} default blocks", q, k, v,
                                     fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K)
        row = dict(
            shape=list(shape),
            tiles=[fa._fit_block(s, fa.DEFAULT_BLOCK_Q),
                   fa._fit_block(s, fa.DEFAULT_BLOCK_K)],
            max_abs_err=e_out, lse_max_abs_err=e_lse,
            ms=_ms(lambda: fa.flash_attention_fwd(q, k, v)),
            plain_ms=_ms(lambda: fa.flash_attention_reference(q, k, v),
                         iters=3, warmup=1),
            library_ms=_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)))
        row["bound_ms"], row["bound_by"] = _flash_bound(*shape)
        print(f"[kernel] {json.dumps(row)}")
        rows[shape] = row
    # Tile sweep at the main shape (the default takes the largest tiles).
    q, k, v = _qkv_views(gen, 2, 16, 4096, 128)
    sweep = {f"{bq}x{bk}": _ms(lambda: fa.flash_attention_fwd(
        q, k, v, None, bq, bk)) for bq in fa.KERNEL_TILES
        for bk in fa.KERNEL_TILES}
    print(f"[kernel] tile sweep at (2, 16, 4096, 128), ms: "
          f"{json.dumps(sweep)}")
    return rows[(2, 16, 4096, 128)]


def phase_forward(cfg, params, gen):
    tokens = torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_SEQ),
                           generator=gen, device="cuda")
    before = fa.launches
    logits = gpt.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    _require(fa.launches - before == cfg.n_layers,
             f"forward launched the kernel {fa.launches - before} times, "
             f"not once per layer ({cfg.n_layers})")
    _require(logits.shape == (FWD_BATCH, FWD_SEQ, cfg.vocab_size)
             and logits.dtype == torch.float32
             and bool(torch.isfinite(logits).all()),
             "forward logits have the wrong shape or dtype, or are not finite")
    ms, _ = _wall_ms(lambda: gpt.forward(params, tokens, cfg))
    print(f"[forward] B={FWD_BATCH} T={FWD_SEQ}: {ms:.2f} ms, "
          f"{FWD_BATCH * FWD_SEQ / ms * 1e3:.0f} tokens/s, "
          f"{cfg.n_layers} kernel launches per forward")

    cache = decode.init_cache(cfg, FWD_BATCH, max_seq=FWD_SEQ)
    plain, _ = decode.prefill(params, tokens, cfg, cache)
    del cache
    last, plain_last = logits[:, -1], plain[:, -1]
    err = float((last - plain_last).abs().max())
    print(f"[forward] last-position logits vs plain-attention prefill: "
          f"max abs err {err:.4e} (tol {LOGIT_ATOL}), logit std "
          f"{float(plain_last.std()):.3f}")
    _require(bool(torch.isfinite(plain).all()) and err <= LOGIT_ATOL,
             f"forward vs prefill logits: max abs err {err} > {LOGIT_ATOL}")
    _check_tokens("forward", plain_last.argmax(-1), last)


def phase_serve(cfg, params, gen):
    rows = [torch.randint(1, cfg.vocab_size, (n,), generator=gen,
                          device="cuda") for n in SERVE_LENS]
    prompt = torch.zeros((len(rows), SERVE_WIDTH), dtype=torch.long,
                         device="cuda")
    for i, r in enumerate(rows):
        prompt[i, SERVE_WIDTH - len(r):] = r
    lens = torch.tensor(SERVE_LENS, device="cuda")

    def serve(new):
        return decode.generate(params, prompt, cfg, max_new_tokens=new,
                               prompt_lens=lens)

    out = serve(SERVE_NEW)  # warm-up, and the answer checked below
    ms_total, again = _wall_ms(lambda: serve(SERVE_NEW), iters=2)
    ms_prefill, _ = _wall_ms(lambda: serve(1), iters=2)
    _require(out.shape == (len(rows), SERVE_NEW) and int(out.min()) >= 0
             and int(out.max()) < cfg.vocab_size,
             f"generate returned {tuple(out.shape)} tokens out of range")
    _require(torch.equal(out, again), "greedy generate is not repeatable")
    step_ms = (ms_total - ms_prefill) / (SERVE_NEW - 1)
    print(f"[serve] {len(rows)} requests, prompts {list(SERVE_LENS)} "
          f"left-padded to {SERVE_WIDTH}, {SERVE_NEW} greedy tokens each: "
          f"{ms_total:.1f} ms per batch ({ms_prefill:.1f} ms prefill + first "
          f"token), {step_ms:.2f} ms per decode step, "
          f"{len(rows) * SERVE_NEW / ms_total * 1e3:.0f} tokens/s")
    fwd_last = torch.stack([gpt.forward(params, r[None], cfg)[0, -1]
                            for r in rows])
    _check_tokens("serve", out[:, 0], fwd_last)


def _device_profile(what, fn):
    """Run fn() once under torch.profiler (CUDA activity) and print the
    device time by kernel: total, share of the host-clock window, top
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched.
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms in kernels)
    _require(busy_ms > 0, f"{what}: the profiler saw no device time")
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    print(f"[profile] {what}: {wall_ms:.2f} ms host clock, {busy_ms:.2f} ms "
          f"device busy ({100 * busy_ms / wall_ms:.1f} %), "
          f"{len(kernels)} kernel names")
    for name, ms in top:
        print(f"[profile]   {ms:8.3f} ms  {name[:90]}")


def phase_profile(cfg, params, gen):
    tokens = torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_SEQ),
                           generator=gen, device="cuda")
    _device_profile(f"forward B={FWD_BATCH} T={FWD_SEQ}",
                    lambda: gpt.forward(params, tokens, cfg))
    B, new = len(SERVE_LENS), 8
    prompt = torch.randint(1, cfg.vocab_size, (B, SERVE_WIDTH),
                           generator=gen, device="cuda")
    cache = decode.init_cache(cfg, B, max_seq=SERVE_WIDTH + new)
    mat = decode._matmul_weights_in(params, cfg.dtype)  # as generate does
    logits, cache = decode.prefill(mat, prompt, cfg, cache)
    token = logits[:, -1].argmax(-1)

    def steps():
        tok = token
        for i in range(new):
            step_logits, _ = decode.decode_step(mat, tok, SERVE_WIDTH + i,
                                                cache, cfg)
            tok = step_logits.argmax(-1)

    _device_profile(f"{new} decode steps B={B} at column {SERVE_WIDTH}",
                    steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    phase_build()
    krow = phase_kernel(gen)

    cfg = gpt.GPTConfig(**LONG_SEQ_GPT, dtype=torch.bfloat16)
    params = gpt.init_params(cfg, gen)
    fa.launches = 0  # the main path starts here
    phase_forward(cfg, params, gen)
    phase_serve(cfg, params, gen)
    launches = fa.launches
    _require(launches > 0, "the main path launched no flash kernel")
    phase_profile(cfg, params, gen)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:53",
        "launches": launches, "max_abs_err": krow["max_abs_err"],
        "ms": krow["ms"], "plain_ms": krow["plain_ms"],
        "bound_ms": krow["bound_ms"], "bound_by": krow["bound_by"],
        "library_ms": krow["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
