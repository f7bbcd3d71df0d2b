"""Drive the PyTorch/H100 port (ray_tpu_torch) on one GPU.

Run from the repository root, on a machine with one Hopper GPU and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (the script then exits non-zero):

1. build    -- compile every kernel of the port from csrc/ with nvcc
               (sm_90a), printing each variant's registers and spills.
2. kernel   -- hold the flash-attention forward kernel against its plain
               PyTorch version (out and lse) at six shapes: head dims 64
               and 128, 4 and 16 heads, the ragged S = 2880, the serving
               forward's (2, 16, 4096, 128) and the training path's
               (8, 16, 4096, 128), one batch slice at a time; two calls
               give the same bits; an expanded (zero-stride) input still
               runs the kernel; an fp32 input raises.  Time it at the two
               main shapes beside its bound, the plain version (B=2) and
               one PyTorch call computing the same function (the
               yardstick, never used by the port); its registers and
               shared memory a block (cudaFuncGetAttributes), with no
               spills.
3. forward  -- the long-sequence GPT of bench.py (vocab 32000, d_model 2048,
               16 heads of 128, 12 layers, d_ff 8192, max_seq 4096, bf16 on
               fp32 params, random weights from --seed) at B=2, T=4096: one
               kernel launch per layer, finite logits that agree with the
               plain-attention `prefill` on the same tokens.
4. serve    -- `generate` answers 4 left-padded requests of 128..1024
               tokens with 64 greedy tokens each; the first tokens agree
               with the forward's argmax on each unpadded prompt.
5. backward -- hold the dq and dk/dv kernels (and the forward whose out
               and lse they take) against their plain versions, one batch
               slice at a time (bit-identical across two calls), at the
               training path's shape (8, 16, 4096, 128) and four others,
               and time them there beside their bounds, the plain versions
               and the backward of F.scaled_dot_product_attention (the
               yardstick); autograd through flash_attention launches the
               kernels for equal and unequal blocks alike; each kernel's
               registers and shared memory a block (cudaFuncGetAttributes),
               with no spills.
6. train    -- the same GPT with remat="full", trained with the default
               AdamW at 3e-4 for 1 + 5 steps at B=8, T=4096 on one fixed
               batch: finite, falling loss, and per step exactly 2 forward
               launches (one in the remat re-run), 1 dq and 1 dk/dv launch
               per layer; ms per step, tokens/s, MFU.
7. gradcheck -- at B=1, T=4096 on the trained weights: the kernel path's
               loss and gradients against fp32 plain attention, no further
               off than bf16 plain attention is; loss_chunk=1024 against
               the full-logits loss; remat "ffn" against "full" (one
               forward launch per layer instead of two).
8. profile  -- device time by kernel (torch.profiler) of one forward, of
               8 decode steps and of one training step, against the host
               clock.

Launch counts are set to 0 just before phase 3 and read after phase 4 (the
serving path), and set to 0 again just before phase 6 and read after it
(the training path).  The second-to-last lines are the card's name and
power limit (from nvidia-smi) and a JSON `kernels` line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
# bench.py's long-sequence training run: B=8, T=4096, remat "full", flash
# attention, full logits (loss_chunk 0), AdamW at 3e-4.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 4096, 5, 3e-4
# The forward kernel's shapes: head dim 64, 4 and 16 heads, a sequence
# whose last 128-row tile is ragged, the serving forward's shape (B=2,
# timed) and the training path's (B=8, timed).
FWD_MAIN = (FWD_BATCH, 16, FWD_SEQ, 128)
FWD_TRAIN = (TRAIN_BATCH, 16, TRAIN_SEQ, 128)
FWD_SHAPES = ((1, 4, 1024, 64), (1, 4, 1024, 128), (1, 16, 1024, 128),
              (1, 16, 2880, 128), FWD_MAIN, FWD_TRAIN)
# The backward kernels at the training path's shape (B=8; timed there), the
# forward's shape of phase 2, a short one, one whose last 128-row tile is
# ragged, and head_dim 64.  The dense plain versions run one
# batch slice at a time, so that their [H, S, S] f32 tensors fit.
BWD_SHAPES = ((TRAIN_BATCH, 16, TRAIN_SEQ, 128), (2, 16, 4096, 128),
              (1, 16, 1024, 128), (1, 16, 2880, 128), (1, 16, 1024, 64))

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
# Backward kernels vs their plain versions (dense f32, nothing rounded),
# bf16 inputs ~N(0, 1): the kernels round P (for dv) and dS (for dq, dk)
# to bf16 before the products that consume them, as the TPU kernels do,
# and round the result to bf16, each up to 2^-9 relative; the errors of
# the rounded terms add with random signs.  Held as max |err| <= 2^-7 *
# max |ref| per gradient (four bf16 roundings of the largest value).
BWD_REL = 2.0 ** -7
# Model gradients, per leaf, as relative norm error against fp32 plain
# attention: the kernel path may be at most this factor further off than
# bf16 plain attention.  Both share every bf16 rounding outside attention,
# which dominates; inside it the kernel keeps scores in f32 where the plain
# path rounds them to bf16, so the kernel path is expected no worse (1.0),
# with half again for the run-to-run scatter of two independent bf16
# roundings.
GRAD_FACTOR = 1.5
# loss_chunk=1024 vs the full-logits loss, same weights and tokens: the
# same per-token losses summed in another order (1e-4 relative on the
# loss); each chunk's LM-head weight gradient is rounded to bf16 and the
# four are summed in bf16, as the JAX package's transpose does (a few
# 2^-8 roundings: 1e-2 in relative norm per gradient leaf).
CHUNK_LOSS_REL, CHUNK_GRAD_REL = 1e-4, 1e-2
# remat "ffn" vs "full": the same operations on the same values, only
# scheduled differently (tests/test_models.py holds the JAX package's
# modes to 1e-5).
REMAT_REL = 1e-5


# Profiler kernel names -> a class, first match wins: the port's kernels,
# cuBLAS's GEMMs (nvjet on this PyTorch), PyTorch's own kernels.
KERNEL_CLASSES = (("flash kernels", ("flash_",)),
                  ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass")),
                  ("PyTorch elementwise/reduce", ("at::native",)))


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


def _bwd_bound(b, h, s, d, kernel):
    """(least ms, what bounds it) for one backward kernel on an H100, over
    the n = B*H*S(S+1)/2 visible pairs: dq does 6*D*n FLOP (QK^T, dO V^T,
    dS K) and moves q, k, v, dO and dq; dk/dv does 8*D*n (K Q^T, V dO^T,
    P^T dO, dS^T Q) and moves q, k, v, dO, dk and dv; both read lse and
    delta (f32)."""
    n = b * h * s * (s + 1) / 2
    flops, tensors = {"dq": (6 * d * n, 5), "dkdv": (8 * d * n, 6)}[kernel]
    nbytes = tensors * b * h * s * d * 2 + 2 * b * h * s * 4
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
    # template arguments in source order (<D> for flash_fwd, <D, dq or
    # dkdv> for flash_bwd).  The count is the launch's: setmaxnreg then
    # moves registers between the warpgroups of both, as flash_sm90.cuh's
    # PRODUCER_REGS and CONSUMER_REGS ask.
    for name, log in logs.items():
        for fn, spill, regs in re.findall(
                r"Compiling entry function '([^']+)'.*?"
                r"(\d+) bytes spill stores.*?Used (\d+) registers", log,
                re.S):
            kernel = re.search(r"\d+(flash_\w+?)_kernel", fn)
            args = [int(a) for a in re.findall(r"L[ib](\d+)E", fn)]
            if kernel and kernel.group(1) == "flash_bwd":
                args[1:] = ["dq" if args[1] else "dkdv"]
            print(f"[build] {name}: {kernel.group(1) if kernel else fn}"
                  f"<{','.join(map(str, args))}>: {regs} registers, {spill} "
                  f"bytes spilled")


def _fwd_errors(what, q, k, v, out, lse):
    """Hold the forward kernel's out and lse on q, k, v against its plain
    version; raise unless they agree within tolerance.  Returns (max |out
    err|, max |lse err|)."""
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
    diff = (out.float() - ref_out.float()).abs()
    e_out, e_lse = float(diff.max()), float((lse - ref_lse).abs().max())
    _require(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
             f"{what}: non-finite kernel output")
    _require(bool((diff <= OUT_ATOL + OUT_RTOL * ref_out.float().abs()).all())
             and e_lse <= LSE_ATOL,
             f"{what}: kernel disagrees with the plain version (tolerance "
             f"{OUT_ATOL} + {OUT_RTOL}|ref| on out, {LSE_ATOL} on lse)")
    return e_out, e_lse


def _check_forward(what, q, k, v):
    """Run the kernel on q, k, v, hold it against its plain version batch
    slice by batch slice, and check that a second call gives the same
    bits.  Returns (max |out err|, max |lse err|)."""
    out, lse = fa.flash_attention_fwd(q, k, v)
    e_out = e_lse = 0.0
    for i, (qi, ki, vi, oi, li) in enumerate(_slices(q.shape[0], q, k, v,
                                                     out, lse)):
        eo, el = _fwd_errors(f"{what} slice {i}", qi, ki, vi, oi, li)
        e_out, e_lse = max(e_out, eo), max(e_lse, el)
    again = fa.flash_attention_fwd(q, k, v)
    _require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
             f"{what}: two forward calls differ")
    print(f"[kernel] {what}: max |out| err {e_out:.3e}, max |lse| err "
          f"{e_lse:.3e}, bit-identical across two calls")
    return e_out, e_lse


def _time_forward(shape, q, k, v, plain: bool):
    """CUDA-event times of the kernel, its plain version (if `plain`) and
    the SDPA forward (the yardstick) on q, k, v, beside the bound."""
    row = dict(shape=list(shape),
               ms=_ms(lambda: fa.flash_attention_fwd(q, k, v)),
               library_ms=_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)))
    if plain:
        row["plain_ms"] = _ms(lambda: fa.flash_attention_reference(q, k, v),
                              iters=3, warmup=1)
    row["bound_ms"], row["bound_by"] = _flash_bound(*shape)
    return row


def _check_expanded_input(gen):
    """k and v shared by every head (stride 0 over heads), as an expanded
    tensor: the wrapper copies them for the TMA loads and still launches
    the kernel once, never the plain version."""
    q, k, v = _qkv_views(gen, 1, 4, 1024, 128)
    k, v = (x[:, :1].expand_as(q) for x in (k, v))
    _require(k.stride(1) == 0 and not fa._fits_kernel_layout(k),
             "the expanded input has no zero stride")
    before = fa.launches["flash_fwd"]
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    n = fa.launches["flash_fwd"] - before
    _require(n == 1, f"expanded input: {n} kernel launches, not 1")
    e_out, e_lse = _fwd_errors("expanded k, v", q, k, v, out, lse)
    print(f"[kernel] expanded (zero-stride) k, v at (1, 4, 1024, 128): 1 "
          f"launch, max |out| err {e_out:.3e}, max |lse| err {e_lse:.3e}")


def _kernel_attributes(lib_name, fn_name, what, cases):
    """{case: attributes} of a kernel source's variants, as
    cudaFuncGetAttributes reads them after their launches: registers a
    thread at launch (before setmaxnreg), static shared memory a block,
    spilled bytes a thread, the most threads a block may have, and the
    dynamic shared memory a block was given.  `cases` maps each case to
    the C function's leading int arguments; raises on any spill."""
    import ctypes
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    keys = ("launch_registers", "static_smem_bytes", "local_bytes",
            "max_threads_per_block", "dynamic_smem_bytes")
    found = {}
    for case, args in cases.items():
        fn.argtypes = [ctypes.c_int] * len(args) + [
            ctypes.POINTER(ctypes.c_int)]
        out = (ctypes.c_int * len(keys))()
        _build.check(lib, fn(*args, out), fn_name)
        found[case] = dict(zip(keys, out))
        print(f"[{what}] {lib_name}<{','.join(map(str, case))}> attributes: "
              f"{json.dumps(found[case])}")
    _require(all(a["local_bytes"] == 0 for a in found.values()),
             f"a {lib_name} kernel spills to local memory")
    return found


def phase_kernel(gen):
    errs, rows = [], {}
    for shape in FWD_SHAPES:
        q, k, v = _qkv_views(gen, *shape)
        errs.append(_check_forward(str(shape), q, k, v))
        if shape in (FWD_MAIN, FWD_TRAIN):
            rows[shape] = _time_forward(shape, q, k, v,
                                        plain=shape == FWD_MAIN)
            print(f"[kernel] {json.dumps(rows[shape])}")
        del q, k, v
    _check_expanded_input(gen)
    # The kernel takes bf16 only: an fp32 CUDA input raises, it never
    # falls back to the plain version.
    q, k, v = _qkv_views(gen, 1, 4, 1024, 128)
    try:
        fa.flash_attention(q.float(), k.float(), v.float())
    except ValueError:
        pass
    else:
        raise SmokeFailure("fp32 CUDA input did not raise")
    # After the launches above, which set each head dim's dynamic shared
    # memory.
    attrs = _kernel_attributes("flash_fwd", "flash_fwd_attributes", "kernel",
                               {(d,): (d,) for d in fa.KERNEL_HEAD_DIMS})
    return dict(rows[FWD_MAIN], max_abs_err=max(e for e, _ in errs),
                lse_max_abs_err=max(e for _, e in errs),
                attributes=attrs[(FWD_MAIN[3],)],
                train_shape=rows[FWD_TRAIN])


def phase_forward(cfg, params, gen):
    tokens = torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_SEQ),
                           generator=gen, device="cuda")
    before = fa.launches["flash_fwd"]
    logits = gpt.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    n = fa.launches["flash_fwd"] - before
    _require(n == cfg.n_layers, f"forward launched the kernel {n} times, "
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


def _launched_since(before: dict) -> dict:
    """Kernel launches since the counts were `before`, by kernel."""
    return {n: fa.launches[n] - before[n] for n in before}


def _bwd_case(gen, shape):
    """q, k, v as the model hands them to the kernels, out and lse from the
    forward kernel, and a random dO in the model's [B, S, H, D] order."""
    b, h, s, d = shape
    q, k, v = _qkv_views(gen, *shape)
    out, lse = fa.flash_attention_fwd(q, k, v)
    g = torch.randn((b, s, h, d), generator=gen,
                    device="cuda").bfloat16().transpose(1, 2)
    return q, k, v, out, lse, g, d ** -0.5


def _slices(b, *tensors):
    """The batch slices [i:i+1] of each tensor, for i < b: the plain
    versions run on one at a time."""
    return [[t[i:i + 1] for t in tensors] for i in range(b)]


def _max_rel_err(what, got, ref):
    """max |got - ref|, raising unless it is <= BWD_REL * max |ref|."""
    err = float((got.float() - ref.float()).abs().max())
    top = float(ref.float().abs().max())
    _require(bool(torch.isfinite(got).all()) and err <= BWD_REL * top,
             f"{what}: max |err| {err:.3e} > {BWD_REL:.3e} * max |ref| "
             f"{top:.3e}")
    return err


def _check_backward(shape, q, k, v, out, lse, g, delta, scale, grads):
    """Hold the forward's out and lse and the kernels' dq, dk, dv against
    their plain versions, batch slice by batch slice.  Returns the max
    errors over the slices."""
    errs = dict.fromkeys(("out", "lse", "dq", "dk", "dv"), 0.0)
    for i, (qi, ki, vi, oi, li, gi, di, *got) in enumerate(_slices(
            shape[0], q, k, v, out, lse, g, delta, *grads)):
        what = f"{shape} slice {i}"
        e_out, e_lse = _fwd_errors(what, qi, ki, vi, oi, li)
        refs = (fa.flash_dq_reference(qi, ki, vi, gi, li, di, scale),
                *fa.flash_dkdv_reference(qi, ki, vi, gi, li, di, scale))
        found = {"out": e_out, "lse": e_lse, **{
            n: _max_rel_err(f"{what} {n}", a, r)
            for n, a, r in zip(("dq", "dk", "dv"), got, refs)}}
        errs = {n: max(errs[n], found[n]) for n in errs}
        del refs
    return errs


def phase_backward(gen):
    rows = {}
    for shape in BWD_SHAPES:
        q, k, v, out, lse, g, scale = _bwd_case(gen, shape)
        delta = fa._delta(out, g)
        grads = (fa.flash_dq(q, k, v, g, lse, delta, scale),
                 *fa.flash_dkdv(q, k, v, g, lse, delta, scale))
        errs = _check_backward(shape, q, k, v, out, lse, g, delta, scale,
                               grads)
        # No atomics: a second call gives the same bits.
        again = (fa.flash_dq(q, k, v, g, lse, delta, scale),
                 *fa.flash_dkdv(q, k, v, g, lse, delta, scale))
        _require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                 f"{shape}: two backward calls differ")
        del again
        row = dict(shape=list(shape), max_abs_err=errs, max_abs_grad={
            n: float(t.float().abs().max())
            for n, t in zip(("dq", "dk", "dv"), grads)})
        if shape == BWD_SHAPES[0]:
            row.update(_time_backward(q, k, v, out, lse, g, delta, scale))
        for kernel in ("dq", "dkdv"):
            row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = \
                _bwd_bound(*shape, kernel)
        print(f"[backward] {json.dumps(row)}")
        rows[shape] = row
        del q, k, v, out, lse, g, delta, grads
    _check_backward_through_autograd(gen)
    # After the launches above, which set each kernel's dynamic shared memory.
    attrs = _kernel_attributes(
        "flash_bwd", "flash_bwd_attributes", "backward",
        {(d, kernel): (d, int(kernel == "dq")) for d in fa.KERNEL_HEAD_DIMS
         for kernel in ("dq", "dkdv")})
    d = BWD_SHAPES[0][3]
    return dict(rows[BWD_SHAPES[0]], attributes={
        k: attrs[(d, k)] for k in ("dq", "dkdv")})


def _time_backward(q, k, v, out, lse, g, delta, scale):
    """CUDA-event times of each kernel, the whole backward (delta + dq +
    dk/dv), their plain versions (run on the batch slices one after
    another), and the SDPA backward (the yardstick: one PyTorch call
    computing dq, dk, dv)."""
    b = q.shape[0]
    rowwise = _slices(b, q, k, v, g, lse, delta)
    whole = _slices(b, q, k, v, out, lse, g)
    t = dict(
        dq_ms=_ms(lambda: fa.flash_dq(q, k, v, g, lse, delta, scale)),
        dkdv_ms=_ms(lambda: fa.flash_dkdv(q, k, v, g, lse, delta, scale)),
        bwd_ms=_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, g,
                                                  scale)),
        dq_plain_ms=_ms(lambda: [fa.flash_dq_reference(*x, scale)
                                 for x in rowwise], iters=3, warmup=1),
        dkdv_plain_ms=_ms(lambda: [fa.flash_dkdv_reference(*x, scale)
                                   for x in rowwise], iters=3, warmup=1),
        bwd_plain_ms=_ms(lambda: [fa.flash_attention_bwd_reference(
            *x, scale) for x in whole], iters=3, warmup=1))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    t["library_ms"] = _ms(lambda: torch.autograd.grad(
        o, leaves, g, retain_graph=True))
    return t


def _check_backward_through_autograd(gen):
    """flash_attention's autograd Function on the card: a sum's cotangent
    has zero strides, which the kernels do not take, so the wrapper copies
    it; for equal and for unequal forward blocks each kernel runs once and
    the gradients agree with the plain backward."""
    q, k, v, out, lse, _, scale = _bwd_case(gen, (1, 16, 1024, 128))
    ones = torch.ones_like(out)
    refs = fa.flash_attention_bwd_reference(q, k, v, out, lse, ones, scale)
    for blocks in ((fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K), (128, 64)):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        before = dict(fa.launches)
        # dO: ones, strides 0
        fa.flash_attention(*leaves, None, *blocks).sum().backward()
        torch.cuda.synchronize()
        ran = _launched_since(before)
        _require(ran == {"flash_fwd": 1, "flash_dq": 1, "flash_dkdv": 1},
                 f"autograd through flash_attention{blocks} launched {ran}")
        for name, x, ref in zip(("dq", "dk", "dv"), leaves, refs):
            _max_rel_err(f"autograd {blocks} {name}", x.grad, ref)
    print("[backward] autograd through flash_attention (zero-stride dO), "
          "blocks 512x512 and 128x64: 1 launch of each kernel, gradients "
          "agree with the plain version")


def phase_train(cfg, gen):
    state, opt = gpt.make_train_state(cfg, gen, learning_rate=TRAIN_LR)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    step = gpt.make_train_step(cfg, optimizer=opt)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_dq": cfg.n_layers,
            "flash_dkdv": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(1 + TRAIN_STEPS):  # one warm-up step, then timed steps
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        ran = _launched_since(before)
        _require(ran == want, f"train step {i} launched {ran}, not {want}")
    _require(all(math.isfinite(x) for x in losses),
             f"non-finite training loss: {losses}")
    _require(losses[-1] < losses[0],
             f"training loss did not fall: {losses}")
    ms = sum(times) / len(times) * 1e3
    tps = TRAIN_BATCH * TRAIN_SEQ / ms * 1e3
    n_params = sum(p.numel() for p in gpt._leaves(state["params"]))
    flops_6n = 6 * n_params
    flops_attn = flops_6n + 12 * cfg.n_layers * TRAIN_SEQ * cfg.d_model
    row = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses,
               step_ms=ms, step_ms_each=[x * 1e3 for x in times],
               tokens_per_s=tps, n_params=n_params,
               mfu_6n=flops_6n * tps / PEAK_BF16_FLOPS,
               mfu_6n_plus_attention=flops_attn * tps / PEAK_BF16_FLOPS,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches_per_step=want)
    print(f"[train] {json.dumps(row)}")
    return state, step, tokens


def _loss_and_grads(params, tokens, cfg):
    leaves = gpt._leaves(params)
    loss = gpt.loss_fn(params, tokens, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.float() for g in grads]


def _rel_norm(a, b):
    return float((a - b).norm() / b.norm())


def phase_gradcheck(cfg, params, gen):
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    runs = {}
    for name, run_cfg in (
            ("kernel", cfg),
            ("plain_bf16", dataclasses.replace(cfg, use_flash=False)),
            ("plain_fp32", dataclasses.replace(cfg, use_flash=False,
                                               dtype=torch.float32)),
            ("kernel_chunk1024", dataclasses.replace(cfg, loss_chunk=1024)),
            ("kernel_remat_ffn", dataclasses.replace(cfg, remat_mode="ffn"))):
        before = dict(fa.launches)
        runs[name] = _loss_and_grads(params, tokens, run_cfg)
        ran = _launched_since(before)
        # "full" re-runs each layer's flash forward in the backward; "ffn"
        # stores the attention's residuals, so it runs once.
        fwd = 0 if name.startswith("plain") else cfg.n_layers * (
            1 if run_cfg.remat_mode == "ffn" else 2)
        bwd = 0 if name.startswith("plain") else cfg.n_layers
        _require(ran == {"flash_fwd": fwd, "flash_dq": bwd,
                         "flash_dkdv": bwd}, f"{name}: launched {ran}")
    ref_loss, ref = runs["plain_fp32"]
    rows = []
    for i, (name, _) in enumerate(gpt._named_leaves(params)):
        e_kernel = _rel_norm(runs["kernel"][1][i], ref[i])
        e_plain = _rel_norm(runs["plain_bf16"][1][i], ref[i])
        e_chunk = _rel_norm(runs["kernel_chunk1024"][1][i],
                            runs["kernel"][1][i])
        e_ffn = _rel_norm(runs["kernel_remat_ffn"][1][i],
                          runs["kernel"][1][i])
        rows.append(dict(leaf=name, kernel_vs_fp32=e_kernel,
                         plain_bf16_vs_fp32=e_plain,
                         chunk1024_vs_full=e_chunk, remat_ffn_vs_full=e_ffn))
        _require(e_ffn <= REMAT_REL, f"{name}: remat 'ffn' gradient differs "
                 f"from 'full' by {e_ffn:.3e}")
        _require(e_kernel <= GRAD_FACTOR * e_plain,
                 f"{name}: kernel-path gradient error {e_kernel:.3e} > "
                 f"{GRAD_FACTOR} x plain bf16 {e_plain:.3e}")
        _require(e_chunk <= CHUNK_GRAD_REL,
                 f"{name}: loss_chunk=1024 gradient differs by {e_chunk:.3e}")
    losses = {n: r[0] for n, r in runs.items()}
    chunk_err = abs(losses["kernel_chunk1024"] - losses["kernel"]) / abs(
        losses["kernel"])
    _require(chunk_err <= CHUNK_LOSS_REL,
             f"loss_chunk=1024 loss differs by {chunk_err:.3e}")
    for r in rows:
        print(f"[gradcheck] {json.dumps(r)}")
    print(f"[gradcheck] B=1 T={TRAIN_SEQ} losses {json.dumps(losses)}; "
          f"per leaf, relative norm error of the kernel path <= "
          f"{GRAD_FACTOR} x plain bf16's (both against plain fp32), "
          f"loss_chunk=1024 within {CHUNK_GRAD_REL} of loss_chunk=0, remat "
          f"'ffn' within {REMAT_REL} of 'full'")


def _device_profile(what, fn, top=6):
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
    averages = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in averages
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms in kernels)
    _require(busy_ms > 0, f"{what}: the profiler saw no device time")
    print(f"[profile] {what}: {wall_ms:.2f} ms host clock, {busy_ms:.2f} ms "
          f"device busy ({100 * busy_ms / wall_ms:.1f} %), "
          f"{len(kernels)} kernel names")
    for name, ms in sorted(kernels, key=lambda kv: -kv[1])[:top]:
        print(f"[profile]   {ms:8.3f} ms  {name[:90]}")
    classes = {}
    for name, ms in kernels:
        cls = next((c for c, keys in KERNEL_CLASSES if any(
            k in name for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    print(f"[profile]   by class, ms: {json.dumps(classes)}")
    # The same device time attributed to the PyTorch ops that launched it.
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in averages if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    for name, ms, count in ops[:top]:
        print(f"[profile]   op {ms:8.3f} ms  {count:5d} calls  {name[:70]}")


def phase_profile(cfg, state, step, train_tokens, gen):
    params = state["params"]
    tokens = torch.randint(0, cfg.vocab_size, (FWD_BATCH, FWD_SEQ),
                           generator=gen, device="cuda")
    with torch.no_grad():
        _device_profile(f"forward B={FWD_BATCH} T={FWD_SEQ}",
                        lambda: gpt.forward(params, tokens, cfg))
    B, new = len(SERVE_LENS), 8
    prompt = torch.randint(1, cfg.vocab_size, (B, SERVE_WIDTH),
                           generator=gen, device="cuda")
    cache = decode.init_cache(cfg, B, max_seq=SERVE_WIDTH + new)
    with torch.no_grad():
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
    del cache, mat
    _device_profile(f"train step B={TRAIN_BATCH} T={TRAIN_SEQ}",
                    lambda: step(state, train_tokens), top=10)


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
    fa.reset_launches()  # the serving path starts here
    phase_forward(cfg, params, gen)
    phase_serve(cfg, params, gen)
    serve = dict(fa.launches)
    _require(serve["flash_fwd"] > 0, "the serving path launched no flash "
             "forward kernel")
    del params  # the training state needs the room
    torch.cuda.empty_cache()

    brow = phase_backward(gen)

    train_cfg = dataclasses.replace(cfg, remat=True, remat_mode="full",
                                    use_flash=True, loss_chunk=0)
    fa.reset_launches()  # the training path starts here
    state, step, train_tokens = phase_train(train_cfg, gen)
    train = dict(fa.launches)
    _require(all(train.values()), f"the training path left a kernel "
             f"unlaunched: {train}")
    phase_gradcheck(train_cfg, state["params"], gen)
    phase_profile(train_cfg, state, step, train_tokens, gen)

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:53",
         "launches": serve["flash_fwd"] + train["flash_fwd"],
         "launches_by_path": {"serve": serve["flash_fwd"],
                              "train": train["flash_fwd"]},
         "max_abs_err": krow["max_abs_err"], "ms": krow["ms"],
         "plain_ms": krow["plain_ms"], "bound_ms": krow["bound_ms"],
         "bound_by": krow["bound_by"], "library_ms": krow["library_ms"],
         "library_call": "F.scaled_dot_product_attention(is_causal=True)",
         "attributes": krow["attributes"],
         "train_shape": {n: krow["train_shape"][n] for n in (
             "shape", "ms", "bound_ms", "bound_by", "library_ms")}},
        *({"name": f"flash_{k}", "route": "cuda",
           "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
           "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
           "launches": train[f"flash_{k}"],
           "launches_by_path": {"serve": serve[f"flash_{k}"],
                                "train": train[f"flash_{k}"]},
           "max_abs_err": max(brow["max_abs_err"][n] for n in grads),
           "ms": brow[f"{k}_ms"], "plain_ms": brow[f"{k}_plain_ms"],
           "bound_ms": brow[f"{k}_bound_ms"],
           "bound_by": brow[f"{k}_bound_by"],
           "library_ms": brow["library_ms"],
           "library_call": "backward of F.scaled_dot_product_attention "
                           "(dq, dk and dv in one call)",
           "attributes": brow["attributes"][k]}
          for k, line, grads in (("dq", 130, ("dq",)),
                                 ("dkdv", 167, ("dk", "dv"))))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
