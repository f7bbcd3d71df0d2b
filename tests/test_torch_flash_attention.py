"""ray_tpu_torch.ops.flash_attention on the CPU: its plain version against
the JAX package's Pallas kernel (interpret mode), the Hopper kernel's
shape/dtype gate and `_build` (with a stand-in compiler).  The
kernel itself runs only on a GPU; chip_smoke.py holds it against the
plain version there."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides; the sums differ only in order (online vs dense
# softmax), as in tests/test_flash_attention.py.
ATOL = 2e-5


def test_plain_version_matches_pallas_kernel():
    for shape, block in (((1, 2, 256, 128), 128),
                         ((1, 2, 384, 128), 512)):  # JAX fits 512 -> 128
        _check_plain_version(shape, block)


def _check_plain_version(shape, block):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    scale = shape[-1] ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_out = jfa.flash_attention(jq, jk, jv, scale, block, block, True)
    _, j_lse = jfa._flash_fwd(jq, jk, jv, scale=scale, block_q=block,
                              block_k=block, interpret=True)

    before = dict(tfa.launches)
    t_out, t_lse = tfa.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert tfa.launches == before  # CPU tensors never reach the kernel
    assert t_out.shape == shape and t_lse.shape == shape[:3]
    assert t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL)
    out_only = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_array_equal(out_only.numpy(), t_out.numpy())


# (seq_len, requested block) -> kernel tile
FIT_BLOCK_CASES = [((4096, 512), 128), ((2816, 512), 128), ((2880, 512), 64),
                   ((1024, 64), 64), ((1000, 512), 64), ((384, 100), 50)]
# (seq_len, head_dim, dtype, (block_q, block_k)) -> supported
SUPPORTS_CASES = [
    ((4096, 128, torch.bfloat16, (512, 512)), True),
    ((2880, 128, torch.bfloat16, (512, 512)), True),    # 64-row tiles
    ((1024, 64, torch.bfloat16, (64, 128)), True),
    ((1000, 128, torch.bfloat16, (512, 512)), False),   # seq % 64 != 0
    ((4096, 96, torch.bfloat16, (512, 512)), False),    # head_dim
    ((4096, 256, torch.bfloat16, (512, 512)), False),
    ((4096, 128, torch.float32, (512, 512)), False),    # bf16 only
    ((4096, 128, torch.float16, (512, 512)), False),
    ((4096, 128, torch.bfloat16, (32, 512)), False),    # no 32-row tile
]


def test_gates_and_build(tmp_path, monkeypatch):
    got = {args: tfa._fit_block(*args) for args, _ in FIT_BLOCK_CASES}
    assert got == dict(FIT_BLOCK_CASES)
    got = [(args, tfa.supports(*args[:3], *args[3]))
           for args, _ in SUPPORTS_CASES]
    assert got == SUPPORTS_CASES
    _check_failed_build_raises_with_compiler_output(tmp_path / "fail",
                                                    monkeypatch)
    _check_build_is_keyed_by_source(tmp_path / "ok", monkeypatch)


def _fake_nvcc(tmp_path, monkeypatch, fail):
    """Point `_build` at a stand-in compiler (a Python script run by this
    interpreter) and a scratch source and build directory: it prints a
    ptxas-like line, then fails or writes the -o file."""
    tmp_path.mkdir()
    script = tmp_path / "fake_nvcc.py"
    script.write_text(
        "import sys\n"
        "print('ptxas info    : Used 42 registers')\n"
        f"if {fail}:\n"
        "    print('flash_fwd.cu(1): error: boom'); sys.exit(2)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "flash_fwd.cu").write_text("// stand-in source\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        [str(script), *_build.NVCC_FLAGS])
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def _check_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="(?s)exit 2.*error: boom"):
        _build.build_all()
    assert not list((tmp_path / "build").iterdir())


def _check_build_is_keyed_by_source(tmp_path, monkeypatch):
    csrc = _fake_nvcc(tmp_path, monkeypatch, fail=False)
    logs = _build.build_all()
    assert "Used 42 registers" in logs["flash_fwd"]
    first = _build._target("flash_fwd")
    assert first.exists()
    assert _build.build_all() == logs  # up to date: nothing rebuilt
    (csrc / "flash_fwd.cu").write_text("// edited\n")
    assert _build._target("flash_fwd") != first
    _build.build_all()
    assert _build._target("flash_fwd").exists()
