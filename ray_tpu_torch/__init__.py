"""PyTorch/CUDA port of ray_tpu's device code, for NVIDIA Hopper.

The JAX package `ray_tpu` is the reference: each module here keeps the
layout and semantics of its counterpart there, and imports nothing of it
(nor of jax).  Ported so far: the flagship GPT's single-device inference
forward (`models.gpt`), its KV-cache `generate` (`models.decode`), and the
causal flash-attention forward kernel (`ops.flash_attention`).
"""
