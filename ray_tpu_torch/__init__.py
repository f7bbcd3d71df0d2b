"""PyTorch/CUDA port of ray_tpu's device code, for NVIDIA Hopper.

The JAX package `ray_tpu` is the reference: each module here keeps the
layout and semantics of its counterpart there, and imports nothing of it
(nor of jax).  Ported so far: the flagship GPT on one device
(`models.gpt`): its inference forward and its training (`loss_fn`, remat,
`make_train_state`, `train_step` with AdamW at optax's defaults); its
KV-cache `generate` (`models.decode`); the JAX parameter and AdamW-state
layouts (`models.convert`); and every Pallas kernel of the JAX package as a
hand-written Hopper kernel (`ops.flash_attention`: the causal
flash-attention forward, and its backward as a dq and a dk/dv kernel).
"""
