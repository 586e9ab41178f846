"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's serving decode path
and GPT training step.

A package of its own beside ``ray_tpu`` (the JAX reference, which it never
imports). Its layout mirrors the reference so each module's counterpart is
found under the same name:

- :mod:`ray_tpu_torch.models.gpt` — GPT config, weights, forward core,
  remat policies, loss and ``make_train_step``;
- :mod:`ray_tpu_torch.models.gpt_decode` — flat and paged KV pools
  (prefill with prefix COW, k-step decode, int8 KV), greedy and seeded
  sampling, and the speculative verify step;
- :mod:`ray_tpu_torch._private.prng` — threefry2x32, bit-exact with
  ``jax.random`` (``PRNGKey``, ``split``, ``uniform``, ``categorical``);
- :mod:`ray_tpu_torch.ops.paged_attention` — the paged decode-attention
  kernel, hand-written CUDA C++ for Hopper (``sm_90a``), plus its plain
  PyTorch version;
- :mod:`ray_tpu_torch.ops.flash_attention` — flash-attention forward and
  backward kernels (CUDA C++, ``sm_90a``) behind a differentiable
  ``flash_attention``, plus their plain PyTorch versions;
- :mod:`ray_tpu_torch.ops._build` — the ``nvcc`` build of every kernel
  source at first use;
- :mod:`ray_tpu_torch.serve.engine` — the continuous-batching
  :class:`~ray_tpu_torch.serve.engine.DecodeEngine` (paged or flat pool,
  temperature > 0 with per-request seeds, ``resume_from`` replay,
  speculative decoding);
- :mod:`ray_tpu_torch.serve.draft` — the n-gram and model drafters.

Not ported yet: KV export/import (disaggregated prefill/decode), tensor
parallelism, the serve front (replicas, supervision, tracing, metrics),
and everything outside the GPT model's decode and training step.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that argument they raise.
"""
