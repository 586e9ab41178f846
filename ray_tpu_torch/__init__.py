"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's serving decode path.

A package of its own beside ``ray_tpu`` (the JAX reference, which it never
imports). Its layout mirrors the reference so each module's counterpart is
found under the same name:

- :mod:`ray_tpu_torch.models.gpt` — GPT config, weights, forward core;
- :mod:`ray_tpu_torch.models.gpt_decode` — paged slot-pool primitives
  (prefill with prefix COW, k-step decode, int8 KV);
- :mod:`ray_tpu_torch.ops.paged_attention` — the paged decode-attention
  kernel, hand-written CUDA C++ for Hopper (``sm_90a``), plus its plain
  PyTorch version;
- :mod:`ray_tpu_torch.serve.engine` — the continuous-batching
  :class:`~ray_tpu_torch.serve.engine.DecodeEngine`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that argument they raise.
"""
