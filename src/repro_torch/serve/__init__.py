"""Serving runtimes of the port.

* ``repro_torch.serve.engine`` -- KV-cache LM engine with batched prefill
  (the flash-attention kernel) and token-by-token decode.

The JAX package's policy-serving front-ends (``policy``, ``shard``,
``admission``, ``rpc``) are not ported yet (ROADMAP A7).
"""
