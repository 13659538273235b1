"""The plain reference the benchmark holds the port against: float32
PyTorch, written from the published descriptions and the port's stated
semantics, importing nothing of ``repro_torch`` (nor ``jax`` or
``repro``)."""
