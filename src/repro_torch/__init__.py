"""PyTorch + CUDA port of the DSA offload engine (the JAX package ``repro``
is the reference it is checked against).

It imports ``torch``, numpy and the standard library only, never ``jax``
or ``repro``.  Entry point: ``repro_torch.core.make_device``, which runs on
the GPU unless the caller passes ``device="cpu"``."""
