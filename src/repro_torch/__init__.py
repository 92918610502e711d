"""PyTorch + CUDA port of the DSA offload engine and its serving path (the
JAX package ``repro`` is the reference it is checked against).

It imports ``torch``, numpy and the standard library only, never ``jax``
or ``repro``.  Entry points: ``repro_torch.core.make_device``,
``repro_torch.models.build_model`` and ``repro_torch.serving.
VhostStyleServer``, which run on the GPU unless the caller asks for the
CPU (``device="cpu"``)."""
