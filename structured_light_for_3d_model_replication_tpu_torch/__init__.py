"""PyTorch + CUDA port of the structured-light scanner, for NVIDIA Hopper.

A sibling of the JAX package ``structured_light_for_3d_model_replication_tpu``
with the same layout (``config``, ``ops/…``, ``models/…``, ``io/…``,
``cli/``), so each function's counterpart is found at the same place. The
port imports ``torch``, ``numpy``, ``scipy``, PIL (OpenCV where present) and
the standard library — never ``jax`` and never the JAX package — and keeps
its own copy of what it needs.

Hand-written CUDA kernels live in ``csrc/`` and are built and bound by
``kernels/`` at first use; nothing imports ``kernels`` eagerly. The host
graph code it shares with the JAX package (``native/src``) is built and
bound by ``_native.py`` at first use. Public entry
points take ``device=None``, which means ``torch.device("cuda")``; without a
card they raise unless the caller passes ``device="cpu"``, where every kernel
is replaced by its plain PyTorch version.
"""
