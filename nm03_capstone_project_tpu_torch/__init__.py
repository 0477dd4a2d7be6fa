"""PyTorch / CUDA port of nm03_capstone_project_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and
``numpy``, never ``jax`` and nothing of the JAX package, and keeps its own
copies of what it needs. Module names follow the JAX package so each
counterpart is easy to find. The three Pallas kernels of the JAX package
are hand-written CUDA kernels here (``csrc/``), each with a plain PyTorch
version beside it.

Entry point: :func:`nm03_capstone_project_tpu_torch.pipeline.process_batch`.
"""

__version__ = "0.1.0"
