"""``repro_torch`` — the PyTorch/CUDA port of the CHORDS serving stack.

Mirrors ``repro``'s layout (``core``, ``configs``, ``kernels``, ``models``,
``diffusion``, ``serve``, ``obs``, ``launch``) module for module; see
``src/repro_torch/README.md`` for the map and the parity contracts. This
package imports ``torch`` and never ``jax`` nor ``repro``: it runs on a GPU
host that has no JAX installed.

Entry points default to ``device="cuda"`` and raise on a host without a GPU
unless the caller passes ``device="cpu"`` (:func:`resolve_device`).
"""
from repro_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
