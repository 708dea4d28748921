"""tpuclip_torch — the PyTorch / CUDA port of tpuclip for one NVIDIA H100.

``tpuclip/`` (JAX + Pallas for TPU) is the reference and is left unchanged;
this package follows its layout module by module. It imports torch and
never jax. The framework-neutral tpuclip modules (config, SQLite store and
matrix cache, decode/prefetch, tokenizer, gallery, logging/profiling) are
imported from ``tpuclip`` as they are; the pieces whose tpuclip modules pull
jax at import are carried as copies pinned to the originals by tests.

Ported so far: ``scan`` and ``search`` (int8 scan + exact rescore) on the
SigLIP towers, with the two int8 scan kernels in CUDA (``csrc/``).
"""

__version__ = "0.1.0"

from tpuclip_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device", "__version__"]
