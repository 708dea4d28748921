"""tpuclip_torch — the PyTorch / CUDA port of tpuclip for one NVIDIA H100.

``tpuclip/`` (JAX + Pallas for TPU) is the reference and is left unchanged;
this package follows its layout module by module. It imports torch, never
jax, and nothing of ``tpuclip``: the framework-neutral modules it needs
(config, SQLite store and matrix cache, decode/prefetch/preprocess,
tokenizer, gallery, logging/profiling/bucketing, model configs and
checkpoint reading, the hamming helpers and the duplicate filter) are
carried as copies under the same relative paths, each held to its
original by a test. Environment variables, the SQLite schema, the
matrix-cache files and the cache paths are the same, so a database written
by one package opens in the other.

Ported: ``scan``, ``search`` (int8 with an exact rescore, bf16,
binary-only, the cascade, IVF, folder filters), ``serve`` and the rest of
the CLI, ``train`` included, on the SigLIP towers and SigLIP2's NaFlex
towers (``models/naflex.py``), with tpuclip's fused query programs as CUDA
graphs (``ops/graphs.py``), every Pallas kernel of tpuclip in CUDA
(``csrc/``) and the mesh (``parallel/``: row-sharded searches,
cluster-sharded IVF, the multi-host bootstrap, tensor-parallel towers and
data x model parallel training).
"""

__version__ = "0.1.0"

from tpuclip_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device", "__version__"]
