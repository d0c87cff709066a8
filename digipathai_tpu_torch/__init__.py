"""DigiPathAI on PyTorch and CUDA: the port of ``digipathai_tpu`` to one NVIDIA H100.

The JAX package stays the reference; this package computes the same
segmentation with PyTorch, and its kernels are hand-written CUDA: the 3x3
convolutions (``csrc/conv_fused.cu``), the fused U-Net decoder stage
(``csrc/stage_fused.cu``) and the CRF's bilateral message
(``csrc/bilateral.cu``).  The package imports nothing of ``digipathai_tpu``:
host code (slide readers, the patch loader, the TIFF writer, the server)
is a copy of the JAX package's, under the same module names.
"""

__version__ = "0.1.0"

# Lazy re-exports: `import digipathai_tpu_torch` stays cheap (no torch import).
_LAZY = {
    "getSegmentation": "digipathai_tpu_torch.engine.segmentation",
    "Slide": "digipathai_tpu_torch.io.slide",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["getSegmentation", "Slide", "__version__"]
