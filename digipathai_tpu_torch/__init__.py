"""DigiPathAI on PyTorch and CUDA: the port of ``digipathai_tpu`` to one NVIDIA H100.

The JAX package stays the reference; this package computes the same
segmentation with PyTorch, and its 3x3 convolutions run on a hand-written
CUDA kernel (``csrc/conv_fused.cu``).  Host code that loads no JAX (slide
readers, the patch loader, the TIFF writer, the server) is shared with
``digipathai_tpu`` and imported from there.
"""

__version__ = "0.1.0"

# Lazy re-exports: `import digipathai_tpu_torch` stays cheap (no torch import).
_LAZY = {
    "getSegmentation": "digipathai_tpu_torch.engine.segmentation",
    "Slide": "digipathai_tpu.io.slide",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["getSegmentation", "Slide", "__version__"]
