"""islx_torch: the PyTorch/CUDA port of islx (bf16 main path on one NVIDIA H100).

The JAX package ``islx`` is the reference; this package imports nothing
from it and nothing of JAX. ``ImagePose``, ``BatchedBodyPipeline`` and
``BatchedHandPipeline`` are exported lazily, as islx's ``_LAZY`` does, so
that importing the package loads no pipeline."""

_LAZY = {
    "ImagePose": "islx_torch.pipeline.image",
    "BatchedBodyPipeline": "islx_torch.pipeline.batch_pose",
    "BatchedHandPipeline": "islx_torch.pipeline.batch_pose",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'islx_torch' has no attribute {name!r}")
