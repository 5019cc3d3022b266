"""The torch inference engine (the counterpart of dynamo_tpu/engine/):
paged KV pools on the GPU, llama-family models, continuous batching and
on-device sampling. Importing it builds and loads no kernel library: the
CUDA sources compile at their first launch (ops/cuda/build.py).
"""

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec

__all__ = ["EngineConfig", "ModelSpec", "InferenceEngine"]


def __getattr__(name: str):
    # the models import engine.config, and engine.core imports the models:
    # InferenceEngine resolves on first use so neither import is circular
    if name == "InferenceEngine":
        from dynamo_tpu_torch.engine.core import InferenceEngine

        return InferenceEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
