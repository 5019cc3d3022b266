"""OpenAI-compatible frontend + request pipeline (the counterpart of
dynamo_tpu/frontend/).

The serving pipeline:

    HTTP (SSE) -> OpenAIPreprocessor -> Backend (detokenize/stops)
               -> Migration (retry on worker death) -> PushRouter
               -> worker instances (tokens in / tokens out)

Workers self-register ModelDeploymentCards in the hub (v1/mdc/...); the
frontend's ModelWatcher builds a pipeline per model as cards appear and
tears them down as leases expire.
"""

from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer, load_tokenizer
from dynamo_tpu_torch.frontend.model_card import ModelDeploymentCard, register_llm
from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.frontend.backend_op import Backend
from dynamo_tpu_torch.frontend.migration import Migration
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelWatcher
from dynamo_tpu_torch.frontend.http import HttpFrontend

__all__ = [
    "MockTokenizer",
    "load_tokenizer",
    "ModelDeploymentCard",
    "register_llm",
    "OpenAIPreprocessor",
    "Backend",
    "Migration",
    "ModelManager",
    "ModelWatcher",
    "HttpFrontend",
]
