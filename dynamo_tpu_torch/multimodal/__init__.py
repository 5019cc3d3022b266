"""Multimodal serving (EPD: Encode -> Prefill -> Decode), the counterpart of
dynamo_tpu/multimodal/.

Image content parts in chat requests flow through a dedicated ENCODE worker
(worker.py: a CLIP ViT tower, vit.py, or the mock encoder) that turns images
into embedding rows; the frontend's MultimodalEncode operator (operator.py)
calls it before routing, and the engine injects the rows at the prompt's
placeholder positions during prefill (one masked scatter after the embedding
lookup). Images are PNG, decoded and resized with the standard library and
numpy (image.py), bit for bit the reference's Pillow pixels.
"""

from dynamo_tpu_torch.multimodal.encoder import (
    MockVisionEncoder,
    load_image_bytes,
)

__all__ = ["MockVisionEncoder", "load_image_bytes"]
