"""Multimodal serving (EPD: Encode -> Prefill -> Decode), the counterpart of
dynamo_tpu/multimodal/.

Image content parts in chat requests flow through a dedicated ENCODE worker
(worker.py: a CLIP ViT tower, vit.py, or the mock encoder) that turns images
into embedding rows; the frontend's MultimodalEncode operator (operator.py)
calls it before routing, and the engine injects the rows at the prompt's
placeholder positions during prefill (one masked scatter after the embedding
lookup). Images are PNG, JPEG or GIF, decoded (image.py, jpeg.py, gif.py) and
resized with the standard library and numpy, bit for bit the reference's
Pillow pixels; a video is an animated GIF, sampled into frames that are
re-encoded as Pillow's PNG bytes (encoder.sample_video_frames).
"""

from dynamo_tpu_torch.multimodal.encoder import (
    MockVisionEncoder,
    load_image_bytes,
)

__all__ = ["MockVisionEncoder", "load_image_bytes"]
