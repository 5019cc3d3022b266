"""KServe gRPC frontend (Open Inference Protocol v2) of the port (the
counterpart of dynamo_tpu/grpc/).

The reference serves it on ``grpc.aio`` with protobuf messages. The port
imports neither: it carries its own layers, all on the stdlib: the KServe
messages' protobuf wire (``kserve.py``), HPACK
(``hpack.py``), an HTTP/2 server connection (``h2.py``) and the part of a
gRPC server the frontend uses (``server.py``). ``service.py`` is the
reference's ``KserveGrpcFrontend`` on them: text generation over the KServe
tensor protocol (``text_input`` / ``input_ids`` / ``openai_request``),
probes, metadata and ModelStreamInfer streaming.
"""

from dynamo_tpu_torch.grpc.service import KserveGrpcFrontend

__all__ = ["KserveGrpcFrontend"]
