"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu's serving core.

The JAX package ``dynamo_tpu`` is the reference; this package mirrors its
layout (engine/, models/, ops/, runtime/, tokens.py) and imports nothing
from it. Plain tensor code is PyTorch; every TPU kernel on the serving path
is a hand-written CUDA kernel for Hopper (``csrc/``, bound in ``ops/cuda/``)
beside a plain PyTorch version of the same function. Entry points run on
the GPU unless the caller passes ``device="cpu"``.
"""
