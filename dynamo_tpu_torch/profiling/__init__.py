"""The user-facing load and profile tools of the port: the counterparts of
the reference's ``benchmarks/`` modules that ``cli bench`` and ``cli
profile`` run, on the standard library, numpy and torch (no aiohttp, no
JAX).

- ``loadgen``: ``benchmarks/loadgen.py``, the OpenAI-surface load
  generator (closed-loop concurrency ladders and open-loop arrival
  processes; TTFT / ITL / duration percentiles, throughput). ``cli bench``.
- ``profile_sla``: ``benchmarks/profile_sla.py``, the pre-deployment SLA
  profiler that writes the planner's ``prefill.npz`` / ``decode.npz``.
  ``cli profile``.
- ``profile_engine``: ``benchmarks/profile_engine.py``, the step thread's
  phase profile of one serving rung (``python -m
  dynamo_tpu_torch.profiling.profile_engine``).

These are tools a user points at a deployment, not the repository's
benchmark harness.
"""
