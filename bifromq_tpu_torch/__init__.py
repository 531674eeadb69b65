"""bifromq_tpu_torch: the PyTorch + CUDA port of bifromq_tpu's match plane.

The package serves the publish -> match -> fan-out path of
``bifromq_tpu`` on an NVIDIA H100: topic bytes are hashed into level
tokens (``ops/tokenize.py``), walked through the compiled subscription
automaton (``models/kernels.fused_walk_routes``) and expanded into
per-peer delivery buckets (``ops/match.expand_routes``), each stage a
hand-written CUDA kernel under ``csrc/``. Above the matcher,
``dist/service.DistService`` serves a publish through the per-tenant
batcher and the pub match cache to ``dist/worker.DistWorker``, whose
route table lives on a raft-replicated KV range (``kv/``, ``raft/``),
and fans the matched routes out to the sub-brokers. Entry points run on
the card unless the caller passes ``device="cpu"``; on CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

The package imports nothing of ``bifromq_tpu`` and never imports
``jax``: the host modules it needs (topic parsing, the oracle, the byte
plane, the automaton compiler, the workload generators, the dist worker
and service with their KV, raft and plugin layers) are copies kept under
the same module paths and function names.
"""
