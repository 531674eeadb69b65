"""bifromq_tpu_torch.raft — raft consensus (analog of base-kv-raft)."""
