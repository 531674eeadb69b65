"""bifromq_tpu_torch.kv — storage engine (analog of base-kv local engines + schemas)."""
