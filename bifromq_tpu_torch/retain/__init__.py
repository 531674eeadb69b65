"""bifromq_tpu_torch.retain: the retained-message service (port of
``bifromq_tpu/retain``; analog of bifromq-retain)."""
