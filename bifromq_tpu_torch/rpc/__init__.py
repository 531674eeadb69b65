"""bifromq_tpu_torch.rpc — only the framing the dist codec shares (the fabric is ROADMAP A.5b)."""
