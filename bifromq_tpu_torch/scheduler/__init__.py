"""bifromq_tpu_torch.scheduler — adaptive batching (analog of base-scheduler)."""
from .batcher import BatchCallScheduler, Batcher

__all__ = ["BatchCallScheduler", "Batcher"]
