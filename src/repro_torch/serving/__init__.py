"""Serving runtime of the PyTorch port: the continuous-batching engine
over MMU-leased paged KV memory."""
from repro_torch.serving.engine import (EngineStats, Request, ServeEngine,
                                        pool_pressure_gate)
from repro_torch.serving.paged_kv import PagedKVCache

__all__ = ["EngineStats", "PagedKVCache", "Request", "ServeEngine",
           "pool_pressure_gate"]
