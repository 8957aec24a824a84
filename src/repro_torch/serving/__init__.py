"""Serving runtime of the PyTorch port: the continuous-batching engine
over MMU-leased paged KV memory and paged recurrent state."""
from repro_torch.serving.engine import (EngineStats, Request, ServeEngine,
                                        pool_pressure_gate)
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.paged_state import PagedRecurrentState
from repro_torch.serving.swap import HostSwapTier

__all__ = ["EngineStats", "HostSwapTier", "PagedKVCache",
           "PagedRecurrentState", "Request", "ServeEngine",
           "pool_pressure_gate"]
