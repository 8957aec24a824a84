"""Serving runtime of the PyTorch port: the continuous-batching engine
over MMU-leased paged KV memory (prefix sharing, copy-on-write, the host
swap tier) and paged recurrent state, and the model mux."""
from repro_torch.serving.engine import (EngineStats, Request, ServeEngine,
                                        pool_pressure_gate)
from repro_torch.serving.model_registry import (ModelBitstream,
                                                ModelRegistry, MuxEngine)
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.paged_state import PagedRecurrentState
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.swap import HostSwapTier

__all__ = ["EngineStats", "HostSwapTier", "ModelBitstream", "ModelRegistry",
           "MuxEngine", "PagedKVCache", "PagedRecurrentState", "PrefixCache",
           "Request", "ServeEngine", "pool_pressure_gate"]
