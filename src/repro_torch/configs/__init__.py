"""Architecture configs of the PyTorch port (see ``base``)."""
from repro_torch.configs.base import (ModelConfig, ShardingProfile,
                                      get_config, list_archs)

__all__ = ["ModelConfig", "ShardingProfile", "get_config", "list_archs"]
