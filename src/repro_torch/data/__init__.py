"""The synthetic token pipeline (numpy; a copy of ``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticTokenPipeline,
                                       pipeline_for)

__all__ = ["DataConfig", "SyntheticTokenPipeline", "pipeline_for"]
