"""Step builders for one device (the VMM's programs) or a device mesh
(``partition``: the sharding rules; ``rank_mesh``: a rank's view and
its collectives)."""
from repro_torch.parallel.steps import (abstract_params, build_decode,
                                        build_prefill, build_step_for_cell,
                                        build_train, step_kernels)

__all__ = ["abstract_params", "build_decode", "build_prefill",
           "build_step_for_cell", "build_train", "step_kernels"]
