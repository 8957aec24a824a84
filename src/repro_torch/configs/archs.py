"""Side-effect import module: registers every architecture of the port
(one module per arch, each a copy of the reference's config with its
reduced smoke variant; importing registers them with
``configs.base._REGISTRY``)."""
from repro_torch.configs import whisper_medium      # noqa: F401
from repro_torch.configs import internlm2_1_8b      # noqa: F401
from repro_torch.configs import qwen1_5_0_5b        # noqa: F401
from repro_torch.configs import phi3_mini_3_8b      # noqa: F401
from repro_torch.configs import starcoder2_15b      # noqa: F401
from repro_torch.configs import recurrentgemma_2b   # noqa: F401
from repro_torch.configs import rwkv6_7b            # noqa: F401
from repro_torch.configs import internvl2_2b        # noqa: F401
from repro_torch.configs import kimi_k2_1t_a32b     # noqa: F401
from repro_torch.configs import mixtral_8x7b        # noqa: F401
