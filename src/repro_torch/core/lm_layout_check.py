"""Cross-checks the scan-segment layout against every arch config (the
port of ``repro.core.lm_layout_check``, over the port's ``layer_specs``,
which gives an enc-dec decoder its cross attention from the config)."""
from repro_torch.configs import get_config, list_archs
from repro_torch.models.lm import build_layout, layer_specs


def verify_layouts():
    for arch in list_archs():
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            specs = layer_specs(cfg)
            layout = build_layout(cfg, specs)
            n = sum(len(e[1]) if e[0] == "unroll" else len(e[1]) * e[2]
                    for e in layout)
            assert n == cfg.n_layers, (arch, reduced, layout)
            # kimi: dense prefix unrolled
            if cfg.ffn_kind == "moe" and cfg.moe.first_dense_layers:
                assert layout[0][0] == "unroll"
                assert layout[0][1][0].ffn != "moe"
            # recurrentgemma: periodic body + tail
            if len(cfg.block_pattern) > 1:
                kinds = [e[0] for e in layout]
                assert "scan" in kinds
    return True
