"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A share is
stated against these, with the card's power limit printed beside it."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12          # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops, nbytes, flops_peak=BF16_FLOPS):
    """The least time the work can take on the card: its operations at
    ``flops_peak`` or its bytes at the memory rate, whichever is
    longer."""
    return max(flops / flops_peak, nbytes / HBM_BYTES_PER_S)
