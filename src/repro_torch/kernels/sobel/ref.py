"""Plain PyTorch version of the Sobel kernel: the CPU path of
``ops.sobel_op`` and the yardstick the CUDA kernel is held against."""
import torch
import torch.nn.functional as F

_GX = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
_GY = ((-1, -2, -1), (0, 0, 0), (1, 2, 1))


def sobel_ref(x):
    """x (H, W) → sqrt(gx² + gy²) over the zero-padded image, in fp32,
    output in the input dtype (the reference's tap order)."""
    H, W = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    gx = torch.zeros((H, W), dtype=torch.float32, device=x.device)
    gy = torch.zeros_like(gx)
    for dy in range(3):
        for dx in range(3):
            win = xp[dy:dy + H, dx:dx + W]
            gx = gx + _GX[dy][dx] * win
            gy = gy + _GY[dy][dx] * win
    return torch.sqrt(gx * gx + gy * gy).to(x.dtype)
