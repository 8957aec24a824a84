"""Wrapper of the matmul kernel, with the call contract of
``repro.kernels.matmul.ops.matmul_op``: (M,K) @ (K,N) with an fp32
accumulator, output in the input dtype. A CUDA tensor launches
``csrc/matmul.cu`` on the current stream; a CPU tensor runs
:func:`matmul_ref`.

The bf16 instance reads its tiles with TMA, which needs 16-byte row
strides and bases: :func:`pad_operands` copies an operand whose row is
not a multiple of 8 elements (or whose base is misaligned) into zeroed
scratch with its rows padded to a multiple of 8, as the reference's
wrapper pads to its blocks. The kernel reads only the true (M, K, N)
extent and writes the (M, N) output, so nothing is sliced back.
4096³ never pads. The fp32 instance masks ragged edges in the kernel and
pads nothing."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.matmul.ref import matmul_ref

NAME = "matmul"
#: bf16 elements in 16 bytes: TMA's unit for row strides and bases
TMA_ELEMS = 8


def tma_padding(K, N):
    """(Kp, Np): the row lengths of x and y that the bf16 kernel reads
    through TMA, K and N rounded up to a multiple of 8."""
    return common.round_up(K, TMA_ELEMS), common.round_up(N, TMA_ELEMS)


def pad_operands(x, y):
    """x (M,K), y (K,N) → (xp, yp) with rows of Kp and Np elements
    (:func:`tma_padding`) on 16-byte-aligned bases. An operand that
    already fits is returned as it is; any other is copied into
    ``torch.zeros`` of shape (M, Kp) or (Kp, Np), so the padding adds
    zeros to the product: ``(xp @ yp)[:M, :N] == x @ y``."""
    M, K = x.shape
    N = y.shape[1]
    Kp, Np = tma_padding(K, N)

    def fit(t, rows, cols):
        if t.shape == (rows, cols) and t.data_ptr() % 16 == 0:
            return t
        buf = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
        buf[:t.shape[0], :t.shape[1]] = t
        return buf

    if Kp == K and Np == N:
        return fit(x, M, K), fit(y, K, N)
    return fit(x, M, Kp), fit(y, Kp, Np)


def matmul_op(x, y):
    require = common.require
    require(x.dim() == 2 and y.dim() == 2 and x.shape[1] == y.shape[0],
            f"bad matmul shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    require(x.dtype == y.dtype, "x/y dtypes differ")
    if common.on_cpu(x, y):
        return matmul_ref(x, y)
    common.check_contiguous(x=x, y=y)
    M, K = x.shape
    N = y.shape[1]
    dt = common.dtype_code(x)
    if x.dtype == torch.bfloat16:
        x, y = pad_operands(x, y)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = common.entry(NAME, "matmul", "pppiiiiiip")
    code = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), M, K, N,
              x.shape[1], y.shape[1], dt, common.stream_of(x))
    common.check(code, "matmul")
    common.LAUNCHES[NAME] += 1
    return out
