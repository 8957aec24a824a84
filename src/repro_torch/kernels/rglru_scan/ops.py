"""Wrapper of the RG-LRU scan kernel, with the call contract of
``repro.kernels.rglru_scan.ops.rglru_scan_op``: fp32 ``a``, ``b``
(B, S, D) and ``h0`` (B, D) → ``h`` (B, S, D), any S and D, and a
gradient.

A CUDA tensor launches ``csrc/rglru_scan.cu`` on the current stream (the
kernel masks ragged S and D itself: no padding copy like the reference
wrapper's ``a=1, b=0``); a CPU tensor runs :func:`rglru_scan_ref`. The
kernel keeps the serial order of the recurrence, so its output is
bit-equal to the plain version's. Its tile (16 channels a CTA) and its
ring of stages are constants of the kernel source, the same at every
shape.

Both devices go through one ``torch.autograd.Function``. The scan's
adjoint is itself a linear recurrence, run backwards in time: with
λ_t = g_t + a_{t+1} λ_{t+1} (λ_{S-1} = g_{S-1}),
da_t = λ_t h_{t-1} (h_{-1} = h0), db_t = λ_t and dh0 = a_0 λ_0. So the
backward is one more scan over the time-reversed inputs
(``flip(cat(a[:, 1:], 0))``, ``flip(g)``, a zero h0): on the card one
more launch of the same kernel, in fp32, and no loop in Python. The
reference has no backward Pallas kernel (it trains through
``jax.lax.associative_scan``); the recurrence is the same, the order of
its sums differs."""
import torch

from repro_torch.kernels import common
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

NAME = "rglru_scan"


def rglru_scan_op(a, b, h0):
    require = common.require
    require(a.dim() == 3 and b.shape == a.shape
            and h0.shape == (a.shape[0], a.shape[2]),
            f"rglru_scan takes a, b (B,S,D) and h0 (B,D), got "
            f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(h0.shape)}")
    require(a.dtype == b.dtype == h0.dtype == torch.float32,
            "rglru_scan takes fp32 a, b and h0")
    return _Scan.apply(a, b, h0)


class _Scan(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU), saving a, h and
    h0. Backward: the reversed scan above, through the same dispatch."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        lam = _scan(a_next.flip(1).contiguous(), g.flip(1).contiguous(),
                    torch.zeros_like(h0)).flip(1)
        h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
        return lam * h_prev, lam, a[:, 0] * lam[:, 0]


def _scan(a, b, h0):
    """The forward recurrence on the inputs' device."""
    where = common.path(a, b, h0)
    if where == "cpu":
        return rglru_scan_ref(a, b, h0)
    h = torch.empty_like(a) if where == "meta" else _kernel(a, b, h0)
    common.record(NAME, 0, (a, b, h0), (h,))
    return h


def _kernel(a, b, h0):
    require = common.require
    B, S, D = a.shape
    require(B > 0 and S > 0 and D > 0, "empty scan")
    common.check_contiguous(a=a, b=b, h0=h0)
    out = torch.empty_like(a)
    fn = common.entry(NAME, "rglru_scan", "ppppiiip")
    code = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), B,
              S, D, common.stream_of(a))
    common.check(code, "rglru_scan")
    common.LAUNCHES[NAME] += 1
    return out
