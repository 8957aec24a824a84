"""PyTorch/CUDA port of ``repro``: the serving main path (``qwen1.5-0.5b``
through ``ServeEngine`` over MMU-leased paged KV memory) with
hand-written Hopper kernels under ``kernels/``.

The package imports nothing of ``repro`` and never ``jax``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; a CUDA tensor
always goes through its kernel, a CPU tensor through the kernel's plain
PyTorch version.
"""
