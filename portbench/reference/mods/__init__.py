# Frozen copy of mods_tpu_torch/__init__.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""PyTorch/CUDA port of the MODS two-view matcher.

The JAX package `mods_tpu` beside this one is the reference; this
package imports neither it nor JAX.  Entry points take `device=` and run
on the CUDA card unless the caller asks for "cpu"; every kernel that the
JAX package wrote in Pallas is a CUDA C++ kernel here
(`ops/patch_kernels.py`, `csrc/patch_kernels.cu`), with a plain PyTorch
version beside it that is the CPU path.
"""
import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent;
    nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
    return dev


# The matmul precision and cuDNN's TF32 switch inside `full_float32`: the
# port's ("highest", False), which the reference keeps.  The lower-precision
# control (portbench/readings.py) sets ("high", True): TF32 on the card.
PRECISION = {"matmul": "highest", "cudnn_tf32": False}


@contextlib.contextmanager
def full_float32():
    """TF32 off for the matmuls and convolutions run inside, so that the
    port's path computes in full float32; the caller's settings come back
    on exit.  Usable as a decorator."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision(PRECISION["matmul"])
    torch.backends.cudnn.allow_tf32 = PRECISION["cudnn_tf32"]
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
