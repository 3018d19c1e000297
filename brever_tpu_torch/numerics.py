"""The numeric configuration the port runs in on the card.

PyTorch runs cuDNN's float32 convolutions in TF32 by default, which keeps
about three decimal digits. The port's parity bounds, and every time in
PERF.md, hold for full float32: :func:`disable_tf32` sets that, and the
entry points call it (the trainer, the service, both profilers and
``chip_smoke.py``), so that what runs is what was measured.
"""

import torch


def disable_tf32():
    """TF32 off for cuBLAS's matrix products and cuDNN's convolutions
    (process-wide ``torch.backends`` flags)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
