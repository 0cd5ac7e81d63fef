"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and there is no card.

    On CUDA it also turns TF32 off for matmuls and cuDNN convolutions: cuDNN
    runs f32 convolutions in TF32 by default (about three decimal digits),
    and the port computes the CNN task in full f32, as the reference does.
    And it asks cuDNN for deterministic algorithms: its default weight
    gradient differs from call to call in the last bits, which is enough to
    change which chunks of two models are bitwise equal, and so what the
    bank's dedup saves; with it two calls of a path give the same floats.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the host"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
