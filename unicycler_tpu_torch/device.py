"""Device choice for the package's entry points.

Entry points take `device=None`, which means CUDA. Without a CUDA device
they raise instead of quietly running on the CPU; the CPU route runs only
when the caller asks for it with device='cpu'.
"""

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device available; pass device="cpu" to run the '
                'CPU route')
        return dev
    if dev.type == 'cpu':
        return dev
    raise ValueError('unsupported device %r (use "cuda" or "cpu")'
                     % (device,))
