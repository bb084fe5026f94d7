"""Where the port's entry points run: the card unless the caller says
otherwise. There is no silent fallback to the CPU — a serving path that
quietly ran on the host would still answer, only hundreds of times
slower, and nothing would say so."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the first CUDA device and raises when there is none;
    anything else (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is taken
    as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port's entry points run on "
                "the card unless the caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def generator(seed: int, device: torch.device) -> torch.Generator:
    """An explicit seeded generator on ``device`` (the port never draws
    from torch's global generator)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g

