"""The one place the port chooses its device.

Everything below the CLI receives the ``torch.device`` chosen here: the
pipeline, the pair scorer and the kernels' wrappers never pick one
themselves.
"""

from __future__ import annotations

import torch


def select_device(requested=None) -> torch.device:
    """The device to run on.

    ``requested`` may be None, a string ("cpu", "cuda", "cuda:1") or a
    ``torch.device``.  With nothing requested the first CUDA card is used
    when one is present, otherwise the CPU.  Asking for CUDA on a machine
    without a card raises instead of running on the CPU.
    """
    if requested is None:
        return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    dev = torch.device(requested)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available on this machine")
        if dev.index is None:
            dev = torch.device("cuda:0")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {requested!r} (use cpu or cuda)")
