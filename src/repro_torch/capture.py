"""What the compiled serving step (``serve.graphs``) and the compiled train
step (``train.graphs``) share: the rule that decides whether a step is
captured as a CUDA graph, and the stream on which every graph is captured.
"""

from __future__ import annotations

import functools
from typing import Any

import torch


def resolve_compile(compile: Any, device: torch.device,
                    ranks: int = 1) -> bool:
    """Whether an engine or trainer on ``device`` replays a captured step:
    ``"auto"`` on a CUDA device, ``True`` (a CUDA device or ValueError),
    ``False`` never.  A train step across ``ranks`` > 1 (under an ambient
    mesh: context parallelism, ``train.loop``) runs eagerly: ``"auto"`` is
    eager and ``True`` raises.  Its collectives go through host copies on
    ``gloo``, which a CUDA graph cannot record; the captured step across
    ranks on ``nccl`` is ROADMAP Queue 1 item 10(e)."""
    if ranks > 1 and compile in ("auto", False):
        return False
    if ranks > 1 and compile is True:
        raise NotImplementedError(
            f"compile=True across {ranks} ranks: the step across a mesh runs "
            f"eagerly; its capture on nccl is ROADMAP Queue 1 item 10(e)")
    if compile == "auto":
        return device.type == "cuda"
    if compile is True:
        if device.type != "cuda":
            raise ValueError(f"compile=True needs a CUDA device (the step is "
                             f"captured as a CUDA graph), got {device}")
        return True
    if compile is False:
        return False
    raise ValueError(f"compile must be 'auto', True or False, got "
                     f"{compile!r}")


@functools.lru_cache(maxsize=None)
def side_stream(index: int) -> torch.cuda.Stream:
    """The one stream of device ``index`` on which every graph warms up and
    is captured: the allocator hands a freed block again only on the
    stream it was allocated on, so graphs that share a memory pool reuse
    each other's blocks only if they were captured on one stream."""
    return torch.cuda.Stream(torch.device("cuda", index))
