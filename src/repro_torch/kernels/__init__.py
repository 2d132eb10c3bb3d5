"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``mxv``), and the torch oracles (``ref``).

Each kernel module counts its wrapper's launches in a ``LAUNCHES`` dict;
:func:`launch_counts`, :func:`add_launches` and :func:`launches_apart`
read and move all of them at once."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

from . import (adamw, conv2d, decode_attn, decode_attn_int8, flash_attn,
               mamba_scan, mxv)

# the kernels' launch counters; their keys are unique across the modules
_COUNTERS = (mxv.LAUNCHES, conv2d.LAUNCHES, flash_attn.LAUNCHES,
             decode_attn.LAUNCHES, decode_attn_int8.LAUNCHES,
             mamba_scan.LAUNCHES, adamw.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, by name."""
    out: Dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (launches by kernel name) to the kernels' counters."""
    for counter in _COUNTERS:
        for name in counter:
            counter[name] += delta.get(name, 0)


@contextlib.contextmanager
def launches_apart(into: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """The launches counted inside the block are added to ``into`` (by
    kernel name) and taken out of the kernels' counters again."""
    before = launch_counts()
    try:
        yield into
    finally:
        after = launch_counts()
        for counter in _COUNTERS:
            for name in counter:
                into[name] = into.get(name, 0) + after[name] - before[name]
                counter[name] = before[name]
