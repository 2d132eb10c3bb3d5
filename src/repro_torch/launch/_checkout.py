"""Another checkout's ``repro_torch``, imported beside this one, so that a
timing script can run both in one process on one card."""

from __future__ import annotations

import importlib
import importlib.util
import pathlib
import sys


def load_other(src: str, *modules: str):
    """The ``modules`` (dotted names under the package, such as
    ``"kernels.mamba_scan"``) of the ``repro_torch`` under ``src``,
    imported as the package ``other_repro_torch`` (its kernels use relative
    imports only, and build into that checkout's own ``build/``)."""
    root = pathlib.Path(src).resolve() / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", root / "__init__.py",
        submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"other_repro_torch.{m}")
                 for m in modules)
