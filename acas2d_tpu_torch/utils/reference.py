"""Locating the upstream reference checkout (sprites, parity artifacts).

Counterpart of `acas2d_tpu/utils/reference.py`.  The rendering's sprites
(`render.load_sprites`), the replay window's icon and the analysis
overlay (`analysis.REF_EVALS`) read files committed in the reference
repository.  Set ``ACAS2D_REFERENCE_DIR`` to its checkout; without it the
port looks in a `reference/` directory at the root of this repository
(the JAX package's default lies outside the checkout).  Consumers degrade
gracefully when the directory or a file is absent: the sprites become
geometric markers, the icon and the overlay are left out.
"""

from __future__ import annotations

import os

DEFAULT_REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "reference")


def reference_dir() -> str:
    """Root of the reference checkout (``ACAS2D_REFERENCE_DIR`` overrides)."""
    return os.environ.get("ACAS2D_REFERENCE_DIR", DEFAULT_REFERENCE_DIR)


def reference_path(*parts: str) -> str:
    """Join path components under :func:`reference_dir`."""
    return os.path.join(reference_dir(), *parts)
