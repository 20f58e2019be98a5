"""Path-or-file-object plumbing shared by the binary codecs (copy of the
JAX package's ``io/_fileobj.py``).

The PLY and STL codecs accept either a filesystem path (opened and closed
here) or an already-open binary file object, which stays the caller's.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def binary_sink(path_or_file):
    """Yield a binary writable for a path or an already-open file object
    (only paths are opened and closed here)."""
    if hasattr(path_or_file, "write"):
        yield path_or_file
    else:
        with open(path_or_file, "wb") as f:
            yield f


@contextlib.contextmanager
def binary_source(path_or_file):
    """Yield a binary readable for a path or an already-open file object."""
    if hasattr(path_or_file, "read"):
        yield path_or_file
    else:
        with open(path_or_file, "rb") as f:
            yield f
