"""The data-parallel group of the mesh step that is updating, if any.

The mesh steps of ``parallel/mesh.py`` open an :func:`activated` block
while they update; the update hooks of the algorithm code
(``algorithm/optim.py``, ``algorithm/modelfree/onpolicy.py``) read
:func:`active_data_parallel`, so that they need not import the mesh layer.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator
from typing import Any

#: the open blocks' groups, innermost last
_ACTIVE: list[Any] = []


def active_data_parallel() -> Any:
    """The ``parallel.mesh.DataParallel`` of the mesh step that is updating, or ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def activated(dp: Any) -> Iterator[Any]:
    """``dp`` is :func:`active_data_parallel` inside the block."""
    _ACTIVE.append(dp)
    try:
        yield dp
    finally:
        _ACTIVE.pop()
