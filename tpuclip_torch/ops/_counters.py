"""Launch counters of the kernel wrappers.

Every wrapper that launches a kernel is registered with :func:`counted`,
which gives it a ``launches`` attribute, starting at 0, that the wrapper
raises by one where it launches its kernel and nowhere else.
:data:`COUNTED` lists the registered wrappers, so code that runs wrappers
without their kernels running (a CUDA graph capture) can take those counts
back and add them again when the kernels do run, without naming any.
"""

from __future__ import annotations

from typing import Callable, List

COUNTED: List[Callable] = []


def counted(wrapper: Callable) -> Callable:
    """Registers ``wrapper`` in :data:`COUNTED` with ``launches = 0``."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper
