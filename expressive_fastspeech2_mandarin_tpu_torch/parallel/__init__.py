"""Data-parallel training over processes (``torch.distributed``); the JAX
package's ``parallel/``."""

from .mesh import (
    Layout,
    all_reduce_,
    default_backend,
    initialize_distributed,
    make_layout,
    replicated,
)

__all__ = ["Layout", "all_reduce_", "default_backend",
           "initialize_distributed", "make_layout", "replicated"]
