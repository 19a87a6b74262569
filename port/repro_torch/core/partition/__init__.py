"""The paper's six spatial partitioning algorithms + MASJ assignment."""
from . import (  # noqa: F401  (registration)
    api, assign, bos, bsp, fg, hc, slc, str_)
from .api import Partitioning, info, methods, partition  # noqa: F401
from .assign import partition_counts  # noqa: F401
