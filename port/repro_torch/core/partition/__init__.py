"""Spatial partitioning + MASJ assignment (this slice: ``bsp``)."""
from . import api, assign, bsp  # noqa: F401  (registration)
from .api import Partitioning, partition  # noqa: F401
