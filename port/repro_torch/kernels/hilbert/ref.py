"""Plain PyTorch version of the Hilbert kernel: the core twin."""
from ...core.hilbert import hilbert_keys, quantize, xy2d  # noqa: F401


def encode(gx, gy, order: int):
    """(N,) int32 grid coords -> (N,) int64 curve index."""
    return xy2d(gx, gy, order)
