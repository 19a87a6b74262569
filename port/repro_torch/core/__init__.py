"""Core library: geometry, the Hilbert curve, partitioning, MASJ
assignment, the paper's metrics and cost model, sampling and
placement."""
