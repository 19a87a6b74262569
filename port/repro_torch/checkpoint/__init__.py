"""Atomic checkpoints of logical shapes (twin of ``repro.checkpoint``)."""
