"""The fault-tolerant training loop (twin of ``repro.ft``)."""
