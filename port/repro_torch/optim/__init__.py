"""The optimizer (twin of ``repro.optim``): AdamW."""
