"""Core library: geometry, partitioning and MASJ assignment."""
