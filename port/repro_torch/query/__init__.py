"""Query executors over staged layouts (this slice: range)."""
