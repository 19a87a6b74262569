"""Query executors over staged layouts: range and kNN."""
