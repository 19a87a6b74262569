"""Query executors: range and kNN over staged layouts, and the spatial
join (tile joins, dedup, the join engine)."""
