"""Row-partitioned multi-partition training (``dist.py``)."""
