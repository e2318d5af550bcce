"""Multi-partition training: row-partitioned (``dist.py``, ``dist_halo.py``,
``dist_gat.py``) and column-parallel (``dist_col.py``)."""
