"""Distributed runtime of the port: the sharding rules and their DTensor
layouts (`sharding.py`), the elastic training loop (`elastic.py`),
gradient compression (`compression.py`), the collective planner
(`collectives.py`), and the dry run's per-device counts
(`trace_analysis.py`) and roofline terms (`roofline.py`)."""
