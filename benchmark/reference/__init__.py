"""The plain float32 reference of the benchmark (``las_ref.py``)."""
