"""Condition annotators of the PyTorch port: MiDaS DPT depth and normals
(`midas.py`) and canny edges (`canny.py`)."""
