"""Condition annotators of the PyTorch port: canny (`canny.py`), HED edges
(`hed.py`), MiDaS DPT depth and normals (`midas.py`), UniFormer-S/UperNet
ADE20k segmentation (`uniformer.py`), M-LSD lines (`mlsd.py`), OpenPose
skeletons (`openpose.py`) and the image utilities (`util.py`)."""
