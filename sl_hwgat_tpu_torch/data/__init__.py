"""Host-side data pipeline of the port (NumPy/SciPy keypoint transforms)."""
