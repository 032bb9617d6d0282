"""parallel of the PyTorch port (see ``parallel/mesh.py``)."""
