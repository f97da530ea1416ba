"""parallel layer of the PyTorch port: sharding over several devices (see ``mesh.py``)."""
