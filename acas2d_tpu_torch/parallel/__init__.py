"""Training over several processes (torch.distributed): `mesh.py`."""
