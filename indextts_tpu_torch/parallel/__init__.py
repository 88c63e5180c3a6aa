"""Multi-device execution of the port over torch.distributed (parallel/mesh.py)."""
