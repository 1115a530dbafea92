"""Data parallelism over a device mesh: one process per device
(torch.distributed), the batch split over the ranks (mesh.py), each rank
feeding its own rows (hostdata.py)."""
