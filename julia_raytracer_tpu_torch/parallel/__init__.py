"""Multi-process rendering and training on torch.distributed: pixel lanes
split over the process group, the scene replicated on every process."""
