"""Launch drivers of the port (the counterpart of ``repro.launch``): the
batched serving loop, ``python -m repro_torch.launch.serve``."""
