"""Scripts of the port, each runnable as ``python -m nislam_torch.scripts.<name>``."""
