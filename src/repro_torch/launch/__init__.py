"""launch subpackage: the serving driver (``python -m
repro_torch.launch.serve``), the training driver (``python -m
repro_torch.launch.train``) and their step functions (``steps``)."""
