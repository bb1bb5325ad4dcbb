"""launch subpackage: the serving driver (``python -m
repro_torch.launch.serve``), the training driver (``python -m
repro_torch.launch.train``), their step functions and abstract cells
(``steps``), the meshes (``mesh``), and the dry run of the production
cells (``python -m repro_torch.launch.dryrun``) with its op-level
analyzer (``op_analysis``) and roofline (``roofline``)."""
