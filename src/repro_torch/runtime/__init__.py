"""runtime subpackage: the fault-tolerant training loop, the scripted rank
faults of elastic serving and the moves between meshes (``reshard``,
``shrink_mesh``)."""
