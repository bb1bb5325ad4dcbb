"""runtime subpackage: the scripted rank faults of elastic serving and
the moves between meshes (``reshard``, ``shrink_mesh``)."""
