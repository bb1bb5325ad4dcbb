"""runtime subpackage: the scripted rank faults of elastic serving."""
