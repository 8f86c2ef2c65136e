from .checkpoint import Checkpointer, is_orbax_path, read_state_dict
from .orbax import load_orbax

__all__ = ["Checkpointer", "is_orbax_path", "load_orbax", "read_state_dict"]
