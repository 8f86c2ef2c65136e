from .checkpoint import Checkpointer, is_orbax_path

__all__ = ["Checkpointer", "is_orbax_path"]
