from .slots import pad_to_slots

__all__ = ["pad_to_slots"]
