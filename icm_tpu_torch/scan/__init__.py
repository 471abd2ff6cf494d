from .zigzag import inverse_order, zigzag_merge, zigzag_order, zigzag_split

__all__ = ["inverse_order", "zigzag_merge", "zigzag_order", "zigzag_split"]
