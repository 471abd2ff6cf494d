from .zigzag import inverse_order, zigzag_merge, zigzag_order, zigzag_split, zigzag_split_tokens

__all__ = ["inverse_order", "zigzag_merge", "zigzag_order", "zigzag_split",
           "zigzag_split_tokens"]
