from .metrics import psnr

__all__ = ["psnr"]
