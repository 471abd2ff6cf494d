from .metrics import compute_map, csv_eval_ap, psnr

__all__ = ["compute_map", "csv_eval_ap", "psnr"]
