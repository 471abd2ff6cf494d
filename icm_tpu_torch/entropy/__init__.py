from .base import (
    EntropyTables,
    dequantize,
    pmf_to_cdf_rows,
    pmf_to_quantized_cdf_np,
    quantize,
)
from .bottleneck import EntropyBottleneck, eb_tables_from_pmf_data
from .gaussian import (
    SCALES_LEVELS,
    SCALES_MAX,
    SCALES_MIN,
    GaussianConditional,
    build_indexes,
    gc_build_tables,
    get_scale_table,
)

__all__ = [
    "EntropyTables",
    "dequantize",
    "pmf_to_cdf_rows",
    "pmf_to_quantized_cdf_np",
    "quantize",
    "EntropyBottleneck",
    "eb_tables_from_pmf_data",
    "GaussianConditional",
    "build_indexes",
    "gc_build_tables",
    "get_scale_table",
    "SCALES_MIN",
    "SCALES_MAX",
    "SCALES_LEVELS",
]
