from havac_tpu_torch.validation.nhmmer import (
    ContainmentReport,
    NhmmerWindow,
    compare_containment,
    engine_hits_for_comparison,
    load_tblout,
    parse_tblout,
)
from havac_tpu_torch.validation.quantization import (
    QuantizationReport,
    diagonal_scores_float,
    diagonal_scores_int8,
    quantization_report,
)
from havac_tpu_torch.validation.ssv_filter import (
    float_projected_scores,
    float_ssv_crossings,
    float_ssv_windows,
)

__all__ = [
    "ContainmentReport",
    "NhmmerWindow",
    "QuantizationReport",
    "compare_containment",
    "diagonal_scores_float",
    "diagonal_scores_int8",
    "engine_hits_for_comparison",
    "float_projected_scores",
    "float_ssv_crossings",
    "float_ssv_windows",
    "load_tblout",
    "parse_tblout",
    "quantization_report",
]
