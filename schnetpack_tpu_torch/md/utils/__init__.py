from .normal_modes import (
    NormalModeTransformer, normal_mode_frequencies, normal_mode_matrix,
)
from .thermostat_utils import (
    GLEMatrixParser, YSWeights, load_gle_matrices, ys_weights,
)

__all__ = [
    "NormalModeTransformer", "normal_mode_frequencies", "normal_mode_matrix",
    "GLEMatrixParser", "YSWeights", "load_gle_matrices", "ys_weights",
]
