from .step import Spec, StepParams, make_params, sample_geom_minus1
from . import board
from . import cuda_board
from . import cuda_lowered

__all__ = ["Spec", "StepParams", "make_params", "sample_geom_minus1",
           "board", "cuda_board", "cuda_lowered"]
