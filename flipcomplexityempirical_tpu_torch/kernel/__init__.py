from .step import Spec, StepParams, make_params, sample_geom_minus1
from . import board
from . import cuda_board

__all__ = ["Spec", "StepParams", "make_params", "sample_geom_minus1",
           "board", "cuda_board"]
