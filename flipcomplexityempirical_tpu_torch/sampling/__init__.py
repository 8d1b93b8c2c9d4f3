from .runner import RunResult, init_batch, pop_bounds, run_chains
from .board_runner import init_board, run_board
from .cuda_runner import run_board_cuda
from .recom import recom_move, run_recom
from .tempered import (TemperResult, init_tempered, per_rung_history,
                       run_tempered)

__all__ = ["RunResult", "pop_bounds", "init_batch", "run_chains",
           "init_board", "run_board", "run_board_cuda", "TemperResult",
           "init_tempered", "run_tempered", "per_rung_history", "recom_move",
           "run_recom"]
