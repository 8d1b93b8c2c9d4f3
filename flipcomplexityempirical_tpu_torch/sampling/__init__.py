from .runner import RunResult, pop_bounds
from .board_runner import init_board, run_board
from .cuda_runner import run_board_cuda

__all__ = ["RunResult", "pop_bounds", "init_board", "run_board",
           "run_board_cuda"]
