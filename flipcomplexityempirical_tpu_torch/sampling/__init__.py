from .runner import RunResult, init_batch, pop_bounds, run_chains
from .board_runner import init_board, run_board
from .cuda_runner import run_board_cuda

__all__ = ["RunResult", "pop_bounds", "init_batch", "run_chains",
           "init_board", "run_board", "run_board_cuda"]
