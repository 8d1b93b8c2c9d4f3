"""flipcomplexityempirical_tpu_torch — the flip-walk sampler in PyTorch and
CUDA for NVIDIA Hopper.

The port of ``flipcomplexityempirical_tpu`` (which stays the reference):
batched 2-district single-node-flip chains on a plain rook grid, with the
chunk of steps in a hand-written CUDA kernel (``kernel/cuda_board.py``,
``csrc/board_chunk.cu``) and the bookkeeping around it in PyTorch. Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``,
where every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from . import graphs  # noqa: F401
from . import kernel  # noqa: F401
from . import sampling  # noqa: F401
from .kernel import Spec  # noqa: F401
from .sampling import init_board, run_board_cuda  # noqa: F401
