"""flipcomplexityempirical_tpu_torch — the flip-walk sampler in PyTorch and
CUDA for NVIDIA Hopper.

The port of ``flipcomplexityempirical_tpu`` (which stays the reference):
batched 2-district single-node-flip chains, with the chunk of steps in a
hand-written CUDA kernel and the bookkeeping around it in PyTorch. Three
paths: ``run_board`` (the lowered body: ``lower/stencil.py``,
``kernel/cuda_lowered.py``, ``csrc/lowered_chunk.cu``) runs the paper's
experiment graphs (sec11, the Frankengraph, the triangular lattice),
every ``record_interface`` spec and plain rook grids of up to 4096 cells,
draw for draw as the JAX package's ``run_board``; ``run_board_cuda``
(``kernel/cuda_board.py``, ``csrc/board_chunk.cu``, the Pallas kernel's
twin) runs a plain rook grid on the port's own Philox stream; and the
general path, ``sampling.init_batch`` / ``sampling.run_chains`` on any
sparse graph (the hexagonal lattice; ``kernel/dense.py``,
``kernel/cuda_dense.py``, ``csrc/general_dense_chunk.cu``, and the legacy
re-propose body of ``kernel/step.py`` as torch ops), draw for draw as the
JAX package's ``run_chains``. The paper's sweeps run end to end
through ``experiments`` (``run_config``, ``run_sweep`` and the CLI
``python -m flipcomplexityempirical_tpu_torch.experiments``), the sweep
service (``service``, ``python -m flipcomplexityempirical_tpu_torch.
service``) runs a sweep's fingerprint-equal configs as one batch of
chains, and ``python -m flipcomplexityempirical_tpu_torch.bench`` is the
port of the root ``bench.py``'s board and general paths. Summary mode
(``stats``: ``analytics=`` on the runners, ``analytics='summary'`` in the
driver) folds each chunk's rows on the card (``kernel/cuda_summary.py``,
``csrc/summary_fold.cu``) instead of copying the history to the host.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, where every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from . import graphs  # noqa: F401
from . import lower  # noqa: F401
from . import kernel  # noqa: F401
from . import sampling  # noqa: F401
from . import experiments  # noqa: F401
from . import service  # noqa: F401
from .kernel import Spec  # noqa: F401
from .sampling import init_board, run_board, run_board_cuda  # noqa: F401
