"""Statistics over a run's results: the host estimators (numpy copies of
the JAX package's ``diagnostics``, ``bottleneck``, ``partisan`` and
``compactness``), their on-device twins (``device``), and the summary
accumulator that summary-mode runs fold their rows into on the card
(``accumulators``; ``DeviceAnalytics`` is what the runners take as
``analytics=``)."""

from . import partisan
from .diagnostics import (
    autocorrelation, integrated_autocorr_time, ess, gelman_rubin,
    autocorr_mixing_time, round_trips, well_crossings,
)
from .bottleneck import conductance_profile, bottleneck_ratio
from .partisan import (
    district_vote_tallies, mean_median, efficiency_gap, seats_won,
)
from .compactness import polsby_popper, cut_edge_count, perimeter_area
from .device import (bottleneck_ratio_device,
                     conductance_profile_device, ess_device,
                     gelman_rubin_device, integer_thresholds)
from .accumulators import (
    SummaryAcc, init_summary, fold_out, fold_block, summary,
    summary_nbytes, summary_host, summary_diagnostics, summary_allreduce,
    BufferMirror, DeviceAnalytics,
)

__all__ = [
    "partisan",
    "SummaryAcc", "init_summary", "fold_out", "fold_block", "summary",
    "summary_nbytes", "summary_host", "summary_diagnostics",
    "summary_allreduce", "BufferMirror", "DeviceAnalytics",
    "autocorrelation", "integrated_autocorr_time", "ess", "ess_device",
    "bottleneck_ratio_device", "conductance_profile_device",
    "gelman_rubin_device", "integer_thresholds", "gelman_rubin",
    "autocorr_mixing_time", "round_trips", "well_crossings",
    "conductance_profile", "bottleneck_ratio",
    "district_vote_tallies", "mean_median", "efficiency_gap", "seats_won",
    "polsby_popper", "cut_edge_count", "perimeter_area",
]
