"""Roofline math on the H100's constants (``roofline.py``) and the
per-rank analysis of a traced torch program (``hlo.py``, the counterpart of
the reference's HLO walk) that ``make_report`` and the dry run read."""
from .hlo import CollectiveStats, count_op, parse_collectives
from .roofline import (
    HBM_BW, ICI_BW, PEAK_FLOPS, RooflineReport, analytic_model_flops,
    load_reports, make_report, save_reports,
)

__all__ = [k for k in dir() if not k.startswith("_")]
