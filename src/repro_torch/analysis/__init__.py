"""Roofline math on the H100's constants (``roofline.py``). The reference's
HLO walk (``analysis/hlo.py``) and ``make_report``, which read XLA's
compiled programs, wait for ROADMAP.md §1 item 11b."""
from .roofline import (
    HBM_BW, ICI_BW, PEAK_FLOPS, RooflineReport, analytic_model_flops,
    load_reports, save_reports,
)

__all__ = [k for k in dir() if not k.startswith("_")]
