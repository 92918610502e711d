"""Roofline terms of a step on the NVIDIA H100: ``H100``'s constants, the
ring model of collective bytes, and the op counter that stands in for the
reference's HLO walk (``op_cost``)."""
from repro_torch.roofline.analysis import (
    H100,
    HW,
    collective_bytes_from_log,
    roofline_terms,
)

__all__ = ["HW", "H100", "collective_bytes_from_log", "roofline_terms"]
