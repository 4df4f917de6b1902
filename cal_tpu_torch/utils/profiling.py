"""Roofline accounting of the sparse aggregate on the card.

Counterpart of cal_tpu/utils/profiling.py's ``spmm_roofline`` with the TPU
peak table replaced by the H100 SXM's HBM rate (NVIDIA's data sheet).  The
one-hot MXU accounting of ``spmm_roofline`` (tile counts, ``pct_mxu_peak``)
measures a TPU mechanism and is not carried over.
"""
from __future__ import annotations

H100_SXM_HBM_GBPS = 3350.0


def spmm_roofline(num_live_edges: float, hidden: int, seconds: float) -> dict:
    """Edges/s of one SpMM invocation over ``num_live_edges`` and its share
    of the HBM floor: one read of the gathered rows and one write of the
    output rows, ~2 * E * H * 4 bytes (cal_tpu's definition, f32 rows)."""
    out = {"edges_per_s": num_live_edges / seconds}
    gbps_floor = 2.0 * num_live_edges * hidden * 4.0 / seconds / 1e9
    out.update(hbm_gbps_floor=gbps_floor,
               pct_hbm_floor=100.0 * gbps_floor / H100_SXM_HBM_GBPS)
    return out
