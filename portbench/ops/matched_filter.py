"""``matched_filter_device`` on one (T + 2, 2, h) input: row 0 the data's
spectrum s̃, row 1 its PSD, rows 2 … the templates (data/gw_segment.py).
Returns ρ's valid window as (re, im), (T, L)."""

from ..work.matched_filter import layout


def call(port, x, params):
    lay = layout(x.shape, params)
    (snr_r, snr_i), _, _ = port.matched_filter_device(
        x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0], delta_f=lay["delta_f"],
        kmin=lay["kmin"], valid=(lay["start"], lay["stop"]))
    return snr_r, snr_i
