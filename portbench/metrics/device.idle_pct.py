"""device.idle_pct: % of the traced frames' wall time in which no
operation ran on the card: 100 (1 - union of the device intervals /
wall). Layer: device. Moves frame_ms."""


def read(ctx):
    rep = ctx["trace"]
    if rep is None:
        return None
    return 100.0 * (1.0 - rep["busy_s"] / rep["window_s"])
