"""device_idle_pct: the share of the traced window that no kernel, copy or
fill covers on the card (one minus the union of their intervals over
the window); on several cards, the idlest rank's."""


def read(run):
    return max(100.0 * (1.0 - r["trace"]["busy_s"] / r["trace"]["window_s"])
               for r in run["ranks"])
