"""Share of the traced window in which no operation ran on the card, in
% (from the device trace of the window's first jobs)."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
