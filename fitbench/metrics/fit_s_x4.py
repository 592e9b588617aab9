"""Time to a fitted model on four cards: the window's length over the fits
completed in it, on the first rank's host clock. Each fit runs from the
call on every rank until its answer is there (the fit's last collective
gathers the ranks' iterates)."""


def read(ctx):
    return ctx.window_s / len(ctx.fit_s) if ctx.fit_s else None
