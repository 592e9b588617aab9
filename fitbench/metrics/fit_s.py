"""Time to a fitted model: the window's length over the fits completed in
it (host clock)."""


def read(ctx):
    return ctx.window_s / len(ctx.fit_s) if ctx.fit_s else None
