"""Seconds of audio whose outputs completed in the window, over the
window's wall time (host clock, from the first dispatch to the last
completion)."""


def read(ctx):
    return ctx.audio_s / ctx.window_s
