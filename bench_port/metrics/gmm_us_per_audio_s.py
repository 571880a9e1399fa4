"""Device microseconds of the acoustic scoring (`asr/am/gmm.loglik`, CUDA
events around the call) per second of audio served in the window."""


def read(ctx):
    if "am.gmm" not in ctx.spans:
        return None
    return ctx.spans["am.gmm"] / ctx.audio_s * 1e6
