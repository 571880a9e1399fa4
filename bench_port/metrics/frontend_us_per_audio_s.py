"""Device microseconds of the front end (the MVDR weights, the fused
analysis + beamform, the synthesis, MFCC and CMN, by CUDA events around
each call) per second of audio served in the window."""

STAGES = ("frontend.weights", "frontend.fused", "frontend.synthesis", "frontend.mfcc",
          "frontend.cmn")


def read(ctx):
    if not any(s in ctx.spans for s in STAGES):
        return None
    return sum(ctx.spans.get(s, 0.0) for s in STAGES) / ctx.audio_s * 1e6
