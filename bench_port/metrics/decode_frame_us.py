"""Host-clock microseconds of `topk_decoder.decode_batch` (synchronised
before and after, traceback included) per batch frame: the window's
decode time over the sum of its batches' frame counts."""


def read(ctx):
    frames = ctx.counters.get("decoder.batch_frames", 0)
    if not frames:
        return None
    return ctx.spans["decoder.decode_batch"] / frames * 1e6
