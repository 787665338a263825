"""mel_ms.convert: the mel front-end, ms a request: ``convert``'s synchronised
stage walls (``VoiceConverter.stage_times``) of the traced window's
requests, summed over mel, over the requests."""

STAGES = ('mel',)


def read(r):
    if not r.stage_ms or not all(s in r.stage_ms for s in STAGES):
        return None
    return sum(r.stage_ms[s] for s in STAGES)
