"""embed_ms.convert: the speaker encoder: the source's and the target's embedding, ms a request: ``convert``'s synchronised
stage walls (``VoiceConverter.stage_times``) of the traced window's
requests, summed over embed_source, embed_target, over the requests."""

STAGES = ('embed_source', 'embed_target')


def read(r):
    if not r.stage_ms or not all(s in r.stage_ms for s in STAGES):
        return None
    return sum(r.stage_ms[s] for s in STAGES)
