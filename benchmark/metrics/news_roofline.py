"""``news_roofline.train``: NRMS's news encoder forward against its least
time: the kernels launched inside the program's ``train.step.news`` spans
of the traced steps (``harness/launches.py``: the title gather, the word
lookup, the attention and the pooling of every slot), their device time
summed, under the least time of as many forwards from shapes
(:mod:`metrics.nrms_shapes`: batch x (history + candidates) titles; FLOPs
at the float32 peak, bytes of the word rows, the ids, the weights and the
news vectors at HBM's). None where the trace has no such span or kernel."""

from __future__ import annotations

from metrics import nrms_shapes


def read(ctx, name: str):
    news = ((ctx.profile or {}).get("span_kernels") or {}).get("train.step.news")
    if not news or not news["kernels"] or news["seconds"] <= 0:
        return None
    conf = ctx.config
    titles = conf["train"]["batch_size"] * nrms_shapes.slots(conf)
    once = nrms_shapes.least_time(conf, titles * nrms_shapes.title_flops(conf),
                                  nrms_shapes.news_bytes(conf, titles))
    return 100.0 * news["ranges"] * once / news["seconds"]
