"""``csrc/hysteresis.cu``'s share of its roofline (%): the bound of every
call in the window (``roofline.hysteresis_work`` from the masks' shape)
over the device time of the ``hyst_*`` kernels. Layer: kernels."""

from bench_torch import roofline


def _record(trace, records, args, kwargs, call):
    strong = args[0] if args else kwargs["strong"]
    records.append(roofline.bound_s(*roofline.hysteresis_work(strong.numel())))
    return call()


SPIES = (("magnify_tpu_torch.ops.edge", "hysteresis", _record),)


def read(trace, cfg):
    return roofline.share_pct(
        trace, sum(trace.records.get("hysteresis_roofline", ())), "hyst_")
