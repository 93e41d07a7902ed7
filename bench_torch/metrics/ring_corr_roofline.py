"""``csrc/ring_corr.cu``'s share of its roofline (%): the bound of every
call in the window (``roofline.ring_corr_work``: the features' pixels,
the radii and the nonzero taps of the weights it is given) over the
device time of ``ring_corr_kernel``. Layer: kernels."""

from bench_torch import roofline


def _record(trace, records, args, kwargs, call):
    feats, weights = args
    dense = weights.dense
    key = ("ring_corr_taps", dense.data_ptr(), tuple(dense.shape))
    if key not in trace.cache:
        trace.cache[key] = int((dense != 0).sum())
    records.append(roofline.bound_s(*roofline.ring_corr_work(
        feats.numel() // feats.shape[-3], dense.shape[0], trace.cache[key])))
    return call()


SPIES = (("magnify_tpu_torch.ops.score", "ring_corr", _record),)


def read(trace, cfg):
    return roofline.share_pct(
        trace, sum(trace.records.get("ring_corr_roofline", ())),
        "ring_corr_kernel")
